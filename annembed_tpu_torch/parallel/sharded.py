"""Multi-device sharding of the embedding pipeline (port of
annembed_tpu/parallel/sharded.py).

The JAX package drives a 1-D ``data`` mesh of devices from one process
with ``shard_map``.  The port runs one process per device (SPMD): a
:class:`Mesh` is this rank's place in a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU), every sharded function is
called by every rank with the same arguments, and the body the JAX
package writes as ``local(...)`` runs on the rank's row, entry or edge
block.  ``psum`` is ``all_reduce``; ``all_gather(..., tiled=True)`` is
``all_gather_into_tensor`` of row blocks.  ``parallel/launch.py`` starts
the ranks.

  * kNN construction (parallel/sharded_knn.py): query rows, join batches
    or NN-descent slabs split over the ranks, results merged.
  * Spectral init (parallel/sharded_svd.py): COO entries split, each
    matmat one ``all_reduce``.
  * CE optimization: ``sharded_dense_optimize``, the production
    multi-device optimizer: node rows sharded, the (dim, n) embedding
    replicated, one all-gather of the updated row blocks per half-sweep.
    ``make_sharded_train_step`` and ``make_sharded_dense_step`` are the
    JAX package's semantics checks.

Replicated state stays bit-equal on every rank: it comes from generators
seeded alike on every rank, or rank 0 broadcasts it where the card's
atomics make a computation not bit-reproducible (the IVF quantizer, the
optimizer's starting coordinates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..optim.ce import NB_NEGATIVE, EdgeSet, _common_coeff
from ..params import PROBA_MIN
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D ``data`` mesh of ``size`` ranks: its
    rank, its device and the process group (None: the default group).
    The collectives are methods, so the single-device modules that take
    a mesh (knn/ivf.py, knn/nndescent.py) need not import this one."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank) concatenated
        along dim 0 in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, t, group=self.group)
        return out

    def all_reduce_sum(self, *ts: torch.Tensor) -> None:
        """Sum each tensor over the ranks, in place."""
        for t in ts:
            dist.all_reduce(t, group=self.group)

    def broadcast(self, *ts: torch.Tensor, src: int = 0) -> None:
        """Overwrite each tensor with rank ``src``'s, in place."""
        for t in ts:
            dist.broadcast(t, src, group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """The mesh of an initialized process group of ``n_devices`` ranks
    (default: the whole group).  The group is set up by
    ``parallel.launch.run_on_ranks`` or by the caller (torchrun style);
    the device is ``cuda:<current>`` under NCCL and the CPU under gloo."""
    if axis != "data":
        # every sharded function addresses the axis as "data"
        raise ValueError("this module requires the mesh axis name 'data'")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "start the ranks with parallel.launch."
                           "run_on_ranks, or init_process_group first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=world, device=device)


def rank_generator(seed: int, mesh: Mesh, device=None) -> torch.Generator:
    """A generator of this rank's own stream (JAX's ``fold_in(key,
    dev)``), on ``device`` (default: the CPU)."""
    gen = torch.Generator(device=device or "cpu")
    return gen.manual_seed(seed * 1_000_003 + 7919 * (mesh.rank + 1))


# ---------------------------------------------------------------------------
# sharded kNN
# ---------------------------------------------------------------------------

def sharded_knn_graph(x, k: int, mesh: Mesh, block_rows: int = 1024):
    """Row-sharded exact kNN (alias of the production
    ``sharded_knn_graph_brute``)."""
    from .sharded_knn import sharded_knn_graph_brute
    return sharded_knn_graph_brute(x, k, mesh, block_rows=block_rows)


# ---------------------------------------------------------------------------
# sharded CE training step (semantics check)
# ---------------------------------------------------------------------------

def _local_delta(y, u, neg, src, dst, weight, local_cdf, neighbors,
                 emb_scale, grad_step: float, b: float):
    """Delta contribution of one rank's edge shard (the body of the
    reference hot loop, embedder.rs:1167-1302, in batched form): ``u``
    (batch,) uniforms pick the edges through the shard's cdf, ``neg``
    (batch, NB_NEGATIVE) are the negatives."""
    eidx = torch.searchsorted(local_cdf, u).clamp_max(local_cdf.shape[0] - 1)
    i = src[eidx].to(torch.int64)
    j = dst[eidx].to(torch.int64)
    w = weight[eidx]
    # draws that land on zero-weight padding edges are no-ops
    valid = w > 0.0
    yi, yj = y[i], y[j]
    scale = emb_scale[i]
    d2s = torch.square(yi - yj).sum(-1) / torch.square(scale)
    coeff = _common_coeff(d2s, scale, b)
    rep_att = 1.0 / torch.square(d2s).clamp_min(1.0 / PROBA_MIN)
    coeff_ij = (grad_step * coeff * (-w + (1 - w) * rep_att)).clamp_min(-0.49)
    coeff_ij = torch.where((d2s > 0) & valid, coeff_ij,
                           torch.zeros_like(coeff_ij))
    g_att = (yj - yi) * coeff_ij[:, None]

    neg = neg.to(torch.int64)
    nbrs = neighbors[i].to(torch.int64)
    reject = ((neg == i[:, None]) | (neg == j[:, None])
              | (neg[:, :, None] == nbrs[:, None, :]).any(-1))
    yk = y[neg]
    d2k = torch.square(yi[:, None, :] - yk).sum(-1) \
        / torch.square(scale)[:, None]
    coeff_k = _common_coeff(d2k, scale[:, None], b)
    rep = 1.0 / torch.square(d2k).clamp_min(1.0 / 16.0)
    coeff_ik = (grad_step * coeff_k * rep).clamp_max(2.0)
    coeff_ik = torch.where((d2k > 0) & ~reject & valid[:, None], coeff_ik,
                           torch.zeros_like(coeff_ik))
    g_rep = (yk - yi[:, None, :]) * coeff_ik[:, :, None]

    delta = torch.zeros_like(y)
    delta.index_add_(0, i, -(g_att + g_rep.sum(1)))
    delta.index_add_(0, j, g_att)
    return delta


def make_sharded_train_step(mesh: Mesh, b: float = 1.0,
                            batch_size_per_device: int = 1024):
    """SEMANTICS CHECK, not the production path: a minimal data-parallel
    form of the per-sample (sampling) optimizer.  The production
    multi-device optimizer is ``sharded_dense_optimize``.

    Returns ``step(y, seed, src, dst, weight, local_cdf, neighbors,
    emb_scale, grad_step, draws=None)``: the embedding y is replicated,
    src/dst/weight/cdf are this rank's edge shard (``shard_edge_set``;
    the cdf is the shard's own, so sampling is stratified by shard), and
    the ranks' deltas are summed.  ``draws`` = (u (batch,), neg (batch,
    NB_NEGATIVE)) are this rank's; otherwise they come from the rank's
    own stream of ``seed``."""

    def step(y, seed, src, dst, weight, local_cdf, neighbors, emb_scale,
             grad_step, draws=None):
        if draws is None:
            gen = rank_generator(int(seed), mesh, y.device)
            u = torch.rand(batch_size_per_device, generator=gen,
                           device=y.device)
            neg = torch.randint(0, y.shape[0],
                                (batch_size_per_device, NB_NEGATIVE),
                                generator=gen, device=y.device)
        else:
            u, neg = (torch.as_tensor(a).to(y.device) for a in draws)
        delta = _local_delta(y, u, neg, src, dst, weight, local_cdf,
                             neighbors, emb_scale, float(grad_step), b)
        mesh.all_reduce_sum(delta)
        return y + delta

    return step


def shard_edge_set(es: EdgeSet, mesh: Mesh):
    """This rank's padded edge shard and its cumulative weights, plus the
    replicated neighbour table and scales: the arguments of the sharded
    train step after ``seed``."""
    e = es.nb_edges
    ndev = mesh.size
    if e < ndev:
        raise ValueError(f"need at least one edge per device "
                         f"({e} edges, {ndev} devices)")
    pad = (-e) % ndev
    shard_len = (e + pad) // ndev
    lo = mesh.rank * shard_len

    def shard(a):
        a = torch.cat([a, a.new_zeros(pad)]) if pad else a
        return a[lo:lo + shard_len].to(mesh.device)

    w = shard(es.weight)
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1:].clamp_min(1e-30)
    return (shard(es.src), shard(es.dst), w, cdf,
            es.neighbors.to(mesh.device), es.embedded_scale.to(mesh.device))


def make_sharded_dense_step(mesh: Mesh, b: float = 1.0, n_neg: int = 10):
    """SEMANTICS CHECK, not the production path: one dense sweep in
    row-major layout with a full per-call permutation, the scatter-based
    reference the JAX package keeps for parity testing.

    Returns ``step(y, seed, row0, indices, w, m_visit, w_rev, m_rev,
    emb_scale, gamma, draws=None)``: node rows (and their (m, k) edge
    tables, ``shard_dense_inputs``) sharded, y (n, d) replicated; each
    rank computes the attraction of its rows (own moves plus the reverse
    moves of their neighbours) and its rows' pool repulsion, and the
    ranks' deltas are summed.  ``draws`` = (perm (n,), offset) are this
    rank's; otherwise they come from its own stream of ``seed``."""
    from ..optim.dense import _clipped_alpha

    def step(y, seed, row0, indices, w, m_visit, w_rev, m_rev, emb_scale,
             gamma, draws=None):
        n, d = y.shape
        m_rows, k = indices.shape
        dev = y.device
        r0 = int(row0[0])
        if draws is None:
            gen = rank_generator(int(seed), mesh)
            perm = torch.randperm(n, generator=gen).to(dev)
            offset = int(torch.randint(0, n, (), generator=gen))
        else:
            perm = torch.as_tensor(draws[0]).to(dev, torch.int64)
            offset = int(draws[1])
        gamma = float(gamma)
        idx = indices.to(torch.int64)
        yi_rows = y[r0:r0 + m_rows]
        scale_i = emb_scale[r0:r0 + m_rows]

        # attraction (pair-shared closed form, optim/dense.py)
        yi = yi_rows[:, None, :]
        yj = y[idx]
        scale_j = emb_scale[idx]
        d2 = torch.square(yi - yj).sum(-1)
        a_f = _clipped_alpha(d2 / torch.square(scale_i[:, None]),
                             scale_i[:, None], w, gamma, b)
        a_r = _clipped_alpha(d2 / torch.square(scale_j), scale_j, w_rev,
                             gamma, b)
        f_pair = torch.pow(torch.clamp(1 - 2 * a_f, 1e-3, 1.05), m_visit) \
            * torch.pow(torch.clamp(1 - 2 * a_r, 1e-3, 1.05), m_rev)
        share = m_visit / (m_visit + m_rev).clamp_min(1e-30)
        net = share * (1.0 - f_pair) * 0.5
        step_vec = (yj - yi) * net[:, :, None]

        # repulsion from the permuted pool (contiguous slices)
        y_pool = y[perm]
        pos = (r0 * n_neg + torch.arange(m_rows * n_neg, device=dev)
               + offset) % n
        neg_ids = perm[pos].reshape(m_rows, n_neg)
        yk = y_pool[pos].reshape(m_rows, n_neg, d)
        gids = r0 + torch.arange(m_rows, device=dev)
        reject = (neg_ids == gids[:, None]) \
            | (neg_ids[:, :, None] == idx[:, None, :]).any(-1)
        d2k = torch.square(yi - yk).sum(-1) / torch.square(scale_i)[:, None]
        coeff_k = _common_coeff(d2k, scale_i[:, None], b)
        rep = 1.0 / torch.square(d2k).clamp_min(1.0 / 16.0)
        coeff_ik = (gamma * coeff_k * rep).clamp_max(2.0)
        coeff_ik = torch.where((d2k > 0) & ~reject, coeff_ik,
                               torch.zeros_like(coeff_ik))
        d_neg = ((yi - yk) * coeff_ik[:, :, None]).sum(1)

        delta = torch.zeros_like(y)
        delta[r0:r0 + m_rows] = step_vec.sum(1) + d_neg
        delta.index_add_(0, idx.reshape(-1), -step_vec.reshape(-1, d))
        mesh.all_reduce_sum(delta)
        return y + delta

    return step


def shard_dense_inputs(g, npar, params, mesh: Mesh):
    """This rank's dense-step inputs: (row0 (1,), indices, w, m_visit,
    w_rev, m_rev) of its row block and the replicated emb_scale.
    Requires n divisible by the mesh size (pad upstream if needed)."""
    from ..optim.ce import embedded_scales_from_initial
    from ..optim.dense import reverse_edge_info

    n, k = g.indices.shape
    ndev = mesh.size
    if n % ndev:
        raise ValueError("pad n to a multiple of the mesh size")
    dev = mesh.device
    indices = g.indices.to(dev)
    w = npar.probas.to(dev, torch.float32)
    w_rev = reverse_edge_info(indices, w)
    n_sub = params.n_sub
    m_visit = params.nb_sampling_by_edge * k * w / n_sub
    m_rev = params.nb_sampling_by_edge * k * w_rev / n_sub
    emb_scale = embedded_scales_from_initial(npar.scale.to(dev))
    m = n // ndev
    sl = slice(mesh.rank * m, (mesh.rank + 1) * m)
    row0 = torch.tensor([mesh.rank * m], dtype=torch.int32, device=dev)
    return (row0, indices[sl], w[sl], m_visit[sl], w_rev[sl], m_rev[sl],
            emb_scale)


# ---------------------------------------------------------------------------
# the production multi-device dense optimizer
# ---------------------------------------------------------------------------

def make_sharded_dense_segment(mesh: Mesh, b: float, n_sub: int, n_neg: int,
                               nb_grad_batch: int, n_groups: int,
                               grad_step_init: float, f_min: float,
                               mask_p: float, seg_steps: int, batch0: int = 0,
                               use_rot0: bool = False,
                               packed_gather: bool = False,
                               parallel_kicks: bool = False,
                               gather_reuse: int = 1,
                               neighbor_exclusion: bool = True,
                               mask_generator: Optional[torch.Generator]
                               = None):
    """One multi-sweep segment of the production dense schedule,
    row-sharded over the mesh: the optim/dense.py formulation (column-
    grouped scatter-free attraction with the closure floor and edge
    masks, then the rolled identity-pool kicks) on this rank's row
    block, each half-sweep one launch of ops/dense_sweep.py's kernel pair
    (their twins on the CPU), the updated blocks all-gathered after it.
    Kick t of position p pairs it with (p + offset + t * (n // n_neg))
    mod n of the replicated snapshot, a contiguous window.

    ``batch0`` / ``use_rot0`` carry the n_sub schedule phases: gamma
    decays at batch ``batch0 + step // n_sub + 1`` of the global
    schedule, the column-group rotation follows ``rot0 + local`` when
    scheduled.  ``gather_reuse`` S > 1 reads the neighbours of S sweeps
    from one snapshot, blocks restarting at the segment.
    ``packed_gather`` is accepted: the JAX package packs the (2, n)
    coordinates into complex64 for a cheaper TPU gather with bit-equal
    values, so the port runs its one gather either way.  The edge masks
    of ``mask_p`` < 1 come from ``mask_generator``, this rank's own
    stream.

    Returns ``segment(y0, tables, offsets, step0, rot0)``: y0 (n, dim)
    replicated, ``tables`` the kernels' layout of this rank's (m, k) edge
    tables with the replicated scales and hubness weights
    (``segment_tables``), ``offsets`` one pool offset per sweep.  The
    result is (n, dim), replicated."""
    from ..ops.dense_sweep import dense_attraction_rows, dense_kick_rows
    from ..optim.dense import _gamma
    del packed_gather

    def segment(y0, tables, offsets, step0: int, rot0: int):
        groups, idx_full = tables["edges"], tables["idx_full"]
        scale, nw = tables["scale"], tables["neg_weight"]
        k, m = idx_full.shape
        if groups.shape[0] != n_groups:
            raise ValueError(f"tables of {groups.shape[0]} column groups, "
                             f"not n_groups={n_groups}")
        if len(offsets) != seg_steps:
            raise ValueError(f"{len(offsets)} offsets for {seg_steps} "
                             "sweeps")
        kg = k // n_groups
        r0 = mesh.rank * m

        def sweep(y, local, y_src):
            s = step0 + local
            gamma = _gamma(grad_step_init, batch0 + s // n_sub + 1,
                           nb_grad_batch)
            c = (rot0 + local if use_rot0 else s) % n_groups
            mask = None
            if mask_p < 1.0:
                mask = (torch.rand((kg, m), generator=mask_generator,
                                   device=mask_generator.device) < mask_p
                        ).to(y.device, torch.float32)
            rows = dense_attraction_rows(
                y, y_src, r0, groups[c], scale, gamma, b, f_min=f_min,
                mask=mask, mask_p=mask_p)
            y = mesh.all_gather_rows(rows)
            # the kicks read the post-attraction snapshot, own rows too
            rows = dense_kick_rows(
                y, y[r0:r0 + m], r0, int(offsets[local]), idx_full, scale,
                gamma, b, n_neg, neg_weight=nw,
                neighbor_exclusion=neighbor_exclusion,
                parallel_kicks=parallel_kicks)
            return mesh.all_gather_rows(rows)

        y = y0.to(torch.float32).contiguous()
        # the stale gather (S > 1): the neighbours of S sweeps are read
        # from the replicated snapshot of the block's first sweep,
        # rotation and draws as fresh; blocks restart at the segment
        for blk in range(0, seg_steps, gather_reuse):
            snap = y
            for local in range(blk, min(blk + gather_reuse, seg_steps)):
                y = sweep(y, local, snap)
        return y

    return segment


def segment_tables(indices, w, m_visit, w_rev, m_rev, emb_scale, neg_weight,
                   n_groups: int) -> dict:
    """The sweep kernels' layout of a rank's (m, k) edge tables, which
    every segment of a schedule phase shares: the packed edge records
    (n_groups, m, words), the neighbour ids (k, m) int32 (global ids),
    and the scales and hubness weights (n,) float32 (None: all ones)."""
    from ..ops.dense_sweep import pack_groups
    if indices.shape[1] % n_groups:
        raise ValueError(f"k={indices.shape[1]} must be divisible by "
                         f"n_groups={n_groups}")
    idx = indices.to(torch.int32)
    scale = emb_scale.to(torch.float32).contiguous()
    return dict(edges=pack_groups(idx, w, m_visit, w_rev, m_rev, scale,
                                  n_groups),
                idx_full=idx.T.contiguous(), scale=scale,
                neg_weight=(None if neg_weight is None else
                            neg_weight.to(torch.float32).contiguous()))


def sharded_dense_optimize(y0, g, npar, params, mesh: Mesh,
                           nb_grad_batch: Optional[int] = None,
                           neg_weights=None, relabel=None,
                           offsets: Optional[Sequence[int]] = None,
                           generator: Optional[torch.Generator] = None):
    """Multi-device dense optimization with the single-device schedule
    (optim/dense.py::run_dense_optimization): relabel-once permutation,
    column groups, per-visit multiplicities, closure floor and edge
    masks, hubness importance weights, the n_sub schedule phases, the
    stacked kicks and the stale gather, row-sharded over the mesh in
    segments of the JAX package's per-device program cap.

    Ragged n is padded to a multiple of the mesh size with inert rows:
    zero edge weight and multiplicity, self edges, zero negative weight
    (they sit in the rolled pool, where any other weight would kick real
    rows); the output drops them.  Pool offsets are drawn over the padded
    n.  ``params.dense_n_blocks`` and the row-major path are single-
    device layouts and are not applied here, as in the JAX package.

    ``relabel`` and ``offsets`` (every executed sweep, in order) may be
    given; otherwise both come from ``generator`` (default: a CPU
    generator seeded with ``params.seed``, the same stream on every
    rank), as do the pad rows' coordinates.  The starting coordinates
    are rank 0's.  Returns (y (n, dim) in the original order,
    replicated; info)."""
    from ..optim.dense import _auto_groups, _segments, prepare_dense_inputs

    p = params
    dev = mesh.device
    n, k = g.indices.shape
    ndev = mesh.size
    n_groups = _auto_groups(k)
    # (an explicit 0 means "no optimization", not "use the default")
    nb = int(p.nb_grad_batch) if nb_grad_batch is None else int(nb_grad_batch)
    schedule = p.n_sub_schedule
    if not schedule:
        schedule = ((nb, int(p.n_sub)),)
    else:
        schedule = tuple((int(nbp), int(s)) for nbp, s in schedule)
        if sum(nbp for nbp, _ in schedule) != nb:
            raise ValueError(f"n_sub_schedule batches {schedule} must sum "
                             f"to nb_grad_batch={nb}")
    n_sub = schedule[0][1]
    if generator is None:
        generator = torch.Generator().manual_seed(p.seed)

    y0 = y0.to(dev, torch.float32).contiguous().clone()
    mesh.broadcast(y0)
    with span("relabel"):
        (y0_r, indices_r, w, m_visit, w_rev, m_rev, emb_scale, neg_weight,
         n_neg, inv) = prepare_dense_inputs(
            y0, g, npar, p, n_sub, n_groups,
            None if neg_weights is None else neg_weights.to(dev),
            relabel=relabel, generator=generator)

    pad = (-n) % ndev
    if pad:
        dim = y0_r.shape[1]
        y_pad = torch.rand((pad, dim), generator=generator) * 10.0 - 5.0
        y0_r = torch.cat([y0_r, y_pad.to(dev)])
        pad_idx = torch.arange(n, n + pad, dtype=torch.int32, device=dev)
        indices_r = torch.cat([indices_r, pad_idx[:, None].expand(pad, k)])
        zeros = w.new_zeros((pad, k))
        w, m_visit = torch.cat([w, zeros]), torch.cat([m_visit, zeros])
        w_rev, m_rev = torch.cat([w_rev, zeros]), torch.cat([m_rev, zeros])
        emb_scale = torch.cat([emb_scale, emb_scale.new_ones(pad)])
        if neg_weight is None:
            neg_weight = w.new_ones(n)
        neg_weight = torch.cat([neg_weight, w.new_zeros(pad)])
    n_pad = n + pad
    m = n_pad // ndev
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    shard = [indices_r[rows], w[rows], m_visit[rows], w_rev[rows],
             m_rev[rows]]

    reuse = max(int(p.dense_gather_reuse), 1)
    after = float(p.dense_gather_reuse_after)
    mask_gen = None
    if float(p.dense_mask_p) < 1.0:
        mask_gen = rank_generator(p.seed, mesh, dev)
    y = y0_r
    batch_cursor, sweeps = 0, 0
    for nbp, s_p in schedule:
        scale_m = n_sub / s_p
        n_neg_p = (n_neg if len(schedule) == 1 else
                   max(1, round(NB_NEGATIVE * p.nb_sampling_by_edge * k
                                / s_p)))
        # the reference's final batch runs at gamma = 0: skipped
        eff = max(min(batch_cursor + nbp, nb - 1) - batch_cursor, 0)
        total = eff * s_p
        if total:
            if offsets is None:
                offs = torch.randint(0, n_pad, (total,),
                                     generator=generator).tolist()
            else:
                offs = list(offsets[sweeps:sweeps + total])
                if len(offs) != total:
                    raise ValueError("too few offsets for the schedule")
            args = list(shard)
            if scale_m != 1.0:
                args[2], args[4] = args[2] * scale_m, args[4] * scale_m
            # the kernels' layout of the phase's tables, once for all of
            # its segments
            tables = segment_tables(*args, emb_scale, neg_weight, n_groups)
            made = {}
            # the per-device program cap of the JAX package: the row
            # shard's sweep cost, not the padded global n
            for pos, seg_steps, s_r in _segments(total, m, n_groups, 1, s_p,
                                                 nb, batch_cursor, reuse,
                                                 after):
                if (seg_steps, s_r) not in made:
                    made[(seg_steps, s_r)] = make_sharded_dense_segment(
                        mesh, b=float(p.b), n_sub=s_p, n_neg=n_neg_p,
                        nb_grad_batch=nb, n_groups=n_groups,
                        grad_step_init=float(p.grad_step),
                        f_min=float(p.dense_f_min),
                        mask_p=float(p.dense_mask_p), seg_steps=seg_steps,
                        batch0=batch_cursor, use_rot0=len(schedule) > 1,
                        packed_gather=bool(p.dense_packed_gather),
                        parallel_kicks=bool(p.dense_parallel_kicks),
                        gather_reuse=s_r,
                        neighbor_exclusion=bool(p.dense_neighbor_exclusion),
                        mask_generator=mask_gen)
                y = made[(seg_steps, s_r)](
                    y, tables, offs[pos:pos + seg_steps], pos, sweeps + pos)
        sweeps += total
        batch_cursor += nbp
    if offsets is not None and len(offsets) != sweeps:
        raise ValueError(f"{len(offsets)} offsets for {sweeps} sweeps")
    info = {"optimizer": "dense", "n_devices": ndev, "n_sub": int(p.n_sub),
            "n_neg": n_neg, "n_groups": n_groups,
            "f_min": float(p.dense_f_min),
            "mask_p": float(p.dense_mask_p), "sweeps": sweeps}
    if len(schedule) > 1:
        info["n_sub_schedule"] = schedule
    if p.dense_parallel_kicks:
        info["parallel_kicks"] = 1
    if reuse > 1:
        info["gather_reuse"] = reuse
    return y[:n][inv], info
