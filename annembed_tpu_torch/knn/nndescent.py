"""NN-descent refinement of an approximate kNN graph (port of
annembed_tpu/knn/nndescent.py; Dong et al. 2011).

The IVF local join can miss neighbours that fall outside the probed
cells; neighbours of neighbours are excellent candidates.  One round
gathers, for every node, the two-hop candidates of its *symmetrized*
neighbourhood (forward lists plus a fixed-width reverse table), scores
them with the metric's pair form and merges them with the current top-k.

``rho`` < 1 is Dong's candidate sampling: each round draws an
independent per-node random subset of size rho (k + rc) from the
symmetrized neighbourhood and joins over it (outer and inner hop), so
the (rows, C, d) candidate gather shrinks by ~rho^2.  The node's own
full neighbourhood is always appended as direct candidates, so one-hop
reverse edges are never lost.  The uniforms of each round are an
argument, or come from a generator on the data's device.

A round's local join runs where ``ops.nndescent.round_route`` sends its
shape: one launch of the hand-written kernel over every row (DistL2 on
the card), or ``_nndescent_slab`` over rows in slabs whose candidate
gather fits a byte budget.  Tables are int32 in memory and widened where
torch wants int64.  The counter ``knn.nndescent.pairs`` counts the
candidate distances the rounds score.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.nndescent import _outputs, nndescent_round
from ..utils.profiling import PhaseTimer, count
from .brute import _topk_lowest_index
from .distances import PANEL_BYTES, get_pair_fn

#: the registry counter of the candidate distances the rounds score
PAIRS = "knn.nndescent.pairs"


def _reverse_table(indices: torch.Tensor, capacity: int,
                   dists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, capacity) int32 table of reverse neighbours (who points at
    me), padded with n.  Overflow beyond capacity keeps the nearest
    sources when ``dists`` is given, else the lowest-id ones."""
    n, k = indices.shape
    dev = indices.device
    flat_dst = indices.reshape(-1)
    # order by (destination, distance), ties in arrival order: stable
    # sorts, minor key first
    if dists is None:
        order = torch.argsort(flat_dst, stable=True)
    else:
        by_d = torch.argsort(dists.reshape(-1), stable=True)
        order = by_d[torch.argsort(flat_dst[by_d], stable=True)]
        del by_d
    dst_sorted = flat_dst[order].to(torch.int64)
    src_sorted = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    del order
    # position within a destination's group = index - first index of it
    first_idx = torch.searchsorted(dst_sorted, torch.arange(n, device=dev))
    pos = torch.arange(n * k, device=dev) - first_idx[dst_sorted]
    keep = pos < capacity
    table = torch.full((n, capacity), n, dtype=torch.int32, device=dev)
    table[dst_sorted[keep], pos[keep]] = src_sorted[keep]
    return table


def _union_pp(indices: torch.Tensor, rev_capacity: int,
              dists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Padded symmetrized neighbourhood table (n + 1, k + rc) int32: the
    forward lists, the reverse table, and one all-pad row n."""
    n = indices.shape[0]
    rev = _reverse_table(indices, rev_capacity, dists)
    union = torch.cat([indices.to(torch.int32), rev], dim=1)
    return torch.cat([union, union.new_full((1, union.shape[1]), n)])


def _sample_union_pp(uniforms: torch.Tensor, union_pp: torch.Tensor,
                     s: int) -> torch.Tensor:
    """Per-row random s-subset of the padded union table (n + 1, u) ->
    (n + 1, s), valid (non-pad) entries preferred: the s smallest of one
    uniform per entry, pads pushed last, ties to the lower column."""
    n = union_pp.shape[0] - 1
    u = uniforms + 10.0 * (union_pp >= n)
    cols = torch.sort(u, dim=1, stable=True).indices[:, :s]
    return torch.gather(union_pp, 1, cols)


def _nndescent_slab(x_pad: torch.Tensor, inner_pp: torch.Tensor,
                    cur_idx: torch.Tensor, cur_dist: torch.Tensor,
                    uni: torch.Tensor, full: torch.Tensor,
                    rid: torch.Tensor, k: int, distance: str = "DistL2",
                    pairs: Optional[torch.Tensor] = None):
    """One slab of the local join (the twin of ``csrc/nndescent.cu``).

    ``inner_pp`` (n + 1, s) is the (possibly rho-sampled) neighbourhood
    used for the inner hop; ``uni`` (rows, s) the outer sampled
    neighbourhood of the slab's rows; ``full`` (rows, u) the unsampled
    neighbourhood, appended as direct candidates.  ``x_pad`` may be
    bfloat16 (candidate scoring only; distances accumulate in f32).

    Duplicate candidates (one node reached through several lists) are
    removed by an id sort + adjacent-equal mask before the top-k merge,
    and duplicates already inside the current list are set to inf first,
    so fresh candidates can evict them.  ``pairs`` (an int64 scalar
    tensor), when given, gains the number of candidates scored."""
    pair_fn = get_pair_fn(distance)
    n = x_pad.shape[0] - 1
    rows, kk = cur_idx.shape
    eq = cur_idx[:, :, None] == cur_idx[:, None, :]
    earlier = torch.ones((kk, kk), dtype=torch.bool,
                         device=cur_idx.device).tril(-1)
    cur_dist = cur_dist.masked_fill((eq & earlier).any(-1), float("inf"))
    # candidates: sampled B(sampled B(i)) plus the full B(i); sorted by
    # id so duplicates are adjacent, pads (>= n) last
    cand = torch.cat([inner_pp[uni].reshape(rows, -1), full], dim=1)
    cand = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    q = x_pad[rid].to(torch.float32)
    xc = x_pad[cand].to(torch.float32)
    cd = pair_fn(q[:, None, :], xc)
    del xc
    invalid = (cand >= n) | (cand == rid[:, None]) | dup
    # already-known neighbours would be duplicates in the merge
    known = (cand[:, :, None] == cur_idx[:, None, :]).any(-1)
    skip = invalid | known
    cd.masked_fill_(skip, float("inf"))
    if pairs is not None:
        pairs += (~skip).sum()
    all_d = torch.cat([cur_dist, cd], dim=1)
    all_i = torch.cat([cur_idx, cand], dim=1)
    new_d, pos = _topk_lowest_index(all_d, k)
    return torch.gather(all_i, 1, pos), new_d.clamp_min_(0.0)


def _exact_rerank_slab(x: torch.Tensor, idx_slab: torch.Tensor,
                       rid_slab: torch.Tensor, distance: str = "DistL2"):
    """Recompute the distances of (rows, k) neighbour lists exactly in
    f32 and restore ascending order (a pad id >= n stays at inf)."""
    n = x.shape[0]
    pad = idx_slab >= n
    xc = x[idx_slab.clamp_max(n - 1)]                    # (rows, k, d)
    d = get_pair_fn(distance)(x[rid_slab][:, None, :], xc)
    d = d.masked_fill(pad, float("inf"))
    d, order = torch.sort(d, dim=1, stable=True)
    return torch.gather(idx_slab, 1, order), d.clamp_min_(0.0)


def nndescent_refine(x: torch.Tensor, indices: torch.Tensor,
                     dists: torch.Tensor, n_rounds: int = 2,
                     rev_capacity: int = 0, distance: str = "DistL2",
                     dtype: str = "float32", rho: float = 1.0,
                     seed: int = 0,
                     uniforms: Optional[Sequence[torch.Tensor]] = None,
                     slab_bytes: int = PANEL_BYTES,
                     timer: Optional[PhaseTimer] = None, mesh=None):
    """Refine (indices, dists) over ``n_rounds``, in any of the five
    metrics.  Returns (indices (n, k) int32, dists (n, k) f32).

    ``dtype="bfloat16"`` scores candidates from a bf16 copy of x (half
    the bytes of the (rows, C, d) gather) and exact-reranks the final
    lists in f32, so returned distances stay f32-exact.

    ``rho`` < 1 joins over a per-node, per-round random subset of the
    symmetrized neighbourhood.  ``uniforms``, one (n + 1, k + rc) tensor
    per round, may be given; otherwise each round draws its own from a
    generator on x's device seeded ``seed + 1013``.  ``slab_bytes``
    bounds one slab's (rows, C, d) f32 gather of the torch route and the
    slab plan of a mesh; results do not depend on it.  ``timer`` receives
    the wall seconds of the phases ``nndescent_round_<i>`` and
    ``nndescent_rerank``; the counter ``knn.nndescent.pairs`` the
    candidates each round scores, read after its span's sync.

    ``mesh`` (parallel/sharded.py, through ``sharded_nndescent_refine``)
    gives rank r every size-th slab of the one slab plan; the union
    tables and their sampling are computed alike on every rank, and the
    ranks' slab outputs, zero elsewhere, are summed after each round and
    after the rerank."""
    x = x.to(torch.float32)
    n, d = x.shape
    dev = x.device
    k = indices.shape[1]
    if rev_capacity <= 0:
        rev_capacity = k
    score_bf16 = dtype == "bfloat16"
    x_score = x.to(torch.bfloat16) if score_bf16 else x
    x_pad = torch.cat([x_score, x_score.new_zeros((1, d))])
    u = k + rev_capacity
    s = u if rho >= 1.0 else max(2, int(round(rho * u)))
    cand_per_row = s * s + u
    # the gather, the pair form's difference and square, and the
    # (rows, C, k) known mask are live together
    slab = max(1, slab_bytes // (cand_per_row * (12 * d + k)))
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    indices = indices.to(torch.int32).contiguous()
    dists = dists.to(torch.float32).contiguous()
    gen = None
    if timer is None:
        timer = PhaseTimer()
    for rnd in range(n_rounds):
        with timer.phase(f"nndescent_round_{rnd + 1}") as sync:
            indices, dists, gen, pairs = _round(
                x_pad, indices, dists, rnd, rev_capacity, s, slab,
                distance, uniforms, gen, seed, mesh)
            sync.append(dists)
        # read after the span's sync: no stall of its own
        count(PAIRS, pairs.item())
        del pairs
    if score_bf16:
        with timer.phase("nndescent_rerank") as sync:
            rr_slab = max(1, slab_bytes // (12 * k * d))
            out_i, out_d = _outputs(indices, dists, _size(mesh))
            for s0 in _own_slabs(n, rr_slab, mesh):
                s1 = min(s0 + rr_slab, n)
                out_i[s0:s1], out_d[s0:s1] = _exact_rerank_slab(
                    x, indices[s0:s1], ids[s0:s1], distance)
            indices, dists = _merge(out_i, out_d, mesh)
            sync.append(dists)
    return indices, dists


def _own_slabs(n: int, slab: int, mesh):
    """First rows of the slabs this rank runs: all of them, or every
    size-th under a mesh."""
    return range(0, n, slab)[_rank(mesh)::_size(mesh)]


def _rank(mesh) -> int:
    return 0 if mesh is None else mesh.rank


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _merge(out_i, out_d, mesh):
    if mesh is not None:
        mesh.all_reduce_sum(out_i, out_d)
    return out_i, out_d


def _round(x_pad, indices, dists, rnd: int, rev_capacity: int, s: int,
           slab: int, distance: str, uniforms, gen, seed: int, mesh=None):
    """One NN-descent round over all rows (``ops.nndescent``'s route).
    Returns the new (indices, dists), the generator (made at the first
    sampled round) and the candidates scored (an int64 scalar on the
    device, made after the union table, whose sorts are the round's
    peak)."""
    dev = indices.device
    union_pp = _union_pp(indices, rev_capacity, dists)
    inner_pp = union_pp
    if s < union_pp.shape[1]:
        if uniforms is not None:
            un = uniforms[rnd].to(dev)
        else:
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(seed + 1013)
            un = torch.rand(union_pp.shape, generator=gen, device=dev)
        inner_pp = _sample_union_pp(un, union_pp, s)
        del un
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    out_i, out_d = nndescent_round(x_pad, inner_pp, union_pp, indices, dists,
                                   slab, distance, _rank(mesh), _size(mesh),
                                   pairs)
    out_i, out_d = _merge(out_i, out_d, mesh)
    return out_i, out_d, gen, pairs
