"""Dense-sweep CE optimizer.

Port of annembed_tpu/optim/dense.py (see its module docstring for the
derivation).  In short, per sub-sweep of the default path:

  * attraction in closed form per edge (``_attraction_sweep_sfT``): a
    pair's gap shrinks by (1-2a_f)^m (1-2a_r)^m_rev for its expected
    multiplicities m per visit, floored at ``f_min``; each row moves only
    its own endpoint (mutual pairs split the move);
  * ``n_neg`` SEQUENTIAL repulsion kicks (``_repulsion_block_T``) against
    the post-attraction snapshot: nodes are relabeled once by a global
    random permutation, so kick t of position p pairs it with position
    (p + offset + t*(n//n_neg)) mod n, a contiguous slice, zero gathers;
  * gamma decays as grad_step * (1 - batch/nb_grad_batch); the final
    batch (gamma = 0) is skipped.

The transposed path runs on the CUDA kernels of ``ops/dense_sweep.py``
on the card, and on the CPU on their twins, which call the per-sweep
functions below in the JAX package's (d, n) layout: whole-array sweeps
one persistent launch a run (a segment, or a stale-gather block), node
blocks and edge masks two launches a sweep (``launch_plan``).
``dense_optimize`` keeps the kernel's layout: coordinates row-major
(n, d), each group's edge tables one packed record a row, built once
per call.  The relabel permutation and the per-sweep offsets come
from a ``torch.Generator``, or are passed in (tests feed the JAX
package's draws).

The knobs, each as the JAX package runs it:

  * ``n_blocks`` > 1: each sub-sweep moves one contiguous node block,
    group x block round-robin (block fastest);
  * ``gather_reuse`` S > 1: S consecutive sweeps read their neighbours
    from one snapshot (the attraction reads them up to S-1 sweeps stale);
    stale blocks restart at each segment of ``_segments``, whose
    boundaries are the JAX package's program segments;
  * ``parallel_kicks``: the n_neg kicks read the post-attraction
    snapshot and are summed instead of chained;
  * ``scatter_free=False``: the row-major path that moves both endpoints
    of an edge, duplicate targets summed by ``index_add_``;
  * ``packed_gather``: accepted; the JAX package packs the (2, n)
    coordinates into complex64 for a cheaper TPU gather with bit-equal
    values, so the port runs its one gather either way.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..graph.proba import NodeParams
from ..params import PROBA_MIN, EmbedderParams
from ..ops.dense_sweep import (dense_attraction_rows, dense_kick_rows,
                                dense_sweeps, pack_groups)
from ..utils.profiling import span
from .ce import NB_NEGATIVE, _common_coeff, embedded_scales_from_initial


def _clipped_alpha(d2s, scale, w, gamma: float, b: float):
    """Per-sample attraction fraction alpha = -coeff_ij
    (embedder.rs:1216-1239)."""
    coeff = _common_coeff(d2s, scale, b)
    rep_att = 1.0 / torch.square(d2s).clamp_min(1.0 / PROBA_MIN)
    coeff_ij = (gamma * coeff * (-w + (1.0 - w) * rep_att)).clamp_min(-0.49)
    return torch.where(d2s > 0.0, -coeff_ij, torch.zeros_like(coeff_ij))


def _pair_closure(alpha_f, alpha_r, m_eff, m_rev, f_min: float):
    """The pair's remaining gap fraction after its samples,
    (1-2a_f)^m (1-2a_r)^m_rev, floored at ``f_min``, as exp of a sum of
    logs (the form of the transposed sweep)."""
    f_pair = torch.exp(
        m_eff * torch.log(torch.clamp(1.0 - 2.0 * alpha_f, 1e-3, 1.05))
        + m_rev * torch.log(torch.clamp(1.0 - 2.0 * alpha_r, 1e-3, 1.05)))
    return f_pair.clamp_min(f_min)


def _repulsion_coeff(d2s, scale, gamma: float, b: float):
    """A kick's coefficient: capped at 2 (embedder.rs:1288), pole
    floored at 1/16."""
    coeff = _common_coeff(d2s, scale, b)
    rep = 1.0 / torch.square(d2s).clamp_min(1.0 / 16.0)
    return (gamma * coeff * rep).clamp_max(2.0)


def _attraction_sweep_sfT(yT, idxT, wT, mT, w_revT, m_revT, scale_iT,
                          scale_jT, gamma: float, b: float,
                          f_min: float = 1e-3, mask=None,
                          mask_p: float = 1.0, y_ownT=None, yjT=None):
    """Scatter-free attraction in the transposed layout: yT (d, n);
    idxT/wT/mT/w_revT/m_revT/scale_jT (kg, m), ``scale_jT`` the
    pre-gathered emb_scale[idx]; scale_iT (1, m).  ``y_ownT`` (d, m) is
    the rows' own block when it is not all of yT (node blocks); ``yjT``
    (d, kg, m) pre-gathered neighbour coordinates (the stale gather).
    Returns the (d, m) displacement of every row's own endpoint."""
    y_own = yT if y_ownT is None else y_ownT
    yj = yT[:, idxT.to(torch.int64)] if yjT is None else yjT  # (d, kg, m)
    diff = yj - y_own[:, None, :]
    d2 = torch.square(diff).sum(0)                     # (kg, m)
    alpha_f = _clipped_alpha(d2 / torch.square(scale_iT), scale_iT, wT,
                             gamma, b)
    alpha_r = _clipped_alpha(d2 / torch.square(scale_jT), scale_jT, w_revT,
                             gamma, b)
    m_eff = mT if mask is None else mT * mask * (1.0 / mask_p)
    net = torch.where(w_revT > 0.0, 0.5, 1.0) * (
        1.0 - _pair_closure(alpha_f, alpha_r, m_eff, m_revT, f_min))
    return (diff * net[None, :, :]).sum(1)             # (d, m)


def _repulsion_kick_T(yi, yk_t, scaleT, gamma: float, b: float, ok_mask,
                      nw_t):
    """One sequential repulsion kick: coeff capped at 2
    (embedder.rs:1288), pole floored at 1/16, optional hubness importance
    weight, self/neighbour rejection via ``ok_mask``."""
    d2s = torch.square(yi - yk_t).sum(0, keepdim=True) / torch.square(scaleT)
    coeff_ik = _repulsion_coeff(d2s, scaleT, gamma, b)
    if nw_t is not None:
        coeff_ik = coeff_ik * nw_t
    coeff_ik = torch.where((d2s > 0.0) & ok_mask, coeff_ik,
                           torch.zeros_like(coeff_ik))
    return yi + (yi - yk_t) * coeff_ik


def _neighbor_rejection(pos, idxT, shifts, n: int):
    """(n_neg, nb) mask: kick t of the node at position pos_i pairs it
    with (pos_i + shifts[t]) mod n; reject when that partner is one of
    its neighbours idxT[:, i] (embedder.rs:1246-1252)."""
    nid = (pos[None, :] + shifts[:, None]) % n          # (n_neg, nb)
    return (nid[:, None, :] == idxT[None, :, :]).any(1)


def _repulsion_block_T(yT_ext, y_blk, lo: int, n: int, offset: int,
                       idxT_blk_full, scale_blkT, gamma: float, b: float,
                       n_neg: int, neg_weight_ext=None,
                       neighbor_exclusion: bool = True,
                       parallel_kicks: bool = False):
    """Sequential repulsion kicks for the contiguous node block starting
    at position ``lo``: kick t pairs position p with
    (p + offset + t*(n//n_neg)) mod n, one slice of the (d, n + nb)
    wraparound-extended snapshot ``yT_ext`` per kick.  With
    ``parallel_kicks`` every kick reads the block's snapshot ``y_blk``
    instead of the running position, and the kicks are summed (the same
    partners, caps and rejection; n_neg == 1 is the sequential path)."""
    d, nb = y_blk.shape
    dev = y_blk.device
    pos = lo + torch.arange(nb, dtype=torch.int64, device=dev)
    stride = max(1, n // n_neg)
    shift_list = [(offset + stride * t) % n for t in range(n_neg)]
    shifts = torch.tensor(shift_list, dtype=torch.int64, device=dev)
    ok_all = ((pos[None, :] + shifts[:, None]) % n) != pos[None, :]
    if neighbor_exclusion:
        ok_all &= ~_neighbor_rejection(pos, idxT_blk_full.to(torch.int64),
                                       shifts, n)
    starts = [(lo + sh) % n for sh in shift_list]
    if parallel_kicks:
        yk = torch.stack([yT_ext[:, st:st + nb] for st in starts])
        yi0 = y_blk[None]                              # (1, d, nb)
        scale3 = scale_blkT[None]                      # (1, 1, nb)
        d2s = (torch.square(yi0 - yk).sum(1, keepdim=True)
               / torch.square(scale3))                 # (n_neg, 1, nb)
        c = _repulsion_coeff(d2s, scale3, gamma, b)
        if neg_weight_ext is not None:
            c = c * torch.stack([neg_weight_ext[st:st + nb]
                                 for st in starts])[:, None, :]
        c = torch.where((d2s > 0.0) & ok_all[:, None, :], c,
                        torch.zeros_like(c))
        return y_blk + ((yi0 - yk) * c).sum(0)
    yi = y_blk
    for t, start in enumerate(starts):
        yk_t = yT_ext[:, start:start + nb]
        nw_t = (None if neg_weight_ext is None
                else neg_weight_ext[start:start + nb][None, :])
        yi = _repulsion_kick_T(yi, yk_t, scale_blkT, gamma, b,
                               ok_all[t][None, :], nw_t)
    return yi


def _repulsion_sweep_rolledT(yT, offset: int, idxT, emb_scaleT,
                             gamma: float, b: float, n_neg: int,
                             neg_weight=None, neighbor_exclusion: bool = True,
                             parallel_kicks: bool = False):
    """Identity-pool repulsion over all n positions (the whole-array case
    of ``_repulsion_block_T``).  Returns the (d, n) displacement."""
    n = yT.shape[1]
    yT_ext = torch.cat([yT, yT], dim=1)
    nw_ext = (None if neg_weight is None
              else torch.cat([neg_weight, neg_weight]))
    yi = _repulsion_block_T(yT_ext, yT, 0, n, offset, idxT, emb_scaleT,
                            gamma, b, n_neg, neg_weight_ext=nw_ext,
                            neighbor_exclusion=neighbor_exclusion,
                            parallel_kicks=parallel_kicks)
    return yi - yT


def _row_pair_terms(y, indices, w, w_rev, emb_scale, gamma: float,
                    b: float):
    """Row-major (n, d) coordinates and (n, kg) edge tables: the rows
    yi (n, 1, d), their neighbours yj (n, kg, d) and each edge's clipped
    attraction fraction from its own side and from the neighbour's."""
    idx = indices.to(torch.int64)
    yi = y[:, None, :]
    yj = y[idx]
    scale_i = emb_scale[:, None]
    scale_j = emb_scale[idx]
    d2 = torch.square(yi - yj).sum(-1)                 # (n, kg)
    alpha_f = _clipped_alpha(d2 / torch.square(scale_i), scale_i, w, gamma,
                             b)
    alpha_r = _clipped_alpha(d2 / torch.square(scale_j), scale_j, w_rev,
                             gamma, b)
    return yi, yj, alpha_f, alpha_r


def _attraction_sweep(y, indices, w, m_e, w_rev, m_rev, emb_scale,
                      gamma: float, b: float, f_min: float = 1e-3,
                      mask=None, mask_p: float = 1.0):
    """Row-major attraction that moves both endpoints of every edge
    (y (n, d), edge tables (n, kg)): each directed edge applies its
    multiplicity share of the pair's net per-endpoint closure, so mutual
    pairs are not counted twice.  Returns (delta_self (n, d), delta_rev
    (n, kg, d)); the caller adds delta_rev at the neighbours' rows."""
    yi, yj, alpha_f, alpha_r = _row_pair_terms(y, indices, w, w_rev,
                                               emb_scale, gamma, b)
    m_eff = m_e if mask is None else m_e * mask * (1.0 / mask_p)
    f_pair = (torch.pow(torch.clamp(1.0 - 2.0 * alpha_f, 1e-3, 1.05), m_eff)
              * torch.pow(torch.clamp(1.0 - 2.0 * alpha_r, 1e-3, 1.05),
                          m_rev)).clamp_min(f_min)
    share = m_e / (m_e + m_rev).clamp_min(1e-30)
    step_vec = (yj - yi) * (share * (1.0 - f_pair) * 0.5)[:, :, None]
    return step_vec.sum(1), -step_vec


def _attraction_sweep_scatter_free(y, indices, w, m_e, w_rev, m_rev,
                                   emb_scale, gamma: float, b: float,
                                   f_min: float = 1e-3, mask=None,
                                   mask_p: float = 1.0):
    """Row-major form of ``_attraction_sweep_sfT`` (each row moves only
    its own endpoint); the JAX package keeps it to pin the transposed
    form.  Returns delta_self (n, d)."""
    yi, yj, alpha_f, alpha_r = _row_pair_terms(y, indices, w, w_rev,
                                               emb_scale, gamma, b)
    m_eff = m_e if mask is None else m_e * mask * (1.0 / mask_p)
    net = torch.where(w_rev > 0.0, 0.5, 1.0) * (
        1.0 - _pair_closure(alpha_f, alpha_r, m_eff, m_rev, f_min))
    return ((yj - yi) * net[:, :, None]).sum(1)


def _repulsion_sweep(y, y_pool, pool_offset: int, indices, emb_scale,
                     gamma: float, b: float, ids_pool, n_neg: int):
    """Row-major repulsion with every kick taken at the original
    position and summed, from the permuted pool ``y_pool`` = y[perm],
    ``ids_pool`` = perm: node i's negatives are pool positions
    (i*n_neg + t + offset) mod n.  The JAX package keeps it as a
    reference form.  Returns the (n, d) displacement."""
    n, d = y.shape
    dev = y.device
    pos = (torch.arange(n * n_neg, device=dev) + pool_offset) % n
    neg_ids = ids_pool.to(torch.int64)[pos].reshape(n, n_neg)
    yk = y_pool[pos].reshape(n, n_neg, d)
    reject = neg_ids == torch.arange(n, device=dev)[:, None]
    reject |= (neg_ids[:, :, None]
               == indices.to(torch.int64)[:, None, :]).any(-1)
    yi = y[:, None, :]
    scale = emb_scale[:, None]
    d2s = torch.square(yi - yk).sum(-1) / torch.square(scale)
    coeff = _repulsion_coeff(d2s, scale, gamma, b)
    coeff = torch.where((d2s > 0.0) & ~reject, coeff, torch.zeros_like(coeff))
    return ((yi - yk) * coeff[:, :, None]).sum(1)


def _repulsion_sweep_rolled(y, offset: int, indices, emb_scale, gamma: float,
                            b: float, n_neg: int, neg_weight=None):
    """Row-major identity-pool repulsion (the scatter path's): node i
    takes positions (i*n_neg + t + offset*n_neg) mod n of the current y
    as negatives, kicks sequential.  Returns the (n, d) displacement."""
    n, d = y.shape
    dev = y.device
    shift = offset * n_neg
    yk = torch.roll(y, -shift, 0).repeat(n_neg, 1).reshape(n, n_neg, d)
    row = torch.arange(n, device=dev)[:, None]
    neg_ids = (row * n_neg + torch.arange(n_neg, device=dev)[None, :]
               + shift) % n
    reject = neg_ids == row
    reject |= (neg_ids[:, :, None]
               == indices.to(torch.int64)[:, None, :]).any(-1)
    nw = None
    if neg_weight is not None:
        nw = torch.roll(neg_weight, -shift, 0).repeat(n_neg).reshape(n, n_neg)
    scale = emb_scale[:, None]
    yi = y
    for t in range(n_neg):
        yk_t = yk[:, t, :]
        d2s = torch.square(yi - yk_t).sum(-1, keepdim=True) / torch.square(
            scale)
        coeff = _repulsion_coeff(d2s, scale, gamma, b)
        if nw is not None:
            coeff = coeff * nw[:, t:t + 1]
        ok = (d2s > 0.0) & ~reject[:, t:t + 1]
        yi = yi + (yi - yk_t) * torch.where(ok, coeff, torch.zeros_like(coeff))
    return yi - y


def _block_bounds(n: int, n_blocks: int):
    """Contiguous near-equal node blocks [lo, hi)."""
    return [(b * n // n_blocks, (b + 1) * n // n_blocks)
            for b in range(n_blocks)]


def reverse_edge_info(indices: torch.Tensor, w: torch.Tensor):
    """w_rev[i, l] = w[j -> i] for j = indices[i, l] (0 if j does not
    list i), one source column at a time over (k, n) slices."""
    n, k = indices.shape
    idx = indices.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=idx.device)
    idxT = idx.T
    wT = w.T
    cols = []
    for c in range(k):
        j_c = idx[:, c]
        hit = idxT[:, j_c] == pos[None, :]             # (k, n)
        cols.append(torch.where(hit, wT[:, j_c], torch.zeros_like(wT)).sum(0))
    return torch.stack(cols, dim=1)


def _gamma(grad_step_init: float, batch_idx: int, nb_grad_batch: int):
    """gamma_0 (1 - batch/nb_grad_batch), floored at 0, in f32
    arithmetic as the JAX package computes it."""
    f32 = np.float32
    g = f32(grad_step_init) * (f32(1.0) - f32(batch_idx) / f32(nb_grad_batch))
    return float(max(g, f32(0.0)))


#: the JAX package's cap on sweeps per device program: a segment of the
#: sweep loop holds at most this many sweeps at 70,000 nodes, inversely
#: fewer above.  The port runs no device program, but a stale gather
#: restarts at each segment's start, so the segments keep its sizes.
_MAX_SWEEPS_PER_PROGRAM = 2048
_SWEEP_REFERENCE_N = 70_000


def _segment_cap(n: int, n_groups: int) -> int:
    cap = (_MAX_SWEEPS_PER_PROGRAM * _SWEEP_REFERENCE_N
           // max(n, _SWEEP_REFERENCE_N))
    return max(cap, n_groups)


def _segments(total_steps: int, n: int, n_groups: int, n_blocks: int,
              n_sub: int, nb_grad_batch: int, batch0: int,
              gather_reuse: int, gather_reuse_after: float):
    """(first step, steps, S) of each segment of the JAX package's
    ``dense_optimize`` for a phase of ``total_steps`` sweeps from batch
    ``batch0``: sweeps of the first ``gather_reuse_after`` of the global
    schedule run fresh (S = 1), later ones at S = ``gather_reuse``;
    segment sizes are the program cap, S-aligned, the last segment of a
    range shorter."""
    act = 0
    if gather_reuse > 1 and gather_reuse_after > 0.0:
        boundary = int(gather_reuse_after * nb_grad_batch)
        act = min(max((boundary - batch0) * n_sub, 0), total_steps)
    cap = min(total_steps, _segment_cap(max(n // n_blocks, 1), n_groups))
    ranges = ([(0, total_steps, gather_reuse)] if act == 0 else
              [(0, act, 1), (act, total_steps, gather_reuse)])
    segments = []
    for lo, hi, s_r in ranges:
        seg = cap
        if s_r > 1 and seg > s_r:
            seg -= seg % s_r
        for pos in range(lo, hi, seg):
            segments.append((pos, min(seg, hi - pos), s_r))
    return segments


def dense_optimize(y0, indices, w, m_visit, w_rev, m_rev_visit, emb_scale,
                   neg_weight, grad_step_init: float, b: float, n_sub: int,
                   n_neg: int, nb_grad_batch: int, n_groups: int = 1,
                   scatter_free: bool = True, f_min: float = 1e-3,
                   mask_p: float = 1.0, batch0: int = 0,
                   batch1: Optional[int] = None,
                   rot_base: Optional[int] = None, n_blocks: int = 1,
                   neighbor_exclusion: bool = True,
                   parallel_kicks: bool = False, gather_reuse: int = 1,
                   gather_reuse_after: float = 0.0,
                   offsets: Optional[Sequence[int]] = None,
                   generator: Optional[torch.Generator] = None):
    """Run batches [batch0, batch1) of the global nb_grad_batch schedule
    at this n_sub; column group ``c`` of the (n, k) edge table is swept
    every n_groups-th sub-sweep (with ``n_blocks`` > 1, one node block of
    it, blocks fastest).  ``offsets`` (one per executed sweep) or
    ``generator`` give the repulsion pool offsets.  Sweeps whose global
    batch lies past ``gather_reuse_after`` of the schedule read their
    neighbours from one snapshot per ``gather_reuse`` sweeps.  Returns the
    updated (n, d) coordinates (relabeled order)."""
    if batch1 is None:
        batch1 = nb_grad_batch
    # the reference's final batch runs at gamma = 0 (embedder.rs:873-876),
    # a no-op for both sweeps: keep the schedule, skip those sweeps
    eff_batches = max(min(batch1, nb_grad_batch - 1) - batch0, 0)
    total_steps = eff_batches * n_sub
    if total_steps == 0:
        return y0
    n, k = indices.shape
    if k % n_groups:
        raise ValueError(f"k={k} must be divisible by n_groups={n_groups}")
    gather_reuse = max(int(gather_reuse), 1)
    if gather_reuse > 1 and (not scatter_free or n_blocks > 1):
        raise ValueError("gather_reuse > 1 requires the transposed "
                         "scatter-free path with n_blocks=1")
    if n_blocks > 1 and not scatter_free:
        raise ValueError("n_blocks > 1 requires the transposed path")
    kg = k // n_groups
    if offsets is None:
        if generator is None:
            raise ValueError("pass offsets or a generator")
        offsets = torch.randint(0, n, (total_steps,),
                                generator=generator).tolist()
    elif len(offsets) != total_steps:
        raise ValueError(f"{len(offsets)} offsets for {total_steps} sweeps")
    dev = y0.device

    def gamma_of(s):
        return _gamma(grad_step_init, batch0 + s // n_sub + 1, nb_grad_batch)

    def rot_of(s, period):
        return ((rot_base or 0) + s) % period

    def mask_of(shape):
        if mask_p >= 1.0:
            return None
        return (torch.rand(shape, generator=generator) < mask_p).to(
            device=dev, dtype=torch.float32)

    if not scatter_free:
        return _row_major_sweeps(
            y0, indices.to(torch.int64), w, m_visit, w_rev, m_rev_visit,
            emb_scale, neg_weight, b, n_neg, n_groups, f_min, mask_p,
            total_steps, offsets, gamma_of, rot_of, mask_of)

    # the kernel's layout, built once: y row-major (n, d), one packed edge
    # record a row per column group (n_groups, n, words), the neighbour
    # ids (k, n) in int32
    idx32 = indices.to(torch.int32)
    scale = emb_scale.to(torch.float32).contiguous()
    nw = (None if neg_weight is None
          else neg_weight.to(torch.float32).contiguous())
    edges = pack_groups(idx32, w, m_visit, w_rev, m_rev_visit, scale,
                        n_groups)
    kick = dict(neg_weight=nw, neighbor_exclusion=neighbor_exclusion,
                parallel_kicks=parallel_kicks)

    def sweep(y, s, lo, rows, idx_full, y_src=None, flat=False):
        # the attraction of rows [lo, lo + rows), then their kicks
        # against the post-attraction snapshot, written back into y
        gamma = gamma_of(s)
        a = dense_attraction_rows(
            y, y if y_src is None else y_src, lo,
            edges[rot_of(s, n_groups * n_blocks) // n_blocks, lo:lo + rows],
            scale, gamma, b, f_min=f_min, mask=mask_of((kg, rows)),
            mask_p=mask_p)
        dense_kick_rows(y, a, lo, int(offsets[s]), idx_full, scale, gamma, b,
                        n_neg, flat=flat, out=y[lo:lo + rows], **kick)

    y = y0.to(torch.float32).contiguous().clone()
    plan = launch_plan(total_steps, n, n_groups, n_blocks, n_sub,
                       nb_grad_batch, batch0, gather_reuse,
                       gather_reuse_after, mask_p)
    if n_blocks > 1:
        blocks = [(lo, hi - lo, idx32[lo:hi].T.contiguous())
                  for lo, hi in _block_bounds(n, n_blocks)]
        for s in range(total_steps):
            sweep(y, s, *blocks[rot_of(s, n_groups * n_blocks) % n_blocks])
        return y

    idx_full = idx32.T.contiguous()                    # (k, n)
    if plan["route"] == "persistent":
        # each run's gamma, pool offset and column group, on the device
        gammas = torch.tensor([gamma_of(s) for s in range(total_steps)],
                              dtype=torch.float32, device=dev)
        offs = torch.tensor([int(o) % n for o in offsets], dtype=torch.int64,
                            device=dev)
        grps = torch.tensor([rot_of(s, n_groups) for s in range(total_steps)],
                            dtype=torch.int32, device=dev)
    for first, count, stale in plan["runs"]:
        # the stale gather: the neighbours of a run are read from a
        # snapshot taken at its first sweep, the column-group rotation
        # unchanged; runs restart at each segment
        snap = y.clone() if stale else None
        if plan["route"] == "persistent":
            run = slice(first, first + count)
            dense_sweeps(y, snap, edges, scale, gammas[run], offs[run],
                         grps[run], b, n_neg, idx_full, f_min=f_min, **kick)
            continue
        for s in range(first, first + count):
            sweep(y, s, 0, n, idx_full, y_src=snap, flat=True)
    return y


def launch_plan(total_steps: int, n: int, n_groups: int, n_blocks: int,
                n_sub: int, nb_grad_batch: int, batch0: int,
                gather_reuse: int, gather_reuse_after: float,
                mask_p: float) -> dict:
    """How the scatter-free path of ``dense_optimize`` runs its sweeps on
    the card: ``route`` "persistent" (whole-array sweeps, one
    ``dense_sweeps`` launch a run) or "pair" (node blocks, or the
    per-sweep edge masks of ``mask_p`` < 1, drawn on the host: two
    launches a sweep); ``runs`` the (first sweep, sweeps, stale) of
    ``_segments``: with S > 1 one run a stale-gather block, which reads
    its neighbours from a snapshot of its first sweep, else one run a
    segment."""
    gather_reuse = max(int(gather_reuse), 1)
    runs = []
    if n_blocks > 1:
        runs.append((0, total_steps, False))
    else:
        for pos, seg_steps, s_r in _segments(
                total_steps, n, n_groups, n_blocks, n_sub, nb_grad_batch,
                batch0, gather_reuse, gather_reuse_after):
            if s_r == 1:
                runs.append((pos, seg_steps, False))
                continue
            for first in range(pos, pos + seg_steps, s_r):
                runs.append((first, min(s_r, pos + seg_steps - first),
                             True))
    route = "pair" if n_blocks > 1 or mask_p < 1.0 else "persistent"
    return dict(route=route, runs=runs)


def _row_major_sweeps(y0, idx64, w, m_visit, w_rev, m_rev_visit, emb_scale,
                      neg_weight, b: float, n_neg: int, n_groups: int,
                      f_min: float, mask_p: float, total_steps: int, offsets,
                      gamma_of, rot_of, mask_of):
    """``scatter_free=False``: attraction on both endpoints of every edge
    of the sweep's column group, the neighbours' share summed into their
    rows by ``index_add_``, then the row-major identity-pool kicks."""
    n, k = idx64.shape
    kg = k // n_groups
    groups = []
    for c in range(n_groups):
        sl = slice(c * kg, (c + 1) * kg)
        groups.append(dict(idx=idx64[:, sl].contiguous(), w=w[:, sl],
                           m=m_visit[:, sl], w_rev=w_rev[:, sl],
                           m_rev=m_rev_visit[:, sl]))
    y = y0.to(torch.float32)
    for s in range(total_steps):
        gamma = gamma_of(s)
        gd = groups[rot_of(s, n_groups)]
        d_self, d_rev = _attraction_sweep(
            y, gd["idx"], gd["w"], gd["m"], gd["w_rev"], gd["m_rev"],
            emb_scale, gamma, b, f_min=f_min, mask=mask_of((n, kg)),
            mask_p=mask_p)
        rev_sum = torch.zeros_like(y).index_add_(
            0, gd["idx"].reshape(-1), d_rev.reshape(-1, y.shape[1]))
        y = y + d_self + rev_sum
        y = y + _repulsion_sweep_rolled(y, int(offsets[s]), idx64, emb_scale,
                                        gamma, b, n_neg,
                                        neg_weight=neg_weight)
    return y


def _auto_groups(k: int) -> int:
    # 2 column groups measured best on the transposed sweep; 3+ slice
    # the edge table too thin per sync step
    for g in (2, 3, 4):
        if k % g == 0 and k // g >= 2:
            return g
    return 1


def prepare_dense_inputs(y0, g: KGraph, npar: NodeParams,
                         params: EmbedderParams, n_sub: int, n_groups: int,
                         neg_weights=None, relabel=None,
                         generator: Optional[torch.Generator] = None):
    """Relabel-once prologue: one global random permutation (uniform
    rolled-pool negatives even on class-sorted input), per-visit
    multiplicities, reverse-edge weights, clamped hubness importance
    weights.  ``relabel`` (position -> old id) may be given; otherwise it
    is drawn from ``generator``.

    Returns (y0_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale,
    neg_weight, n_neg, inv); ``inv`` maps old ids to positions."""
    n, k = g.indices.shape
    dev = g.indices.device
    if relabel is None:
        with span("rng.relabel"):
            relabel = torch.randperm(n, generator=generator)
    relabel = torch.tensor(np.asarray(relabel), dtype=torch.int64, device=dev)
    inv = torch.argsort(relabel)
    indices_r = inv[g.indices.to(torch.int64)[relabel]].to(torch.int32)
    w = npar.probas.to(torch.float32)[relabel]
    emb_scale = embedded_scales_from_initial(npar.scale)[relabel]
    y0_r = y0.to(torch.float32)[relabel]
    # expected samples of an edge per visit (a group is visited every
    # n_groups-th sweep, n_sub / n_groups visits per batch)
    m_visit = params.nb_sampling_by_edge * k * w * n_groups / n_sub
    w_rev = reverse_edge_info(indices_r, w)
    m_rev_visit = params.nb_sampling_by_edge * k * w_rev * n_groups / n_sub
    n_neg = max(1, round(NB_NEGATIVE * params.nb_sampling_by_edge * k / n_sub))
    neg_weight = None
    if neg_weights is not None:
        nw = neg_weights.to(torch.float32)[relabel]
        neg_weight = torch.clamp(nw / nw.mean().clamp_min(1e-30), 0.25, 4.0)
    return (y0_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale,
            neg_weight, n_neg, inv)


def run_dense_optimization(y0, g: KGraph, npar: NodeParams,
                           params: EmbedderParams, n_sub: int = 60,
                           n_groups: int = 0, neg_weights=None,
                           relabel=None,
                           offsets: Optional[Sequence[int]] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, dict]:
    """Driver with the reference's parameter semantics.

    Nodes are relabeled by one global permutation and the output comes
    back in the original order.  ``params.n_sub_schedule`` (phases of
    (n_batches, n_sub) summing to nb_grad_batch) runs the same global
    gamma decay at a different sub-sweep granularity per phase.
    ``params.dense_n_blocks`` > 1 splits every sub-sweep into node
    blocks: multiplicities and negatives per sweep scale by n_blocks.
    ``relabel`` and ``offsets`` (all executed sweeps, in order) may be
    given; otherwise both come from ``generator`` (default: seeded with
    ``params.seed``)."""
    n, k = g.indices.shape
    if n_groups <= 0:
        n_groups = _auto_groups(k)
    n_blocks = max(int(params.dense_n_blocks), 1)
    if n_blocks > 1 and not params.dense_scatter_free:
        raise ValueError("dense_n_blocks > 1 requires the transposed "
                         "scatter-free path (dense_scatter_free=True)")
    if generator is None:
        generator = torch.Generator().manual_seed(params.seed)
    schedule = params.n_sub_schedule
    if not schedule:
        schedule = ((int(params.nb_grad_batch), n_sub),)
    else:
        schedule = tuple((int(nb), int(s)) for nb, s in schedule)
        if sum(nb for nb, _ in schedule) != int(params.nb_grad_batch):
            raise ValueError(
                f"n_sub_schedule batches {schedule} must sum to "
                f"nb_grad_batch={params.nb_grad_batch}")
    # equal per-batch (group, block) coverage
    if n_blocks > 1:
        for _, s_p in schedule:
            if s_p % (n_groups * n_blocks) != 0:
                raise ValueError(
                    f"n_sub={s_p} must be divisible by n_groups*"
                    f"n_blocks={n_groups}*{n_blocks} for equal edge "
                    f"coverage")
    gather_reuse = max(int(params.dense_gather_reuse), 1)
    with span("relabel"):
        (y_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale,
         neg_weight, n_neg, inv) = prepare_dense_inputs(
            y0, g, npar, params, schedule[0][1], n_groups, neg_weights,
            relabel=relabel, generator=generator)
    nb_total = int(params.nb_grad_batch)
    batch_cursor, sweeps = 0, 0
    for nb_p, s_p in schedule:
        # multiplicities and negatives per sweep scale as 1/n_sub and as
        # n_blocks (each node is in 1/n_blocks of the sweeps)
        scale_m = schedule[0][1] * n_blocks / s_p
        n_neg_p = max(1, round(NB_NEGATIVE * params.nb_sampling_by_edge
                               * k * n_blocks / s_p))
        executed = max(min(batch_cursor + nb_p, nb_total - 1)
                       - batch_cursor, 0) * s_p
        y_r = dense_optimize(
            y_r, indices_r, w, m_visit * scale_m, w_rev,
            m_rev_visit * scale_m, emb_scale, neg_weight,
            grad_step_init=float(params.grad_step), b=float(params.b),
            n_sub=s_p, n_neg=n_neg_p, nb_grad_batch=nb_total,
            n_groups=n_groups, scatter_free=params.dense_scatter_free,
            f_min=float(params.dense_f_min),
            mask_p=float(params.dense_mask_p), batch0=batch_cursor,
            batch1=batch_cursor + nb_p,
            rot_base=sweeps if len(schedule) > 1 else None,
            n_blocks=n_blocks,
            neighbor_exclusion=bool(params.dense_neighbor_exclusion),
            parallel_kicks=bool(params.dense_parallel_kicks),
            gather_reuse=gather_reuse,
            gather_reuse_after=float(params.dense_gather_reuse_after),
            offsets=(None if offsets is None
                     else offsets[sweeps:sweeps + executed]),
            generator=generator)
        sweeps += executed
        batch_cursor += nb_p
    if offsets is not None and len(offsets) != sweeps:
        raise ValueError(f"{len(offsets)} offsets for {sweeps} sweeps")
    info = {"optimizer": "dense", "n_sub": n_sub, "n_neg": n_neg,
            "n_groups": n_groups, "f_min": float(params.dense_f_min),
            "mask_p": float(params.dense_mask_p), "sweeps": sweeps}
    if n_blocks > 1:
        info["n_blocks"] = n_blocks
    if len(schedule) > 1:
        info["n_sub_schedule"] = schedule
    if params.dense_parallel_kicks:
        info["parallel_kicks"] = 1
    if gather_reuse > 1:
        info["gather_reuse"] = gather_reuse
    return y_r[inv], info
