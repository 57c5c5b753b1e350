"""Dense-sweep CE optimizer, production path.

Port of the transposed scatter-free path of annembed_tpu/optim/dense.py
(see its module docstring for the derivation).  In short, per sub-sweep:

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

Layout: coordinates are (d, n) and edge tables (kg, n), as in the JAX
package, so the two can be compared array for array.  The relabel
permutation and the per-sweep offsets come from a ``torch.Generator``,
or are passed in (tests feed the JAX package's draws).

Not ported yet (ROADMAP): the stale-gather and node-block branches, the
row-major scatter path, stacked (parallel) kicks and the packed gather.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..graph.proba import NodeParams
from ..params import PROBA_MIN, EmbedderParams
from .ce import NB_NEGATIVE, _common_coeff, embedded_scales_from_initial


def _clipped_alpha(d2s, scale, w, gamma: float, b: float):
    """Per-sample attraction fraction alpha = -coeff_ij
    (embedder.rs:1216-1239)."""
    coeff = _common_coeff(d2s, scale, b)
    rep_att = 1.0 / torch.square(d2s).clamp_min(1.0 / PROBA_MIN)
    coeff_ij = (gamma * coeff * (-w + (1.0 - w) * rep_att)).clamp_min(-0.49)
    return torch.where(d2s > 0.0, -coeff_ij, torch.zeros_like(coeff_ij))


def _attraction_sweep_sfT(yT, idxT, wT, mT, w_revT, m_revT, scale_iT,
                          scale_jT, gamma: float, b: float,
                          f_min: float = 1e-3, mask=None,
                          mask_p: float = 1.0):
    """Scatter-free attraction in the transposed layout: yT (d, n);
    idxT/wT/mT/w_revT/m_revT/scale_jT (kg, n), ``scale_jT`` the
    pre-gathered emb_scale[idx]; scale_iT (1, n).  Returns the (d, n)
    displacement of every row's own endpoint."""
    yj = yT[:, idxT.to(torch.int64)]                   # (d, kg, n)
    diff = yj - yT[:, None, :]
    d2 = torch.square(diff).sum(0)                     # (kg, n)
    alpha_f = _clipped_alpha(d2 / torch.square(scale_iT), scale_iT, wT,
                             gamma, b)
    alpha_r = _clipped_alpha(d2 / torch.square(scale_jT), scale_jT, w_revT,
                             gamma, b)
    m_eff = mT if mask is None else mT * mask * (1.0 / mask_p)
    f_pair = torch.exp(
        m_eff * torch.log(torch.clamp(1.0 - 2.0 * alpha_f, 1e-3, 1.05))
        + m_revT * torch.log(torch.clamp(1.0 - 2.0 * alpha_r, 1e-3, 1.05)))
    f_pair = f_pair.clamp_min(f_min)
    c = torch.where(w_revT > 0.0, 0.5, 1.0)
    net = c * (1.0 - f_pair)                           # (kg, n)
    return (diff * net[None, :, :]).sum(1)             # (d, n)


def _repulsion_kick_T(yi, yk_t, scaleT, gamma: float, b: float, ok_mask,
                      nw_t):
    """One sequential repulsion kick: coeff capped at 2
    (embedder.rs:1288), pole floored at 1/16, optional hubness importance
    weight, self/neighbour rejection via ``ok_mask``."""
    d2s = torch.square(yi - yk_t).sum(0, keepdim=True) / torch.square(scaleT)
    coeff = _common_coeff(d2s, scaleT, b)
    rep = 1.0 / torch.square(d2s).clamp_min(1.0 / 16.0)
    coeff_ik = (gamma * coeff * rep).clamp_max(2.0)
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
                       neighbor_exclusion: bool = True):
    """Sequential repulsion kicks for the contiguous node block starting
    at position ``lo``: kick t pairs position p with
    (p + offset + t*(n//n_neg)) mod n, one slice of the (d, n + nb)
    wraparound-extended snapshot ``yT_ext`` per kick."""
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
    yi = y_blk
    for t in range(n_neg):
        start = (lo + shift_list[t]) % n
        yk_t = yT_ext[:, start:start + nb]
        nw_t = (None if neg_weight_ext is None
                else neg_weight_ext[start:start + nb][None, :])
        yi = _repulsion_kick_T(yi, yk_t, scale_blkT, gamma, b,
                               ok_all[t][None, :], nw_t)
    return yi


def _repulsion_sweep_rolledT(yT, offset: int, idxT, emb_scaleT,
                             gamma: float, b: float, n_neg: int,
                             neg_weight=None, neighbor_exclusion: bool = True):
    """Identity-pool repulsion over all n positions (the whole-array case
    of ``_repulsion_block_T``).  Returns the (d, n) displacement."""
    n = yT.shape[1]
    yT_ext = torch.cat([yT, yT], dim=1)
    nw_ext = (None if neg_weight is None
              else torch.cat([neg_weight, neg_weight]))
    yi = _repulsion_block_T(yT_ext, yT, 0, n, offset, idxT, emb_scaleT,
                            gamma, b, n_neg, neg_weight_ext=nw_ext,
                            neighbor_exclusion=neighbor_exclusion)
    return yi - yT


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


def dense_optimize(y0, indices, w, m_visit, w_rev, m_rev_visit, emb_scale,
                   neg_weight, grad_step_init: float, b: float, n_sub: int,
                   n_neg: int, nb_grad_batch: int, n_groups: int = 1,
                   f_min: float = 1e-3, mask_p: float = 1.0, batch0: int = 0,
                   batch1: Optional[int] = None,
                   rot_base: Optional[int] = None,
                   neighbor_exclusion: bool = True,
                   offsets: Optional[Sequence[int]] = None,
                   generator: Optional[torch.Generator] = None):
    """Run batches [batch0, batch1) of the global nb_grad_batch schedule
    at this n_sub; column group ``c`` of the (n, k) edge table is swept
    every n_groups-th sub-sweep.  ``offsets`` (one per executed sweep)
    or ``generator`` give the repulsion pool offsets.  Returns the
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
    kg = k // n_groups
    if offsets is None:
        if generator is None:
            raise ValueError("pass offsets or a generator")
        offsets = torch.randint(0, n, (total_steps,),
                                generator=generator).tolist()
    elif len(offsets) != total_steps:
        raise ValueError(f"{len(offsets)} offsets for {total_steps} sweeps")
    idx64 = indices.to(torch.int64)
    idxT_full = idx64.T.contiguous()                   # (k, n)
    scale_iT = emb_scale[None, :]
    groups = []
    for c in range(n_groups):
        sl = slice(c * kg, (c + 1) * kg)
        groups.append(dict(
            idxT=idx64[:, sl].T.contiguous(), wT=w[:, sl].T.contiguous(),
            mT=m_visit[:, sl].T.contiguous(),
            w_revT=w_rev[:, sl].T.contiguous(),
            m_revT=m_rev_visit[:, sl].T.contiguous(),
            scale_jT=emb_scale[idx64[:, sl]].T.contiguous()))

    yT = y0.to(torch.float32).T.contiguous()
    for s in range(total_steps):
        gamma = _gamma(grad_step_init, batch0 + s // n_sub + 1, nb_grad_batch)
        gd = groups[((rot_base or 0) + s) % n_groups]
        mask = None
        if mask_p < 1.0:
            mask = (torch.rand((kg, n), generator=generator) < mask_p
                    ).to(device=yT.device, dtype=torch.float32)
        yT = yT + _attraction_sweep_sfT(
            yT, gd["idxT"], gd["wT"], gd["mT"], gd["w_revT"], gd["m_revT"],
            scale_iT, gd["scale_jT"], gamma, b, f_min=f_min, mask=mask,
            mask_p=mask_p)
        yT = yT + _repulsion_sweep_rolledT(
            yT, int(offsets[s]), idxT_full, scale_iT, gamma, b, n_neg,
            neg_weight=neg_weight, neighbor_exclusion=neighbor_exclusion)
    return yT.T.contiguous()


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


def check_dense_params(params: EmbedderParams) -> None:
    """Raise on the dense knobs the port does not support yet."""
    unsupported = {
        "dense_gather_reuse": params.dense_gather_reuse > 1,
        "dense_n_blocks": params.dense_n_blocks > 1,
        "dense_scatter_free=False": not params.dense_scatter_free,
        "dense_parallel_kicks": params.dense_parallel_kicks,
        "dense_packed_gather": params.dense_packed_gather,
    }
    for name, hit in unsupported.items():
        if hit:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP: the remaining dense "
                "knobs)")


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
    ``relabel`` and ``offsets`` (all executed sweeps, in order) may be
    given; otherwise both come from ``generator`` (default: seeded with
    ``params.seed``)."""
    check_dense_params(params)
    n, k = g.indices.shape
    if n_groups <= 0:
        n_groups = _auto_groups(k)
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
    (y_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale, neg_weight,
     n_neg, inv) = prepare_dense_inputs(y0, g, npar, params, schedule[0][1],
                                        n_groups, neg_weights,
                                        relabel=relabel, generator=generator)
    nb_total = int(params.nb_grad_batch)
    batch_cursor, sweeps = 0, 0
    for nb_p, s_p in schedule:
        # multiplicities and negatives per sweep scale as 1/n_sub
        scale_m = schedule[0][1] / s_p
        n_neg_p = max(1, round(NB_NEGATIVE * params.nb_sampling_by_edge
                               * k / s_p))
        executed = max(min(batch_cursor + nb_p, nb_total - 1)
                       - batch_cursor, 0) * s_p
        y_r = dense_optimize(
            y_r, indices_r, w, m_visit * scale_m, w_rev,
            m_rev_visit * scale_m, emb_scale, neg_weight,
            grad_step_init=float(params.grad_step), b=float(params.b),
            n_sub=s_p, n_neg=n_neg_p, nb_grad_batch=nb_total,
            n_groups=n_groups, f_min=float(params.dense_f_min),
            mask_p=float(params.dense_mask_p), batch0=batch_cursor,
            batch1=batch_cursor + nb_p,
            rot_base=sweeps if len(schedule) > 1 else None,
            neighbor_exclusion=bool(params.dense_neighbor_exclusion),
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
    if len(schedule) > 1:
        info["n_sub_schedule"] = schedule
    return y_r[inv], info
