"""IVF (inverted-file) approximate kNN for large n: the graph build above
``KnnParams.brute_force_limit`` (port of annembed_tpu/knn/ivf.py).

Strategy (cell-blocked local join):
  1. a coarse quantizer with ``nlist`` cells: Lloyd k-means (any d), or
     the strip-balanced grid (d == 2);
  2. every cell's points are split into *virtual query rows* of at most
     ``qcap`` points; each cell offers its first ``cap`` points (in
     stable cell order) as candidates;
  3. a virtual row's points are queried against the candidates of the
     ``nprobe`` cells probed from its own cell, in probe order and then
     position in the cell: one distance panel, one top-k (ties to the
     lower position), and for DistL2 an exact rerank of the selected k.

The JAX package gives every panel the static shape (qcap, nprobe * cap)
and masks what is not there.  Here a virtual row's candidates are the
exact ragged windows laid end to end, rows of similar width are batched
into one (rows, qcap, width) panel within a byte budget, and what
padding is left is masked; the order of the valid candidates, and so
every result, is the same.  ``layout="sorted"`` reorders the corpus by
cell once, so queries and candidate windows are ranges of positions;
``layout="gathered"`` reads them through id tables.  Both give the same
bits.  On a CUDA tensor the sorted layout's DistL2 join is one launch of
a hand-written kernel of ops/ivf_join.py (the tensor-core one or the
SIMT one, by d and k), which writes no panel and
agrees with the torch join outside near-ties (``join_route``).

Tables are int32 in memory (n k and every position fit); they are
widened where torch wants an int64 index.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch

from ..ops.ivf_join import ivf_join, join_route
from ..utils.profiling import PhaseTimer, count, span
from .brute import _topk_lowest_index, check_knobs
from .distances import (PANEL_BYTES, USES_SQNORM, check_distance,
                        corpus_sqnorm, get_panel_fn, l2_pair, l2_panel)
from .kmeans import assign_to_centroids, kmeans_fit

logger = logging.getLogger(__name__)

#: the registry counter of the candidate distances the IVF plans call for
PAIRS = "knn.ivf.pairs"


def ivf_sizing(n: int, k: int, nlist: int = 0):
    """IVF table sizing, the one place the heuristics live:
      * nlist: 4 sqrt(n) keeps cells small so the local join stays cheap
        (NN-descent recovers the recall finer cells lose);
      * cap: candidates capped at 4x the average cell size;
      * qcap: query rows bounded separately (memory only, not recall).
    Returns (nlist, cap, qcap)."""
    if nlist <= 0:
        nlist = max(64, int(4 * math.sqrt(n)))
    cap = max(k + 1, int(4 * n / nlist) + 1)
    qcap = min(cap, max(k + 1, 1024))
    return nlist, cap, qcap


def build_ivf_tables(cells: np.ndarray, nlist: int, n: int, cap: int):
    """Host (numpy) query rows + candidate table with bounded shapes:
    every cell's members are split into virtual query rows of at most
    ``cap`` points, and the candidate table keeps the first ``cap``
    members per cell.  Returns (virt_table (V, cap), virt_parent (V,),
    cand_table (nlist, cap)), padded with n."""
    counts = np.bincount(cells, minlength=nlist)
    order = np.argsort(cells, kind="stable")
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    cand_table = np.full((nlist, cap), n, dtype=np.int32)
    sorted_cells = cells[order]
    pos = np.arange(len(cells)) - starts[sorted_cells]
    keep = pos < cap
    cand_table[sorted_cells[keep], pos[keep]] = order[keep]

    n_virt_per_cell = np.maximum(1, -(-counts // cap))
    virt_parent = np.repeat(np.arange(nlist, dtype=np.int32),
                            n_virt_per_cell)
    v_total = int(n_virt_per_cell.sum())
    virt_table = np.full((v_total, cap), n, dtype=np.int32)
    virt_starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(n_virt_per_cell, out=virt_starts[1:])
    virt_row = virt_starts[sorted_cells] + pos // cap
    virt_col = pos % cap
    virt_table[virt_row, virt_col] = order
    return virt_table, virt_parent, cand_table


def _cell_layout(cells: torch.Tensor, nlist: int, qcap: int):
    """Stable cell order and the virtual-row split shared by both
    layouts: (order (n,) sorted position -> id, counts (nlist,), starts
    (nlist,), nvirt (nlist,) rows per cell, vstarts (nlist,) first row
    of each cell), all int64."""
    counts = torch.bincount(cells, minlength=nlist)
    order = torch.argsort(cells, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    nvirt = torch.div(counts + (qcap - 1), qcap,
                      rounding_mode="floor").clamp_min(1)
    vstarts = torch.cumsum(nvirt, 0) - nvirt
    return order, counts, starts, nvirt, vstarts


def _ivf_tables_impl(cells: torch.Tensor, nlist: int, cap: int, qcap: int):
    """Device tables of the gathered layout: (virt_table (V, qcap) int32
    member ids per virtual row, virt_parent (V,) int32, cand_table
    (nlist, cap) int32 first ``cap`` members per cell, V), padded with n.
    V is the exact row count (one readback); the JAX package allocates
    ``nlist + n // qcap`` rows and leaves the tail all-pad."""
    n = cells.shape[0]
    dev = cells.device
    order, counts, starts, nvirt, vstarts = _cell_layout(cells, nlist, qcap)
    sorted_cells = cells[order].to(torch.int64)
    pos = torch.arange(n, device=dev) - starts[sorted_cells]
    order32 = order.to(torch.int32)

    keep = pos < cap
    cand_table = torch.full((nlist, cap), n, dtype=torch.int32, device=dev)
    cand_table[sorted_cells[keep], pos[keep]] = order32[keep]

    v_total = int(nvirt.sum())
    virt_row = vstarts[sorted_cells] + pos // qcap
    virt_table = torch.full((v_total, qcap), n, dtype=torch.int32, device=dev)
    virt_table[virt_row, pos % qcap] = order32
    virt_parent = torch.repeat_interleave(
        torch.arange(nlist, dtype=torch.int32, device=dev), nvirt)
    return virt_table, virt_parent, cand_table, v_total


def _ivf_rowplan_impl(cells: torch.Tensor, nlist: int, qcap: int):
    """Row plan of the cell-sorted layout: the corpus is reordered by
    cell id once, after which every virtual query row and every
    candidate list is a range of sorted positions.

    Returns (order (n,) sorted position -> original id, starts (nlist,),
    counts (nlist,), virt_parent (V,), qstarts (V,), V), int32: virtual
    row r covers sorted positions [qstarts[r], qstarts[r] + qcap) of its
    parent cell, cut at the cell's end."""
    dev = cells.device
    order, counts, starts, nvirt, vstarts = _cell_layout(cells, nlist, qcap)
    v_total = int(nvirt.sum())
    cell_ids = torch.arange(nlist, device=dev)
    virt_parent = torch.repeat_interleave(cell_ids, nvirt)
    r = torch.arange(v_total, device=dev)
    qstarts = starts[virt_parent] + (r - vstarts[virt_parent]) * qcap
    i32 = torch.int32
    return (order.to(i32), starts.to(i32), counts.to(i32),
            virt_parent.to(i32), qstarts.to(i32), v_total)


def _candidate_slots(cc: torch.Tensor, width: int):
    """Lay the probed cells' candidate windows end to end.  cc (R, nprobe)
    candidates offered by each probe.  Returns, per slot of a (R, width)
    candidate list: the probe it belongs to, its position in that
    probe's window, and whether the slot is filled."""
    r, nprobe = cc.shape
    ends = torch.cumsum(cc, 1)
    j = torch.arange(width, device=cc.device).expand(r, width).contiguous()
    probe = torch.searchsorted(ends, j, right=True).clamp_max_(nprobe - 1)
    filled = j < ends[:, -1:]
    within = torch.where(filled, j - (ends - cc).gather(1, probe), 0)
    return probe, within, filled


def _join_rows(xp: torch.Tensor, q_rows: torch.Tensor, q_valid: torch.Tensor,
               cand: torch.Tensor, c_valid: torch.Tensor, k: int, dtype: str,
               distance: str):
    """The local join of a batch of R virtual rows.  ``xp`` is the corpus
    with a zero pad row at index n; q_rows (R, Q) and cand (R, W) are row
    indices into it (n where not valid).  Returns (members (R Q,),
    idx (R Q, k) int32, dist (R Q, k)); idx holds ``cand`` values, and a
    row with fewer than k valid candidates ends in dist = inf."""
    r, qn = q_rows.shape
    w = cand.shape[1]
    n = xp.shape[0] - 1
    q = xp[q_rows]                                       # (R, Q, d)
    xc = xp[cand]                                        # (R, W, d)
    x_sq = corpus_sqnorm(xc) if distance in USES_SQNORM else None
    dist = get_panel_fn(distance)(q, xc, x_sq, dtype=dtype)
    invalid = ((~c_valid)[:, None, :]
               | (cand[:, None, :] == q_rows[:, :, None])
               | (~q_valid)[:, :, None])
    dist.masked_fill_(invalid, float("inf"))
    del invalid
    # an id selected at dist = inf is replaced by the caller's fix-up,
    # so ties at inf need no order
    out_d, pos = _topk_lowest_index(dist.reshape(r * qn, w), k,
                                    order_inf_ties=False)
    del dist
    row_of = torch.arange(r, device=xp.device).repeat_interleave(qn)
    idx = cand.reshape(-1)[row_of[:, None] * w + pos]    # (R Q, k)
    if distance == "DistL2":
        # exact rerank of the selected values: the expansion cancels
        # catastrophically for tiny distances; inf stays inf
        d_ex = l2_pair(q.reshape(r * qn, 1, -1), xp[idx])
        out_d = torch.where(torch.isinf(out_d), out_d, d_ex)
        out_d, o = torch.sort(out_d, dim=1, stable=True)
        idx = torch.gather(idx, 1, o)
    members = torch.where(q_valid, q_rows, n).reshape(-1)
    return members, idx.to(torch.int32), out_d


def _batches(qn: np.ndarray, ctot: np.ndarray, k: int, panel_bytes: int):
    """Group virtual rows into batches whose (rows, Q, W) f32 panel fits
    ``panel_bytes``: rows in order of falling candidate count, Q and W
    the batch's largest.  Rows without a query are left out.  Yields
    (row ids, Q, W)."""
    rows = np.flatnonzero(qn > 0)
    rows = rows[np.argsort(-ctot[rows], kind="stable")]
    i = 0
    while i < len(rows):
        w = max(int(ctot[rows[i]]), k)
        q_max, j = 0, i
        while j < len(rows):
            q_new = max(q_max, int(qn[rows[j]]))
            if j > i and 4 * (j - i + 1) * q_new * w > panel_bytes:
                break
            q_max, j = q_new, j + 1
        yield rows[i:j], q_max, w
        i = j


def _join_all(xp: torch.Tensor, qn: torch.Tensor, ctot: torch.Tensor,
              batch_fn, k: int, dtype: str, distance: str, panel_bytes: int,
              mesh=None):
    """Run the join over every virtual row in byte-bounded batches and
    scatter each batch's results into the (n, k) outputs at once.  With
    ``mesh`` (parallel/sharded.py), rank r runs every size-th batch of
    the one batch plan (built from replicated counts, so every rank
    issues the same collectives) and the ranks' outputs, zero where a
    rank ran no batch, are summed: each row is some batch's member."""
    n = xp.shape[0] - 1
    dev = xp.device
    idx = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
    dist = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    plan = list(_batches(qn.cpu().numpy(), ctot.cpu().numpy(), k,
                         panel_bytes))
    if mesh is not None:
        plan = plan[mesh.rank::mesh.size]
    for rows, q_max, w in plan:
        rows_t = torch.as_tensor(rows, device=dev)
        members, it, dt = _join_rows(xp, *batch_fn(rows_t, q_max, w), k,
                                     dtype, distance)
        members = members.to(torch.int64)     # invalid -> the drop row n
        idx[members] = it
        dist[members] = dt
    idx, dist = idx[:n], dist[:n]
    if mesh is not None:
        mesh.all_reduce_sum(idx, dist)
    return idx, dist.clamp_min_(0.0)


def _ivf_join_sorted(xs_pad, qstarts, qparents, starts, counts, cell_nbrs,
                     k: int, qcap: int, cap: int, dtype: str,
                     distance: str = "DistL2",
                     panel_bytes: int = PANEL_BYTES, mesh=None):
    """Cell-sorted local join.  ``xs_pad`` is the corpus reordered by
    cell id plus one zero row; queries and candidates are ranges of
    sorted positions.  ``starts`` / ``counts`` may carry one extra
    sentinel cell (count 0) for the grid quantizer's out-of-range probe
    id.  Returns (idx, dist) of shape (n, k) in sorted-position space,
    before the under-filled fix-up."""
    n = xs_pad.shape[0] - 1
    parents = qparents.to(torch.int64)
    starts, counts = starts.to(torch.int64), counts.to(torch.int64)
    qstarts = qstarts.to(torch.int64)
    qends = starts[parents] + counts[parents]
    qn = (qends - qstarts).clamp(0, qcap)
    nbrs = cell_nbrs.to(torch.int64)[parents]            # (V, nprobe)
    cc_all = counts[nbrs].clamp_max(cap)

    def batch(rows, q_max, w):
        iota_q = torch.arange(q_max, device=rows.device)
        qpos = qstarts[rows, None] + iota_q
        q_valid = iota_q < qn[rows, None]
        probe, within, c_valid = _candidate_slots(cc_all[rows], w)
        cpos = starts[nbrs[rows]].gather(1, probe) + within
        return (torch.where(q_valid, qpos, n), q_valid,
                torch.where(c_valid, cpos, n), c_valid)

    return _join_all(xs_pad, qn, cc_all.sum(1), batch, k, dtype, distance,
                     panel_bytes, mesh)


def _ivf_join(x_pad, virt_table, virt_parent, cand_table, cell_nbrs, k: int,
              dtype: str, distance: str = "DistL2",
              panel_bytes: int = PANEL_BYTES, mesh=None):
    """Id-table local join: for each virtual query row, the exact kNN of
    its members within the probed cells' candidate lists.  ``x_pad`` is
    (n + 1, d) with a zero pad row.  Returns (idx, dist) of shape (n, k)
    in id space, before the under-filled fix-up."""
    n = x_pad.shape[0] - 1
    parents = virt_parent.to(torch.int64)
    qn = (virt_table < n).sum(1)
    nbrs = cell_nbrs.to(torch.int64)[parents]            # (V, nprobe)
    cc_all = (cand_table < n).sum(1)[nbrs]

    def batch(rows, q_max, w):
        members = virt_table[rows, :q_max].to(torch.int64)
        probe, within, c_valid = _candidate_slots(cc_all[rows], w)
        cand = cand_table[nbrs[rows].gather(1, probe), within]
        return (members, members < n,
                torch.where(c_valid, cand.to(torch.int64), n), c_valid)

    return _join_all(x_pad, qn, cc_all.sum(1), batch, k, dtype, distance,
                     panel_bytes, mesh)


def _strip_grid_assign(xq: torch.Tensor, g: int):
    """Strip-balanced 2-D partition: g equal-mass strips by rank of dim
    0, then g equal-count cells by rank of dim 1 within each strip.
    Every cell holds ~n / g^2 points, so cells never overflow the
    candidate cap and never come up empty.

    Returns (cells (n,) int32, bounds (g, g-1) f32, counts (g,) int32):
    bounds[s, j-1] is the lower y-boundary of cell j in strip s."""
    n = xq.shape[0]
    dev = xq.device
    iota = torch.arange(n, device=dev)
    ord0 = torch.argsort(xq[:, 0], stable=True)
    rank0 = torch.empty_like(iota)
    rank0[ord0] = iota
    stripe = -(-n // g)
    strip = torch.div(rank0, stripe, rounding_mode="floor")
    counts = torch.bincount(strip, minlength=g)
    starts = torch.cumsum(counts, 0) - counts
    # order by (strip, y), ties in arrival order: two stable sorts,
    # minor key first
    by_y = torch.argsort(xq[:, 1], stable=True)
    idx_s = by_y[torch.argsort(strip[by_y], stable=True)]
    strip_s, y_s = strip[idx_s], xq[idx_s, 1]
    pos = iota - starts[strip_s]
    cnt = counts[strip_s].clamp_min(1)
    cell_y = torch.div(pos * g, cnt, rounding_mode="floor")
    cells = torch.empty(n, dtype=torch.int32, device=dev)
    cells[idx_s] = (strip_s * g + cell_y).to(torch.int32)
    # lower boundary of cell j (1..g-1) in strip s: the y value at the
    # first position of that cell, ceil(j count / g) into the strip
    j = torch.arange(1, g, device=dev)[None, :]
    bpos = starts[:, None] - torch.div(-(j * counts[:, None]), g,
                                       rounding_mode="floor")
    bounds = y_s[bpos.clamp(0, n - 1)]
    return cells, bounds, counts.to(torch.int32)


def _strip_cell_neighbors(bounds: np.ndarray, g: int,
                          w: int = 5) -> np.ndarray:
    """Probe table for the strip-balanced partition: cell (s, j) probes
    (j-1, j, j+1) in its own strip plus up to ``w`` cells in each
    adjacent strip whose y-range overlaps its own (strips have
    independent y-boundaries, so the overlap window is found by
    searchsorted on the neighbour strip's bounds).  Out-of-range slots
    hold the sentinel id g^2; no probe id is duplicated.  Host-side:
    bounds is a small (g, g-1) array."""
    nlist = g * g
    probes = np.full((nlist, 3 + 2 * w), nlist, np.int32)
    for s in range(g):
        lo_b = np.concatenate([[-np.inf], bounds[s]])      # (g,)
        hi_b = np.concatenate([bounds[s], [np.inf]])
        for j in range(g):
            c = s * g + j
            col = 0
            for jj in (j - 1, j, j + 1):
                if 0 <= jj < g:
                    probes[c, col] = s * g + jj
                col += 1
            for side, sp in ((0, s - 1), (1, s + 1)):
                base = 3 + side * w
                if not (0 <= sp < g):
                    continue
                jlo = int(np.searchsorted(bounds[sp], lo_b[j],
                                          side="right"))
                jhi = int(np.searchsorted(bounds[sp], hi_b[j],
                                          side="right"))
                # widen by one on each side for boundary ties
                jlo = max(jlo - 1, 0)
                jhi = min(jhi + 1, g - 1)
                for t, jj in enumerate(range(jlo, min(jhi, jlo + w - 1)
                                             + 1)):
                    probes[c, base + t] = sp * g + jj
    return probes


def _quantize_cells(xq: torch.Tensor, k: int, nlist: int, nprobe: int,
                    quantizer: str, seed: int, sample_size: int,
                    kmeans_iter: int,
                    sample_ids: Optional[torch.Tensor] = None,
                    init_ids: Optional[torch.Tensor] = None):
    """Coarse-quantizer dispatch.  Returns (cells, cell_nbrs, nlist, cap,
    qcap, pad_cell): ``pad_cell`` means cell_nbrs contains the sentinel
    id ``nlist``, an empty cell the caller must add.

    quantizer="grid" (d == 2 only, e.g. the embedded cloud the quality
    estimator re-indexes): strip-balanced equal-count cells with
    overlap-mapped block probes, no k-means pass.  quantizer="kmeans":
    Lloyd k-means on at most ``sample_size`` rows, then every row to its
    nearest centroid and every cell to its ``nprobe`` nearest cells
    (itself first).  The k-means subsample (``sample_ids``) and
    initialization (``init_ids``) may be given; otherwise they come from
    CPU generators seeded ``seed + 1`` and ``seed``."""
    n, d = xq.shape
    if quantizer == "grid":
        if d != 2:
            raise ValueError(
                f"grid quantizer supports exactly d == 2 (got d={d}); "
                "use quantizer='kmeans'")
        nlist0, _, _ = ivf_sizing(n, k, nlist)
        # the ~13-cell probe window must contain the k-NN radius: bound
        # occupancy below by ~3k
        nlist0 = min(nlist0, max(4, n // (3 * k)))
        g = max(2, int(round(nlist0 ** 0.5)))
        nlist = g * g
        _, cap, qcap = ivf_sizing(n, k, nlist)
        cells, bounds, _ = _strip_grid_assign(xq, g)
        cell_nbrs = torch.from_numpy(
            _strip_cell_neighbors(bounds.cpu().numpy(), g)).to(xq.device)
        return cells, cell_nbrs, nlist, cap, qcap, True
    if quantizer != "kmeans":
        raise ValueError(f"unknown quantizer {quantizer!r}")
    nlist, cap, qcap = ivf_sizing(n, k, nlist)
    nprobe = min(nprobe, nlist)
    sub = xq
    if n > sample_size:
        if sample_ids is None:
            gen = torch.Generator().manual_seed(seed + 1)
            with span("rng.kmeans_sample"):
                sample_ids = torch.randperm(n, generator=gen)[:sample_size]
        sub = xq[sample_ids.to(xq.device)]
    with span("kmeans_fit"):
        centroids, _ = kmeans_fit(sub, nlist, n_iter=kmeans_iter, seed=seed,
                                  init_ids=init_ids)
    with span("kmeans_assign"):
        cells = assign_to_centroids(xq, centroids)
        # nearest cells per cell (self included first, exact centroid
        # panel)
        cd = l2_panel(centroids, centroids, corpus_sqnorm(centroids))
        _, cell_nbrs = _topk_lowest_index(cd, nprobe)
    return cells, cell_nbrs.to(torch.int32), nlist, cap, qcap, False


def knn_graph_ivf(x: torch.Tensor, k: int, distance: str = "DistL2",
                  nlist: int = 0, nprobe: int = 32, dtype: str = "float32",
                  kmeans_iter: int = 10, seed: int = 0,
                  sample_size: int = 500_000, topk_recall: float = 0.0,
                  quantizer: str = "kmeans", layout: str = "sorted",
                  panel_bytes: int = PANEL_BYTES,
                  kmeans_sample_ids: Optional[torch.Tensor] = None,
                  kmeans_init_ids: Optional[torch.Tensor] = None,
                  timer: Optional[PhaseTimer] = None, mesh=None):
    """Approximate kNN graph via the IVF local join.  Returns (idx (n, k)
    int32, dist (n, k) f32), ascending.  ``timer`` receives the wall
    seconds of the phases ``ivf_quantize`` and ``ivf_join``; the
    counter ``knn.ivf.pairs`` the plan's candidate distances
    (``plan_pairs``).

    All five metrics are served: the in-join distances use the metric's
    own panel; the coarse quantizer always partitions in L2 (on
    L2-normalized vectors for cosine, exactly spherical k-means; for the
    others an approximation whose recall loss NN-descent recovers).
    ``dtype="bfloat16"`` casts the operands of the L2 / cosine panel's
    cross product; DistL2 distances are exact f32 either way (rerank).
    ``panel_bytes`` bounds one batch's f32 distance panel of the torch
    join; the results do not depend on it, nor on ``layout``.  On a CUDA
    tensor, ``layout="sorted"`` with DistL2 runs the join as one launch
    of the kernel of ops/ivf_join.py (``join_route``), which agrees
    with the torch join outside near-ties; the gathered layout and the
    other metrics run the torch join.  ``mesh`` (parallel/sharded.py,
    through ``sharded_knn_graph_ivf``) splits the join over the ranks
    (the kernel's virtual rows, the torch join's batches); every rank
    fits the quantizer and rank 0's cells are broadcast, so the tables
    are replicated bit for bit."""
    check_distance(distance)
    check_knobs(dtype, topk_recall)
    x = x.to(torch.float32)
    n, d = x.shape
    # quantizer space: L2-normalized vectors for cosine
    if distance == "DistCosine":
        xq = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-30)
    else:
        xq = x
    if layout not in ("sorted", "gathered"):
        raise ValueError(f"unknown IVF layout {layout!r}")
    if timer is None:
        timer = PhaseTimer()
    with timer.phase("ivf_quantize") as sync:
        cells, cell_nbrs, nlist, cap, qcap, pad_cell = _quantize_cells(
            xq, k, nlist, nprobe, quantizer, seed, sample_size, kmeans_iter,
            sample_ids=kmeans_sample_ids, init_ids=kmeans_init_ids)
        if mesh is not None:
            cells, cell_nbrs = cells.contiguous(), cell_nbrs.contiguous()
            mesh.broadcast(cells, cell_nbrs)
        sync.append(cells)
    del xq
    logger.info("ivf: n=%d nlist=%d cap=%d qcap=%d nprobe=%d", n, nlist, cap,
                qcap, cell_nbrs.shape[1])
    with timer.phase("ivf_join") as sync:
        if layout == "sorted":
            idx, dist = _knn_graph_ivf_sorted(
                x, cells, cell_nbrs, pad_cell, k, nlist, cap, qcap, dtype,
                distance, panel_bytes, mesh)
        else:
            idx, dist = _knn_graph_ivf_gathered(
                x, cells, cell_nbrs, pad_cell, k, nlist, cap, qcap, dtype,
                distance, panel_bytes, mesh)
        pairs = plan_pairs(cells, cell_nbrs, nlist, cap)
        sync.append(dist)
    # read after the span's sync: no stall of its own
    count(PAIRS, pairs.item())
    return idx, dist


def plan_pairs(cells: torch.Tensor, cell_nbrs: torch.Tensor, nlist: int,
               cap: int) -> torch.Tensor:
    """The candidate distances the join's plan calls for: every row of a
    cell c against the first min(counts[p], cap) rows of each cell p it
    probes, sum_c counts[c] sum_{p in cell_nbrs[c]} min(counts[p], cap)
    (the sentinel probe id ``nlist`` an empty cell); a 0-d int64 tensor
    on the cells' device.  The same count whatever route serves the
    join."""
    counts = torch.bincount(cells.to(torch.int64), minlength=nlist + 1)
    probed = counts[cell_nbrs.to(torch.int64)].clamp_max(cap).sum(1)
    return (counts[:nlist] * probed).sum()


def _knn_graph_ivf_gathered(x, cells, cell_nbrs, pad_cell: bool, k: int,
                            nlist: int, cap: int, qcap: int, dtype: str,
                            distance: str, panel_bytes: int = PANEL_BYTES,
                            mesh=None):
    """The id-table layout: tables, join, fix-up."""
    n, d = x.shape
    virt_table, virt_parent, cand_table, _ = _ivf_tables_impl(
        cells, nlist, cap, qcap)
    if pad_cell:
        # sentinel probe id nlist -> one all-pad candidate row
        cand_table = torch.cat([cand_table, torch.full(
            (1, cap), n, dtype=torch.int32, device=x.device)])
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    idx, dist = _ivf_join(x_pad, virt_table, virt_parent, cand_table,
                          cell_nbrs, k, dtype, distance, panel_bytes, mesh)
    return _fixup_underfilled(idx, dist, n)


def sorted_plan(x, cells, pad_cell: bool, nlist: int, qcap: int):
    """The cell-sorted layout's join inputs: (order32 (n,) sorted position
    -> id, xs_pad (n + 1, d) the rows in cell order and a zero row, then
    the row plan qstarts, virt_parent (V,) and starts, counts (cells,)),
    int32; with ``pad_cell`` one more cell, empty, for the sentinel probe
    id nlist."""
    n, d = x.shape
    order32, starts, counts, virt_parent, qstarts, _ = _ivf_rowplan_impl(
        cells, nlist, qcap)
    if pad_cell:
        starts = torch.cat([starts, starts.new_full((1,), n)])
        counts = torch.cat([counts, counts.new_zeros((1,))])
    xs_pad = torch.cat([x[order32], x.new_zeros((1, d))])  # one-time reorder
    return order32, xs_pad, qstarts, virt_parent, starts, counts


def sorted_join_inputs(x, k: int, nlist: int = 0, nprobe: int = 32,
                       quantizer: str = "kmeans", cap: Optional[int] = None,
                       qcap: Optional[int] = None, seed: int = 0):
    """The DistL2 join's inputs for the rows ``x`` as ``knn_graph_ivf``
    builds them in the sorted layout (its quantizer at ``seed``, the
    default k-means subsample and iterations): the keyword arguments of
    ``ops.ivf_join.ivf_join``.  ``cap`` / ``qcap`` in place of the
    sizing's cut windows shorter and split cells into more virtual rows
    (the kernel's checks use that)."""
    cells, cell_nbrs, nlist, cap0, qcap0, pad = _quantize_cells(
        x, k, nlist, nprobe, quantizer, seed, 500_000, 10)
    cap = cap0 if cap is None else cap
    qcap = min(cap, qcap0 if qcap is None else qcap)
    _, xs_pad, qstarts, parents, starts, counts = sorted_plan(
        x, cells, pad, nlist, qcap)
    return dict(xs_pad=xs_pad, sqnorm=corpus_sqnorm(xs_pad), qstarts=qstarts,
                qparents=parents, starts=starts, counts=counts,
                cell_nbrs=cell_nbrs, k=k, qcap=qcap, cap=cap)


def _knn_graph_ivf_sorted(x, cells, cell_nbrs, pad_cell: bool, k: int,
                          nlist: int, cap: int, qcap: int, dtype: str,
                          distance: str, panel_bytes: int = PANEL_BYTES,
                          mesh=None):
    """The cell-sorted layout: the join runs in sorted-position
    space; one final relabeling pass returns original ids and rows."""
    n = x.shape[0]
    order32, xs_pad, qstarts, virt_parent, starts, counts = sorted_plan(
        x, cells, pad_cell, nlist, qcap)
    if join_route(x.device.type, "sorted", distance, x.shape[1],
                  k) != "torch":
        # one kernel launch (the one join_route gives d and k) over every
        # virtual row of this rank; the others' rows are 0 until the sum
        rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        idx_s, dist_s = ivf_join(xs_pad, corpus_sqnorm(xs_pad), qstarts,
                                 virt_parent, starts, counts, cell_nbrs, k,
                                 qcap, cap, dtype, rank, size)
        if mesh is not None:
            mesh.all_reduce_sum(idx_s, dist_s)
    else:
        idx_s, dist_s = _ivf_join_sorted(xs_pad, qstarts, virt_parent,
                                         starts, counts, cell_nbrs, k, qcap,
                                         cap, dtype, distance, panel_bytes,
                                         mesh)
    del xs_pad
    idx_s, dist_s = _fixup_underfilled(idx_s, dist_s, n)
    # sorted-position space -> original labels: row r holds point
    # order32[r]; neighbour values are sorted positions
    order = order32.to(torch.int64)
    idx_o = torch.empty_like(idx_s)
    idx_o[order] = order32[idx_s]
    dist_o = torch.empty_like(dist_s)
    dist_o[order] = dist_s
    return idx_o, dist_o


def _fixup_underfilled(idx: torch.Tensor, dist: torch.Tensor, n: int):
    """Repair rows whose probed cells held < k valid candidates: they
    carry the pad id n or dist = inf.  Valid entries are an ascending
    prefix, so duplicating the row's last valid neighbour keeps the row
    sorted; a row with no valid candidate at all falls back to
    (i + 1) % n at a huge finite distance (its edge weight ~ 0, and
    NN-descent repairs it)."""
    bad = (idx >= n) | torch.isinf(dist)
    nvalid = (~bad).sum(1)
    last = (nvalid - 1).clamp_min(0)[:, None]
    fb_i = torch.gather(idx, 1, last)
    fb_d = torch.gather(dist, 1, last)
    rows = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    none_valid = (nvalid == 0)[:, None]
    fb_i = torch.where(none_valid, (rows + 1) % n, fb_i)
    fb_d = torch.where(none_valid, fb_d.new_tensor(1e30), fb_d)
    return torch.where(bad, fb_i, idx), torch.where(bad, fb_d, dist)
