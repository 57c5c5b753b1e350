"""Certified grid radius search on 2-d embedded clouds.

Port of annembed_tpu/knn/radius.py.  The quality estimator needs the
exact ``radius_k``-th neighbour distance of its evaluated nodes against
the whole embedded cloud (reference src/embedder.rs:527-554); a brute
search at 11M rows sorts an 11M-wide panel row per query.  At d = 2 this
search returns the same f32 distances from a few thousand candidates a
query:

  1. the strip-balanced equal-count grid (``ivf._strip_grid_assign``)
     partitions the cloud, and the corpus is sorted by (cell, y), so
     every cell is a contiguous, y-ordered window;
  2. each query takes three contiguous spans: ``w_own`` cells of its own
     strip around its cell, and ``w_adj`` cells of each adjacent strip
     centred on its y value;
  3. exact squared distances and the k smallest over those spans;
  4. the certificate: the k-th distance is exact iff it lies strictly
     below a lower bound on the distance to every cell left out, built
     from per-strip x extrema and running per-cell y extrema (so it is
     conservative under ties).  Rows that fail it are searched again by
     ``knn_search_brute``.

The candidate distances use the expression of
``brute._exact_l2_rerank`` (sum of squares over the last axis, sqrt of
the clamped f32 value), so a certified row is bit-identical to the brute
search's row.
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Sequence

import torch

from .brute import knn_search_brute
from .ivf import _strip_grid_assign

logger = logging.getLogger(__name__)


def grid_shape(n: int, k: int, min_occupancy: int = 0):
    """(g, cap_cell) of the grid for n rows at k columns: g strips of g
    cells, each cell holding at most cap_cell rows; g is None where the
    search delegates to brute (g < 4 or n < 4 occupancy)."""
    occ = max(min_occupancy, 3 * k, 128)
    g = max(2, int(math.sqrt(n / occ)))
    if g < 4 or n < 4 * occ:
        return None, None
    # strips hold <= ceil(n / g) rows, cells within a strip differ by <= 1
    strip_max = -(-n // g)
    return g, -(-strip_max // g) + 1


def _reverse_cummin(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (dim,)), dim).values, (dim,))


def _grid_tables(y: torch.Tensor, g: int):
    """Cell-sorted corpus and the certificate's extremum tables.

    Returns (ys (n, 2) corpus sorted by (cell, y), cells (n,) cell id of
    each original row, starts (g*g,), counts (g*g,), bounds (g, g-1),
    cummax_y / cummin_y (g, g) running per-cell y extrema along the
    y-cell axis (empty cells transparent), strip_cummax_x /
    strip_cummin_x (g,) running per-strip x extrema)."""
    n = y.shape[0]
    cells, bounds, _ = _strip_grid_assign(y, g)
    cells64 = cells.to(torch.int64)
    counts = torch.bincount(cells64, minlength=g * g)
    starts = torch.cumsum(counts, 0) - counts
    # sort by (cell, y): two stable sorts, minor key first
    by_y = torch.argsort(y[:, 1], stable=True)
    order = by_y[torch.argsort(cells64[by_y], stable=True)]
    ys = y[order]

    nonempty = counts > 0
    first = starts.clamp(0, n - 1)
    last = (starts + counts - 1).clamp(0, n - 1)
    cell_min_y = torch.where(nonempty, ys[first, 1], float("inf"))
    cell_max_y = torch.where(nonempty, ys[last, 1], float("-inf"))
    # running extrema along the y-cells of each strip: the bound for
    # "all cells <= j" / "all cells >= j" must see through empty cells
    cummax_y = torch.cummax(cell_max_y.reshape(g, g), 1).values
    cummin_y = _reverse_cummin(cell_min_y.reshape(g, g), 1)

    strip_of = torch.div(cells64, g, rounding_mode="floor")
    x0 = y[:, 0]
    strip_max_x = torch.full((g,), float("-inf"), device=y.device
                             ).scatter_reduce(0, strip_of, x0, "amax",
                                              include_self=False)
    strip_min_x = torch.full((g,), float("inf"), device=y.device
                             ).scatter_reduce(0, strip_of, x0, "amin",
                                              include_self=False)
    strip_cummax_x = torch.cummax(strip_max_x, 0).values
    strip_cummin_x = _reverse_cummin(strip_min_x, 0)
    return (ys, cells, starts, counts, bounds, cummax_y, cummin_y,
            strip_cummax_x, strip_cummin_x)


def _grid_query_dists(ys_pad, q, s, j, starts, counts, bounds, cummax_y,
                      cummin_y, strip_cummax_x, strip_cummin_x, k: int,
                      g: int, w_own: int, w_adj: int, cap_cell: int):
    """Candidate top-k and certificate for one query block.

    q (m, 2) are the query coordinates, s / j (m,) their strip and
    y-cell (int64).  Returns (dists (m, k) ascending exact L2, ok (m,)
    bool: True iff the k-th distance is certified exact)."""
    n_pad = ys_pad.shape[0]
    dev = q.device
    ho, ha = w_own // 2, w_adj // 2
    qx, qy = q[:, 0], q[:, 1]
    inf = torch.full_like(qx, float("inf"))
    nan = torch.full_like(qx, float("nan"))
    zero = torch.zeros_like(qx)

    def span(s_arr, jlo, jhi, valid):
        """Sorted-position span [start, end) of cells jlo..jhi of strip
        s_arr; empty where ``valid`` is False."""
        c_lo = (s_arr * g + jlo).clamp(0, g * g - 1)
        c_hi = (s_arr * g + jhi).clamp(0, g * g - 1)
        st = torch.where(valid, starts[c_lo], 0)
        en = torch.where(valid, starts[c_hi] + counts[c_hi], 0)
        return st, en

    # own strip: cells [j - ho, j + ho]
    jloA = (j - ho).clamp(0, g - 1)
    jhiA = (j + ho).clamp(0, g - 1)
    stA, enA = span(s, jloA, jhiA, torch.ones_like(s, dtype=torch.bool))

    def adj_window(sp, valid):
        """Window of w_adj cells of strip sp centred on the query's y
        (strips have their own boundaries: side-left searchsorted)."""
        b_rows = bounds[sp.clamp(0, g - 1)].contiguous()     # (m, g-1)
        jc = torch.searchsorted(b_rows, qy[:, None].contiguous(),
                                right=False)[:, 0]
        jlo = (jc - ha).clamp(0, g - 1)
        jhi = (jc + ha).clamp(0, g - 1)
        st, en = span(sp, jlo, jhi, valid)
        return st, en, jlo, jhi

    validB = s - 1 >= 0
    stB, enB, jloB, jhiB = adj_window(s - 1, validB)
    validC = s + 1 <= g - 1
    stC, enC, jloC, jhiC = adj_window(s + 1, validC)

    def gather_span(st, en, cap):
        stc = torch.clamp_max(st, n_pad - cap)
        pos = stc[:, None] + torch.arange(cap, device=dev)[None, :]
        valid = (pos >= st[:, None]) & (pos < en[:, None])
        return ys_pad[pos], valid                             # (m, cap, 2)

    blkA, vA = gather_span(stA, enA, w_own * cap_cell)
    blkB, vB = gather_span(stB, enB, w_adj * cap_cell)
    blkC, vC = gather_span(stC, enC, w_adj * cap_cell)
    cand = torch.cat([blkA, blkB, blkC], 1)                  # (m, C, 2)
    valid = torch.cat([vA, vB, vC], 1)                       # (m, C)
    del blkA, blkB, blkC, vA, vB, vC

    # brute._exact_l2_rerank's expression: certified rows bit-identical
    d2 = torch.square(q[:, None, :] - cand).sum(-1)
    del cand
    d2 = d2.masked_fill(~valid, float("inf"))
    d2_k = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
    dists = torch.sqrt(d2_k.clamp_min(0.0))                  # (m, k) asc
    del d2

    # --- certificate: distance lower bounds to every unprobed cell ---
    def at(tab2d, rows, cols, ok):
        r = rows.clamp(0, g - 1)
        c = cols.clamp(0, g - 1)
        return torch.where(ok, tab2d[r, c], nan)

    # strips <= s-2 (x <= strip_cummax_x[s-2]) / strips >= s+2
    lb_xm = torch.where(s - 2 >= 0,
                        qx - strip_cummax_x[(s - 2).clamp(0, g - 1)], inf)
    lb_xp = torch.where(s + 2 <= g - 1,
                        strip_cummin_x[(s + 2).clamp(0, g - 1)] - qx, inf)

    # own strip, y-cells below / above the window
    lo_ok = jloA - 1 >= 0
    hi_ok = jhiA + 1 <= g - 1
    lb_yo_lo = torch.where(lo_ok, qy - at(cummax_y, s, jloA - 1, lo_ok), inf)
    lb_yo_hi = torch.where(hi_ok, at(cummin_y, s, jhiA + 1, hi_ok) - qy, inf)

    def adj_bounds(sp, valid, jlo, jhi, dx):
        dxc = torch.maximum(dx, zero)
        lo_ok = valid & (jlo - 1 >= 0)
        hi_ok = valid & (jhi + 1 <= g - 1)
        dy_lo = qy - at(cummax_y, sp, jlo - 1, lo_ok)
        dy_hi = at(cummin_y, sp, jhi + 1, hi_ok) - qy
        lo = torch.where(lo_ok, torch.sqrt(
            torch.square(dxc) + torch.square(torch.maximum(dy_lo, zero))),
            inf)
        # a negative dy makes the y bound vacuous: the x term alone
        lo = torch.where(lo_ok & (dy_lo < 0.0), dxc, lo)
        hi = torch.where(hi_ok, torch.sqrt(
            torch.square(dxc) + torch.square(torch.maximum(dy_hi, zero))),
            inf)
        hi = torch.where(hi_ok & (dy_hi < 0.0), dxc, hi)
        return torch.minimum(lo, hi)

    # strip s-1: x <= strip_max_x[s-1] <= qx up to ties
    dx_m = qx - torch.where(validB, strip_cummax_x[(s - 1).clamp(0, g - 1)],
                            -inf)
    lb_B = torch.where(validB, adj_bounds(s - 1, validB, jloB, jhiB, dx_m),
                       inf)
    dx_p = torch.where(validC, strip_cummin_x[(s + 1).clamp(0, g - 1)],
                       inf) - qx
    lb_C = torch.where(validC, adj_bounds(s + 1, validC, jloC, jhiC, dx_p),
                       inf)

    margin = torch.minimum(
        torch.minimum(torch.minimum(lb_xm, lb_xp),
                      torch.minimum(lb_yo_lo, lb_yo_hi)),
        torch.minimum(lb_B, lb_C))
    return dists, dists[:, k - 1] < margin


def grid_radius_search(y, q_ids, k: int, w_own: int = 5, w_adj: int = 7,
                       query_block: int = 4096, min_occupancy: int = 0,
                       keep_cols: Optional[Sequence[int]] = None):
    """Exact k smallest L2 distances (self included) from the corpus
    points ``q_ids`` to the whole 2-d corpus ``y`` (a tensor: the search
    runs on its device).

    Equal to ``knn_search_brute(y[q_ids], y, k)[1]``: certified rows are
    bit-identical, the others (logged) come from that very search.
    Returns (dists (m, k) f32 ascending, n_fallback); ``keep_cols``
    keeps only those columns of each row (the full-fraction quality
    estimate needs two of k, and (n, k) is ~11 GB at 11M x 251)."""
    y = torch.as_tensor(y, dtype=torch.float32)
    n, d = y.shape
    if d != 2:
        raise ValueError(f"grid_radius_search needs d == 2 (got {d})")
    dev = y.device
    q_ids = torch.as_tensor(q_ids, device=dev).to(torch.int64)
    m = q_ids.shape[0]
    cols = None if keep_cols is None else list(keep_cols)

    def brute(ids):
        _, sd = knn_search_brute(y[ids], y, k=k)
        return sd if cols is None else sd[:, cols]

    g, cap_cell = grid_shape(n, k, min_occupancy)
    if g is None:
        return brute(q_ids), m

    (ys, cells, starts, counts, bounds, cummax_y, cummin_y,
     strip_cummax_x, strip_cummin_x) = _grid_tables(y, g)
    ys_pad = torch.cat([ys, ys.new_zeros((max(w_own, w_adj) * cap_cell, 2))])
    del ys
    qcells = cells[q_ids].to(torch.int64)
    s_all = torch.div(qcells, g, rounding_mode="floor")
    j_all = qcells - s_all * g
    del qcells, cells

    sd_parts, ok_parts = [], []
    for i0 in range(0, m, query_block):
        blk = slice(i0, i0 + query_block)
        sd_b, ok_b = _grid_query_dists(
            ys_pad, y[q_ids[blk]], s_all[blk], j_all[blk], starts, counts,
            bounds, cummax_y, cummin_y, strip_cummax_x, strip_cummin_x, k,
            g, w_own, w_adj, cap_cell)
        sd_parts.append(sd_b if cols is None else sd_b[:, cols])
        ok_parts.append(ok_b)
    sd = torch.cat(sd_parts) if sd_parts else y.new_zeros(
        (0, k if cols is None else len(cols)))
    ok = torch.cat(ok_parts) if ok_parts else torch.ones(
        0, dtype=torch.bool, device=dev)
    del sd_parts, ok_parts, ys_pad

    bad = torch.nonzero(~ok).squeeze(1)        # the call's one readback
    n_fallback = int(bad.numel())
    if n_fallback:
        logger.info("grid radius search: %d/%d queries uncertified, "
                    "exact brute fallback", n_fallback, m)
        sd[bad] = brute(q_ids[bad])
    else:
        logger.info("grid radius search: all %d queries certified exact "
                    "(g=%d)", m, g)
    return sd, n_fallback
