"""Exact kNN graph and kNN search by tiled distance panels + top-k.

Port of annembed_tpu/knn/brute.py.  Queries run in row blocks (a Python
loop; the JAX package's ``lax.map``), so at most one (block, m) panel is
live.  The last block is simply shorter: nothing is padded, so no padded
row can reach a result.  Self edges are masked by index (not by
distance, which would break on duplicate points).

DistL2: the panel's expansion |q|^2 + |x|^2 - 2 q.x carries ~1e-3
relative cancellation error in f32, enough to swap near-tied neighbours,
so the top (k + 8) candidates are re-ranked with exact elementwise
(q - x)^2 distances.  At d <= 3 (embedded clouds: the quality
estimator's radius search) the panel itself is formed elementwise, so
candidate selection is exact too.  Other metrics select their top k
from the panel directly, as the JAX package does.  Ties go to the lower
corpus index at every stage, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import torch

from .distances import (USES_SQNORM, check_distance, corpus_sqnorm,
                        get_panel_fn, l2_panel_sq, panel_rows)

_RERANK_EXTRA = 8
#: up to this d the L2 panel is the exact elementwise sum of squares
_EXACT_PANEL_MAX_D = 3


def check_knobs(dtype: str, topk_recall: float) -> None:
    """Raise on an unknown panel dtype or an out-of-range
    ``topk_recall``.  The JAX package selects its candidates with
    ``lax.approx_max_k`` at ``topk_recall`` > 0; that reduction is
    approximate only on a TPU and returns the exact top k elsewhere, so
    the port runs its exact selection at every ``topk_recall``."""
    if not 0.0 <= topk_recall <= 1.0:
        raise ValueError(f"topk_recall={topk_recall} outside [0, 1]")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown panel dtype {dtype!r}; valid: "
                         "'float32', 'bfloat16'")


def _sorted_by_value_then_index(vals: torch.Tensor, idx: torch.Tensor):
    """Row-wise order by (value, index): ties to the lower index."""
    by_idx = torch.argsort(idx, dim=1)
    vals = torch.gather(vals, 1, by_idx)
    idx = torch.gather(idx, 1, by_idx)
    pos = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, pos), torch.gather(idx, 1, pos)


def _topk_lowest_index(panel: torch.Tensor, k: int,
                       order_inf_ties: bool = True):
    """The k smallest entries of each row, ties to the lower index.
    ``torch.topk`` breaks ties in no set order, so it selects k + 8
    candidates; a row whose k-th value is tied beyond them is re-selected
    by a stable sort of the whole row.  With ``order_inf_ties`` off, a
    row whose k-th value is inf keeps whatever inf entries were selected
    (for callers that discard them)."""
    m = panel.shape[1]
    kk = min(k + _RERANK_EXTRA, m)
    vals, idx = torch.topk(panel, kk, dim=1, largest=False, sorted=True)
    vals, idx = _sorted_by_value_then_index(vals, idx)
    if kk < m:
        kth = vals[:, k - 1:k]
        short = (panel <= kth).sum(1) > (vals <= kth).sum(1)
        if not order_inf_ties:
            short &= torch.isfinite(kth[:, 0])
        rows = short.nonzero().squeeze(1)
        if rows.numel():
            v, i = torch.sort(panel[rows], dim=1, stable=True)
            vals[rows], idx[rows] = v[:, :kk], i[:, :kk]
    return vals[:, :k], idx[:, :k]


def _l2_sq_panel(q, x, x_sq, dtype="float32"):
    """Squared L2 panel: exact at low d (whatever ``dtype``), the
    expansion with its cross product in ``dtype`` otherwise."""
    d = q.shape[1]
    if d > _EXACT_PANEL_MAX_D:
        return l2_panel_sq(q, x, x_sq, dtype)
    return torch.square(q[:, None, :] - x[None, :, :]).sum(-1)


def _exact_l2_rerank(q, x, cand_idx, k: int, self_ids=None):
    """Re-rank candidate indices by exact L2 distance.

    q: (b, d), cand_idx: (b, kk) int64 -> (idx (b, k) int32, dist (b, k)).
    ``self_ids`` (b,) masks the query's own id before selection: when kk
    reaches n the panel's masked self column re-enters the candidates
    and its recomputed exact distance (0) would win."""
    xc = x[cand_idx]                                    # (b, kk, d)
    d2 = torch.square(q[:, None, :] - xc).sum(-1)       # (b, kk)
    if self_ids is not None:
        d2 = d2.masked_fill(cand_idx == self_ids[:, None], float("inf"))
    d2_s, pos = torch.sort(d2, dim=1, stable=True)
    idx = torch.gather(cand_idx, 1, pos[:, :k])
    return idx.to(torch.int32), torch.sqrt(d2_s[:, :k].clamp_min(0.0))


def _block_topk(q, corpus, x_sq, k: int, distance: str, self_ids=None,
                dtype: str = "float32"):
    """One query-block panel + top-k selection (+ exact rerank for
    DistL2) — the shared body of the graph build and the corpus search.
    ``dtype`` is the operand type of a matmul panel's cross product; the
    DistL2 rerank is f32 either way."""
    l2 = distance == "DistL2"
    panel = (_l2_sq_panel(q, corpus, x_sq, dtype) if l2
             else get_panel_fn(distance)(q, corpus, x_sq, dtype=dtype))
    if self_ids is not None:
        panel[torch.arange(q.shape[0], device=q.device), self_ids] = \
            float("inf")
    if not l2:
        vals, idx = _topk_lowest_index(panel, k)
        return idx.to(torch.int32), vals.clamp_min(0.0)
    kk = min(k + _RERANK_EXTRA, corpus.shape[0])
    vals, idx = torch.topk(panel, kk, dim=1, largest=False, sorted=True)
    _, idx = _sorted_by_value_then_index(vals, idx)
    return _exact_l2_rerank(q, corpus, idx, k, self_ids=self_ids)


def _sqnorm(x, distance):
    return corpus_sqnorm(x) if distance in USES_SQNORM else None


def knn_graph_brute(x: torch.Tensor, k: int, distance: str = "DistL2",
                    block_rows: int = 1024, dtype: str = "float32",
                    topk_recall: float = 0.0):
    """Exact k nearest neighbours of every row of ``x`` (self excluded).
    Returns ``(indices int32, dists f32)`` of shape (n, k), ascending."""
    check_distance(distance)
    check_knobs(dtype, topk_recall)
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    x = x.to(torch.float32)
    x_sq = _sqnorm(x, distance)
    br = panel_rows(n, block_rows)
    idx_parts, dist_parts = [], []
    for r0 in range(0, n, br):
        r1 = min(r0 + br, n)
        ids = torch.arange(r0, r1, device=x.device)
        i, d = _block_topk(x[r0:r1], x, x_sq, k, distance, self_ids=ids,
                           dtype=dtype)
        idx_parts.append(i)
        dist_parts.append(d)
    return torch.cat(idx_parts), torch.cat(dist_parts)


def knn_search_brute(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     distance: str = "DistL2", block_rows: int = 1024,
                     dtype: str = "float32", topk_recall: float = 0.0):
    """k nearest corpus points for each query (no self-exclusion).
    Replaces ``hnsw.search`` (reference src/embedder.rs:527-554)."""
    check_distance(distance)
    check_knobs(dtype, topk_recall)
    n = corpus.shape[0]
    if k > n:
        raise ValueError("k larger than corpus")
    queries = queries.to(torch.float32)
    corpus = corpus.to(torch.float32)
    x_sq = _sqnorm(corpus, distance)
    br = panel_rows(n, block_rows)
    idx_parts, dist_parts = [], []
    for r0 in range(0, queries.shape[0], br):
        i, d = _block_topk(queries[r0:r0 + br], corpus, x_sq, k, distance,
                           dtype=dtype)
        idx_parts.append(i)
        dist_parts.append(d)
    if not idx_parts:
        return (torch.empty((0, k), dtype=torch.int32, device=corpus.device),
                torch.empty((0, k), dtype=torch.float32,
                            device=corpus.device))
    return torch.cat(idx_parts), torch.cat(dist_parts)
