"""kNN graph construction front-end (port of annembed_tpu/knn/api.py).

Only the exact brute branch is ported; graphs above
``KnnParams.brute_force_limit`` need IVF + NN-descent (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..params import KnnParams
from .brute import knn_graph_brute, knn_search_brute


def check_brute_limit(n: int, params: KnnParams) -> None:
    """Refuse a graph of ``n`` rows that only the IVF build may take."""
    if n > params.brute_force_limit:
        raise NotImplementedError(
            f"n={n} > brute_force_limit={params.brute_force_limit} needs "
            "the IVF + NN-descent build, not ported yet (ROADMAP A8); "
            "raise KnnParams.brute_force_limit to build exactly")


def build_kgraph(x: torch.Tensor, knbn: int, distance: str = "DistL2",
                 params: KnnParams | None = None) -> KGraph:
    """Build the k-NN graph of ``x`` (reference bin/embed.rs:450)."""
    if params is None:
        params = KnnParams(knbn=knbn, distance=distance)
    check_brute_limit(x.shape[0], params)
    idx, dist = knn_graph_brute(x, knbn, distance=distance,
                                block_rows=params.block_rows,
                                dtype=params.dtype,
                                topk_recall=params.topk_recall)
    return KGraph(indices=idx, dists=dist)


def recall_at_k(approx_idx, exact_idx) -> float:
    """Mean fraction of the exact k-NN present in the approximate rows
    (duplicate ids in an approx row count once)."""
    a = torch.as_tensor(approx_idx)
    e = torch.as_tensor(exact_idx)
    hits = (e[:, :, None] == a[:, None, :]).any(-1).sum().item()
    return hits / float(e.numel())


def sampled_exact_recall(x: torch.Tensor, g: KGraph, sample: int = 2000,
                         seed: int = 11, sample_ids=None) -> float:
    """recall@k of the build graph ``g`` against an exact search on a row
    sample (self column dropped from the k+1 search result; a duplicate
    twin displacing self is handled by the [:k] truncation).  The
    sample draw is numpy's, as in the JAX package."""
    n, k = g.indices.shape
    if sample_ids is None:
        rng = np.random.default_rng(seed)
        sub = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    else:
        sub = np.asarray(sample_ids)
    sub_t = torch.as_tensor(sub, dtype=torch.int64, device=x.device)
    ei, _ = knn_search_brute(x[sub_t], x, k=k + 1)
    ei = ei.cpu().numpy()
    not_self = ei != sub[:, None]
    exact = np.stack([row[m][:k] for row, m in zip(ei, not_self)])
    return recall_at_k(g.indices[sub_t].cpu(), torch.as_tensor(exact))
