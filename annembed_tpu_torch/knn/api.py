"""kNN graph construction front-end: brute force vs IVF dispatch (port
of annembed_tpu/knn/api.py).

Up to ``KnnParams.brute_force_limit`` rows the graph is exact
(knn/brute.py); above it, the IVF local join (knn/ivf.py) followed by
NN-descent refinement (knn/nndescent.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..params import KnnParams
from ..utils.profiling import PhaseTimer
from .brute import knn_graph_brute, knn_search_brute
from .ivf import knn_graph_ivf
from .nndescent import nndescent_refine


def build_kgraph(x: torch.Tensor, knbn: int, distance: str = "DistL2",
                 params: KnnParams | None = None,
                 timer: PhaseTimer | None = None) -> KGraph:
    """Build the k-NN graph of ``x`` with the strategy fitting its size
    (reference bin/embed.rs:450).  ``timer`` receives the wall seconds of
    the IVF build's phases (quantize, join, NN-descent rounds, rerank)."""
    if params is None:
        params = KnnParams(knbn=knbn, distance=distance)
    if x.shape[0] <= params.brute_force_limit:
        idx, dist = knn_graph_brute(x, knbn, distance=distance,
                                    block_rows=params.block_rows,
                                    dtype=params.dtype,
                                    topk_recall=params.topk_recall)
        return KGraph(indices=idx, dists=dist)
    # enlarged build-k: construct and refine at build_k_factor * k, then
    # truncate to k.  Wider lists make each NN-descent round propagate
    # further (the candidate set is B(B(i))), so recall@k rises faster
    # per round than refining at k itself.
    kb = knbn
    if params.refine_rounds > 0 and params.build_k_factor > 1.0:
        kb = max(knbn + 1, int(round(knbn * params.build_k_factor)))
    idx, dist = knn_graph_ivf(x, kb, distance=distance, nlist=params.nlist,
                              nprobe=params.nprobe, dtype=params.dtype,
                              topk_recall=params.topk_recall,
                              quantizer=params.quantizer,
                              layout=params.ivf_layout, timer=timer)
    if params.refine_rounds > 0:
        idx, dist = nndescent_refine(x, idx, dist,
                                     n_rounds=params.refine_rounds,
                                     distance=distance, dtype=params.dtype,
                                     rho=params.nndescent_rho, timer=timer)
    return KGraph(indices=idx[:, :knbn].contiguous(),
                  dists=dist[:, :knbn].contiguous())


def recall_at_k(approx_idx, exact_idx, row_chunk: int = 500_000) -> float:
    """Mean fraction of the exact k-NN present in the approximate rows.
    Duplicate ids in an approx row (the IVF under-filled fix-up
    duplicates the last valid neighbour) count once: each exact
    neighbour either is in the approx row or is not.  Rows go in chunks
    so the (c, k, k) match tensor stays bounded at 11M rows."""
    a = torch.as_tensor(approx_idx)
    e = torch.as_tensor(exact_idx)
    hits = 0
    for c0 in range(0, e.shape[0], row_chunk):
        ac, ec = a[c0:c0 + row_chunk], e[c0:c0 + row_chunk]
        hits += (ec[:, :, None] == ac[:, None, :]).any(-1).sum().item()
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
