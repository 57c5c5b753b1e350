"""Deterministic synthetic Higgs-shaped data (numpy only).

A copy of ``synthetic_higgs`` from examples/higgs.py (the repository's
stand-in for the 11M x 28 HIGGS table, which needs a download), plus the
z-score rescale that example applies (reference higgs.rs:158-176).
"""

from __future__ import annotations

import numpy as np


def synthetic_higgs(n_s: int, seed: int = 7, return_labels: bool = False):
    """32-cluster 8-d latent manifold lifted to 28 dims (float32); with
    ``return_labels`` also the (n_s,) cluster of every row (the same
    draws, so the rows do not change)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, 8), dtype=np.float32) * 4.0
    labels = rng.integers(0, 32, n_s)
    latent = (centers[labels]
              + rng.standard_normal((n_s, 8), dtype=np.float32))
    lift = rng.standard_normal((8, 28), dtype=np.float32)
    x = (latent @ lift
         + 0.3 * rng.standard_normal((n_s, 28), dtype=np.float32))
    return (x, labels) if return_labels else x


def label_purity(y, labels, k: int = 6, sample: int = 2000,
                 seed: int = 11) -> float:
    """Mean fraction of the k nearest embedded neighbours (exact, self
    excluded) of ``sample`` random rows that share the row's source
    cluster.  ``y`` is a torch tensor (n, dim) on any device."""
    import torch

    from ..knn.brute import knn_search_brute

    n = y.shape[0]
    rng = np.random.default_rng(seed)
    sub = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    sub_t = torch.as_tensor(sub, device=y.device)
    idx, _ = knn_search_brute(y[sub_t].contiguous(), y, k=k + 1)
    idx = idx.cpu().numpy()
    nbrs = np.stack([row[row != s][:k] for row, s in zip(idx, sub)])
    return float((labels[nbrs] == labels[sub][:, None]).mean())


def zscore(x: np.ndarray) -> np.ndarray:
    """Per-column z-score, as float32."""
    return ((x - x.mean(0)) / np.maximum(x.std(0), 1e-12)).astype(np.float32)
