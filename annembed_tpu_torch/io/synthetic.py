"""Deterministic synthetic datasets (numpy only).

* ``synthetic_blobs`` and ``synthetic_clustered_manifold``: bit-identical
  copies of annembed_tpu/io/synthetic.py, the bench's two 70k x 784
  fixtures (intrinsic dimension 20, and a clustered 2-d manifold).
* ``synthetic_higgs``: a copy of examples/higgs.py's stand-in for the
  11M x 28 HIGGS table (which needs a download), plus the z-score
  rescale that example applies (reference higgs.rs:158-176).
"""

from __future__ import annotations

import numpy as np


def _quantize_u8(x: np.ndarray) -> np.ndarray:
    x = (x - x.min()) / (x.max() - x.min()) * 255.0
    return np.round(x).astype(np.uint8)


def synthetic_blobs(n: int, d: int = 784, seed: int = 42,
                    n_clusters: int = 10,
                    latent_dim: int = 20) -> np.ndarray:
    """Isotropic Gaussian clusters in a ``latent_dim``-d latent, linearly
    lifted to ``d`` dims and uint8-quantized like MNIST pixels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, latent_dim)) * 6.0
    labels = rng.integers(0, n_clusters, n)
    z = centers[labels] + rng.normal(size=(n, latent_dim))
    lift = rng.normal(size=(latent_dim, d)) / np.sqrt(latent_dim)
    x = z @ lift + 0.05 * rng.normal(size=(n, d))
    return _quantize_u8(x)


def synthetic_clustered_manifold(n: int, d: int = 784, seed: int = 7,
                                 n_clusters: int = 10,
                                 latent_dim: int = 2,
                                 labels_out: bool = False):
    """Per cluster c, ``cos(z @ W_c + b_c) + offset_c`` of a Gaussian
    latent z (random Fourier features: a smooth manifold of intrinsic
    dimension ``latent_dim``), 1% ambient noise, uint8-quantized."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_clusters, n)
    z = rng.normal(size=(n, latent_dim)).astype(np.float64)
    w = rng.normal(size=(n_clusters, latent_dim, d)) * 0.9
    b = rng.uniform(0.0, 2.0 * np.pi, size=(n_clusters, d))
    offs = rng.normal(size=(n_clusters, d)) * 0.8
    x = np.empty((n, d), np.float64)
    for c in range(n_clusters):
        m = labels == c
        x[m] = np.cos(z[m] @ w[c] + b[c])
    x += offs[labels]
    x += 0.01 * rng.normal(size=(n, d))
    xq = _quantize_u8(x)
    if labels_out:
        return xq, labels
    return xq


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
