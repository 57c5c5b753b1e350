"""Symmetric normalized graph Laplacian in COO form + spectral solve.

Port of the diffusion-maps half of annembed_tpu/graph/laplacian.py
(reference src/graphlaplace.rs, src/diffmaps.rs:427).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..linalg.rsvd import (SvdResult, full_svd_dense, randomized_svd_coo)
from ..params import FULL_SVD_SIZE_LIMIT
from .kgraph import coo_to_dense


@dataclasses.dataclass
class GraphLaplacian:
    """Symmetrized kernel D^{-1/2} G D^{-1/2} plus its normalizer (what
    downstream embeddings divide eigenvectors by, graphlaplace.rs:21-35)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    normalizer: torch.Tensor                     # (n,)
    n: int
    normed_scales: Optional[torch.Tensor] = None  # (n,) rho_i / mean(rho)
    mean_scale: object = 1.0
    svd_res: Optional[SvdResult] = None

    def to_dense(self) -> torch.Tensor:
        return coo_to_dense(self.rows, self.cols, self.vals, self.n)

    def do_svd(self, asked_dim: int, n_iter: int = 5, omega=None,
               generator: Optional[torch.Generator] = None) -> SvdResult:
        """Exact SVD up to FULL_SVD_SIZE_LIMIT nodes, randomized above
        (graphlaplace.rs:127; rank max(asked_dim, 20), :115).  ``omega``
        (n, rank + 10) may inject the Gaussian test matrix."""
        if self.n <= FULL_SVD_SIZE_LIMIT:
            res = full_svd_dense(self.to_dense())
        else:
            res = randomized_svd_coo(self.rows, self.cols, self.vals,
                                     n=self.n, rank=max(asked_dim, 20),
                                     n_iter=n_iter, n_oversample=10,
                                     omega=omega, generator=generator)
        self.svd_res = res
        return res


def alfa_normalize_coo(rows, cols, vals, n: int, alfa: float):
    """Alfa weighting + symmetric normalization (diffmaps.rs:565,579-584):
      q_i   = kernel row sums, normalized to mean 1
      K_ij /= (q_i q_j)^alfa
      D_i   = new row sums
      K_ij /= sqrt(D_i D_j)
    Returns (vals, normalizer = sqrt(D))."""
    r = rows.to(torch.int64)
    c = cols.to(torch.int64)
    q = torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, r, vals)
    q = q / q.mean()
    vals = vals / torch.pow((q[r] * q[c]).clamp_min(1e-30), alfa)
    degrees = torch.zeros(n, dtype=vals.dtype, device=vals.device
                          ).index_add_(0, r, vals)
    d_inv_sqrt = 1.0 / torch.sqrt(degrees.clamp_min(1e-30))
    vals = vals * d_inv_sqrt[r] * d_inv_sqrt[c]
    return vals, torch.sqrt(degrees.clamp_min(0.0))
