"""Symmetric normalized graph Laplacian in COO form + spectral solve.

Port of annembed_tpu/graph/laplacian.py (reference src/graphlaplace.rs,
the legacy kdumap Laplacian of src/tools/kdumap.rs:250 and the
alfa-weighted one of src/diffmaps.rs:427).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..linalg.rsvd import (SvdResult, coo_matmat, full_svd_dense,
                           randomized_svd_coo)
from ..params import FULL_SVD_SIZE_LIMIT
from .kgraph import KGraph, coo_to_dense, symmetric_coo


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

    def matmat(self):
        return coo_matmat(self.rows, self.cols, self.vals, self.n)

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


def _row_sums(rows, vals, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, rows.to(torch.int64), vals)


def laplacian_from_probas(g: KGraph, probas: torch.Tensor) -> GraphLaplacian:
    """Legacy Laplacian of ``get_dmap_embedding`` (kdumap.rs:250
    ``get_laplacian``): the probability graph symmetrized as
    1/2 (P + P^T), normalized D^{-1/2} G D^{-1/2}; the normalizer kept
    is the degree vector D (kdumap.rs:282-291)."""
    n = g.nb_nodes
    rows, cols, vals = symmetric_coo(g, weights=probas, mode="mean")
    diag = _row_sums(rows, vals, n)
    d_inv_sqrt = 1.0 / torch.sqrt(diag.clamp_min(1e-30))
    r, c = rows.to(torch.int64), cols.to(torch.int64)
    vals = vals * d_inv_sqrt[r] * d_inv_sqrt[c]
    return GraphLaplacian(rows=rows, cols=cols, vals=vals, normalizer=diag,
                          n=n)


def alfa_normalize_coo(rows, cols, vals, n: int, alfa: float):
    """Alfa weighting + symmetric normalization (diffmaps.rs:565,579-584):
      q_i   = kernel row sums, normalized to mean 1
      K_ij /= (q_i q_j)^alfa
      D_i   = new row sums
      K_ij /= sqrt(D_i D_j)
    Returns (vals, normalizer = sqrt(D))."""
    r = rows.to(torch.int64)
    c = cols.to(torch.int64)
    q = _row_sums(r, vals, n)
    q = q / q.mean()
    vals = vals / torch.pow((q[r] * q[c]).clamp_min(1e-30), alfa)
    degrees = _row_sums(r, vals, n)
    d_inv_sqrt = 1.0 / torch.sqrt(degrees.clamp_min(1e-30))
    vals = vals * d_inv_sqrt[r] * d_inv_sqrt[c]
    return vals, torch.sqrt(degrees.clamp_min(0.0))


def laplacian_alfa_weighted(rows, cols, vals, n: int, alfa: float,
                            normed_scales=None,
                            mean_scale=1.0) -> GraphLaplacian:
    """Diffusion-maps Laplacian of an already symmetric kernel COO (self
    edges included) with density exponent ``alfa`` (diffmaps.rs:427-587
    ``compute_laplacian``; see :func:`alfa_normalize_coo`).  The
    reference's 1/max_nbng factor in q_mean (diffmaps.rs:469,546) cancels
    in the final normalization, so the plain mean is used."""
    vals, normalizer = alfa_normalize_coo(rows, cols, vals, n, alfa)
    return GraphLaplacian(rows=rows, cols=cols, vals=vals,
                          normalizer=normalizer, n=n,
                          normed_scales=normed_scales, mean_scale=mean_scale)
