"""Carre du Champ operator (local diffusion geometry).

Port of annembed_tpu/estimators/cdc.py (reference src/cdcop.rs): the
covariance of the diffusion transition kernel at a point, the best local
normal approximation of the data (Bamberger & Jones 2025, Coifman-Lafon
2006).

Construction (cdcop.rs:149-185): the diffusion-maps kernel with the
variable-bandwidth preset but alfa = beta = 0; at a point i the
random-walk transition row is recovered from the symmetric kernel by
P_ij = K_ij * sqrt(D_j) / sqrt(D_i), under which rows sum to 1 (the
JAX package implements that intended math; graphlaplace.rs:204).

cdc matrix at i (cdcop.rs:189-237):
    mean = sum_j P_ij x_j
    C    = sum_j P_ij (x_j - mean)(x_j - mean)^T / (2 rho_i^2)
with rho_i the normalized local scale.  Everything runs on the data's
device from the sparse kernel rows: a point's row is a window of at most
``max_row`` entries of the row-sorted COO kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..graph.laplacian import GraphLaplacian
from ..params import DiffusionParams
from ..spectral.diffmaps import DiffusionMaps


@dataclasses.dataclass
class CdcMat:
    """Symmetric covariance matrix and its spectrum (cdcop.rs:38-100)."""

    mat: torch.Tensor  # (d, d)

    def get_trace(self) -> float:
        return float(torch.trace(self.mat))

    def get_spectrum(self, epsil: float = 0.02) -> torch.Tensor:
        """Eigenvalues, descending; values below epsil * lambda_0 are
        dropped (the EPSIL-mode SVD of cdcop.rs:70-100)."""
        s = torch.linalg.eigvalsh(self.mat).flip(0).clamp_min(0.0)
        return s[s > epsil * s[0]]


def psd_dist_upper_bound(a: CdcMat, b: CdcMat) -> float:
    """Upper bound of the Bures-Wasserstein distance
    d^2 <= tr A + tr B - 2 sqrt(tr(A B))  (cdcop.rs:377-399)."""
    trab = torch.sum(a.mat * b.mat.T)
    d2 = torch.trace(a.mat) + torch.trace(b.mat) \
        - 2.0 * torch.sqrt(trab.clamp_min(0.0))
    return float(torch.sqrt(d2.clamp_min(0.0)))


def _scales_at(lap: GraphLaplacian, points: torch.Tensor) -> torch.Tensor:
    if lap.normed_scales is None:
        return torch.ones(points.shape[0], dtype=torch.float32,
                          device=points.device)
    return lap.normed_scales[points]


class CarreDuChamp:
    """CdC operator over a dataset (cdcop.rs:123-185), on the device of
    ``data`` (a tensor, or an array that goes to the CPU)."""

    def __init__(self, data, kgraph: Optional[KGraph] = None,
                 knbn: int = 12):
        self.data = torch.as_tensor(data, dtype=torch.float32)
        dparams = DiffusionParams.with_variable_bandwidth()
        dparams.set_alfa(0.0)
        dparams.set_beta(0.0)
        self.params = dparams
        if kgraph is None:
            from ..knn.api import build_kgraph
            kgraph = build_kgraph(self.data, knbn)
        self.kgraph = kgraph
        self.glaplacian: GraphLaplacian = DiffusionMaps(
            params=dparams).laplacian_from_kgraph(kgraph)
        # row-sorted COO copy + per-row offsets: a point's kernel row is
        # a contiguous window of at most max_row entries
        lap = self.glaplacian
        rows = lap.rows.to(torch.int64)
        order = torch.argsort(rows, stable=True)
        self._cols_s = lap.cols.to(torch.int64)[order]
        self._vals_s = lap.vals[order]
        counts = torch.bincount(rows, minlength=lap.n)
        self._row_start = torch.cumsum(counts, 0) - counts
        self._row_count = counts
        self._max_row = int(counts.max())

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.int64,
                               device=self.data.device).reshape(-1)

    # -- kernel rows ---------------------------------------------------
    def _kernel_entries(self, points: torch.Tensor):
        """Sparse kernel rows: (probas (Q, L), cols (Q, L)) with
        L = max row length; padded entries have proba 0."""
        lap = self.glaplacian
        total = self._cols_s.shape[0]
        offs = torch.arange(self._max_row, device=points.device)[None, :]
        pos = (self._row_start[points][:, None] + offs).clamp_max(total - 1)
        valid = offs < self._row_count[points][:, None]
        cols = torch.where(valid, self._cols_s[pos], 0)
        vals = torch.where(valid, self._vals_s[pos], 0.0)
        # P_ij = K_ij * normalizer_j / normalizer_i
        p = vals * lap.normalizer[cols] \
            / lap.normalizer[points][:, None].clamp_min(1e-30)
        return p, cols

    def kernel_rows(self, points) -> torch.Tensor:
        """Random-walk transition rows P_i. for a batch of point ranks;
        dense (Q, n), rows sum to ~1."""
        points = self._points(points)
        p, cols = self._kernel_entries(points)
        out = torch.zeros((points.shape[0], self.glaplacian.n),
                          dtype=torch.float32, device=p.device)
        return out.scatter_add_(1, cols, p)

    # -- cdc matrix ----------------------------------------------------
    def get_cdc_at_point(self, point_rank: int
                         ) -> Tuple[torch.Tensor, CdcMat]:
        """(mean, CdcMat) at one point (cdcop.rs:189-237)."""
        means, covs = self.get_cdc_batch([point_rank])
        return means[0], CdcMat(mat=covs[0])

    def get_cdc_batch(self, points) -> Tuple[torch.Tensor, torch.Tensor]:
        """CdC for a batch of point ranks: (means (Q, d), covs (Q, d, d)),
        from each point's own neighbourhood (Q, L, d), never a dense
        (Q, n) row."""
        points = self._points(points)
        p, cols = self._kernel_entries(points)             # (Q, L)
        xg = self.data[cols]                               # (Q, L, d)
        mean = torch.einsum("ql,qld->qd", p, xg)
        centered = xg - mean[:, None, :]
        cov = torch.einsum("ql,qli,qlj->qij", p, centered, centered)
        s = _scales_at(self.glaplacian, points)
        return mean, cov / (2.0 * torch.square(s))[:, None, None]

    def psd_dist_pairs(self, points_a, points_b) -> torch.Tensor:
        """Bures-Wasserstein upper bound between the CdC operators at
        points_a[i] and points_b[i] (cdcop.rs:377-399) from the sparse
        kernel entries; the (d, d) covariances are never formed:
            tr A    = sum_l p_l ||c_l||^2 / (2 s_a^2)
            tr(AB)  = p^T (G o G) q / (4 s_a^2 s_b^2),  G = C_a C_b^T
        """
        pa, pb = self._points(points_a), self._points(points_b)
        w_a, cols_a = self._kernel_entries(pa)             # (m, L)
        w_b, cols_b = self._kernel_entries(pb)
        xa, xb = self.data[cols_a], self.data[cols_b]      # (m, L, d)
        ca = xa - torch.einsum("ml,mld->md", w_a, xa)[:, None, :]
        cb = xb - torch.einsum("ml,mld->md", w_b, xb)[:, None, :]
        sa2 = torch.square(_scales_at(self.glaplacian, pa))
        sb2 = torch.square(_scales_at(self.glaplacian, pb))
        tra = torch.einsum("ml,ml->m", w_a, (ca * ca).sum(-1)) / (2.0 * sa2)
        trb = torch.einsum("ml,ml->m", w_b, (cb * cb).sum(-1)) / (2.0 * sb2)
        g = torch.einsum("mld,med->mle", ca, cb)           # (m, L, L)
        trab = torch.einsum("ml,mle,me->m", w_a, g * g, w_b) \
            / (4.0 * sa2 * sb2)
        d2 = tra + trb - 2.0 * torch.sqrt(trab.clamp_min(0.0))
        return torch.sqrt(d2.clamp_min(0.0))

    # -- CdC of function pairs ------------------------------------------
    def apply_fvec(self, point_rank: int, f: Callable, g: Callable
                   ) -> torch.Tensor:
        """Gamma(f, g) at a point for vector-valued f, g of a numpy row:
        the kernel-row weighted cross-covariance of their images,
        normalized like get_cdc_at_point (cdcop.rs:243-301).  f and g
        are evaluated on the point's kernel-row neighbourhood only."""
        p, cols = self._kernel_entries(self._points([point_rank]))
        p = p[0]                                            # (L,)
        nbrs = self.data[cols[0]].cpu().numpy()             # (L, d)
        dev = p.device
        fx = torch.stack([torch.as_tensor(np.asarray(f(row)),
                                          dtype=torch.float32)
                          for row in nbrs]).to(dev)
        gx = torch.stack([torch.as_tensor(np.asarray(g(row)),
                                          dtype=torch.float32)
                          for row in nbrs]).to(dev)
        cross = torch.einsum("n,ni,nj->ij", p, fx - p @ fx, gx - p @ gx)
        s = float(_scales_at(self.glaplacian,
                             self._points([point_rank]))[0])
        return cross / (2.0 * s * s)

    def apply_f1d(self, point_rank: int, f: Callable, g: Callable) -> float:
        """Scalar-function variant (cdcop.rs:303)."""
        out = self.apply_fvec(point_rank,
                              lambda v: np.atleast_1d(f(v)),
                              lambda v: np.atleast_1d(g(v)))
        return float(out[0, 0])
