"""Variable-bandwidth diffusion maps (Berry-Harlim).

Port of annembed_tpu/spectral/diffmaps.py (reference src/diffmaps.rs):
local scales -> gaussian kernel with geometric pairwise scales (floored
at PROBA_MIN, self edge of weight 1) -> optional beta < 0 density pass
-> max-symmetrization -> alfa-weighted normalized Laplacian -> spectral
coordinates with diffusion time t.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..graph.kgraph import KGraph, symmetric_coo_apply, symmetric_coo_plan
from ..graph.laplacian import (GraphLaplacian, alfa_normalize_coo,
                               laplacian_from_probas)
from ..params import PROBA_MIN, DiffusionParams


def _local_scales(dists: torch.Tensor, gnbn: int):
    """rho_i = sqrt(sum_{j<gnbn} d_ij^2 / k); zero scales replaced by the
    mean (diffmaps.rs:784-810, 1032-1039: the first gnbn squared
    distances divided by the full k, as the reference does)."""
    k = dists.shape[1]
    rho = torch.sqrt(torch.square(dists[:, :gnbn]).sum(1) / k)
    rho = torch.where(rho <= 0.0, rho.mean(), rho)
    return rho, rho.mean()


def _kernel_weights(dists, indices, rho, epsil_sqrt: float):
    """(n, k) kernel weights with pairwise geometric scales, and the
    self-edge weights; all-equal rows are uniform over k+1 edges
    including the self edge (diffmaps.rs:634-647)."""
    k = dists.shape[1]
    pair_scale = torch.sqrt(rho[:, None] * rho[indices.to(torch.int64)])
    arg = torch.square(dists / (epsil_sqrt * pair_scale.clamp_min(1e-30)))
    w = torch.exp(-arg).clamp_min(PROBA_MIN)
    all_equal = dists[:, -1] <= dists[:, 0]
    uniform = 1.0 / (k + 1.0)
    w = torch.where(all_equal[:, None], torch.full_like(w, uniform), w)
    self_w = torch.where(all_equal, torch.full_like(rho, uniform),
                         torch.ones_like(rho))
    return w, self_w


def _symmetric_kernel_coo(plan, n: int, w, self_w):
    """max(w_ij, w_ji) symmetrization (diffmaps.rs:531) + self edges."""
    ar = torch.arange(n, dtype=torch.int32, device=w.device)
    rows = torch.cat([plan.rows, ar])
    cols = torch.cat([plan.cols, ar])
    vals = torch.cat([symmetric_coo_apply(plan, w, mode="max"),
                      self_w.to(torch.float32)])
    return rows, cols, vals


def _density_from_kernel(rows, vals, n: int) -> torch.Tensor:
    """q_i proportional to kernel row sums, mean 1 (diffmaps.rs:855-952)."""
    q = torch.zeros(n, dtype=torch.float32, device=vals.device).index_add_(
        0, rows.to(torch.int64), vals)
    return q / q.mean()


def _diffusion_coords(lambdas, u, weight, t: Optional[float],
                      real_dim: int):
    """lambda_{j+1}^t u_{i,j+1} / weight_i over the normalized
    eigenvalues; ``t=None`` picks t with (lambda_2/lambda_1)^t < 0.9,
    capped at 5."""
    norm_l = lambdas / lambdas[0]
    if t is None:
        ratio = torch.clamp(norm_l[2] / norm_l[1].clamp_min(1e-12),
                            1e-12, 1.0 - 1e-6)
        time = torch.clamp_max(math.log(0.9) / torch.log(ratio), 5.0)
    else:
        time = t
    lam_t = torch.pow(norm_l[1:real_dim + 1], time)
    return lam_t[None, :] * u[:, 1:real_dim + 1] \
        / weight.clamp_min(1e-30)[:, None]


def _spectral_coords(lambdas, u, scales, normalizer, t: Optional[float],
                     real_dim: int):
    """coord_ij = clip(lambda_{j+1}^t u_{i,j+1} / (scale_i sqrt(N_i /
    mean N)), 10) with N the stored normalizer (diffmaps.rs:1196-1237)."""
    weight = scales * torch.sqrt(normalizer / normalizer.mean())
    return torch.clamp(_diffusion_coords(lambdas, u, weight, t, real_dim),
                       -10.0, 10.0)


def _dmap_laplacian_impl(indices, dists, gnbn: int, epsil: float,
                         beta: float, alfa: float):
    """Local scales -> kernel (-> density pass if beta < 0) ->
    symmetrize -> alfa normalization -> D^{-1/2} scaling."""
    n = indices.shape[0]
    rho, mean = _local_scales(dists, gnbn)
    epsil_sqrt = math.sqrt(epsil)
    plan = symmetric_coo_plan(KGraph(indices=indices, dists=dists))
    q = None
    if beta < 0.0:
        w, sw = _kernel_weights(dists, indices, rho, epsil_sqrt)
        rows, cols, vals = _symmetric_kernel_coo(plan, n, w, sw)
        q = _density_from_kernel(rows, vals, n)
        w, sw = _kernel_weights(dists, indices, torch.pow(q, beta) * mean,
                                epsil_sqrt)
    else:
        w, sw = _kernel_weights(dists, indices, torch.full_like(rho, mean),
                                epsil_sqrt)
    rows, cols, vals = _symmetric_kernel_coo(plan, n, w, sw)
    vals, normalizer = alfa_normalize_coo(rows, cols, vals, n, alfa)
    return rows, cols, vals, normalizer, rho, mean, q


@dataclasses.dataclass
class DiffusionMaps:
    """Reference ``DiffusionMaps`` (diffmaps.rs:254-271)."""

    params: DiffusionParams
    laplacian: Optional[GraphLaplacian] = None
    normed_scales: Optional[torch.Tensor] = None
    mean_scale: object = 1.0
    q_density: Optional[torch.Tensor] = None

    def laplacian_from_kgraph(self, g: KGraph) -> GraphLaplacian:
        """compute_dmap_nodeparams + compute_laplacian
        (diffmaps.rs:380-422,752-849)."""
        k = g.nbng
        gnbn = min(self.params.gnbn or k, k)
        beta = self.params.beta
        if beta > 0:
            raise ValueError("beta cannot be > 0 (diffmaps.rs:827-830)")
        rows, cols, vals, normalizer, rho, mean, q = _dmap_laplacian_impl(
            g.indices, g.dists, gnbn, float(self.params.epsil), float(beta),
            float(self.params.alfa))
        self.mean_scale = mean
        self.normed_scales = rho / mean
        self.q_density = q
        return GraphLaplacian(rows=rows, cols=cols, vals=vals,
                              normalizer=normalizer, n=g.nb_nodes,
                              normed_scales=self.normed_scales,
                              mean_scale=mean)

    def embed_from_laplacian(self, lap: GraphLaplacian, asked_dim: int,
                             t_opt: Optional[float], omega=None,
                             generator: Optional[torch.Generator] = None,
                             mesh=None) -> torch.Tensor:
        """Spectral coordinates from the top eigenvectors
        (diffmaps.rs:1145-1243).  ``mesh`` shards the randomized SVD's
        SpMM over the ranks (GraphLaplacian.do_svd)."""
        svd_res = lap.do_svd(asked_dim + 15, n_iter=self.params.svd_n_iter,
                             omega=omega, generator=generator, mesh=mesh)
        scales = lap.normed_scales
        if scales is None:
            scales = torch.ones(lap.n, dtype=torch.float32,
                                device=lap.vals.device)
        return _spectral_coords(svd_res.s, svd_res.u, scales, lap.normalizer,
                                t_opt, min(asked_dim, svd_res.u.shape[1] - 1))

    def embed_from_kgraph(self, g: KGraph, omega=None,
                          generator: Optional[torch.Generator] = None,
                          mesh=None) -> torch.Tensor:
        """Full chain (diffmaps.rs:1047-1075)."""
        lap = self.laplacian_from_kgraph(g)
        coords = self.embed_from_laplacian(lap, self.params.asked_dim,
                                           self.params.t, omega=omega,
                                           generator=generator, mesh=mesh)
        self.laplacian = lap
        return coords

    def embed_from_data(self, x, knbn: int = 16, distance: str = "DistL2",
                        omega=None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Data (a tensor, on its device) -> kNN graph -> diffusion
        embedding (reference ``embed_from_hnsw``, diffmaps.rs:1114)."""
        from ..knn.api import build_kgraph
        g = build_kgraph(x, knbn, distance=distance)
        return self.embed_from_kgraph(g, omega=omega, generator=generator)


def get_dmap_embedding(g: KGraph, probas: torch.Tensor, asked_dim: int,
                       t_opt: Optional[float] = None, omega=None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Legacy initialization (reference diffmaps.rs:1278-1350
    ``get_dmap_embedding``, used when ``dmapnew = false``) on the kdumap
    Laplacian of the probability graph: coordinates
    lambda_{j+1}^t u_{i,j+1} / sqrt(D_i / mean D), unclipped.  The
    reference clamps ``real_dim`` to u's column count and would then read
    one column past it (diffmaps.rs:1326); this clamps to ncols - 1, as
    its ``embed_from_laplacian`` does (diffmaps.rs:1208), since column 0
    is skipped."""
    lap = laplacian_from_probas(g, probas)
    svd_res = lap.do_svd(asked_dim + 25, omega=omega, generator=generator)
    weight = torch.sqrt(lap.normalizer / lap.normalizer.mean())
    return _diffusion_coords(svd_res.s, svd_res.u, weight, t_opt,
                             min(asked_dim, svd_res.u.shape[1] - 1))
