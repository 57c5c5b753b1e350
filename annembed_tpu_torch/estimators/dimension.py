"""Intrinsic dimension estimators.

Port of annembed_tpu/estimators/dimension.py:
  * Levina-Bickel MLE (reference src/tools/dimension.rs:13-69,
    kgraph.rs:224 ``estimate_intrinsic_dim``): per-node estimate
    averaged over k in [k_first, k_last], then over nodes;
  * Facco 2NN (kgraph.rs:267 ``estimate_intrinsic_dim_2nn``): fit of
    -ln(1 - F(mu)) = d ln(mu) on the ratio mu = r2/r1.

Both are whole-array reductions.  The optional node subsample is given
as ``sample_ids`` (the JAX package draws it with ``jax.random.choice``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graph.kgraph import KGraph


def _levina_bickel_per_node(dists: torch.Tensor, k_first: int, k_last: int):
    """Per-node averaged Levina-Bickel estimate
    d_hat(k) = (k - 1) / sum_{j=1..k-1} ln(d_k / d_j); non-positive sums
    are skipped as in the reference (dimension.rs:44-61).  Rows are
    ascending; the reference's 1-based edges[j] is dists[:, j-1]."""
    logd = torch.log(dists.clamp_min(1e-30))
    est_sum = torch.zeros_like(logd[:, 0])
    nb_pos = torch.zeros_like(logd[:, 0])
    for k in range(k_first, k_last + 1):
        aux = (k - 1) * logd[:, k - 1] - logd[:, :k - 1].sum(1)
        valid = aux > 0.0
        est_sum = est_sum + torch.where(
            valid, (k - 1.0) / aux.clamp_min(1e-30), 0.0)
        nb_pos = nb_pos + valid.to(torch.float32)
    node_ok = nb_pos > 0
    node_dim = torch.where(node_ok, est_sum / nb_pos.clamp_min(1.0),
                           torch.nan)
    return node_dim, node_ok


def intrinsic_dim_levina_bickel(g: KGraph,
                                sample_ids: Optional[torch.Tensor] = None
                                ) -> Tuple[float, float]:
    """Mean and std of the per-node MLE dimension over the nodes (or
    over ``sample_ids``).  k range as dimension.rs:17-29: [8, 19] with
    >= 20 neighbours, else [2, k-1]."""
    k = g.dists.shape[1]
    if k >= 20:
        k_first, k_last = 8, 19
    elif k >= 3:
        k_first, k_last = 2, k - 1
    else:
        raise ValueError("not enough neighbours for dimension estimation")
    node_dim, node_ok = _levina_bickel_per_node(g.dists, k_first, k_last)
    if sample_ids is not None:
        node_dim, node_ok = node_dim[sample_ids], node_ok[sample_ids]
    cnt = node_ok.to(torch.float32).sum().clamp_min(1.0)
    mean = torch.where(node_ok, node_dim, 0.0).sum() / cnt
    var = torch.where(node_ok, torch.square(node_dim - mean), 0.0).sum() / cnt
    return float(mean), float(torch.sqrt(var))


def intrinsic_dim_2nn(g: KGraph,
                      sample_ids: Optional[torch.Tensor] = None) -> float:
    """Facco two-NN estimator (kgraph.rs:267-326): mu = r2/r1 over the
    nodes with r1 > 0 (``sample_ids`` index that filtered list); with the
    empirical CDF F over the sorted mu, d = sum(-ln mu ln(1 - F)) /
    sum((ln mu)^2)."""
    r1 = g.dists[:, 0]
    mu = torch.where(r1 > 0.0, g.dists[:, 1] / r1.clamp_min(1e-30),
                     torch.nan)
    mu = mu[torch.isfinite(mu)]
    if sample_ids is not None:
        mu = mu[sample_ids]
    m = mu.shape[0]
    order = torch.argsort(mu, stable=True)
    ranks = torch.empty_like(mu)
    ranks[order] = torch.arange(m, dtype=mu.dtype, device=mu.device)
    cumul = ranks / m                              # F(mu_i), in [0, 1)
    ln_mu = torch.log(mu.clamp_min(1e-30))
    num = torch.sum(-ln_mu * torch.log((1.0 - cumul).clamp_min(1e-12)))
    den = torch.sum(torch.square(ln_mu))
    return float(num / den.clamp_min(1e-30))
