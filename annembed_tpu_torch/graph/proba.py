"""Distance -> probability edge calibration for the CE optimizer.

Port of annembed_tpu/graph/proba.py (reference src/tools/kdumap.rs:26-235).
For node x with sorted neighbour distances d_1 <= ... <= d_k:
  * rho_x   = d_1
  * scale_x = scale_rho * mean(rho over {x} u neighbours(x))
  * p_i     = exp(-((d_i - d_1)_+ / scale_x)^beta), floored at PROBA_MIN,
              then row-normalized to 1
  * all-equal fallback (kdumap.rs:224-230): uniform 1/k.
The reference's CKMS quantile telemetry (kdumap.rs:88-113) becomes the
exact quantiles of ``proba_telemetry``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..params import PROBA_MIN
from ..utils.stats import quantiles
from .kgraph import KGraph


@dataclasses.dataclass
class NodeParams:
    """Per-node local scale + probability out-edges (dense (n, k)
    layout; neighbour identities live in the companion KGraph)."""

    scale: torch.Tensor   # (n,)
    probas: torch.Tensor  # (n, k)

    @property
    def nb_nodes(self) -> int:
        return self.probas.shape[0]

    @property
    def max_nbng(self) -> int:
        return self.probas.shape[1]

    def perplexity(self) -> torch.Tensor:
        """exp(Shannon entropy) per node: the Hill number of the edge
        distribution (reference nodeparam.rs:88-91)."""
        p = self.probas
        plogp = torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)),
                            torch.zeros_like(p))
        return torch.exp(-plogp.sum(-1))


def _to_proba_edges_impl(indices, dists, scale_rho: float, beta: float):
    n, k = dists.shape
    idx = indices.to(torch.int64)
    rho = dists[:, 0]
    rho_nbrs = rho[idx]                                  # (n, k)
    mean_rho = (rho_nbrs.sum(1) + rho) / (k + 1.0)
    # guard against the IVF no-candidate sentinel (rows pinned at dist
    # 1e30): recompute the mean without sentinel contributions for
    # exactly the affected rows; clean rows keep the unguarded value
    ok = rho < 1e29
    ok_nbrs = ok[idx]
    affected = ~(ok_nbrs.all(1) & ok)
    okf = ok.to(torch.float32)
    oknf = ok_nbrs.to(torch.float32)
    num = (rho_nbrs * oknf).sum(1) + rho * okf
    den = oknf.sum(1) + okf
    mean_guard = torch.where(den > 0.0, num / den.clamp_min(1.0), rho)
    mean_rho = torch.where(affected, mean_guard, mean_rho)
    scale = scale_rho * mean_rho

    shifted = (dists - dists[:, :1]).clamp_min(0.0)
    safe_scale = scale.clamp_min(1e-30)[:, None]
    w = torch.exp(-torch.pow(shifted / safe_scale, beta))
    w = w.clamp_min(PROBA_MIN)
    # all-equal fallback: last distance <= first distance (sorted rows)
    all_equal = dists[:, -1] <= dists[:, 0]
    w = torch.where(all_equal[:, None], torch.full_like(w, 1.0 / k), w)
    w = w / w.sum(1, keepdim=True)
    return scale, w


def to_proba_edges(g: KGraph, scale_rho: float = 1.0,
                   beta: float = 1.0) -> NodeParams:
    """Perplexity-calibrated probability graph (reference kdumap.rs:26)."""
    scale, w = _to_proba_edges_impl(g.indices, g.dists, float(scale_rho),
                                    float(beta))
    return NodeParams(scale=scale, probas=w)


def proba_telemetry(np_: NodeParams) -> Dict[str, float]:
    """Quantiles of the scales, edge weights and perplexities (the
    reference's CKMS telemetry, kdumap.rs:88-113), exact."""
    qs = (0.05, 0.5, 0.95, 0.99)
    out: Dict[str, float] = {}
    for name, v in (("scale", np_.scale), ("weight", np_.probas),
                    ("perplexity", np_.perplexity())):
        for q, val in zip(qs, quantiles(v, qs)):
            out[f"{name}_q{q:g}"] = float(val)
    return out
