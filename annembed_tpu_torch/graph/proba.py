"""Distance -> probability edge calibration for the CE optimizer.

Port of annembed_tpu/graph/proba.py (reference src/tools/kdumap.rs:26-235).
For node x with sorted neighbour distances d_1 <= ... <= d_k:
  * rho_x   = d_1
  * scale_x = scale_rho * mean(rho over {x} u neighbours(x))
  * p_i     = exp(-((d_i - d_1)_+ / scale_x)^beta), floored at PROBA_MIN,
              then row-normalized to 1
  * all-equal fallback (kdumap.rs:224-230): uniform 1/k.
"""

from __future__ import annotations

import dataclasses

import torch

from ..params import PROBA_MIN
from .kgraph import KGraph


@dataclasses.dataclass
class NodeParams:
    """Per-node local scale + probability out-edges (dense (n, k)
    layout; neighbour identities live in the companion KGraph)."""

    scale: torch.Tensor   # (n,)
    probas: torch.Tensor  # (n, k)


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
