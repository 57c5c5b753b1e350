"""Cross-entropy helpers of the dense optimizer.

Port of the parts of annembed_tpu/optim/ce.py that optim/dense.py uses
(reference src/embedder.rs:1127-1373).  The sampling optimizer
(``minibatch_update`` and friends) is ROADMAP A10.
"""

from __future__ import annotations

import torch

from ..graph.kgraph import KGraph

NB_NEGATIVE = 5  # fixed in the reference (embedder.rs:1241)


def embedded_scales_from_initial(scale: torch.Tensor) -> torch.Tensor:
    """0.2 * clamp(rho/mean, 1/4, 4) (embedder.rs:1356-1373)."""
    mean = scale.mean()
    return 0.2 * torch.clamp(scale / mean.clamp_min(1e-30), 0.25, 4.0)


def _cauchy_weight(d2_scaled: torch.Tensor, b: float) -> torch.Tensor:
    """1 / (1 + (d^2/scale^2)^b), clamped below 1 (embedder.rs:1322-1345)."""
    w = 1.0 / (1.0 + torch.pow(d2_scaled.clamp_min(0.0), b))
    return w.clamp_max(1.0 - 1e-7)


def _common_coeff(d2s: torch.Tensor, scale: torch.Tensor, b: float):
    """2 b cauchy d2s^{b-1} / scale^2 (embedder.rs:1216-1222)."""
    if b == 1.0:
        cauchy = 1.0 / (1.0 + d2s)
        return 2.0 * cauchy / torch.square(scale)
    d2c = d2s.clamp_min(1e-30)
    cauchy = 1.0 / (1.0 + torch.pow(d2c, b))
    return 2.0 * b * cauchy * torch.pow(d2c, b - 1.0) / torch.square(scale)


def ce_value_dense(y: torch.Tensor, g: KGraph, probas: torch.Tensor,
                   scale: torch.Tensor, b: float = 1.0,
                   n_chunks: int = 16) -> torch.Tensor:
    """Shannon cross entropy between graph and embedded edge weights
    from the (n, k) layout (embedder.rs:1127-1163), summed over row
    chunks so the (chunk, k, d) temporaries stay bounded.  Returns a
    0-d tensor on y's device."""
    n = g.indices.shape[0]
    emb_scale = embedded_scales_from_initial(scale)
    chunk = -(-n // n_chunks)
    parts = []
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        yj = y[g.indices[r0:r1].to(torch.int64)]          # (c, k, d)
        d2s = torch.square(y[r0:r1, None, :] - yj).sum(-1) \
            / torch.square(emb_scale[r0:r1])[:, None]
        we = _cauchy_weight(d2s, b)
        w = probas[r0:r1]
        term = -w * torch.log(we) - (1.0 - w) * torch.log1p(-we)
        parts.append(term.sum())
    return torch.stack(parts).sum()
