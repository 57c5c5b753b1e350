"""Order statistics shared by the estimators and the hierarchy."""

from __future__ import annotations

from typing import Sequence

import torch


def quantiles(x: torch.Tensor, qs: Sequence[float]) -> list:
    """``jnp.quantile``'s linear interpolation over one sort of the
    flattened ``x``.  ``torch.quantile`` refuses more than 2^24 elements;
    the ratio array has n k of them (66M at 11M rows x 6)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    pos = torch.tensor([q * (n - 1) for q in qs], dtype=torch.float64)
    lo = pos.floor().to(torch.int64)
    hi = pos.ceil().to(torch.int64)
    w_hi = (pos - lo).to(s.device, torch.float32)
    lo_v, hi_v = s[lo.to(s.device)], s[hi.to(s.device)]
    return (lo_v * (1.0 - w_hi) + hi_v * w_hi).tolist()
