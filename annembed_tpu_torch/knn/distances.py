"""Batched L2 distance panels.

Port of the DistL2 half of annembed_tpu/knn/distances.py.  A *panel* is
the (b, m) distance matrix between a query block and the whole corpus,
formed as sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0)) so its O(b m d) work is one
matmul.  That matmul must run in full f32: the package turns TF32 off
(device.py), the counterpart of the JAX package's Precision.HIGHEST at
d <= 32.  DistL1, DistCosine, DistJeffreys and DistJensenShannon are not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

_PORTED = ("DistL2",)
#: bound on one (rows, m) f32 panel
PANEL_BYTES = 1 << 30


def check_distance(distance: str) -> None:
    if distance not in _PORTED:
        raise NotImplementedError(
            f"distance {distance!r} is not ported yet (ROADMAP: the four "
            "non-L2 metrics); the port supports DistL2")


def panel_rows(m: int, cap: int) -> int:
    """Query rows per (rows, m) panel: at most ``cap``, within
    PANEL_BYTES."""
    return max(1, min(cap, PANEL_BYTES // max(4 * m, 1)))


def l2_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcastable exact L2 distance over the last axis."""
    return torch.sqrt(torch.square(a - b).sum(-1).clamp_min(0.0))


def corpus_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, shared across panels."""
    return torch.square(x.to(torch.float32)).sum(-1)


def l2_expansion(q: torch.Tensor, x: torch.Tensor,
                 x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """|q_i|^2 + |x_j|^2 - 2 q_i.x_j as a (b, m) panel in one (b, m)
    buffer, unclamped.  Rounds as the JAX form (q_sq + x_sq) - 2 cross
    does: the sum first, then the exact doubled product subtracted."""
    q_sq = torch.square(q).sum(-1)
    if x_sqnorm is None:
        x_sqnorm = corpus_sqnorm(x)
    d2 = q_sq[:, None] + x_sqnorm[None, :]
    return d2.addmm_(q, x.T, alpha=-2.0)


def l2_panel_sq(q: torch.Tensor, x: torch.Tensor,
                x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """max(|q_i|^2 + |x_j|^2 - 2 q_i.x_j, 0) as a (b, m) panel."""
    return l2_expansion(q, x, x_sqnorm).clamp_min_(0.0)


def l2_panel(q: torch.Tensor, x: torch.Tensor,
             x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean distances |q_i - x_j| as a (b, m) panel (hnsw_rs
    ``DistL2``: the true norm, not its square)."""
    return l2_panel_sq(q, x, x_sqnorm).sqrt_()
