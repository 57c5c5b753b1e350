"""Batched distance panels for the five hnsw_rs metrics.

Port of annembed_tpu/knn/distances.py.  A *panel* is the (b, m) distance
matrix between a query block and the whole corpus.  DistL2 and
DistCosine are one matmul each: L2 as sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0)),
cosine as 1 - q.x / (|q| |x|).  As f32 those matmuls must run in full
f32: the package turns TF32 off (device.py), the counterpart of the JAX
package's Precision.HIGHEST at d <= 32.  With ``dtype="bfloat16"`` the
cross product's operands are cast to bf16 and accumulated in f32, while
the norms still come from the f32 rows.  A panel function also takes a
batch: q (r, b, d) against x (r, m, d) gives (r, b, m).  DistL1,
DistJeffreys and DistJensenShannon are elementwise: each is its
broadcastable pair form tiled over the corpus, so a panel and a
gather-style join cannot drift.  Semantics are
hnsw_rs's: cosine is 0 when either norm is 0, Jeffreys clamps components
at 1e-30, Jensen-Shannon returns the square root of the divergence.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-12
#: probability-vector clamp of hnsw_rs (distances.rs ``M_MIN``)
_M_MIN = 1.0e-30
#: bound on one (rows, m) f32 panel, and on one (rows, tile, d) f32
#: intermediate of an elementwise panel
PANEL_BYTES = 1 << 30


def panel_rows(m: int, cap: int) -> int:
    """Query rows per (rows, m) panel: at most ``cap``, within
    PANEL_BYTES."""
    return max(1, min(cap, PANEL_BYTES // max(4 * m, 1)))


# --- broadcastable pair forms: one formula per metric ---------------------

def l2_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcastable exact L2 distance over the last axis."""
    return torch.sqrt(torch.square(a - b).sum(-1).clamp_min(0.0))


def l1_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).sum(-1)


def cosine_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = (a * b).sum(-1)
    na = torch.sqrt(torch.square(a).sum(-1))
    nb = torch.sqrt(torch.square(b).sum(-1))
    cos = num / (na * nb).clamp_min(_EPS)
    return torch.where((na <= 0.0) | (nb <= 0.0), 0.0, 1.0 - cos)


def jeffreys_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ratio = a.clamp_min(_M_MIN) / b.clamp_min(_M_MIN)
    return ((a - b) * torch.log(ratio)).sum(-1)


def _xlogy(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """p * log(r) with 0 log 0 = 0."""
    return torch.where(p > 0.0, p * torch.log(r.clamp_min(_EPS)), 0.0)


def js_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = (0.5 * (a + b)).clamp_min(_EPS)
    js = 0.5 * _xlogy(a, a / m).sum(-1) + 0.5 * _xlogy(b, b / m).sum(-1)
    return torch.sqrt(js.clamp_min(0.0))


_PAIRS = {
    "DistL2": l2_pair,
    "DistL1": l1_pair,
    "DistCosine": cosine_pair,
    "DistJeffreys": jeffreys_pair,
    "DistJensenShannon": js_pair,
}


def check_distance(distance: str) -> None:
    if distance not in _PAIRS:
        raise ValueError(f"unknown distance {distance!r}; valid: "
                         f"{sorted(_PAIRS)}")


def get_pair_fn(distance: str):
    """Broadcastable pair-distance dispatch (same names as panels)."""
    check_distance(distance)
    return _PAIRS[distance]


# --- matmul panels ---------------------------------------------------------

def corpus_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, shared across panels (L2 and cosine)."""
    return torch.square(x.to(torch.float32)).sum(-1)


def cross_product(q: torch.Tensor, x: torch.Tensor,
                  dtype: str = "float32") -> torch.Tensor:
    """q x^T over the last two axes, operands in ``dtype``, accumulated
    and returned in f32 (``jnp.dot(..., preferred_element_type=f32)``).
    A product of two bf16 values is exact in f32, so on the CPU the bf16
    form is the f32 product of the rounded operands; on the card it is
    the tensor cores' bf16 product with an f32 result."""
    if dtype == "float32":
        return q @ x.mT
    if dtype != "bfloat16":
        raise ValueError(f"unknown panel dtype {dtype!r}")
    qb, xb = q.to(torch.bfloat16), x.to(torch.bfloat16)
    if q.device.type != "cuda":
        return qb.to(torch.float32) @ xb.to(torch.float32).mT
    if q.dim() == 2:
        return torch.mm(qb, xb.T, out_dtype=torch.float32)
    return torch.bmm(qb, xb.mT, out_dtype=torch.float32)


def l2_expansion(q: torch.Tensor, x: torch.Tensor,
                 x_sqnorm: torch.Tensor | None = None,
                 dtype: str = "float32") -> torch.Tensor:
    """|q_i|^2 + |x_j|^2 - 2 q_i.x_j as a (b, m) panel (or a batch of
    them, (r, b, m)), unclamped.  Rounds as the JAX form
    (q_sq + x_sq) - 2 cross does: the sum first, then the exact doubled
    product subtracted.  The norms always come from the f32 rows; only
    the cross product's operands are cast to ``dtype``."""
    q_sq = torch.square(q).sum(-1)
    if x_sqnorm is None:
        x_sqnorm = corpus_sqnorm(x)
    d2 = q_sq[..., :, None] + x_sqnorm[..., None, :]
    if dtype != "float32":
        return d2.sub_(cross_product(q, x, dtype), alpha=2.0)
    if q.dim() == 2:
        return d2.addmm_(q, x.T, alpha=-2.0)
    return d2.baddbmm_(q, x.mT, alpha=-2.0)


def l2_panel_sq(q: torch.Tensor, x: torch.Tensor,
                x_sqnorm: torch.Tensor | None = None,
                dtype: str = "float32") -> torch.Tensor:
    """max(|q_i|^2 + |x_j|^2 - 2 q_i.x_j, 0) as a (b, m) panel."""
    return l2_expansion(q, x, x_sqnorm, dtype).clamp_min_(0.0)


def l2_panel(q: torch.Tensor, x: torch.Tensor,
             x_sqnorm: torch.Tensor | None = None,
             dtype: str = "float32") -> torch.Tensor:
    """Euclidean distances |q_i - x_j| as a (b, m) panel (hnsw_rs
    ``DistL2``: the true norm, not its square)."""
    return l2_panel_sq(q, x, x_sqnorm, dtype).sqrt_()


def cosine_panel(q: torch.Tensor, x: torch.Tensor,
                 x_sqnorm: torch.Tensor | None = None,
                 dtype: str = "float32") -> torch.Tensor:
    """1 - cos(q_i, x_j) as a (b, m) panel, 0 where a norm is 0."""
    q_n = torch.sqrt(torch.square(q).sum(-1))
    if x_sqnorm is None:
        x_sqnorm = corpus_sqnorm(x)
    x_n = torch.sqrt(x_sqnorm)
    denom = (q_n[..., :, None] * x_n[..., None, :]).clamp_min_(_EPS)
    cos = cross_product(q, x, dtype).div_(denom)
    zero = (q_n[..., :, None] <= 0.0) | (x_n[..., None, :] <= 0.0)
    return torch.where(zero, 0.0, 1.0 - cos)


# --- elementwise panels ----------------------------------------------------

def _tiled_panel(q: torch.Tensor, x: torch.Tensor, pair_fn) -> torch.Tensor:
    """(b, m) panel of ``pair_fn`` (or a batch of panels, (r, b, m)) over
    corpus tiles whose (r, b, tile, d) intermediate fits PANEL_BYTES."""
    *lead, b, d = q.shape
    m = x.shape[-2]
    rows = b * max(1, q.numel() // max(b * d, 1))
    tile = max(1, PANEL_BYTES // max(4 * rows * d, 1))
    out = torch.empty((*lead, b, m), dtype=torch.float32, device=q.device)
    for t0 in range(0, m, tile):
        out[..., t0:t0 + tile] = pair_fn(q[..., :, None, :],
                                         x[..., None, t0:t0 + tile, :])
    return out


def l1_panel(q, x, x_sqnorm=None, dtype="float32") -> torch.Tensor:
    """L1 (Manhattan) distance panel, hnsw_rs ``DistL1`` (elementwise:
    ``dtype`` does not apply)."""
    return _tiled_panel(q, x, l1_pair)


def jeffreys_panel(q, x, x_sqnorm=None, dtype="float32") -> torch.Tensor:
    """Jeffreys divergence sum_i (p_i - q_i) ln(p_i / q_i) for probability
    vectors (hnsw_rs ``DistJeffreys``)."""
    return _tiled_panel(q, x, jeffreys_pair)


def jensenshannon_panel(q, x, x_sqnorm=None, dtype="float32") -> torch.Tensor:
    """sqrt of the Jensen-Shannon divergence (hnsw_rs
    ``DistJensenShannon``)."""
    return _tiled_panel(q, x, js_pair)


_PANELS = {
    "DistL2": l2_panel,
    "DistL1": l1_panel,
    "DistCosine": cosine_panel,
    "DistJeffreys": jeffreys_panel,
    "DistJensenShannon": jensenshannon_panel,
}
#: metrics whose panels take the precomputed corpus |x|^2
USES_SQNORM = ("DistL2", "DistCosine")


def get_panel_fn(distance: str):
    """Distance dispatch mirroring reference bin/embed.rs:546-565."""
    check_distance(distance)
    return _PANELS[distance]
