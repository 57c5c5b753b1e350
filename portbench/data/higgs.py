"""The Higgs stand-in: 32 Gaussian clusters in an 8-d latent, lifted to
28 columns with noise, then z-scored per column (the UCI HIGGS table's
shape, 28 float32 features; the rescale of upstream examples/higgs.rs
:158-176).  A torch rewrite, made on the device from the seed, of the
recipe the port's records use for the same stand-in."""

from __future__ import annotations

import torch


def make(n: int, d: int, seed: int, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(rows (n, d) float32, cluster label of each row (n,) int64)."""
    if d != 28:
        raise ValueError(f"the Higgs stand-in has 28 columns, not {d}")
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((32, 8), generator=g, device=device) * 4.0
    labels = torch.randint(0, 32, (n,), generator=g, device=device)
    latent = centers[labels] + torch.randn((n, 8), generator=g,
                                           device=device)
    lift = torch.randn((8, d), generator=g, device=device)
    x = torch.addmm(torch.randn((n, d), generator=g, device=device),
                    latent, lift, beta=0.3)
    del latent
    mean = x.mean(0, dtype=torch.float64)
    std = _std(x, mean)
    x -= mean.to(torch.float32)
    x /= std.clamp_min(1e-12).to(torch.float32)
    return x, labels


def _std(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Population standard deviation per column in float64, in row
    blocks so that no float64 copy of the table is made."""
    acc = torch.zeros_like(mean)
    for r0 in range(0, x.shape[0], 1 << 20):
        acc += torch.square(x[r0:r0 + (1 << 20)].to(torch.float64)
                            - mean).sum(0)
    return torch.sqrt(acc / x.shape[0])
