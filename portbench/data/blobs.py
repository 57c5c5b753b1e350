"""The MNIST-digits stand-in: 10 Gaussian clusters in a 20-d latent,
linearly lifted to 784 columns with a little noise and quantised to
uint8 like MNIST pixels (the 70,000 x 784 shape of upstream README.md:92
and examples/mnist_digits.rs:66-123).  A torch rewrite, made on the
device from the seed, of the recipe the port's records use for the
bench's rows."""

from __future__ import annotations

import torch


def make(n: int, d: int, seed: int, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(rows (n, d) float32 holding the integers 0..255, cluster label
    of each row (n,) int64)."""
    g = torch.Generator(device=device).manual_seed(seed)
    latent_dim = 20
    centers = torch.randn((10, latent_dim), generator=g, device=device) * 6.0
    labels = torch.randint(0, 10, (n,), generator=g, device=device)
    z = centers[labels] + torch.randn((n, latent_dim), generator=g,
                                      device=device)
    lift = (torch.randn((latent_dim, d), generator=g, device=device)
            / latent_dim ** 0.5)
    x = torch.addmm(torch.randn((n, d), generator=g, device=device), z,
                    lift, beta=0.05)
    lo, hi = x.min(), x.max()
    x -= lo
    x *= 255.0 / (hi - lo)
    return torch.round_(x), labels
