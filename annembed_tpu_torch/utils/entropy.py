"""Entropy tools for discrete probability distributions.

Port of annembed_tpu/utils/entropy.py (reference src/tools/entropy.rs):
Renyi/Shannon entropy (:99) and relative Renyi entropy (:151).  Inputs
are tensors or anything ``torch.as_tensor`` takes; results are 0-d
float32 tensors.
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def _normalize(p) -> torch.Tensor:
    p = torch.as_tensor(p, dtype=torch.float32)
    return p / p.sum().clamp_min(_EPS)


def shannon_entropy(p) -> torch.Tensor:
    """H(p) = -sum p ln p (entropy.rs DiscreteProba::entropy order 1)."""
    p = _normalize(p)
    return -torch.where(p > 0, p * torch.log(p.clamp_min(_EPS)), 0.0).sum()


def renyi_entropy(p, order: float) -> torch.Tensor:
    """Renyi entropy of the given order; order 1 is Shannon's
    (entropy.rs:99)."""
    if order <= 0:
        raise ValueError("order must be > 0")
    if abs(order - 1.0) < 1e-9:
        return shannon_entropy(p)
    p = _normalize(p)
    s = (torch.pow(p.clamp_min(_EPS), order) * (p > 0)).sum()
    return torch.log(s.clamp_min(_EPS)) / (1.0 - order)


def relative_renyi_entropy(p, q, order: float) -> torch.Tensor:
    """Renyi divergence D_a(p || q) (entropy.rs:151); order 1 is the
    Kullback-Leibler divergence."""
    p = _normalize(p)
    q = _normalize(q)
    if abs(order - 1.0) < 1e-9:
        return torch.where(p > 0, p * torch.log(p.clamp_min(_EPS)
                                                / q.clamp_min(_EPS)),
                           0.0).sum()
    s = torch.where(p > 0, torch.pow(p.clamp_min(_EPS), order)
                    * torch.pow(q.clamp_min(_EPS), 1.0 - order), 0.0).sum()
    return torch.log(s.clamp_min(_EPS)) / (order - 1.0)


def perplexity(p) -> torch.Tensor:
    """Hill number exp(H) (nodeparam.rs:88-91)."""
    return torch.exp(shannon_entropy(p))
