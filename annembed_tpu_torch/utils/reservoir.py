"""Reservoir sampling (Algorithm L).

Port of annembed_tpu/utils/reservoir.py (reference
src/tools/reservoir.rs:12 ``unweighted_reservoir``): a uniform sample of
a streamed iterable in one pass, its draws from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, TypeVar

import torch

T = TypeVar("T")


def unweighted_reservoir(sample_size: int, iterable: Iterable[T],
                         generator: Optional[torch.Generator] = None,
                         seed: int = 4664397) -> List[T]:
    """Uniform sample of ``sample_size`` items in one pass (Algorithm L:
    skip ahead geometrically instead of flipping a coin per item).  The
    draws come from ``generator``, by default one seeded with ``seed``."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)

    def uniform() -> float:
        # in (0, 1): log(0) would end the skip arithmetic
        return max(torch.rand((), generator=generator, dtype=torch.float64)
                   .item(), 1e-300)

    reservoir: List[T] = []
    it = iter(iterable)
    for _ in range(sample_size):
        try:
            reservoir.append(next(it))
        except StopIteration:
            return reservoir
    w = math.exp(math.log(uniform()) / sample_size)
    while True:
        skip = math.floor(math.log(uniform()) / math.log(1.0 - w)) + 1
        try:
            for _ in range(skip - 1):
                next(it)
            item = next(it)
        except StopIteration:
            return reservoir
        slot = int(torch.randint(sample_size, (), generator=generator))
        reservoir[slot] = item
        w *= math.exp(math.log(uniform()) / sample_size)
