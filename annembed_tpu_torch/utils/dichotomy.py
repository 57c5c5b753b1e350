"""Bisection root-finder for monotone functions.

Port of annembed_tpu/utils/dichotomy.py (reference
src/tools/dichotomy.rs:4 ``dichotomy_solver``): x with f(x) = target for
a monotone f on [xmin, xmax].
"""

from __future__ import annotations

from typing import Callable


def dichotomy_solver(increasing: bool, f: Callable[[float], float],
                     xmin: float, xmax: float, target: float,
                     tol: float = 1e-7, max_iter: int = 200) -> float:
    if xmin >= xmax:
        raise ValueError("xmin must be < xmax")
    lo, hi = xmin, xmax
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        v = f(mid)
        if abs(v - target) < tol:
            return mid
        if (v < target) == increasing:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
