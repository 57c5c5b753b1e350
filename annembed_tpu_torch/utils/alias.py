"""Walker/Vose alias tables for O(1) weighted sampling.

Port of annembed_tpu/utils/alias.py (the reference's
``WeightedAliasIndex``, embedder.rs:987 for positive edges, :919 for
hubness-weighted negatives).  The tables are built on the host by the
native ``annembed_build_alias`` (native/csv_loader.cpp, compiled by
``utils/native.py``), or by the numpy copy of the same Vose loop where
there is no g++; both give the JAX package's tables bit for bit.
Sampling is two gathers and a compare on the draws' device; the draws
are arguments (uniform ids and uniforms), so a test can inject the JAX
package's.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import Tuple

import numpy as np
import torch

from .native import BACKENDS, load_library

logger = logging.getLogger(__name__)


def _numpy_alias(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose's pairing loop in Python (the host with no g++), in the
    native backend's arithmetic: a sequential float64 sum and
    ``(large + small) - 1``, so both give the same tables bit for bit."""
    n = len(weights)
    total = float(np.cumsum(weights, dtype=np.float64)[-1]) if n else 0.0
    if not np.isfinite(total) or total <= 0.0 or (weights < 0).any():
        raise ValueError(
            f"alias table needs finite non-negative weights with a "
            f"positive sum (sum={total})")
    scaled = weights.astype(np.float64) * (n / total)
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = list(np.nonzero(scaled < 1.0)[0])
    large = list(np.nonzero(scaled >= 1.0)[0])
    if n > 2_000_000 and small and large:
        logger.warning("numpy alias build at n=%d is a Python loop "
                       "(minutes); install g++ for the native build", n)
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] + scaled[s] - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


@functools.cache
def _native_alias_fn():
    """``annembed_build_alias`` of the csv loader's library, typed, or
    None."""
    lib = load_library("csv_loader")
    if lib is None:
        return None
    fn = lib.annembed_build_alias
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_int32)]
    return fn


def _native_alias(w: np.ndarray):
    """(rc, prob, alias) from ``annembed_build_alias``, or None without
    the native library."""
    fn = _native_alias_fn()
    if fn is None:
        return None
    n = len(w)
    prob = np.empty(n, np.float32)
    alias = np.empty(n, np.int32)
    rc = fn(w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return rc, prob, alias


def build_alias_table(weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prob (n,) f32, alias (n,) int32) on ``weights``' device.  Which
    backend ran ("native" or "numpy") is left in
    ``utils.native.BACKENDS["alias"]``."""
    w = np.ascontiguousarray(weights.detach().cpu().numpy(), np.float32)
    built = _native_alias(w)
    if built is not None and built[0] == -3:
        raise ValueError("alias table: weight sum is zero or NaN")
    if built is not None and built[0] == 0:
        _, prob, alias = built
        BACKENDS["alias"] = "native"
    else:
        if built is not None:
            logger.warning("native alias build failed rc=%d; numpy build",
                           built[0])
        prob, alias = _numpy_alias(w)
        BACKENDS["alias"] = "numpy"
    dev = weights.device
    return torch.from_numpy(prob).to(dev), torch.from_numpy(alias).to(dev)


def alias_sample(prob: torch.Tensor, alias: torch.Tensor, ids: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Indices distributed as the table's weights, from uniform ``ids``
    in [0, n) and uniforms ``u`` in [0, 1) of the same shape (JAX:
    ``randint`` and ``uniform`` of the two halves of the key)."""
    return torch.where(u < prob[ids], ids, alias[ids])
