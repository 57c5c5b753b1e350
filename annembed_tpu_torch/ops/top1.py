"""Fused L2 distance + running top-1: the nearest corpus row per query.

Used by the hierarchical projection (every point -> nearest sampled
point, knn/hierarchy.py; reference kgproj.rs:195-237).  ``top1_l2``
launches the hand-written CUDA kernel ``csrc/top1_l2.cu`` on CUDA
tensors (port of annembed_tpu/ops/top1.py::_top1_kernel) and its plain
twin ``top1_l2_reference`` on CPU tensors.  Ties go to the lowest
corpus index in both.
"""

from __future__ import annotations

import ctypes

import torch

from ..knn.distances import corpus_sqnorm, l2_expansion, panel_rows
from ..utils.profiling import count, counters, reset_counters
from ._build import load_library

#: the registry counter of the kernel's launches
LAUNCHES = "ops.top1_l2.launches"


def _check(queries: torch.Tensor, corpus: torch.Tensor) -> None:
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[0] >= 2 ** 31:
            raise ValueError(f"{name} has too many rows for int32 indices")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on "
                         f"{corpus.device}")
    if queries.shape[1] != corpus.shape[1] or corpus.shape[1] == 0:
        raise ValueError(f"feature widths {queries.shape[1]} and "
                         f"{corpus.shape[1]} must match and be > 0")
    if corpus.shape[0] == 0:
        raise ValueError("empty corpus")


def top1_l2_reference(queries: torch.Tensor, corpus: torch.Tensor):
    """Plain twin of the kernel: the same unclamped expansion per query
    block, ``min`` over the whole corpus row (first minimum = lowest
    index), ``sqrt(max(d^2, 0))``.  Returns (idx int32, dist f32)."""
    _check(queries, corpus)
    c_sq = corpus_sqnorm(corpus)
    br = panel_rows(corpus.shape[0], queries.shape[0])
    idx_parts, dist_parts = [], []
    for r0 in range(0, queries.shape[0], br):
        d2, idx = torch.min(l2_expansion(queries[r0:r0 + br], corpus, c_sq),
                            dim=1)
        idx_parts.append(idx.to(torch.int32))
        dist_parts.append(torch.sqrt(d2.clamp_min(0.0)))
    if not idx_parts:
        return (torch.empty(0, dtype=torch.int32, device=queries.device),
                torch.empty(0, dtype=torch.float32, device=queries.device))
    return torch.cat(idx_parts), torch.cat(dist_parts)


def _kernel():
    lib = load_library("top1_l2")
    fn = lib.top1_l2_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.top1_l2_scratch_floats
    scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def top1_l2(queries: torch.Tensor, corpus: torch.Tensor):
    """Nearest corpus row for each query: (idx (nq,) int32, dist (nq,)).

    CUDA tensors launch the CUDA kernel (3xTF32 on the tensor cores; a
    failed build or launch raises); CPU tensors run
    ``top1_l2_reference``.  Each kernel launch adds one to
    ``launch_count()``."""
    _check(queries, corpus)
    if queries.device.type == "cpu":
        return top1_l2_reference(queries, corpus)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    nq, d = queries.shape
    m = corpus.shape[0]
    idx = torch.empty(nq, dtype=torch.int32, device=queries.device)
    dist = torch.empty(nq, dtype=torch.float32, device=queries.device)
    if nq == 0:
        return idx, dist
    launch, scratch_floats = _kernel()
    # the corpus split into TF32 hi / lo tiles, and its |c|^2
    scratch = torch.empty(scratch_floats(m, d), dtype=torch.float32,
                          device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(queries.data_ptr(), corpus.data_ptr(), nq, m, d,
                     idx.data_ptr(), dist.data_ptr(), scratch.data_ptr(),
                     stream)
    if err != 0:
        raise RuntimeError(f"top1_l2 kernel launch failed: CUDA error {err}")
    count(LAUNCHES)
    return idx, dist


def launch_count() -> int:
    """The kernel's launches since the last reset."""
    return counters().get(LAUNCHES, 0)


def reset_launch_count() -> None:
    reset_counters(LAUNCHES)
