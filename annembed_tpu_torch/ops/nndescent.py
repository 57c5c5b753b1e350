"""One NN-descent round's local join as a hand-written kernel.

``nndescent_round`` computes what knn/nndescent.py's torch chain
(``_nndescent_slab``, slab after slab) computes for one round: for every
row, the candidates ``inner_pp[inner_pp[i]]`` and ``union_pp[i]`` in id
order, pads, self, repeats and ids already listed left at +inf, the rest
scored by the metric's pair form, and the k smallest (distance,
position) of the current list and the candidates.  It runs where
``round_route`` sends the shape: DistL2 on a CUDA tensor within the
kernel's limits launches ``csrc/nndescent.cu`` once over every row (a
failed build or launch raises); everything else runs
``nndescent_round_reference``, that torch chain.  The JAX package runs
the round as XLA code (annembed_tpu/knn/nndescent.py:87-165
``_nndescent_slab``); it has no Pallas kernel for it.

Both routes add the candidates they score to ``pairs`` (an int64 tensor
on the rows' device), and each round adds one to its route's counter in
``launch_counts()``.  With ``rank`` / ``size`` only the rows of the
slabs rank, rank + size, ... of ``slab`` rows are computed and the
others are 0, for a mesh's ``all_reduce_sum``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count, counters, reset_counters
from ._build import load_library
from .dense_sweep import _need

#: the prefix of the rounds' route counters in the registry
PREFIX = "ops.nndescent."
ROUTES = ("kernel", "torch")
#: The kernel's limits: k <= MAX_K (one list entry a lane), s^2 + u <=
#: MAX_C candidates a row (sorted as 256 or 512 ids in a warp's
#: registers), d <= MAX_D (the query in the warp's shared slice).  The
#: readings: PERF.md section 6 (chip_smoke phase 3d)
MAX_K, MAX_C, MAX_D = 32, 512, 256
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def round_route(device_type: str, distance: str, dtype: str, k: int, c: int,
                d: int) -> str:
    """Where a round of (device, metric, scoring dtype, k, candidates a
    row c = s^2 + u, d) runs: "kernel" (``csrc/nndescent.cu``: DistL2 on a
    CUDA tensor, bf16 or f32, k <= MAX_K, c <= MAX_C, d <= MAX_D) or
    "torch" (the slab chain: the CPU, the four other metrics, larger
    shapes).  By shape only, never because the kernel failed: a failed
    build or launch raises."""
    if (device_type, distance) != ("cuda", "DistL2"):
        return "torch"
    if dtype not in ("float32", "bfloat16"):
        return "torch"
    return "kernel" if k <= MAX_K and c <= MAX_C and d <= MAX_D else "torch"


def _check(x_pad, inner_pp, union_pp, indices, dists, slab, rank, size,
           pairs):
    if x_pad.dim() != 2 or x_pad.shape[0] < 1 or x_pad.shape[1] < 1:
        raise ValueError(f"x_pad must be (n + 1, d), got "
                         f"{tuple(x_pad.shape)}")
    n1, d = x_pad.shape
    dev = x_pad.device
    if x_pad.dtype not in _DTYPES:
        raise TypeError(f"x_pad must be float32 or bfloat16, got "
                        f"{x_pad.dtype}")
    if n1 > 2 ** 31 - 1:
        raise ValueError("too many rows for int32 ids")
    _need("x_pad", x_pad, x_pad.dtype, (n1, d), dev)
    if inner_pp.dim() != 2 or union_pp.dim() != 2:
        raise ValueError("inner_pp and union_pp must be 2-D tables")
    _need("inner_pp", inner_pp, torch.int32, (n1, inner_pp.shape[1]), dev)
    _need("union_pp", union_pp, torch.int32, (n1, union_pp.shape[1]), dev)
    if indices.dim() != 2 or indices.shape[1] < 1:
        raise ValueError(f"indices must be (n, k), got "
                         f"{tuple(indices.shape)}")
    _need("indices", indices, torch.int32, (n1 - 1, indices.shape[1]), dev)
    _need("dists", dists, torch.float32, tuple(indices.shape), dev)
    if pairs is not None:
        _need("pairs", pairs, torch.int64, (), dev)
    if slab < 1:
        raise ValueError(f"slab must be >= 1, got {slab}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside [0, {size})")


def _outputs(indices, dists, size):
    """The round's output tables: zero-filled where a mesh's ranks sum
    their partial tables."""
    make = torch.empty_like if size == 1 else torch.zeros_like
    return make(indices), make(dists)


def nndescent_round_reference(x_pad, inner_pp, union_pp, indices, dists,
                              slab: int, distance: str = "DistL2",
                              rank: int = 0, size: int = 1, pairs=None):
    """Plain twin of the kernel: knn/nndescent.py's ``_nndescent_slab``
    over the slabs rank, rank + size, ... of ``slab`` rows, in any of
    the five metrics."""
    from ..knn.nndescent import _nndescent_slab
    _check(x_pad, inner_pp, union_pp, indices, dists, slab, rank, size,
           pairs)
    n, k = indices.shape
    out_i, out_d = _outputs(indices, dists, size)
    for s0 in range(0, n, slab)[rank::size]:
        s1 = min(s0 + slab, n)
        rid = torch.arange(s0, s1, dtype=torch.int32, device=indices.device)
        out_i[s0:s1], out_d[s0:s1] = _nndescent_slab(
            x_pad, inner_pp, indices[s0:s1], dists[s0:s1], inner_pp[s0:s1],
            union_pp[s0:s1], rid, k, distance, pairs)
    return out_i, out_d


def _bind(lib):
    """The library's launcher, typed."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.nndescent_round_launch
    fn.argtypes = [ptr] * 8 + [i32] * 6 + [i64, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return _bind(load_library("nndescent"))


def _round(launch, stream, x_pad, inner_pp, union_pp, indices, dists,
           slab: int, rank: int = 0, size: int = 1, pairs=None):
    """The kernel branch of ``nndescent_round``: checks, the outputs, one
    call of ``launch`` (the built library's, or its host build's) on
    ``stream``, a raise on an error; no count moves.  Checks that hold
    or time the kernel whatever the rule says call this with
    ``_kernel()``."""
    _check(x_pad, inner_pp, union_pp, indices, dists, slab, rank, size,
           pairs)
    n, k = indices.shape
    d = x_pad.shape[1]
    s, u = inner_pp.shape[1], union_pp.shape[1]
    if k > MAX_K or s * s + u > MAX_C or d > MAX_D:
        raise ValueError(f"k {k}, {s * s + u} candidates or d {d} above "
                         f"the round kernel's {MAX_K}, {MAX_C}, {MAX_D}")
    # at d % 4 == 0 the kernel reads four columns a load (8 or 16 bytes)
    vec = 4 * x_pad.element_size()
    if d % 4 == 0 and x_pad.data_ptr() % vec:
        raise ValueError(f"x_pad's rows must start on a {vec}-byte "
                         f"boundary at d % 4 == 0 (a fresh tensor does)")
    out_i, out_d = _outputs(indices, dists, size)
    err = launch(x_pad.data_ptr(), inner_pp.data_ptr(), union_pp.data_ptr(),
                 indices.data_ptr(), dists.data_ptr(), out_i.data_ptr(),
                 out_d.data_ptr(),
                 None if pairs is None else pairs.data_ptr(), n, d, k, s, u,
                 int(x_pad.dtype == torch.bfloat16), slab, rank, size,
                 stream)
    if err != 0:
        raise RuntimeError(f"nndescent round kernel launch failed: CUDA "
                           f"error {err}")
    return out_i, out_d


def nndescent_round(x_pad, inner_pp, union_pp, indices, dists, slab: int,
                    distance: str = "DistL2", rank: int = 0, size: int = 1,
                    pairs=None):
    """One round's local join: ``x_pad`` (n + 1, d) the scoring rows
    (float32 or bfloat16) and a zero row; ``inner_pp`` (n + 1, s) the
    sampled and ``union_pp`` (n + 1, u) the whole padded neighbourhood,
    int32; ``indices`` (n, k) int32 / ``dists`` (n, k) float32 the
    current lists; ``pairs`` an int64 scalar tensor the scored candidates
    are added to, or None.  Returns the new (indices, dists).

    The route ``round_route`` gives the shape runs, adding one to its
    count in ``launch_counts()``: the kernel launches once over the
    rows (a build or launch the card refuses raises); the torch chain
    runs ``slab`` rows at a time."""
    k = indices.shape[1]
    c = inner_pp.shape[1] ** 2 + union_pp.shape[1]
    route = round_route(x_pad.device.type, distance,
                        _DTYPES.get(x_pad.dtype, str(x_pad.dtype)), k, c,
                        x_pad.shape[1])
    if route == "torch":
        out = nndescent_round_reference(x_pad, inner_pp, union_pp, indices,
                                        dists, slab, distance, rank, size,
                                        pairs)
    else:
        with torch.cuda.device(x_pad.device):
            out = _round(_kernel(),
                         torch.cuda.current_stream(x_pad.device).cuda_stream,
                         x_pad, inner_pp, union_pp, indices, dists, slab,
                         rank, size, pairs)
    count(PREFIX + route)
    return out


def launch_counts() -> dict:
    """Rounds served by each route since the last reset: ``kernel`` and
    ``torch`` (the registry counters ``ops.nndescent.<route>``)."""
    c = counters(PREFIX)
    return {route: c.get(route, 0) for route in ROUTES}


def reset_launch_counts() -> None:
    reset_counters(PREFIX)
