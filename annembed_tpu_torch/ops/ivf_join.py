"""The IVF local join of the cell-sorted layout as hand-written kernels.

``ivf_join`` computes, for DistL2, what knn/ivf.py's torch join
(``_ivf_join_sorted``) computes: for every query position of every
virtual row of the row plan, the k nearest candidates of the windows of
the cells its row probes, the query itself left out, ties to the lower
slot (probe order, then position in the window), selected on
sqrt(max(|q|^2 + |c|^2 - 2 q.c, 0)) with the cross product in ``dtype``
and reranked by the exact f32 distance.  On CUDA tensors it launches one
of two kernels once, by shape (``join_route``): ``csrc/ivf_join_tc.cu``,
the cross products on the tensor cores (bf16 ``wgmma``, or 3xTF32 for
f32) and the running top-k filtered in the accumulator's registers, or
``csrc/ivf_join.cu``, one query a thread on the CUDA cores, for the
shapes where the first measured slower; a failed build or launch
raises.  On
CPU tensors it runs ``ivf_join_reference``, which is that torch join.
The JAX package runs the join as an XLA ``lax.map`` of jnp code
(annembed_tpu/knn/ivf.py:159-230); it has no Pallas kernel for it.

Outputs are (n, k): idx int32 sorted positions, dist float32, a row
with fewer than k candidates ending in dist = inf (the kernels' id
there is n; the twin's may be any), before the caller's
``_fixup_underfilled``.  With ``rank`` / ``size`` only the virtual rows
rank, rank + size, ... are joined and the other rows are 0, for a
mesh's ``all_reduce_sum``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import count, counters, reset_counters
from ._build import load_library
from .dense_sweep import _need

#: the prefix of the join kernels' launch counters in the registry
PREFIX = "ops.ivf_join."

_F32, _I32 = torch.float32, torch.int32
#: two joins agree when their ids differ only where the ranked values
#: (|q|^2 + |c|^2) - 2 q.c are within TIE_REL of |q|^2 + |c|^2 (the
#: expansion rounds at that scale, in another summation order on each
#: side), and the exact distances of common ids within DIST_REL
TIE_REL, DIST_REL = 1e-5, 1e-5
#: The rule sends a join to the tensor-core kernel where that kernel
#: measured faster than the SIMT kernel, else to the SIMT kernel, which
#: serves every d and k.  TC_MAX_D: the padded operand row (d + 3 bf16 or
#: d + 1 TF32 columns) fits in 32.  TC_MIN_D: for each register list (k <=
#: 12, k <= 24), the least d the tensor-core kernel takes.  TC_MAX_K: a
#: 32-slot list (k 25-32, one warpgroup a block) was slower at every d, so
#: the kernel has none.  The readings: PERF.md section 5
#: (tools/torch_join_variants.py, H100 80GB HBM3 at 700 W)
TC_MAX_D, TC_MAX_K = 29, 24
TC_MIN_D = ((12, 4), (TC_MAX_K, 16))
ROUTES = ("simt", "tc")


def join_route(device_type: str, layout: str, distance: str, d: int,
               k: int) -> str:
    """Where the local join of (device, layout, metric, d, k) runs:
    "torch" (the torch join of knn/ivf.py: the CPU, the gathered layout,
    the four other metrics), "tc" (``csrc/ivf_join_tc.cu``: the
    cell-sorted DistL2 join on a CUDA tensor at 4 <= d <= TC_MAX_D for k
    <= 12 and 16 <= d <= TC_MAX_D for 12 < k <= TC_MAX_K, TC_MIN_D) or
    "simt" (``csrc/ivf_join.cu``: the same join at every other d and k).
    By shape only, never because a kernel failed: a failed build or
    launch raises."""
    if (device_type, layout, distance) != ("cuda", "sorted", "DistL2"):
        return "torch"
    for most_k, least_d in TC_MIN_D:
        if k <= most_k:
            return "tc" if least_d <= d <= TC_MAX_D else "simt"
    return "simt"


def _check(xs_pad, sqnorm, qstarts, qparents, starts, counts, cell_nbrs,
           k, qcap, cap, dtype, rank, size):
    if xs_pad.dim() != 2 or xs_pad.shape[0] < 1 or xs_pad.shape[1] < 1:
        raise ValueError(f"xs_pad must be (n + 1, d), got "
                         f"{tuple(xs_pad.shape)}")
    n1, d = xs_pad.shape
    dev = xs_pad.device
    if n1 > 2 ** 31 - 1:
        raise ValueError("too many rows for int32 positions")
    _need("xs_pad", xs_pad, _F32, (n1, d), dev)
    _need("sqnorm", sqnorm, _F32, (n1,), dev)
    _need("qstarts", qstarts, _I32, (qstarts.shape[0],), dev)
    _need("qparents", qparents, _I32, (qstarts.shape[0],), dev)
    _need("starts", starts, _I32, (starts.shape[0],), dev)
    _need("counts", counts, _I32, (starts.shape[0],), dev)
    if cell_nbrs.dim() != 2 or cell_nbrs.shape[1] < 1:
        raise ValueError(f"cell_nbrs must be (nlist, nprobe), got "
                         f"{tuple(cell_nbrs.shape)}")
    _need("cell_nbrs", cell_nbrs, _I32, tuple(cell_nbrs.shape), dev)
    if k < 1 or qcap < 1 or cap < 1:
        raise ValueError(f"k, qcap and cap must be >= 1, got {k}, {qcap}, "
                         f"{cap}")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown join dtype {dtype!r}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside [0, {size})")


def ivf_join_reference(xs_pad, sqnorm, qstarts, qparents, starts, counts,
                       cell_nbrs, k: int, qcap: int, cap: int,
                       dtype: str = "float32", rank: int = 0, size: int = 1):
    """Plain twin of the kernel: knn/ivf.py's torch join
    (``_ivf_join_sorted``, DistL2) of the virtual rows rank, rank +
    size, ...; ``sqnorm`` is unused (the torch join takes each batch's
    norms from its rows)."""
    from ..knn.ivf import _ivf_join_sorted
    _check(xs_pad, sqnorm, qstarts, qparents, starts, counts, cell_nbrs, k,
           qcap, cap, dtype, rank, size)
    return _ivf_join_sorted(xs_pad, qstarts[rank::size], qparents[rank::size],
                            starts, counts, cell_nbrs, k, qcap, cap, dtype,
                            "DistL2")


class Kernel(NamedTuple):
    """A built join library's entry points: ``launch`` (the arguments of
    ``_launch_args``, then, when ``operand_bytes`` is given (the
    tensor-core route), the operand scratch and the optional ranked
    outputs, then the stream), ``max_k(d, bf16, nprobe)`` and
    ``operand_bytes(n, d, bf16)`` (None: no scratch)."""
    launch: Callable
    max_k: Callable
    operand_bytes: Optional[Callable] = None


def _bind(lib) -> Kernel:
    """The SIMT library's launcher, typed, and its largest k."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.ivf_join_launch
    fn.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    max_k = lib.ivf_join_max_k
    max_k.argtypes = []
    max_k.restype = ctypes.c_int
    largest = max_k()
    return Kernel(fn, lambda d, bf16, nprobe: largest)


def _bind_tc(lib) -> Kernel:
    """The tensor-core library's launcher, its largest k and its operand
    scratch, typed."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.ivf_join_tc_launch
    fn.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 7 + [ptr] * 4
    fn.restype = ctypes.c_int
    max_k = lib.ivf_join_tc_max_k
    max_k.argtypes = [i32] * 3
    max_k.restype = ctypes.c_int
    nbytes = lib.ivf_join_tc_operand_bytes
    nbytes.argtypes = [i32] * 3
    nbytes.restype = ctypes.c_longlong
    return Kernel(fn, max_k, nbytes)


@functools.cache
def _kernel(route: str) -> Kernel:
    if route == "simt":
        return _bind(load_library("ivf_join"))
    if route == "tc":
        return _bind_tc(load_library("ivf_join_tc"))
    raise ValueError(f"unknown join kernel route {route!r}")


def _launch_args(xs_pad, sqnorm, qstarts, qparents, starts, counts,
                cell_nbrs, idx, dist, k, qcap, cap, dtype, rank=0, size=1):
    """The launchers' common arguments, before the scratch and stream."""
    v = qstarts.shape[0]
    rows = max(0, -(-(v - rank) // size))
    return (xs_pad.data_ptr(), sqnorm.data_ptr(), qstarts.data_ptr(),
            qparents.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            cell_nbrs.data_ptr(), idx.data_ptr(), dist.data_ptr(), rows,
            rank, size, xs_pad.shape[0] - 1, xs_pad.shape[1], k,
            cell_nbrs.shape[1], qcap, cap, int(dtype == "bfloat16"))


def _join(kernel: Kernel, stream, xs_pad, sqnorm, qstarts, qparents, starts,
          counts, cell_nbrs, k, qcap, cap, dtype="float32", rank=0, size=1,
          ranked=False):
    """The kernel branch of ``ivf_join``: checks, zeroed outputs, the
    operand scratch, one call of ``kernel.launch`` (a built library's,
    or its host build's) on ``stream``, a raise on an error; no count
    moves.  Returns (idx, dist), and with ``ranked`` (the tensor-core
    route; a diagnostic of the checks, ``expansion_error``) also the ids
    and the ranked values of the selected entries before the rerank,
    (n, k) each, in selection order.  Checks that time or hold one
    route whatever the rule says call this with ``_kernel(route)``."""
    _check(xs_pad, sqnorm, qstarts, qparents, starts, counts, cell_nbrs, k,
           qcap, cap, dtype, rank, size)
    n1, d = xs_pad.shape
    bf16 = int(dtype == "bfloat16")
    largest = kernel.max_k(d, bf16, cell_nbrs.shape[1])
    if k > largest:
        raise ValueError(f"k={k} above the join kernel's largest, {largest}")
    dev = xs_pad.device
    idx = torch.zeros((n1 - 1, k), dtype=_I32, device=dev)
    dist = torch.zeros((n1 - 1, k), dtype=_F32, device=dev)
    args = _launch_args(xs_pad, sqnorm, qstarts, qparents, starts, counts,
                        cell_nbrs, idx, dist, k, qcap, cap, dtype, rank, size)
    scratch, out = None, (idx, dist)
    if ranked:
        if kernel.operand_bytes is None:
            raise ValueError("only the tensor-core route reports ranked "
                             "values")
        out += (torch.zeros_like(idx), torch.zeros_like(dist))
    if kernel.operand_bytes is not None:
        scratch = torch.empty(kernel.operand_bytes(n1 - 1, d, bf16),
                              dtype=torch.uint8, device=dev)
        args += (scratch.data_ptr(),
                 out[3].data_ptr() if ranked else None,
                 out[2].data_ptr() if ranked else None)
    err = kernel.launch(*args, stream)
    del scratch
    if err != 0:
        raise RuntimeError(f"ivf_join kernel launch failed: CUDA error {err}")
    return out


def ivf_join(xs_pad, sqnorm, qstarts, qparents, starts, counts, cell_nbrs,
             k: int, qcap: int, cap: int, dtype: str = "float32",
             rank: int = 0, size: int = 1):
    """The DistL2 join of the cell-sorted layout: ``xs_pad`` (n + 1, d)
    float32 the corpus in cell order and a zero row, ``sqnorm`` (n + 1,)
    its ``corpus_sqnorm``; the row plan of ``_ivf_rowplan_impl``
    (``qstarts``, ``qparents`` (V,)), ``starts`` / ``counts`` (cells,)
    with the sentinel empty cell where ``cell_nbrs`` (nlist, nprobe) holds
    it, all int32.  Returns (idx (n, k) int32, dist (n, k) float32).

    CUDA tensors launch once the kernel that ``join_route`` gives (d, k),
    adding one to its count in ``launch_counts()``; a build or launch the
    card refuses raises.  CPU tensors run ``ivf_join_reference``."""
    if xs_pad.device.type != "cuda":
        return ivf_join_reference(xs_pad, sqnorm, qstarts, qparents, starts,
                                  counts, cell_nbrs, k, qcap, cap, dtype,
                                  rank, size)
    route = join_route("cuda", "sorted", "DistL2", xs_pad.shape[1], k)
    with torch.cuda.device(xs_pad.device):
        out = _join(_kernel(route),
                    torch.cuda.current_stream(xs_pad.device).cuda_stream,
                    xs_pad, sqnorm, qstarts, qparents, starts, counts,
                    cell_nbrs, k, qcap, cap, dtype, rank, size)
    count(PREFIX + route)
    return out


def launch_counts() -> dict:
    """Launches of each join kernel since the last reset: ``simt`` and
    ``tc`` (the registry counters ``ops.ivf_join.<route>``)."""
    c = counters(PREFIX)
    return {route: c.get(route, 0) for route in ROUTES}


def reset_launch_counts() -> None:
    reset_counters(PREFIX)


def ranked_value(xs_pad, qpos, cpos, dtype: str):
    """The value the join ranks before its square root, exact in float64:
    max((|q|^2 + |c|^2) - 2 q.c, 0) of rows ``qpos`` and ``cpos``
    (broadcast) of ``xs_pad``, the norms from the f32 rows and the
    product of the operands rounded to ``dtype``; and the scale |q|^2 +
    |c|^2.  Every candidate whose expansion cancels to 0 or below ranks
    at 0, tied with the others there (bf16 products make that common
    among near neighbours: slot order decides)."""
    q, c = xs_pad[qpos], xs_pad[cpos]
    scale = (torch.square(q.double()).sum(-1)
             + torch.square(c.double()).sum(-1))
    if dtype == "bfloat16":
        q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    e = scale - 2.0 * (q.double() * c.double()).sum(-1)
    return e.clamp_min(0.0), scale


def join_agreement(xs_pad, dtype: str, got_i, got_d, want_i, want_d):
    """How two joins' (n, k) graphs (ids in sorted-position space, both
    through ``_fixup_underfilled``) agree: ``mismatch_rows``, rows whose
    id sets differ outside near-ties (the ids one side has and the other
    lacks, each side's sorted by ranked value, differ pairwise by more
    than TIE_REL of |q|^2 + |c|^2, or are not as many); ``near_tie_rows``,
    rows whose sets differ only within near-ties; ``max_rel_dist_err``,
    the largest relative difference of the distances of common ids;
    ``unsorted_rows`` of ``got``; ``mismatch_ids``, the first 20
    mismatched rows.  Rows go in chunks on the graphs' device."""
    n, k = got_i.shape
    chunk = max(1, (1 << 25) // (k * k))
    out = dict(rows=n, mismatch_rows=0, near_tie_rows=0,
               max_rel_dist_err=0.0, unsorted_rows=0, mismatch_ids=[])
    for r0 in range(0, n, chunk):
        gi, wi = got_i[r0:r0 + chunk].long(), want_i[r0:r0 + chunk].long()
        gd, wd = got_d[r0:r0 + chunk], want_d[r0:r0 + chunk]
        eq = gi[:, :, None] == wi[:, None, :]
        in_w, in_g = eq.any(2), eq.any(1)
        wd_at = wd.gather(1, eq.int().argmax(2))
        rel = ((gd - wd_at).abs() / wd_at.abs().clamp_min(1e-30))[in_w]
        if rel.numel():
            out["max_rel_dist_err"] = max(out["max_rel_dist_err"],
                                          float(rel.max()))
        out["unsorted_rows"] += int((gd.diff(dim=1) < 0).any(1).sum())
        rows = (~(in_w.all(1) & in_g.all(1))).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        qpos = (rows + r0)[:, None]
        extra = []
        for ids, kept in ((gi[rows], in_w[rows]), (wi[rows], in_g[rows])):
            v, scale = ranked_value(xs_pad, qpos, ids, dtype)
            v = v.masked_fill(kept, float("inf"))
            order = v.argsort(1)
            extra.append((v.gather(1, order), scale.gather(1, order),
                          (~kept).sum(1)))
        (vg, sg, ng), (vw, sw, nw) = extra
        listed = torch.arange(k, device=rows.device)[None, :] < ng[:, None]
        gap = ((vg - vw).abs() > TIE_REL * torch.maximum(sg, sw)) & listed
        bad = (ng != nw) | gap.any(1)
        out["mismatch_rows"] += int(bad.sum())
        out["mismatch_ids"] += (rows[bad] + r0)[:20].tolist()
        out["mismatch_ids"] = out["mismatch_ids"][:20]
        out["near_tie_rows"] += int((~bad).sum())
    return out


def expansion_error(xs_pad, dtype: str, rank_i, rank_v) -> float:
    """The largest |e - e_exact| / (|q|^2 + |c|^2) over the selected
    entries of a ``ranked`` join (``rank_i`` / ``rank_v`` (n, k): ids and
    values sqrt(max(e, 0)) before the rerank; inf past a row's
    candidates): e read back as the value's square, e_exact by
    ``ranked_value`` in float64, both clamped at 0 as the join ranks
    them.  The expansion's own rounding, against TIE_REL."""
    n, k = rank_i.shape
    chunk = max(1, (1 << 24) // k)
    worst = 0.0
    for r0 in range(0, n, chunk):
        v = rank_v[r0:r0 + chunk].double()
        ids = rank_i[r0:r0 + chunk].long()
        ok = torch.isfinite(v)
        qpos = torch.arange(r0, r0 + v.shape[0], device=v.device)[:, None]
        exact, scale = ranked_value(xs_pad, qpos, ids.clamp_max(n - 1),
                                    dtype)
        err = ((v * v - exact).abs() / scale.clamp_min(1e-30))[ok]
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst

