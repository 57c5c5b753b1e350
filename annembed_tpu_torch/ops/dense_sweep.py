"""Sub-sweeps of the dense CE optimizer as hand-written kernels.

``dense_attraction_rows`` moves the rows [lo, lo + rows) of an (n, d)
embedding by the closed-form attraction of their edges of one column
group; ``dense_kick_rows`` then gives those rows their n_neg repulsion
kicks against the post-attraction snapshot: one sweep, two launches.
``dense_sweeps`` runs a run of whole-array sweeps, each with its own
gamma, pool offset and column group, in one persistent launch.  On CUDA
tensors each launches its kernel of ``csrc/dense_sweep.cu`` (a failed
build or launch raises); on CPU tensors each runs its plain twin, which
is composed of optim/dense.py's ``_attraction_sweep_sfT`` and
``_repulsion_block_T``, the ports of annembed_tpu/optim/dense.py:272 and
:406 (an XLA fusion in the JAX package: it has no Pallas kernel for the
sweep).

Layout (the kernel's): coordinates are row-major (n, d); a group's edge
tables are one int32 record a row (``pack_groups``); the neighbour table
is (k, rows), int32 ids in [0, n); ``scale`` and ``neg_weight`` are
(n,).  The twins take the same arguments and transpose to the (d, n)
layout of optim/dense.py, so on the CPU they give what that module's
sweeps give, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import count, counters, reset_counters
from ._build import load_library

#: the prefix of the sweep kernels' launch counters in the registry
PREFIX = "ops.dense_sweep."

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
#: the fields of an edge record, kg words each
EDGE_FIELDS = ("idx", "w", "m", "w_rev", "m_rev", "scale_j")


def edge_words(kg: int) -> int:
    """Words of a row's edge record of kg edges: 6 kg, padded to 16
    bytes."""
    return -(-len(EDGE_FIELDS) * kg // 4) * 4


def pack_groups(idx, w, m, w_rev, m_rev, scale, n_groups: int = 1):
    """The (rows, k) edge tables of every column group (columns
    [c kg, (c + 1) kg), kg = k // n_groups) as one int32 record a row:
    the kg ids, then w, m, w_rev, m_rev and the neighbours' scales
    ``scale[idx]`` as float32 bits, kg words each, zero-padded to
    ``edge_words(kg)``.  Returns (n_groups, rows, words) int32 on idx's
    device."""
    rows, k = idx.shape
    kg = k // n_groups
    fields = len(EDGE_FIELDS) * kg
    out = torch.empty((n_groups, rows, edge_words(kg)), dtype=_I32,
                      device=idx.device)
    out[:, :, fields:] = 0
    bits = out.view(_F32)
    for c in range(n_groups):
        sl = slice(c * kg, (c + 1) * kg)
        out[c, :, :kg] = idx[:, sl]
        for f, t in enumerate((w, m, w_rev, m_rev), start=1):
            bits[c, :, f * kg:(f + 1) * kg] = t[:, sl]
        bits[c, :, 5 * kg:6 * kg] = scale[idx[:, sl].to(_I64)]
    return out


def unpack_edges(edges):
    """The six (kg, rows) tables of one group's ``pack_groups`` records
    (rows, words): idx int32, the others float32, each contiguous."""
    kg = edges.shape[1] // len(EDGE_FIELDS)
    tables = [edges[:, f * kg:(f + 1) * kg].T.contiguous()
              for f in range(len(EDGE_FIELDS))]
    return [tables[0]] + [t.view(_F32) for t in tables[1:]]


def _need(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(d: int, edges=None, **rows):
    """The kernel reads edge records as 16-byte words and, at d = 2 only,
    a row as one 8-byte word; at any other d a row slice may start
    anywhere (a node block at an odd row of a 3-D embedding does)."""
    if edges is not None and edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned")
    for name, t in rows.items():
        if d == 2 and t is not None and t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned at d = 2")


def _check_rows(y, lo: int, rows: int):
    if y.dim() != 2 or y.shape[1] == 0:
        raise ValueError(f"y must be (n, d) with d > 0, got "
                         f"{tuple(y.shape)}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    if not 0 <= lo <= lo + rows <= y.shape[0]:
        raise ValueError(f"rows [{lo}, {lo + rows}) outside [0, "
                         f"{y.shape[0]})")


def _check_edges(edges, rows, device):
    kg = edges.shape[1] // len(EDGE_FIELDS)
    if kg < 1:
        raise ValueError(f"edges must be (rows, words) records, got "
                         f"{tuple(edges.shape)}")
    _need("edges", edges, _I32, (rows, edge_words(kg)), device)
    return kg


def _check_attraction(y, y_src, lo, edges, scale, mask):
    if edges.dim() != 2:
        raise ValueError(f"edges must be (rows, words), got "
                         f"{tuple(edges.shape)}")
    _check_rows(y, lo, edges.shape[0])
    dev = y.device
    kg = _check_edges(edges, edges.shape[0], dev)
    _need("y", y, _F32, tuple(y.shape), dev)
    _need("y_src", y_src, _F32, tuple(y.shape), dev)
    _need("scale", scale, _F32, (y.shape[0],), dev)
    if mask is not None:
        _need("mask", mask, _F32, (kg, edges.shape[0]), dev)
    return kg


def _check_kick(y, a, lo, offset, idx_full, scale, n_neg, neg_weight, out):
    if a.dim() != 2 or idx_full.dim() != 2:
        raise ValueError("a must be (rows, d) and idx_full (k, rows)")
    _check_rows(y, lo, a.shape[0])
    dev, rows = y.device, a.shape[0]
    _need("y", y, _F32, tuple(y.shape), dev)
    _need("a", a, _F32, (rows, y.shape[1]), dev)
    _need("idx_full", idx_full, _I32, (idx_full.shape[0], rows), dev)
    _need("scale", scale, _F32, (y.shape[0],), dev)
    if neg_weight is not None:
        _need("neg_weight", neg_weight, _F32, (y.shape[0],), dev)
    if out is not None:
        _need("out", out, _F32, (rows, y.shape[1]), dev)
    if n_neg < 1:
        raise ValueError(f"n_neg must be >= 1, got {n_neg}")
    if not isinstance(offset, (int, np.integer)):
        raise TypeError(f"offset must be an int, got {type(offset)}")


def _check_sweeps(y, y_src, edges, scale, gammas, offsets, groups, n_neg,
                  idx_full, neg_weight):
    if edges.dim() != 3:
        raise ValueError(f"edges must be (groups, n, words), got "
                         f"{tuple(edges.shape)}")
    _check_rows(y, 0, y.shape[0])
    dev, n = y.device, y.shape[0]
    _need("y", y, _F32, tuple(y.shape), dev)
    if y_src is not None:
        _need("y_src", y_src, _F32, tuple(y.shape), dev)
    if edges.shape[1] != n:
        raise ValueError(f"edges has shape {tuple(edges.shape)}, not "
                         f"(groups, {n}, words)")
    _check_edges(edges[0], n, dev)
    if not edges.is_contiguous():
        raise ValueError("edges must be contiguous")
    steps = gammas.shape[0] if gammas.dim() == 1 else -1
    _need("gammas", gammas, _F32, (steps,), dev)
    _need("offsets", offsets, _I64, (steps,), dev)
    _need("groups", groups, _I32, (steps,), dev)
    _need("idx_full", idx_full, _I32, (idx_full.shape[0], n), dev)
    _need("scale", scale, _F32, (n,), dev)
    if neg_weight is not None:
        _need("neg_weight", neg_weight, _F32, (n,), dev)
    if n_neg < 1:
        raise ValueError(f"n_neg must be >= 1, got {n_neg}")


def _exponents(b: float):
    """b, b - 1 and 2 b as the twins' scalars reach f32 (computed in
    double, then rounded)."""
    return float(np.float32(b)), float(np.float32(b - 1.0)), \
        float(np.float32(2.0 * b))


def _bind(lib):
    """The three launchers of a built ``dense_sweep`` library, typed."""
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    att = lib.dense_attraction_launch
    att.argtypes = [ptr] * 6 + [i64, i64, i32, i32, i32] + [f32] * 6 + [ptr]
    att.restype = ctypes.c_int
    kick = lib.dense_kick_launch
    kick.argtypes = ([ptr] * 6 + [i64, i64, i64, i32, i32, i64, i64, i32]
                     + [f32] * 4 + [i32, i32, i32, ptr])
    kick.restype = ctypes.c_int
    sweeps = lib.dense_sweeps_launch
    sweeps.argtypes = ([ptr] * 4 + [i64] + [ptr] * 6
                       + [i64, i64, i32, i32, i32, i32, i64, i32]
                       + [f32] * 4 + [i32, i32, ptr])
    sweeps.restype = ctypes.c_int
    return att, kick, sweeps


@functools.cache
def _kernels():
    return _bind(load_library("dense_sweep"))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _attraction_args(y, y_src, lo, edges, scale, gamma, b, f_min, mask,
                     mask_p, out):
    """dense_attraction_launch's arguments, all but the stream."""
    rows, words = edges.shape
    return (*map(_ptr, (y, y_src, edges, scale, mask, out)),
            rows, lo, words // len(EDGE_FIELDS), y.shape[1], words, gamma,
            *_exponents(b), f_min, 1.0 / mask_p)


def _kick_args(y, a, lo, offset, idx_full, scale, gamma, b, n_neg,
               neg_weight, neighbor_exclusion, parallel_kicks, flat, out):
    """dense_kick_launch's arguments, all but the stream."""
    n, d = y.shape
    return (*map(_ptr, (y, a, idx_full, scale, neg_weight, out)),
            a.shape[0], lo, n, idx_full.shape[0], d, int(offset) % n,
            max(1, n // n_neg), n_neg, gamma, *_exponents(b),
            int(neighbor_exclusion), int(parallel_kicks), int(flat))


def _sweeps_args(y, y_src, a, edges, scale, gammas, offsets, groups, b,
                 n_neg, idx_full, f_min, neg_weight, neighbor_exclusion,
                 parallel_kicks):
    """dense_sweeps_launch's arguments, all but the stream."""
    n, d = y.shape
    _, _, words = edges.shape
    return (*map(_ptr, (y, y if y_src is None else y_src, a, edges)),
            n * words,
            *map(_ptr, (scale, neg_weight, idx_full, gammas, offsets,
                        groups)),
            gammas.shape[0], n, words // len(EDGE_FIELDS), idx_full.shape[0],
            d, words, max(1, n // n_neg), n_neg, *_exponents(b), f_min,
            int(neighbor_exclusion), int(parallel_kicks))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"dense {what} kernel launch failed: CUDA error "
                           f"{err}")


def dense_attraction_rows_reference(y, y_src, lo: int, edges, scale,
                                    gamma: float, b: float,
                                    f_min: float = 1e-3, mask=None,
                                    mask_p: float = 1.0):
    """Plain twin of the attraction kernel: ``_attraction_sweep_sfT`` on
    the rows [lo, lo + rows) of ``y``, their neighbours read from
    ``y_src`` (``y`` itself, or a stale snapshot).  Returns the (rows, d)
    moved rows."""
    from ..optim.dense import _attraction_sweep_sfT
    _check_attraction(y, y_src, lo, edges, scale, mask)
    rows = edges.shape[0]
    idx, w, m, w_rev, m_rev, scale_j = unpack_edges(edges)
    own = y[lo:lo + rows].T.contiguous()
    delta = _attraction_sweep_sfT(
        y_src.T.contiguous(), idx, w, m, w_rev, m_rev,
        scale[None, lo:lo + rows], scale_j, gamma, b, f_min=f_min, mask=mask,
        mask_p=mask_p, y_ownT=own)
    return (own + delta).T.contiguous()


def dense_attraction_rows(y, y_src, lo: int, edges, scale, gamma: float,
                          b: float, f_min: float = 1e-3, mask=None,
                          mask_p: float = 1.0):
    """The attraction half of a sweep for the rows [lo, lo + rows),
    rows = edges.shape[0]: y, y_src (n, d) float32; edges (rows, words)
    int32 records of the rows' kg edges of one group (``pack_groups``);
    mask (or None) (kg, rows) float32; scale (n,).  Returns a new
    (rows, d) tensor.

    CUDA tensors launch the kernel (each launch adds one to the
    counter ``ops.dense_sweep.attraction``); CPU tensors run
    ``dense_attraction_rows_reference``."""
    if y.device.type != "cuda":
        return dense_attraction_rows_reference(
            y, y_src, lo, edges, scale, gamma, b, f_min=f_min, mask=mask,
            mask_p=mask_p)
    _check_attraction(y, y_src, lo, edges, scale, mask)
    out = torch.empty((edges.shape[0], y.shape[1]), dtype=_F32,
                      device=y.device)
    if out.shape[0] == 0:
        return out
    _check_aligned(y.shape[1], edges, y=y, y_src=y_src)
    att = _kernels()[0]
    with torch.cuda.device(y.device):
        err = att(*_attraction_args(y, y_src, lo, edges, scale, gamma, b,
                                    f_min, mask, mask_p, out),
                  _stream(y.device))
    _raise_on(err, "attraction")
    count(PREFIX + "attraction")
    return out


def dense_kick_rows_reference(y, a, lo: int, offset: int, idx_full, scale,
                              gamma: float, b: float, n_neg: int,
                              neg_weight=None,
                              neighbor_exclusion: bool = True,
                              parallel_kicks: bool = False,
                              flat: bool = False, out=None):
    """Plain twin of the kick kernel: ``_repulsion_block_T`` for the rows
    [lo, lo + rows) against the snapshot that is ``y`` with those rows
    replaced by ``a``; with ``flat`` the result is formed as
    a + (kicked - a), as the whole array's sweep
    (``_repulsion_sweep_rolledT``) forms it.  Returns (rows, d), written
    into ``out`` when given."""
    from ..optim.dense import _repulsion_block_T
    _check_kick(y, a, lo, offset, idx_full, scale, n_neg, neg_weight, out)
    n, rows = y.shape[0], a.shape[0]
    aT = a.T.contiguous()
    if rows == n:
        snapT = aT
    else:
        snapT = y.T.contiguous()
        snapT[:, lo:lo + rows] = aT
    # the wraparound-extended snapshot of the strided pool
    ext = torch.cat([snapT, snapT[:, :rows]], dim=1)
    nw_ext = (None if neg_weight is None
              else torch.cat([neg_weight, neg_weight[:rows]]))
    kicked = _repulsion_block_T(
        ext, aT, lo, n, int(offset), idx_full, scale[None, lo:lo + rows],
        gamma, b, n_neg, neg_weight_ext=nw_ext,
        neighbor_exclusion=neighbor_exclusion, parallel_kicks=parallel_kicks)
    if flat:
        kicked = aT + (kicked - aT)
    if out is None:
        return kicked.T.contiguous()
    return out.copy_(kicked.T)


def dense_kick_rows(y, a, lo: int, offset: int, idx_full, scale,
                    gamma: float, b: float, n_neg: int, neg_weight=None,
                    neighbor_exclusion: bool = True,
                    parallel_kicks: bool = False, flat: bool = False,
                    out=None):
    """The kick half of a sweep for the rows [lo, lo + rows), rows =
    a.shape[0]: ``y`` (n, d) is the snapshot outside those rows, ``a``
    (rows, d) the rows after their attraction; kick t pairs position p
    with (p + offset + t max(1, n // n_neg)) mod n, rejected when that is
    p or (``neighbor_exclusion``) one of p's ids in ``idx_full`` (k, rows)
    int32; ``neg_weight`` (n,) or None weighs the partners.  ``out``
    (rows, d) may be y's own rows [lo, lo + rows), never ``a``.

    CUDA tensors launch the kernel (each launch adds one to the
    counter ``ops.dense_sweep.kick``); CPU tensors run
    ``dense_kick_rows_reference``."""
    if y.device.type != "cuda":
        return dense_kick_rows_reference(
            y, a, lo, offset, idx_full, scale, gamma, b, n_neg,
            neg_weight=neg_weight, neighbor_exclusion=neighbor_exclusion,
            parallel_kicks=parallel_kicks, flat=flat, out=out)
    _check_kick(y, a, lo, offset, idx_full, scale, n_neg, neg_weight, out)
    if out is None:
        out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    _check_aligned(y.shape[1], y=y, a=a, out=out)
    kick = _kernels()[1]
    with torch.cuda.device(y.device):
        err = kick(*_kick_args(y, a, lo, offset, idx_full, scale, gamma, b,
                               n_neg, neg_weight, neighbor_exclusion,
                               parallel_kicks, flat, out), _stream(y.device))
    _raise_on(err, "kick")
    count(PREFIX + "kick")
    return out


def dense_sweeps_reference(y, y_src, edges, scale, gammas, offsets, groups,
                           b: float, n_neg: int, idx_full,
                           f_min: float = 1e-3, neg_weight=None,
                           neighbor_exclusion: bool = True,
                           parallel_kicks: bool = False):
    """Plain twin of the persistent launch: for each sweep s, the
    attraction twin of every row with group ``groups[s]``'s records and
    ``gammas[s]``, its neighbours read from ``y_src`` (None: y itself),
    then the kick twin of every row at ``offsets[s]``, formed flat and
    written into ``y``.  Returns ``y``."""
    _check_sweeps(y, y_src, edges, scale, gammas, offsets, groups, n_neg,
                  idx_full, neg_weight)
    for gamma, offset, group in zip(gammas.tolist(), offsets.tolist(),
                                    groups.tolist()):
        a = dense_attraction_rows_reference(
            y, y if y_src is None else y_src, 0, edges[group], scale, gamma,
            b, f_min=f_min)
        dense_kick_rows_reference(
            y, a, 0, offset, idx_full, scale, gamma, b, n_neg,
            neg_weight=neg_weight, neighbor_exclusion=neighbor_exclusion,
            parallel_kicks=parallel_kicks, flat=True, out=y)
    return y


def dense_sweeps(y, y_src, edges, scale, gammas, offsets, groups, b: float,
                 n_neg: int, idx_full, f_min: float = 1e-3, neg_weight=None,
                 neighbor_exclusion: bool = True,
                 parallel_kicks: bool = False):
    """``gammas.shape[0]`` whole-array sweeps of ``y`` (n, d) float32, in
    place: sweep s moves every row by the attraction of its edges of
    group ``groups[s]`` (``edges`` (groups, n, words), one
    ``pack_groups`` table a group), neighbours read from ``y_src`` (a
    snapshot, or None: y itself), then gives it its n_neg kicks at pool
    offset ``offsets[s]`` (in [0, n)), both at ``gammas[s]``; ``gammas``
    float32, ``offsets`` int64, ``groups`` int32, (steps,) each on y's
    device.  Returns ``y``.

    CUDA tensors run every sweep in one cooperative launch (adding one to
    the counter ``ops.dense_sweep.persistent`` and the sweeps to
    ``ops.dense_sweep.persistent_sweeps``);
    a launch the card refuses raises.  CPU tensors run
    ``dense_sweeps_reference``."""
    if y.device.type != "cuda":
        return dense_sweeps_reference(
            y, y_src, edges, scale, gammas, offsets, groups, b, n_neg,
            idx_full, f_min=f_min, neg_weight=neg_weight,
            neighbor_exclusion=neighbor_exclusion,
            parallel_kicks=parallel_kicks)
    _check_sweeps(y, y_src, edges, scale, gammas, offsets, groups, n_neg,
                  idx_full, neg_weight)
    steps = gammas.shape[0]
    if steps == 0:
        return y
    _check_aligned(y.shape[1], edges, y=y, y_src=y_src)
    a = torch.empty_like(y)
    sweeps = _kernels()[2]
    with torch.cuda.device(y.device):
        err = sweeps(*_sweeps_args(y, y_src, a, edges, scale, gammas,
                                   offsets, groups, b, n_neg, idx_full,
                                   f_min, neg_weight, neighbor_exclusion,
                                   parallel_kicks), _stream(y.device))
    _raise_on(err, "persistent sweep")
    count(PREFIX + "persistent")
    count(PREFIX + "persistent_sweeps", steps)
    return y


def launch_counts() -> dict:
    """The sweep kernels' launches since the last reset: ``pair`` (both
    halves of every per-sweep pair), ``persistent`` launches and the
    ``persistent_sweeps`` they ran."""
    c = counters(PREFIX)
    return dict(pair=c.get("attraction", 0) + c.get("kick", 0),
                persistent=c.get("persistent", 0),
                persistent_sweeps=c.get("persistent_sweeps", 0))


def reset_launch_counts() -> None:
    reset_counters(PREFIX)
