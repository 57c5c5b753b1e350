"""One sub-sweep of the dense CE optimizer as two fused launches.

``dense_attraction_rows`` moves the rows [lo, lo + rows) of an (n, d)
embedding by the closed-form attraction of their edges of one column
group; ``dense_kick_rows`` then gives those rows their n_neg repulsion
kicks against the post-attraction snapshot.  On CUDA tensors each
launches its hand-written kernel of ``csrc/dense_sweep.cu`` (a failed
build or launch raises); on CPU tensors each runs its plain twin, which
is composed of optim/dense.py's ``_attraction_sweep_sfT`` and
``_repulsion_block_T``, the ports of annembed_tpu/optim/dense.py:272 and
:406 (an XLA fusion in the JAX package: it has no Pallas kernel for the
sweep).

Layout (the kernel's): coordinates are row-major (n, d); the edge tables
of the rows are (kg, rows) and the neighbour table (k, rows), int32 ids
in [0, n); ``scale`` and ``neg_weight`` are (n,).  The twins take the
same arguments and transpose to the (d, n) layout of optim/dense.py, so
on the CPU they give what that module's sweeps give, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library

_F32, _I32 = torch.float32, torch.int32


def _need(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(y, lo: int, rows: int):
    if y.dim() != 2 or y.shape[1] == 0:
        raise ValueError(f"y must be (n, d) with d > 0, got "
                         f"{tuple(y.shape)}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    if not 0 <= lo <= lo + rows <= y.shape[0]:
        raise ValueError(f"rows [{lo}, {lo + rows}) outside [0, "
                         f"{y.shape[0]})")


def _check_attraction(y, y_src, lo, idx, w, m, w_rev, m_rev, scale_j,
                      scale, mask):
    if idx.dim() != 2:
        raise ValueError(f"idx must be (kg, rows), got {tuple(idx.shape)}")
    _check_rows(y, lo, idx.shape[1])
    dev, table = y.device, tuple(idx.shape)
    _need("y", y, _F32, tuple(y.shape), dev)
    _need("y_src", y_src, _F32, tuple(y.shape), dev)
    _need("idx", idx, _I32, table, dev)
    for name, t in (("w", w), ("m", m), ("w_rev", w_rev), ("m_rev", m_rev),
                    ("scale_j", scale_j)):
        _need(name, t, _F32, table, dev)
    _need("scale", scale, _F32, (y.shape[0],), dev)
    if mask is not None:
        _need("mask", mask, _F32, table, dev)


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


def _exponents(b: float):
    """b, b - 1 and 2 b as the twins' scalars reach f32 (computed in
    double, then rounded)."""
    return float(np.float32(b)), float(np.float32(b - 1.0)), \
        float(np.float32(2.0 * b))


@functools.cache
def _kernels():
    lib = load_library("dense_sweep")
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    att = lib.dense_attraction_launch
    att.argtypes = [ptr] * 11 + [i64, i64, i32, i32] + [f32] * 6 + [ptr]
    att.restype = ctypes.c_int
    kick = lib.dense_kick_launch
    kick.argtypes = ([ptr] * 6 + [i64, i64, i64, i32, i32, i64, i64, i32]
                     + [f32] * 4 + [i32, i32, i32, ptr])
    kick.restype = ctypes.c_int
    return att, kick


def _ptr(t):
    return None if t is None else t.data_ptr()


def _attraction_args(y, y_src, lo, idx, w, m, w_rev, m_rev, scale_j, scale,
                     gamma, b, f_min, mask, mask_p, out):
    """dense_attraction_launch's arguments, all but the stream."""
    kg, rows = idx.shape
    return (*map(_ptr, (y, y_src, idx, w, m, w_rev, m_rev, scale_j, scale,
                        mask, out)),
            rows, lo, kg, y.shape[1], gamma, *_exponents(b), f_min,
            1.0 / mask_p)


def _kick_args(y, a, lo, offset, idx_full, scale, gamma, b, n_neg,
               neg_weight, neighbor_exclusion, parallel_kicks, flat, out):
    """dense_kick_launch's arguments, all but the stream."""
    n, d = y.shape
    return (*map(_ptr, (y, a, idx_full, scale, neg_weight, out)),
            a.shape[0], lo, n, idx_full.shape[0], d, int(offset) % n,
            max(1, n // n_neg), n_neg, gamma, *_exponents(b),
            int(neighbor_exclusion), int(parallel_kicks), int(flat))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def dense_attraction_rows_reference(y, y_src, lo: int, idx, w, m, w_rev,
                                    m_rev, scale_j, scale, gamma: float,
                                    b: float, f_min: float = 1e-3,
                                    mask=None, mask_p: float = 1.0):
    """Plain twin of the attraction kernel: ``_attraction_sweep_sfT`` on
    the rows [lo, lo + rows) of ``y``, their neighbours read from
    ``y_src`` (``y`` itself, or a stale snapshot).  Returns the (rows, d)
    moved rows."""
    from ..optim.dense import _attraction_sweep_sfT
    _check_attraction(y, y_src, lo, idx, w, m, w_rev, m_rev, scale_j, scale,
                      mask)
    rows = idx.shape[1]
    own = y[lo:lo + rows].T.contiguous()
    delta = _attraction_sweep_sfT(
        y_src.T.contiguous(), idx, w, m, w_rev, m_rev,
        scale[None, lo:lo + rows], scale_j, gamma, b, f_min=f_min, mask=mask,
        mask_p=mask_p, y_ownT=own)
    return (own + delta).T.contiguous()


def dense_attraction_rows(y, y_src, lo: int, idx, w, m, w_rev, m_rev,
                          scale_j, scale, gamma: float, b: float,
                          f_min: float = 1e-3, mask=None,
                          mask_p: float = 1.0):
    """The attraction half of a sweep for the rows [lo, lo + rows),
    rows = idx.shape[1]: y, y_src (n, d) float32; idx (kg, rows) int32;
    w, m, w_rev, m_rev, scale_j (the neighbours' scales), mask (or None)
    (kg, rows) float32; scale (n,).  Returns a new (rows, d) tensor.

    CUDA tensors launch the kernel (each launch adds one to
    ``dense_attraction_rows.launches``); CPU tensors run
    ``dense_attraction_rows_reference``."""
    if y.device.type != "cuda":
        return dense_attraction_rows_reference(
            y, y_src, lo, idx, w, m, w_rev, m_rev, scale_j, scale, gamma, b,
            f_min=f_min, mask=mask, mask_p=mask_p)
    _check_attraction(y, y_src, lo, idx, w, m, w_rev, m_rev, scale_j, scale,
                      mask)
    out = torch.empty((idx.shape[1], y.shape[1]), dtype=_F32,
                      device=y.device)
    if out.shape[0] == 0:
        return out
    att, _ = _kernels()
    with torch.cuda.device(y.device):
        err = att(*_attraction_args(y, y_src, lo, idx, w, m, w_rev, m_rev,
                                    scale_j, scale, gamma, b, f_min, mask,
                                    mask_p, out), _stream(y.device))
    if err != 0:
        raise RuntimeError(f"dense attraction kernel launch failed: CUDA "
                           f"error {err}")
    dense_attraction_rows.launches += 1
    return out


dense_attraction_rows.launches = 0


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

    CUDA tensors launch the kernel (each launch adds one to
    ``dense_kick_rows.launches``); CPU tensors run
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
    _, kick = _kernels()
    with torch.cuda.device(y.device):
        err = kick(*_kick_args(y, a, lo, offset, idx_full, scale, gamma, b,
                               n_neg, neg_weight, neighbor_exclusion,
                               parallel_kicks, flat, out), _stream(y.device))
    if err != 0:
        raise RuntimeError(f"dense kick kernel launch failed: CUDA error "
                           f"{err}")
    dense_kick_rows.launches += 1
    return out


dense_kick_rows.launches = 0
