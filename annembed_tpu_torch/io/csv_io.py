"""CSV IO: loading data to embed and writing embeddings.

Port of annembed_tpu/io/csv_io.py (reference src/tools/io.rs):
  * ``get_toembed_from_csv`` (:115): numeric CSV -> (n, d) float32 array
    with '#'/'%%' header skipping (:70) and Bernoulli row subsampling
    (:197-199);
  * ``write_csv_array2`` (:48) and ``write_csv_labeled_array2`` (:23):
    rows written at %%.5e, optionally label-prefixed.

The parser is the repository's multithreaded C++ loader
(native/csv_loader.cpp) through ctypes when it can be had: a g++ build
of the source by ``utils/native.py``, keyed by a hash of the source and
flags, so a stale or foreign binary is never loaded.
Without a compiler the numpy parser runs; both keep the same rows,
because the subsample decision hashes (seed, line byte offset)
(``_keep_row``).
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from typing import Optional

import numpy as np

from ..utils.native import load_library

logger = logging.getLogger(__name__)


@functools.cache
def _load_native() -> Optional[ctypes.CDLL]:
    lib = load_library("csv_loader")
    if lib is None:
        return None
    lib.annembed_csv_parse.restype = ctypes.c_void_p
    lib.annembed_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int32]
    lib.annembed_csv_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.annembed_csv_data.argtypes = [ctypes.c_void_p]
    lib.annembed_csv_rows.restype = ctypes.c_int64
    lib.annembed_csv_rows.argtypes = [ctypes.c_void_p]
    lib.annembed_csv_cols.restype = ctypes.c_int64
    lib.annembed_csv_cols.argtypes = [ctypes.c_void_p]
    lib.annembed_csv_free.argtypes = [ctypes.c_void_p]
    return lib


_M64 = (1 << 64) - 1


def _keep_row(seed: int, offset: int, keep_prob: float) -> bool:
    """Bit-for-bit mirror of native/csv_loader.cpp::keep_row: the
    subsample decision hashes (seed, line byte offset), so the selected
    rows do not depend on thread count, chunking, or which parser ran."""
    z = (offset + 0x9E3779B97F4A7C15 * (seed + 1)) & _M64
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _M64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return (z >> 11) * (1.0 / 9007199254740992.0) < keep_prob


def _numpy_parse(path: str, delimiter: str, subsample: float,
                 seed: int) -> np.ndarray:
    rows = []
    with open(path, "rb") as f:
        raw = f.read()
    pos, total = 0, len(raw)
    while pos < total:
        nl = raw.find(b"\n", pos)
        end = nl if nl >= 0 else total
        line_off = pos
        s = raw[pos:end].decode("utf-8", "replace").strip()
        pos = end + 1 if nl >= 0 else total
        if not s or s.startswith("#") or s.startswith("%"):
            continue
        if subsample < 1.0 and not _keep_row(seed, line_off, subsample):
            continue
        parts = s.split() if delimiter == " " \
            else [t.strip() for t in s.split(delimiter)]
        try:
            rows.append(np.array([float(t) for t in parts], np.float32))
        except ValueError as exc:
            raise ValueError(
                f"{path}: malformed CSV line at byte {line_off}: "
                f"{s[:80]!r}") from exc
    if not rows:
        return np.zeros((0, 0), np.float32)
    widths = {r.shape[0] for r in rows}
    if len(widths) != 1:
        raise ValueError(f"{path}: ragged CSV (row widths {sorted(widths)})")
    return np.stack(rows)


def get_toembed_from_csv(path: str | os.PathLike, delimiter: str = ",",
                         subsample: float = 1.0, seed: int = 0,
                         use_native: bool = True) -> np.ndarray:
    """Load a numeric CSV into a float32 (n, d) array; ``subsample``
    keeps each row with that probability (reference io.rs:197-199)."""
    path = os.fspath(path)
    lib = _load_native() if use_native else None
    if lib is not None:
        handle = lib.annembed_csv_parse(path.encode(), delimiter.encode()[:1],
                                        float(subsample), int(seed), 0)
        if handle:
            try:
                r = lib.annembed_csv_rows(handle)
                c = lib.annembed_csv_cols(handle)
                ptr = lib.annembed_csv_data(handle)
                return np.ctypeslib.as_array(ptr, shape=(r, c)).copy()
            finally:
                lib.annembed_csv_free(handle)
        logger.warning("native csv parse failed for %s; numpy parser", path)
    return _numpy_parse(path, delimiter, subsample, seed)


def write_csv_array2(path: str | os.PathLike, data) -> None:
    """Write (n, d) coordinates at %.5e (reference io.rs:48)."""
    np.savetxt(os.fspath(path), np.asarray(data), fmt="%.5e", delimiter=",")


def write_csv_labeled_array2(path: str | os.PathLike, labels, data) -> None:
    """label,coord...,coord rows (reference io.rs:23)."""
    data = np.asarray(data)
    labels = np.asarray(labels).reshape(-1, 1)
    with open(os.fspath(path), "w") as f:
        for lab, row in zip(labels[:, 0], data):
            f.write(str(lab) + "," + ",".join(f"{v:.5e}" for v in row)
                    + "\n")
