"""g++ builds of the repository's C++ sources (``native/*.cpp``).

Each source is compiled on first use into ``build/annembed_tpu_torch/``
under a name keyed by a hash of the source and the flags, so a stale or
foreign binary (such as the git-ignored, ``-march=native``
``native/libannembed_native.so`` of the JAX package) is never loaded.
Without g++ the callers take their numpy paths, and record which path
ran in ``BACKENDS``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "annembed_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

#: the backend each host stage last ran with, by stage ("alias", "mst",
#: "linkage", "condense"): "native" or "numpy" ("boruvka" for the numpy
#: Boruvka MST)
BACKENDS: dict = {}


def build_library(name: str) -> Optional[Path]:
    """g++ build of ``native/<name>.cpp``; None when the source or the
    compiler is missing or the build fails."""
    src = NATIVE_DIR / f"{name}.cpp"
    gxx = shutil.which("g++")
    if gxx is None or not src.is_file():
        return None
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            logger.warning("g++ failed building %s:\n%s", src, proc.stderr)
            return None
        os.replace(tmp, out)
    return out


@functools.cache
def load_library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded build of ``native/<name>.cpp``, or None."""
    path = build_library(name)
    if path is None:
        logger.info("native %s unavailable; numpy path", name)
        return None
    return ctypes.CDLL(str(path))
