"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by the
installed CUDA toolkit's ``nvcc`` into
``build/annembed_tpu_torch/<name>-<hash>.so`` under the repository root,
keyed by a hash of the source and the flags, then loaded with ctypes.
Nothing is fetched and nothing outside the checkout is written.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "annembed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH)")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists, then
    load it.  A failed build raises with nvcc's stderr."""
    out = library_path(name)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
