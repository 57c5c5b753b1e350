"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by the
installed CUDA toolkit's ``nvcc`` into
``build/annembed_tpu_torch/<name>-<hash>.so`` under the repository root,
keyed by a hash of the flags, the source and every ``csrc/`` header it
includes, then loaded with ctypes.  ptxas's resource report (registers,
shared memory, spills) is kept beside the library as ``<stem>.log``.
CUTLASS's headers are put on the include path when they are installed
and the source includes ``cute/`` or ``cutlass/``.  Nothing is fetched
and nothing outside the checkout is written.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "annembed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
CUTLASS_INCLUDE = Path("/usr/local/cutlass/include")
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH)")
    return nvcc


def source_files(name: str) -> tuple[list[Path], bool]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes,
    transitively, and whether any of them includes CuTe or CUTLASS."""
    files, todo, uses_cutlass = [], [(CSRC / f"{name}.cu").resolve()], False
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for quote, inc in _INCLUDE.findall(path.read_text()):
            if inc.startswith(("cute/", "cutlass/")):
                uses_cutlass = True
            elif quote == '"' and (path.parent / inc).is_file():
                todo.append((path.parent / inc).resolve())
    return files, uses_cutlass


def nvcc_flags(name: str) -> tuple[str, ...]:
    _, uses_cutlass = source_files(name)
    if uses_cutlass and CUTLASS_INCLUDE.is_dir():
        return NVCC_FLAGS + (f"-I{CUTLASS_INCLUDE}",)
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    files, _ = source_files(name)
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for path in sorted(files):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """ptxas's report from the build of ``name`` ('' before a build)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists, then
    load it.  A failed build raises with nvcc's stderr."""
    out = library_path(name)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
