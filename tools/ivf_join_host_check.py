#!/usr/bin/env python3
"""Compile ``csrc/ivf_join.cu`` as host C++ and hold its launcher to the
torch join on the CPU: logic, indexing, tie order and every instance of
the kernel without a card or nvcc.

    python3 tools/ivf_join_host_check.py [--keep DIR]

A prelude stands in for the CUDA headers (qualifiers, ``float4``, the
bit casts, the runtime calls the launcher makes).  ``__shared__``
arrays become function statics, which every emulated thread of a block
shares.  A ``<<<...>>>`` launch runs one OS thread per thread of a
block; each walks every block in turn, ``__syncthreads()`` is a
``std::barrier`` over them, and they meet at the end of each block
before the next reuses its shared memory.  Built with g++
``-ffp-contract=off`` against glibc's sqrtf (correctly rounded, as the
card's and PyTorch's).  Every case is held to the torch join
(``_ivf_join_sorted``) after the fix-up both go through: on rows of
small integers, whose distances are exact, bit for bit, ties included;
on float rows by ``ops.ivf_join.join_agreement`` (ids equal outside
near-ties, measured on the ranked value against |q|^2 + |c|^2; dists
within 1e-5 relative).  Exits non-zero on a failed build or check.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from annembed_tpu_torch.knn import ivf  # noqa: E402
from annembed_tpu_torch.ops import ivf_join as ij  # noqa: E402

SOURCE = ROOT / "annembed_tpu_torch" / "csrc" / "ivf_join.cu"
# shared memory a block may hold on the card, the emulation's
# dynamic shared array
HOST_DYN_SMEM_FLOAT4 = 232448 // 16

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 blockIdx(0), threadIdx(0), gridDim(1), blockDim(1);
struct float4 { float x, y, z, w; };
using std::max;
using std::min;
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline float __uint_as_float(unsigned v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned v;
  std::memcpy(&v, &f, sizeof v);
  return v;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// a <<<blocks, threads>>> launch: one OS thread per thread of a block,
// each walking every block; they meet at the end of each block
template <class F>
void host_launch(unsigned blocks, unsigned threads, F body) {
  std::barrier<> bar(threads);
  block_barrier = &bar;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) {
    pool.emplace_back([=, &bar] {
      gridDim = dim3(blocks);
      blockDim = dim3(threads);
      threadIdx = dim3(t);
      for (unsigned b = 0; b < blocks; ++b) {
        blockIdx = dim3(b);
        body();
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& th : pool) th.join();
  block_barrier = nullptr;
}
#define __shared__ static
"""


def host_source() -> str:
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>\n", PRELUDE)
    src, dyn = re.subn(r"extern __shared__ float4 dyn_smem\[\];",
                       f"static float4 dyn_smem[{HOST_DYN_SMEM_FLOAT4}];",
                       src)
    src, launches = re.subn(
        r"(\w+<[^<>;]*>)<<<(\w+), (\w+), (\w+), st>>>\((\w+)\);",
        r"host_launch(\2, \3, [&] { \1(\5); });", src)
    if dyn != 1 or launches != 1:
        raise SystemExit(f"unexpected source: {dyn} dynamic shared arrays, "
                         f"{launches} <<<>>> launches")
    return src


def build(workdir: Path) -> Path:
    cpp = workdir / "ivf_join_host.cpp"
    lib = workdir / "ivf_join_host.so"
    cpp.write_text(host_source())
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-o", str(lib),
                    str(cpp)], check=True)
    return lib


def host_join(launch, max_k):
    """``ops.ivf_join.ivf_join``'s kernel branch with a host-built
    launcher, on CPU tensors."""
    return functools.partial(ij._join, launch, max_k, None)


def load(workdir: Path):
    """The host-built join, as the wrapper's kernel branch calls it."""
    return host_join(*ij._bind(ctypes.CDLL(str(build(workdir)))))


def fixed(inp, idx, dist):
    return ivf._fixup_underfilled(idx, dist, inp["xs_pad"].shape[0] - 1)


def run_case(join, inp, dtype, exact=False):
    """The host-built kernel and the torch join on ``inp``, both through
    the fix-up; two launches bit-equal.  Returns (ok, detail)."""
    got = join(**inp, dtype=dtype)
    again = join(**inp, dtype=dtype)
    want = ij.ivf_join_reference(**inp, dtype=dtype)
    gi, gd = fixed(inp, *got)
    wi, wd = fixed(inp, *want)
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    n = gi.shape[0]
    pad_tail = bool(((got[0] == n) == torch.isinf(got[1])).all())
    if exact:
        ok = same and pad_tail and torch.equal(gi, wi) and torch.equal(gd, wd)
        return ok, (f"bit-equal to the twin {torch.equal(gi, wi)} / "
                    f"{torch.equal(gd, wd)}, repeat {same}, pad ids at inf "
                    f"{pad_tail}")
    agree = ij.join_agreement(inp["xs_pad"], dtype, gi, gd, wi, wd)
    ok = (same and pad_tail and agree["mismatch_rows"] == 0
          and agree["unsorted_rows"] == 0
          and agree["max_rel_dist_err"] <= ij.DIST_REL)
    return ok, (f"{agree}, repeat {same}, pad ids at inf {pad_tail}")


def integer_rows(rng, n, d, span=6):
    """Rows of small integers, with duplicates: every expansion, dot and
    square sum is exact in f32 and in bf16, so ties are exact ties."""
    return torch.from_numpy(rng.integers(-span, span + 1, (n, d))
                            .astype(np.float32))


def clustered_rows(rng, n, d, centers=12, spread=8.0):
    c = rng.normal(size=(centers, d)) * spread
    return torch.from_numpy((c[rng.integers(0, centers, n)]
                             + rng.normal(size=(n, d))).astype(np.float32))


def cases():
    """name -> (inputs, dtype, exact).  Small ragged shapes: every
    instance of the source (d in the 4 / 8 / 16 / 32 tiles and in
    chunks), k from 6 to 251 (whose lists leave room for 96 threads a
    block, not 128), windows cut at cap, cells split into several
    virtual rows, underfilled rows, the grid quantizer's sentinel cell,
    exact ties across probes."""
    rng = np.random.default_rng(11)
    plan = ivf.sorted_join_inputs
    out = {}
    ints = integer_rows(rng, 1500, 5)
    for dtype in ("float32", "bfloat16"):
        out[f"ties_{dtype}"] = (plan(ints, 7, nlist=30, nprobe=5, cap=40,
                                     qcap=24), dtype, True)
    out["ties_k40"] = (plan(ints, 40, nlist=16, nprobe=4), "float32", True)
    out["ties_k251"] = (plan(ints, 251, nlist=8, nprobe=4), "float32", True)
    higgs = clustered_rows(rng, 3000, 28)
    out["d28_k12_bf16"] = (plan(higgs, 12, nprobe=6), "bfloat16", False)
    out["d28_k12_f32_cut"] = (plan(higgs, 12, nlist=20, nprobe=4, cap=120,
                                   qcap=100), "float32", False)
    out["d9_k20_cut"] = (plan(clustered_rows(rng, 2000, 9), 20, nlist=25,
                                nprobe=5, cap=70, qcap=150), "float32", False)
    out["d3_k51"] = (plan(clustered_rows(rng, 3000, 3), 51, nprobe=8),
                     "float32", False)
    out["d40_chunks"] = (plan(clustered_rows(rng, 1200, 40), 10, nlist=16,
                              nprobe=4), "bfloat16", False)
    out["d2_grid_sentinel"] = (plan(
        torch.from_numpy(rng.normal(size=(4000, 2)).astype(np.float32)), 6,
        quantizer="grid"), "float32", False)
    out["underfilled"] = (plan(torch.from_numpy(
        (rng.normal(size=(300, 4)) * 50).astype(np.float32)), 10, nlist=64,
        nprobe=2), "float32", False)
    return out


def check(name, ok, detail):
    print(f"{name}: {'ok' if ok else 'FAILED'} ({detail})", flush=True)
    return ok


def run_mesh_split(join, inp, dtype="bfloat16", size=3) -> bool:
    """Three launches of every third virtual row sum to the one launch,
    bit for bit (a mesh's all_reduce_sum)."""
    whole = join(**inp, dtype=dtype)
    parts = [join(**inp, dtype=dtype, rank=r, size=size) for r in range(size)]
    idx = sum(p[0] for p in parts)
    dist = sum(p[1] for p in parts)
    return check("mesh split", torch.equal(idx, whole[0])
                 and torch.equal(dist, whole[1]),
                 f"{size} row shares summed against one launch")


def run_all(workdir: Path) -> bool:
    join = load(workdir)
    ok = True
    for name, (inp, dtype, exact) in cases().items():
        ok &= check(name, *run_case(join, inp, dtype, exact))
    inp, _, _ = cases()["d28_k12_bf16"]
    return run_mesh_split(join, inp) and ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keep", type=Path, default=None,
                    help="build here instead of a temporary directory")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.keep or Path(tmp)
        workdir.mkdir(parents=True, exist_ok=True)
        ok = run_all(workdir)
    print("host check:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
