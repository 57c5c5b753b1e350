#!/usr/bin/env python3
"""Compile the IVF join kernels' C++ for the host and hold their
launchers to the torch join on the CPU: logic, indexing, tie order and
every instance, without a card or nvcc.

    python3 tools/ivf_join_host_check.py [--keep DIR]

The SIMT kernel (``csrc/ivf_join.cu``, ``load``): a prelude stands in
for the CUDA headers (qualifiers, ``float4``, the bit casts, the runtime
calls the launcher makes).  ``__shared__`` arrays become function
statics, which every emulated thread of a block shares.  A
``<<<...>>>`` launch runs one OS thread per thread of a block; each
walks every block in turn, ``__syncthreads()`` is a ``std::barrier``
over them, and they meet at the end of each block before the next
reuses its shared memory.  The tensor-core kernel (``csrc/ivf_join_tc.cu``,
``load_tc``): its selection, merge and rerank are plain C++ in
``csrc/ivf_join_common.cuh``, run here on fragments of a plain product
(``TC_DRIVER``).  Built with g++ ``-ffp-contract=off`` against glibc's
sqrtf (correctly rounded, as the card's and PyTorch's).  Every case is
held to the torch join (``_ivf_join_sorted``) after the fix-up both go
through: on rows of small integers, whose distances are exact, bit for
bit, ties included; on float rows by ``ops.ivf_join.join_agreement``
(ids equal outside near-ties, measured on the ranked value against
|q|^2 + |c|^2; dists within 1e-5 relative).  The command runs the SIMT
kernel's cases; exits non-zero on a failed build or check.
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

CSRC = ROOT / "annembed_tpu_torch" / "csrc"
SOURCE = CSRC / "ivf_join.cu"
COMMON = CSRC / "ivf_join_common.cuh"
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
#define __noinline__ __attribute__((noinline))
#define __ffs(x) __builtin_ffs(x)
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


def common_header() -> str:
    """``csrc/ivf_join_common.cuh`` as text to inline (no ``#pragma
    once`` in a main file)."""
    return COMMON.read_text().replace("#pragma once\n", "")


def host_source() -> str:
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>\n", PRELUDE)
    src = src.replace('#include "ivf_join_common.cuh"\n', common_header())
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


def host_join(launch, max_k, operand_bytes=None):
    """``ops.ivf_join.ivf_join``'s kernel branch with a host-built
    launcher, on CPU tensors; ``max_k`` an int or ``max_k(d, bf16,
    nprobe)``."""
    largest = max_k if callable(max_k) else (lambda d, bf16, nprobe: max_k)
    return functools.partial(ij._join,
                             ij.Kernel(launch, largest, operand_bytes), None)


def load(workdir: Path):
    """The host-built SIMT join, as the wrapper's kernel branch calls it."""
    return host_join(*ij._bind(ctypes.CDLL(str(build(workdir)))))


# The tensor-core route's launcher on the host: the operand copy written
# by the prologue kernel's per-element functions; every block's tiles
# walked in turn, in each every consumer thread's accumulator fragment
# computed from a plain product of the operand planes (exact products
# summed in f32 in column order; for TF32 the lo.hi, hi.lo and hi.hi
# passes in the kernel's order) in wgmma's m64n128 fragment order, columns
# past the row's candidates NaN (the kernel's stale tile rows, never
# read), the kernel's own filter on it, then the quad's cap as the
# kernel's shuffles compute it; at the end the kernel's merge and rerank
# (ivf_join_common.cuh).
TC_DRIVER = r"""
using namespace ivfj;

extern "C" long long ivf_join_tc_operand_bytes(int n, int d, int bf16) {
  return tc_operand_bytes(n, d, bf16);
}

extern "C" int ivf_join_tc_max_k(int d, int bf16, int nprobe) {
  return tc_max_k(d, bf16, nprobe);
}

namespace {
// column j of row r's operand from the copy (plane p of row r: 4 words at
// op[(p (n + 1) + r) 4]), one TF32 set
float operand_at(const uint32_t* op, long long n1, int nch, int bf16,
                 long long r, int j, int set) {
  if (bf16) {
    const uint32_t w = op[((j / 8) * n1 + r) * 4 + (j % 8) / 2];
    return __uint_as_float(((j % 2) ? (w >> 16) : (w & 0xffffu)) << 16);
  }
  return __uint_as_float(op[((set * nch + j / 4) * n1 + r) * 4 + j % 4]);
}
}  // namespace

template <int KL>
int host_tc(JoinArgs a, long long rows, uint32_t* op) {
  const int n = a.n, d = a.d, k = a.k, nprobe = a.nprobe, bf16 = a.bf16;
  const int ks = tc_ksteps(d, bf16), planes = tc_planes(d, bf16);
  const int nch = 2 * ks, dp = bf16 ? 16 * ks : 8 * ks;
  const long long n1 = n + 1LL;
  for (int p = 0; p < planes; ++p) {
    for (long long r = 0; r < n1; ++r) {
      for (int i = 0; i < 4; ++i) {
        op[(p * n1 + r) * 4 + i] =
            bf16 ? (b_bf16(a, r, 8 * p + 2 * i) |
                    (static_cast<uint32_t>(b_bf16(a, r, 8 * p + 2 * i + 1))
                     << 16))
                 : __float_as_uint(b_tf32(a, r, 4 * (p % nch) + i, p / nch));
      }
    }
  }
  const int ncons = tc_consumers(d, bf16, k, nprobe);
  if (ncons == 0) return 1;
  const int nt = 128 * ncons;
  a.slices = (a.qcap + 64 * ncons - 1) / (64 * ncons);
  std::vector<float> lists_v(2LL * k * nt), merged_v(64LL * ncons * k);
  std::vector<int> lists_s(2LL * k * nt), merged_s(64LL * ncons * k);
  std::vector<int> wstart(nprobe), wlen(nprobe), woff(nprobe + 1);
  // per consumer thread and row: A_q [set][column], its selection
  std::vector<float> aq(2LL * nt * 2 * dp);
  std::vector<RowSel<KL>> rs(2LL * nt);
  std::vector<int> qpos(2LL * nt);
  std::vector<float> quads(2LL * nt);
  for (long long b = 0; b < rows; ++b) {
    const long long vrow = a.row0 + b * a.row_step;
    const int parent = a.qparents[vrow];
    const int qstart = a.qstarts[vrow];
    const int qn = std::min(a.starts[parent] + a.counts[parent] - qstart,
                            a.qcap);
    const int* probes = a.nbrs + static_cast<long long>(parent) * nprobe;
    int o = 0;
    for (int p = 0; p < nprobe; ++p) {
      wstart[p] = a.starts[probes[p]];
      wlen[p] = std::min(a.counts[probes[p]], a.cap);
      woff[p] = o;
      o += wlen[p];
    }
    woff[nprobe] = o;
    const Windows win{wstart.data(), wlen.data(), woff.data(), nprobe};
    const int total = o;
    const int ntiles = (total + TC_BN - 1) / TC_BN;
    for (int slice = 0; slice < a.slices; ++slice) {
      const int first = slice * 64 * ncons;
      if (first >= qn) break;
      const int nact = std::min(ncons, (qn - first + 63) / 64);
      const int threads = 128 * nact;
      // every consumer thread's rows (its place as in the kernel)
      for (int tid = 0; tid < threads; ++tid) {
        const int wg = tid / 128, lane = tid % 32;
        const int rr = ((tid / 32) % 4) * 16 + lane / 4;
        for (int h = 0; h < 2; ++h) {
          const int qi = first + wg * 64 + rr + 8 * h;
          const bool valid = qi < qn;
          const int q = valid ? qstart + qi : n;
          qpos[2 * tid + h] = q;
          rs[2 * tid + h].init(k, valid, a.sqn[q],
                               valid ? win.slot_of(q) : SLOT_NONE);
          for (int j = 0; j < dp; ++j) {
            for (int set = 0; set < 2; ++set) {
              aq[((2 * tid + h) * 2 + set) * dp + j] =
                  bf16 ? __uint_as_float(
                             static_cast<uint32_t>(a_bf16(a, q, valid, j))
                             << 16)
                       : a_tf32(a, q, valid, j, set);
            }
          }
        }
      }
      for (int t = 0; t < ntiles; ++t) {
        for (int tid = 0; tid < threads; ++tid) {
          const int quad = tid % 4;
          float acc[4 * (TC_BN / 8)];
          for (int j = 0; j < TC_BN / 8; ++j) {
            for (int h = 0; h < 2; ++h) {
              for (int e = 0; e < 2; ++e) {
                const int slot = t * TC_BN + 8 * j + 2 * quad + e;
                float x = std::nanf("");
                if (slot < total) {
                  const long long pos = win.pos_of(slot);
                  const float* ah = aq.data() + ((2 * tid + h) * 2) * dp;
                  const float* al = ah + dp;
                  x = 0.0f;
                  if (bf16) {
                    for (int c = 0; c < dp; ++c) {
                      x += ah[c] * operand_at(op, n1, nch, 1, pos, c, 0);
                    }
                  } else {
                    for (int c = 0; c < dp; ++c) {
                      x += al[c] * operand_at(op, n1, nch, 0, pos, c, 0);
                    }
                    for (int c = 0; c < dp; ++c) {
                      x += ah[c] * operand_at(op, n1, nch, 0, pos, c, 1);
                    }
                    for (int c = 0; c < dp; ++c) {
                      x += ah[c] * operand_at(op, n1, nch, 0, pos, c, 0);
                    }
                  }
                }
                acc[4 * j + 2 * h + e] = x;
              }
            }
          }
          RowSel<KL> (&mine)[2] =
              *reinterpret_cast<RowSel<KL>(*)[2]>(rs.data() + 2 * tid);
          filter_tile<TC_BN / 8>(acc, mine, t * TC_BN, 2 * quad,
                                 total - t * TC_BN, k);
        }
        // the quad's cap, as the kernel's two shuffles
        for (int i = 0; i < 2 * threads; ++i) {
          const int q0 = 2 * ((i / 2) & ~3) + i % 2;
          float q = rs[q0].quarter;
          for (int o = 1; o < 4; ++o) q = std::max(q, rs[q0 + 2 * o].quarter);
          quads[i] = q;
        }
        for (int i = 0; i < 2 * threads; ++i) rs[i].tighten(quads[i]);
      }
      // the lists into shared memory and the merge, as the kernel's
      // epilogue
      for (int tid = 0; tid < threads; ++tid) {
        for (int h = 0; h < 2; ++h) {
          rs[2 * tid + h].list.store(lists_v.data() + h * nt + tid,
                                     lists_s.data() + h * nt + tid, 2 * nt,
                                     k);
        }
      }
      for (int tid = 0; tid < threads; ++tid) {
        const int h = tid % 4, wg = tid / 128, lane = tid % 32;
        const int rr = ((tid / 32) % 4) * 16 + lane / 4;
        if (h >= 2 || !rs[2 * tid + h].valid) continue;
        const long long rb = (wg * 64 + rr + 8 * h) * static_cast<long long>(k);
        const int q0 = tid & ~3;
        float* base_v = lists_v.data() + h * nt + q0;
        int* base_s = lists_s.data() + h * nt + q0;
        float* const lv[4] = {base_v, base_v + 1, base_v + 2, base_v + 3};
        int* const ls[4] = {base_s, base_s + 1, base_s + 2, base_s + 3};
        const int q = qpos[2 * tid + h];
        merge_quad(lv, ls, 2 * nt, k, win, n, merged_v.data() + rb,
                   merged_s.data() + rb);
        if (a.rank_v != nullptr) {
          for (int i = 0; i < k; ++i) {
            a.rank_v[static_cast<long long>(q) * k + i] = merged_v[rb + i];
            a.rank_i[static_cast<long long>(q) * k + i] = merged_s[rb + i];
          }
        }
        rerank_write<4>(a, q, merged_v.data() + rb, merged_s.data() + rb, 1);
      }
    }
  }
  return 0;
}

extern "C" int ivf_join_tc_launch(const void* xs, const void* sqn,
                                  const void* qstarts, const void* qparents,
                                  const void* starts, const void* counts,
                                  const void* nbrs, void* out_idx,
                                  void* out_dist, long long rows,
                                  long long row0, long long row_step, int n,
                                  int d, int k, int nprobe, int qcap, int cap,
                                  int bf16, void* operands, void* rank_v,
                                  void* rank_i, void*) {
  if (rows <= 0) return 0;
  if (k < 1 || k > tc_max_k(d, bf16, nprobe) || qcap < 1 || nprobe < 1) {
    return 1;
  }
  JoinArgs a;
  a.xs = static_cast<const float*>(xs);
  a.sqn = static_cast<const float*>(sqn);
  a.qstarts = static_cast<const int*>(qstarts);
  a.qparents = static_cast<const int*>(qparents);
  a.starts = static_cast<const int*>(starts);
  a.counts = static_cast<const int*>(counts);
  a.nbrs = static_cast<const int*>(nbrs);
  a.out_idx = static_cast<int*>(out_idx);
  a.out_dist = static_cast<float*>(out_dist);
  a.row0 = row0;
  a.row_step = row_step;
  a.n = n;
  a.d = d;
  a.k = k;
  a.nprobe = nprobe;
  a.qcap = qcap;
  a.cap = cap;
  a.bf16 = bf16;
  a.rank_v = static_cast<float*>(rank_v);
  a.rank_i = static_cast<int*>(rank_i);
  uint32_t* op = static_cast<uint32_t*>(operands);
  return tc_list_slots(k) == 12 ? host_tc<12>(a, rows, op)
                                 : host_tc<24>(a, rows, op);
}
"""


def tc_host_source() -> str:
    return PRELUDE + common_header() + TC_DRIVER


def build_tc(workdir: Path) -> Path:
    cpp = workdir / "ivf_join_tc_host.cpp"
    lib = workdir / "ivf_join_tc_host.so"
    cpp.write_text(tc_host_source())
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                   check=True)
    return lib


def load_tc_kernel(workdir: Path) -> ij.Kernel:
    """The host-built tensor-core library's entry points."""
    return ij._bind_tc(ctypes.CDLL(str(build_tc(workdir))))


def load_tc(workdir: Path):
    """The host-built tensor-core join, as the wrapper's kernel branch
    calls it."""
    return host_join(*load_tc_kernel(workdir))


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
    out["ties_k24"] = (plan(ints, 24, nlist=30, nprobe=5, cap=60, qcap=40),
                       "bfloat16", True)
    out["ties_k251"] = (plan(ints, 251, nlist=8, nprobe=4), "float32", True)
    higgs = clustered_rows(rng, 3000, 28)
    out["d28_k12_bf16"] = (plan(higgs, 12, nprobe=6), "bfloat16", False)
    out["d28_k12_f32_cut"] = (plan(higgs, 12, nlist=20, nprobe=4, cap=120,
                                   qcap=100), "float32", False)
    # the SIMT kernel's 32-column tiles beside lists of k 32: past the
    # default 48 KB of shared memory a block
    out["d28_k32"] = (plan(higgs, 32, nlist=16, nprobe=4), "float32", False)
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
