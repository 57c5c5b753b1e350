#!/usr/bin/env python3
"""Compile the NN-descent round kernel's C++ for the host and hold its
launcher to the torch round on the CPU: logic, indexing, the tie order
and every instance, without a card or nvcc.

    python3 tools/nndescent_host_check.py [--keep DIR]
    python3 tools/nndescent_host_check.py --card    # on a CUDA card

``csrc/nndescent.cu`` is built with one warp a block.  A prelude stands
in for the CUDA headers (qualifiers, ``float4``, ``uint2``, the bit
casts, the runtime calls the launcher makes) and runs a ``<<<...>>>``
launch as 32 fibers (``ucontext``) on the calling thread, one a lane,
each walking every block in turn.  Every warp intrinsic is a barrier:
the lane publishes its value, hands over to the next lane, and reads
the others' once all 32 have published (two buffers, so one hand-over
an intrinsic).  Built with g++ ``-ffp-contract=off`` against glibc's
sqrtf (correctly rounded, as the card's and PyTorch's).

Every case is held to the torch round (``nndescent_round_reference``)
on the same tables: on rows of small integers whose distances are
integer multiples of one square root (exact in any summation order and
any rounding of the root), bit for bit, ties included; on float rows
by ``agreement`` (ids equal outside near-ties, each differing id's
distance its own, distances within D_RTOL, inf where the twin has inf,
rows ascending).  The scored
candidates (``pairs``) are held equal on every case.  ``--card`` runs
the same cases through ``ops.nndescent.nndescent_round`` on CUDA
tensors instead of the host build.  Exits non-zero on a failed build or
check.
"""

from __future__ import annotations

import argparse
import functools
import re
import subprocess
import sys
import tempfile
import ctypes
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from annembed_tpu_torch.knn import nndescent as tnd  # noqa: E402
from annembed_tpu_torch.ops import nndescent as nd  # noqa: E402

SOURCE = ROOT / "annembed_tpu_torch" / "csrc" / "nndescent.cu"
# the emulation's dynamic shared array (one warp: 2 P + 4 ceil(d / 4)
# floats at most)
HOST_DYN_SMEM_FLOAT4 = 4096
TIE_REL, D_RTOL = 1e-5, 1e-5

PRELUDE = r"""
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#define NND_WARPS 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 0, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
dim3 blockIdx, threadIdx, gridDim, blockDim;
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
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
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// two SMs of two resident blocks: four warps walk the rows
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* v, F, int, int) {
  *v = 2;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// a launch of one warp a block: 32 fibers on this thread, lane t runs
// until its next warp intrinsic, then hands over to lane t + 1; lane 31
// hands back to lane 0, so each intrinsic is a barrier
namespace host {
ucontext_t main_ctx, ctx[32];
int cur = 0;
unsigned blocks = 0, block_of[32];
int parity[32];
unsigned long long xchg[2][32];
std::function<void()> body;

inline void yield() {
  const int me = cur, nx = (me + 1) & 31;
  cur = nx;
  threadIdx = dim3(nx);
  blockIdx = dim3(block_of[nx]);
  swapcontext(&ctx[me], &ctx[nx]);
}

// publish ``v``, wait for every lane; returns the buffer to read
template <class T>
inline int publish(T v) {
  const int me = static_cast<int>(threadIdx.x);
  const int p = parity[me];
  parity[me] ^= 1;
  unsigned long long w = 0;
  std::memcpy(&w, &v, sizeof v);
  xchg[p][me] = w;
  yield();
  return p;
}

template <class T>
inline T read(int p, int lane) {
  T out;
  std::memcpy(&out, &xchg[p][lane & 31], sizeof out);
  return out;
}

void entry() {
  const int me = cur;
  for (unsigned b = 0; b < blocks; ++b) {
    block_of[me] = b;
    blockIdx = dim3(b);
    body();
    yield();
  }
  yield();
  setcontext(&main_ctx);  // lane 0, once every lane is done
}
}  // namespace host

template <class F>
void host_launch(unsigned blocks, int threads, F kernel) {
  if (threads != 32) std::abort();
  std::vector<std::vector<char>> stacks(32, std::vector<char>(1 << 18));
  host::blocks = blocks;
  host::body = kernel;
  for (int t = 0; t < 32; ++t) {
    host::parity[t] = 0;
    host::block_of[t] = 0;
    getcontext(&host::ctx[t]);
    host::ctx[t].uc_stack.ss_sp = stacks[t].data();
    host::ctx[t].uc_stack.ss_size = stacks[t].size();
    host::ctx[t].uc_link = nullptr;
    makecontext(&host::ctx[t], host::entry, 0);
  }
  gridDim = dim3(blocks);
  blockDim = dim3(32);
  host::cur = 0;
  threadIdx = dim3(0);
  blockIdx = dim3(0);
  swapcontext(&host::main_ctx, &host::ctx[0]);
  host::body = nullptr;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return host::read<T>(host::publish(v), src);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  const int me = static_cast<int>(threadIdx.x);
  return host::read<T>(host::publish(v), me ^ mask);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int me = static_cast<int>(threadIdx.x);
  const int src = me >= static_cast<int>(delta) ? me - static_cast<int>(delta)
                                                : me;
  return host::read<T>(host::publish(v), src);
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const int p = host::publish(v);
  unsigned m = host::read<unsigned>(p, 0);
  for (int t = 1; t < 32; ++t) m = std::min(m, host::read<unsigned>(p, t));
  return m;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int p = host::publish(static_cast<unsigned>(pred));
  unsigned bits = 0;
  for (int t = 0; t < 32; ++t) {
    if (host::read<unsigned>(p, t)) bits |= 1u << t;
  }
  return bits;
}
inline void __syncwarp(unsigned = 0xffffffffu) { host::yield(); }
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
    cpp = workdir / "nndescent_host.cpp"
    lib = workdir / "nndescent_host.so"
    cpp.write_text(host_source())
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-shared", "-fPIC", "-o",
                    str(lib), str(cpp)], check=True)
    return lib


def load(workdir: Path):
    """The host-built round, as the wrapper's kernel branch calls it."""
    return functools.partial(nd._round, nd._bind(ctypes.CDLL(str(build(
        workdir)))), None)


def _rows(rng, n, d, ints):
    """Float rows of 6 clusters; or, with ``ints``, one small integer a
    row copied into m = floor(sqrt(d))^2 random columns (0 elsewhere), so
    every distance is sqrt(m) times an integer, exact whatever rounds the
    square root (PyTorch's CPU sqrt is not always correctly rounded), and
    ties are many."""
    if ints:
        m = int(np.sqrt(d)) ** 2
        x = np.zeros((n, d), np.float32)
        x[:, rng.choice(d, m, replace=False)] = rng.integers(-20, 21,
                                                              (n, 1))
        return torch.from_numpy(x)
    centers = rng.normal(size=(6, d)) * 3
    return torch.from_numpy((centers[rng.integers(0, 6, n)]
                             + rng.normal(size=(n, d))).astype(np.float32))


def _lists(x, k, rng, hubs=0):
    """An approximate (n, k) graph of ``x``: each row's k nearest among a
    random fifth of the rows, ascending; with ``hubs`` every row lists
    only the first ``hubs`` rows (repeats included), so most rows have
    no reverse neighbours and their candidates are pads and repeats."""
    n = x.shape[0]
    d2 = torch.cdist(x.double(), x.double())
    d2.fill_diagonal_(float("inf"))
    if hubs:
        idx = torch.from_numpy(rng.integers(0, hubs, (n, k)))
    else:
        keep = torch.from_numpy(rng.random((n, n)) < 0.2)
        d2 = d2.masked_fill(~keep, float("inf"))
        idx = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        idx = torch.where(torch.isinf(d2.gather(1, idx)),
                          torch.from_numpy(rng.integers(0, n, (n, k))), idx)
    dist = torch.sqrt(torch.square(x[:, None, :] - x[idx]).sum(-1))
    dist, order = torch.sort(dist, dim=1, stable=True)
    return idx.gather(1, order).to(torch.int32), dist.contiguous()


def case(name, n, d, k, rho, dtype, ints=True, seed=0, hubs=0, slab=None):
    """One round's inputs as ``nndescent_refine`` builds them (the union
    table, its rho-sampled subset from seeded uniforms), and whether the
    kernel must match the twin bit for bit."""
    rng = np.random.default_rng(seed)
    x = _rows(rng, n, d, ints)
    idx, dist = _lists(x, k, rng, hubs)
    x_score = x.to(torch.bfloat16) if dtype == "bfloat16" else x
    x_pad = torch.cat([x_score, x_score.new_zeros((1, d))])
    union_pp = tnd._union_pp(idx, k, dist)
    u = union_pp.shape[1]
    s = u if rho >= 1.0 else max(2, int(round(rho * u)))
    inner_pp = union_pp
    if s < u:
        un = torch.from_numpy(rng.random(union_pp.shape).astype(np.float32))
        inner_pp = tnd._sample_union_pp(un, union_pp, s)
    inp = dict(x_pad=x_pad, inner_pp=inner_pp.contiguous(),
               union_pp=union_pp, indices=idx, dists=dist,
               slab=slab or max(1, n // 3))
    return name, inp, ints


#: the checks' shapes: the Higgs cell's (k 12, rho 0.5: C 168, d 28, bf16),
#: f32 rows at d 28, the 512-slot sort (k 20, rho 0.5: C 440), unaligned
#: and wide rows (d 5, 2, 100, 200: one and two vectors a lane), rows
#: whose candidates are nearly all pads or repeats, and float rows:
#: (n, d, k, rho, dtype) and the keywords of ``case``
SPECS = {
    "ints_k12_rho05_bf16_d28": ((160, 28, 12, 0.5, "bfloat16"), {}),
    "ints_k12_rho05_f32_d28": ((120, 28, 12, 0.5, "float32"), dict(seed=1)),
    "ints_k20_rho05_f32_d8": ((90, 8, 20, 0.5, "float32"), dict(seed=2)),
    "ints_k6_rho1_bf16_d5": ((120, 5, 6, 1.0, "bfloat16"), dict(seed=3)),
    "ints_k4_rho1_f32_d2": ((100, 2, 4, 1.0, "float32"), dict(seed=4)),
    "ints_k8_rho05_f32_d100": ((60, 100, 8, 0.5, "float32"), dict(seed=5)),
    "ints_k6_rho05_bf16_d200": ((50, 200, 6, 0.5, "bfloat16"),
                                dict(seed=6)),
    "pads_and_repeats": ((80, 6, 12, 0.5, "float32"), dict(seed=7, hubs=4)),
    "float_k12_rho05_bf16_d28": ((150, 28, 12, 0.5, "bfloat16"),
                                 dict(ints=False, seed=8)),
    "float_k10_rho1_f32_d16": ((100, 16, 10, 1.0, "float32"),
                               dict(ints=False, seed=9)),
}
CASE_NAMES = tuple(SPECS)


def cases():
    """Every case of ``SPECS``: (name, inputs, exact)."""
    return [case(name, *args, **kw) for name, (args, kw) in SPECS.items()]


def _clear_ties(dist):
    """Columns further than TIE_REL (relative) from both row neighbours'
    distances, and finite (``assert_graphs_agree``'s rule)."""
    scale = np.maximum(np.abs(dist), 1e-6)
    gap = np.full(dist.shape, np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        step = np.diff(dist, axis=1)
        gap[:, 1:] = step / scale[:, 1:]
        gap[:, :-1] = np.minimum(gap[:, :-1], step / scale[:, :-1])
    return (gap > TIE_REL) & np.isfinite(dist)


def own_distances(x_pad, rows, ids):
    """The DistL2 pair form of each (row, id) recomputed from ``x_pad``:
    f32 sums of the differences of the scoring dtype's operands."""
    dev = x_pad.device
    out = []
    for at in range(0, len(rows), 1 << 20):
        q = x_pad[torch.from_numpy(rows[at:at + (1 << 20)]).to(dev)].float()
        c = x_pad[torch.from_numpy(ids[at:at + (1 << 20)]).long()
                  .to(dev)].float()
        out.append(torch.sqrt(torch.square(q - c).sum(-1).clamp_min(0.0))
                   .cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def agreement(got_i, got_d, want_i, want_d, x_pad) -> dict:
    """How a round's (n, k) output agrees with the twin's on the scoring
    rows ``x_pad``: ``id_mismatch``, columns whose ids differ where the
    twin's column is clear of its row neighbours by TIE_REL (relative),
    the last column excused where the two distances are within TIE_REL
    (a near-tie with an entry neither side lists); ``own_mismatch``,
    columns whose ids differ where the kernel's distance is not that of
    its own id recomputed from ``x_pad`` within D_RTOL (so a swapped
    (id, distance) pair fails even at a near-tie); ``dist_mismatch``,
    finite columns whose two distances differ by more than D_RTOL (both
    are the k smallest of the same candidates: equal up to the sums'
    rounding, whatever the ids); entries inf on one side only, rows not
    ascending, and bit equality."""
    gi, gd = got_i.cpu().numpy(), got_d.cpu().numpy()
    wi, wd = want_i.cpu().numpy(), want_d.cpu().numpy()
    with np.errstate(invalid="ignore"):
        rel = np.abs(gd - wd) / np.maximum(np.abs(wd), 1e-30)
        unsorted = (np.diff(gd, axis=1) < 0).any(1)
    finite = np.isfinite(gd) & np.isfinite(wd)
    differ = gi != wi
    excused = ~_clear_ties(wd)
    excused[:, -1] |= rel[:, -1] <= TIE_REL
    rows, cols = np.nonzero(differ & np.isfinite(gd))
    own = own_distances(x_pad, rows, gi[rows, cols])
    got = gd[rows, cols]
    own_rel = np.abs(own - got) / np.maximum(np.abs(got), 1e-30)
    return dict(id_mismatch=int((differ & ~excused).sum()),
                own_mismatch=int((own_rel > D_RTOL).sum()),
                dist_mismatch=int((rel[finite] > D_RTOL).sum()),
                inf_mismatch=int((np.isinf(gd) != np.isinf(wd)).sum()),
                unsorted_rows=int(unsorted.sum()),
                bit_equal=bool(np.array_equal(gi, wi)
                               and np.array_equal(gd.view(np.uint32),
                                                  wd.view(np.uint32))))


def run_case(round_fn, inp, exact, rank=0, size=1):
    """The kernel branch (``round_fn``, ``nd._round`` with a launcher)
    against the twin on one case; returns (ok, detail)."""
    kw = dict(inp)
    dev = kw["x_pad"].device
    p_got = torch.zeros((), dtype=torch.int64, device=dev)
    p_want = torch.zeros((), dtype=torch.int64, device=dev)
    got = round_fn(**kw, rank=rank, size=size, pairs=p_got)
    want = nd.nndescent_round_reference(**kw, rank=rank, size=size,
                                        pairs=p_want)
    agree = agreement(*got, *want, kw["x_pad"])
    agree.update(pairs=int(p_got), pairs_twin=int(p_want))
    ok = (agree["pairs"] == agree["pairs_twin"]
          and (agree["bit_equal"] if exact else
               not (agree["id_mismatch"] or agree["own_mismatch"]
                    or agree["dist_mismatch"] or agree["inf_mismatch"]
                    or agree["unsorted_rows"])))
    return ok, agree


def run_mesh(round_fn, inp, size):
    """The ranks' outputs of ``size`` launches sum to the one launch's,
    bit for bit, and their scored counts to its count."""
    dev = inp["x_pad"].device
    whole_p = torch.zeros((), dtype=torch.int64, device=dev)
    whole = round_fn(**inp, pairs=whole_p)
    parts_p = torch.zeros((), dtype=torch.int64, device=dev)
    acc_i, acc_d = torch.zeros_like(whole[0]), torch.zeros_like(whole[1])
    for rank in range(size):
        i, dd = round_fn(**inp, rank=rank, size=size, pairs=parts_p)
        acc_i += i
        acc_d += dd
    ok = (torch.equal(acc_i, whole[0]) and torch.equal(acc_d, whole[1])
          and int(parts_p) == int(whole_p))
    return ok, dict(pairs=int(whole_p), rank_pairs=int(parts_p))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keep", help="build in this directory and keep it")
    ap.add_argument("--card", action="store_true",
                    help="run the cases through the card's kernel")
    args = ap.parse_args()
    if args.card:
        dev = torch.device("cuda")

        def round_fn(**kw):
            kw = {key: (v.to(dev) if torch.is_tensor(v) else v)
                  for key, v in kw.items()}
            return nd.nndescent_round(**kw)
    else:
        dev = torch.device("cpu")
        work = Path(args.keep or tempfile.mkdtemp(prefix="nnd_host_"))
        work.mkdir(parents=True, exist_ok=True)
        round_fn = load(work)
    torch.set_num_threads(1)
    bad = 0
    for name, inp, exact in cases():
        inp = {key: (v.to(dev) if torch.is_tensor(v) else v)
               for key, v in inp.items()}
        ok, detail = run_case(round_fn, inp, exact)
        print(f"{name}: {'ok' if ok else 'FAIL'} {detail}", flush=True)
        bad += not ok
    name, inp, _ = cases()[0]
    inp = {key: (v.to(dev) if torch.is_tensor(v) else v)
           for key, v in inp.items()}
    ok, detail = run_mesh(round_fn, inp, 3)
    print(f"{name} over 3 ranks: {'ok' if ok else 'FAIL'} {detail}",
          flush=True)
    bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
