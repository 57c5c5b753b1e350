#!/usr/bin/env python3
"""Compile ``csrc/dense_sweep.cu`` as host C++ and hold its launchers to
the plain twins on the CPU: logic and indexing of the kernels without a
card or nvcc.

    python3 tools/dense_sweep_host_check.py [--n 1503] [--keep DIR]

A prelude stands in for the CUDA headers (qualifiers, vector types,
``__ldg`` / ``__ldcg``, the runtime calls the launchers make).  A
``<<<...>>>`` launch becomes a loop over every block and thread.  The
cooperative launch runs one OS thread per emulated GPU thread, two
emulated SMs of one block each, and ``grid.sync()`` is a
``std::barrier`` over all of them, so every thread finishes a phase
before any starts the next.  Built with g++ ``-ffp-contract=off`` (the
kernel's ``-fmad=false``) against glibc's expf / logf / powf, which may
differ from the card's and from PyTorch's by an ulp: the launchers are
held bit-equal to each other (two launches; the persistent launch and
the per-sweep pair) and to the twins within chip_smoke.py's bands; the
node-block loop of ``dense_optimize`` at d = 3 runs through the pair's
wrappers with the host-built launchers in place of the card's; the
compile-time instances are held bit-equal to the runtime-bound one (the
source's runtime variant, tools/torch_sweep_variants.py).
Exits non-zero on a failed build or check.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from annembed_tpu_torch.ops import dense_sweep as ds  # noqa: E402

# chip_smoke.py's bands against the twin, relative to max|y|
ATT_REL, SWEEP_REL = 1e-5, 1e-4

PRELUDE = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 blockIdx(0), threadIdx(0), gridDim(1), blockDim(1);
struct float2 { float x, y; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorCooperativeLaunchTooLarge = 720 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
constexpr int EMULATED_SMS = 2;
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMULATED_SMS;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, std::size_t) {
  *n = 1;
  return cudaSuccess;
}
std::barrier<>* grid_barrier = nullptr;
namespace cooperative_groups {
struct grid_group {
  void sync() { grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
// a <<<blocks, threads>>> launch: every block and thread in turn
template <class F>
void host_launch(unsigned blocks, unsigned threads, F body) {
  gridDim = dim3(blocks);
  blockDim = dim3(threads);
  for (unsigned b = 0; b < blocks; ++b) {
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx = dim3(b);
      threadIdx = dim3(t);
      body();
    }
  }
}
template <class... P, std::size_t... I>
void call_with(void (*f)(P...), void** a, std::index_sequence<I...>) {
  f(*static_cast<std::remove_reference_t<P>*>(a[I])...);
}
// a cooperative launch: one OS thread per GPU thread, grid.sync() a
// barrier over all of them
template <class... P>
cudaError_t cudaLaunchCooperativeKernel(void (*f)(P...), dim3 grid,
                                        dim3 block, void** args, std::size_t,
                                        cudaStream_t) {
  const unsigned total = grid.x * block.x;
  std::barrier<> bar(total);
  grid_barrier = &bar;
  std::vector<std::thread> pool;
  for (unsigned b = 0; b < grid.x; ++b) {
    for (unsigned t = 0; t < block.x; ++t) {
      pool.emplace_back([=] {
        gridDim = grid;
        blockDim = block;
        blockIdx = dim3(b);
        threadIdx = dim3(t);
        call_with(f, args, std::index_sequence_for<P...>{});
      });
    }
  }
  for (auto& th : pool) th.join();
  grid_barrier = nullptr;
  return cudaSuccess;
}
"""


def host_source(variant: str = "base") -> str:
    from tools.torch_sweep_variants import patched
    src = patched(variant)
    src = src.replace("#include <cooperative_groups.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>\n", PRELUDE)
    src, launches = re.subn(
        r"(\w+<[^<>;]*>)<<<([^;]+?), (\w+), 0, st>>>\((\w+)\);",
        r"host_launch(\2, \3, [&] { \1(\4); });", src)
    src, coop = re.subn(r"reinterpret_cast<const void\*>\((\w+)\)", r"\1",
                        src)
    if launches != 2 or coop != 1:
        raise SystemExit(f"unexpected source: {launches} <<<>>> launches, "
                         f"{coop} cooperative launches")
    return src


def build(workdir: Path, variant: str = "base") -> Path:
    cpp = workdir / f"dense_sweep_host_{variant}.cpp"
    lib = workdir / f"dense_sweep_host_{variant}.so"
    cpp.write_text(host_source(variant))
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-o", str(lib),
                    str(cpp)], check=True)
    return lib


def inputs(seed, n, d=2, k=6, kg=3, hub=True):
    rng = np.random.default_rng(seed)
    idx_full = np.stack([rng.choice(np.delete(np.arange(n), i), k,
                                    replace=False)
                         for i in range(n)]).astype(np.int32)  # (n, k)
    w = rng.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    w_rev = np.where(rng.uniform(size=(n, k)) < 0.5,
                     rng.uniform(0.05, 1.0, (n, k)), 0.0).astype(np.float32)
    t = torch.from_numpy
    scale = t(rng.uniform(0.5, 2.0, n).astype(np.float32))
    edges = ds.pack_groups(t(idx_full), t(w), t(2 * w), t(w_rev),
                           t(2 * w_rev), scale, k // kg)
    return dict(y=t(rng.normal(size=(n, d)).astype(np.float32) * 3),
                edges=edges, scale=scale,
                idx_full=t(np.ascontiguousarray(idx_full.T)),
                nw=(t(rng.uniform(0.25, 4.0, n).astype(np.float32))
                    if hub else None),
                noise=t((rng.normal(size=(n, d)) * 0.1).astype(np.float32)),
                mask=t((rng.uniform(size=(kg, n)) < 0.7).astype(np.float32)))


def check(name, ok, detail):
    print(f"{name}: {'ok' if ok else 'FAILED'} ({detail})", flush=True)
    return ok


def pair_sweep(att, kick, y, y_src, lo, rows, edges, p, gamma, b, n_neg,
               knobs, mask=None, mask_p=1.0, flat=False):
    """One sweep of rows [lo, lo + rows) through the host-built pair."""
    a = torch.empty((rows, y.shape[1]), dtype=torch.float32)
    out = torch.empty_like(a)
    # every tensor whose pointer the launch takes stays referenced here
    e = edges[lo:lo + rows].contiguous()
    ids = p["idx_full"][:, lo:lo + rows].contiguous()
    err = att(*ds._attraction_args(y, y_src, lo, e, p["scale"], gamma, b,
                                   1e-3, mask, mask_p, a), None)
    assert err == 0
    err = kick(*ds._kick_args(y, a, lo, knobs["offset"], ids,
                              p["scale"], gamma, b, n_neg, knobs["nw"],
                              knobs["exclusion"], knobs["parallel"], flat,
                              out), None)
    assert err == 0
    return a, out


def run_pair_cases(att, kick, n) -> bool:
    """The pair against its twins, per knob."""
    ok = True
    cases = {
        "whole": dict(),
        "block_wrap": dict(lo=n // 3, rows=n // 2, offset=n - 7),
        "parallel_kicks": dict(parallel=True),
        "mask": dict(mask_p=0.7),
        "stale": dict(stale=True),
        "b_1.5": dict(b=1.5),
        "no_exclusion": dict(exclusion=False, hub=False),
        "n_neg_7": dict(n_neg=7),
        "n_neg_20": dict(n_neg=20),
        "d_3": dict(d=3),
        "d_5_block": dict(d=5, lo=11, rows=n // 2, parallel=True),
    }
    for name, c in cases.items():
        p = inputs(1, n, d=c.get("d", 2), hub=c.get("hub", True))
        lo = c.get("lo", 0)
        rows = c.get("rows", n - lo)
        y = p["y"]
        y_src = y + p["noise"] if c.get("stale") else y
        mask_p = c.get("mask_p", 1.0)
        mask = (p["mask"][:, lo:lo + rows].contiguous() if mask_p < 1.0
                else None)
        b, n_neg, gamma = c.get("b", 1.0), c.get("n_neg", 5), 0.9
        knobs = dict(offset=c.get("offset", 123), nw=p["nw"],
                     exclusion=c.get("exclusion", True),
                     parallel=c.get("parallel", False))
        flat = rows == n
        e = p["edges"][0]
        a, out = pair_sweep(att, kick, y, y_src, lo, rows, e, p, gamma, b,
                            n_neg, knobs, mask, mask_p, flat)
        a2, out2 = pair_sweep(att, kick, y, y_src, lo, rows, e, p, gamma, b,
                              n_neg, knobs, mask, mask_p, flat)
        a_t = ds.dense_attraction_rows_reference(
            y, y_src, lo, e[lo:lo + rows].contiguous(), p["scale"], gamma,
            b, mask=mask, mask_p=mask_p)
        o_t = ds.dense_kick_rows_reference(
            y, a_t, lo, knobs["offset"],
            p["idx_full"][:, lo:lo + rows].contiguous(), p["scale"], gamma, b,
            n_neg, neg_weight=knobs["nw"],
            neighbor_exclusion=knobs["exclusion"],
            parallel_kicks=knobs["parallel"], flat=flat)
        y_max = float(y.abs().max())
        att_err = float((a - a_t).abs().max())
        err = float((out - o_t).abs().max())
        ok &= check(f"pair {name}",
                    torch.equal(a, a2) and torch.equal(out, out2)
                    and att_err <= ATT_REL * y_max
                    and err <= SWEEP_REL * y_max,
                    f"attraction {att_err:.3e}, sweep {err:.3e}, max|y| "
                    f"{y_max:.3e}")
    return ok


def run_persistent_cases(att, kick, sweeps, n) -> bool:
    """The persistent launch over six sweeps against the pair over the
    same sweeps (bit-equal, at gamma 0.9 then 0.6) and against its twin
    (at gamma 0.02 then 0.01: over several sweeps the expansive map
    amplifies the libraries' one-ulp differences past any band at the
    default step, as tests/test_torch_dense.py pins whole runs)."""
    ok = True
    cases = {
        "default": dict(),
        "stale": dict(stale=True),
        "parallel_kicks": dict(parallel=True),
        "no_exclusion": dict(exclusion=False, hub=False),
        "b_1.5": dict(b=1.5),
        "n_neg_10": dict(n_neg=10),
        "n_neg_2": dict(n_neg=2),
        "n_neg_3": dict(n_neg=3),
        "d_3": dict(d=3),
        "d_4": dict(d=4),
    }
    for name, c in cases.items():
        p = inputs(2, n, d=c.get("d", 2), hub=c.get("hub", True))
        y0 = p["y"]
        snap = y0 + p["noise"] if c.get("stale") else None
        b, n_neg = c.get("b", 1.0), c.get("n_neg", 5)
        offs = torch.tensor([17, n - 1, 101, 5, n // 2, 62])
        groups = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32)
        exclusion = c.get("exclusion", True)
        parallel = c.get("parallel", False)
        a = torch.empty_like(y0)

        def launch(gammas):
            y = y0.clone()
            err = sweeps(*ds._sweeps_args(
                y, snap, a, p["edges"], p["scale"], gammas, offs, groups, b,
                n_neg, p["idx_full"], 1e-3, p["nw"], exclusion, parallel),
                None)
            assert err == 0
            return y

        gammas = torch.tensor([0.9, 0.9, 0.9, 0.6, 0.6, 0.6])
        got, again = launch(gammas), launch(gammas)
        pair = y0.clone()
        for s in range(6):
            knobs = dict(offset=int(offs[s]), nw=p["nw"], exclusion=exclusion,
                         parallel=parallel)
            _, out = pair_sweep(att, kick, pair,
                                pair if snap is None else snap, 0, n,
                                p["edges"][int(groups[s])], p,
                                float(gammas[s]), b, n_neg, knobs, flat=True)
            pair.copy_(out)
        small = torch.tensor([0.02, 0.02, 0.02, 0.01, 0.01, 0.01])
        slow = launch(small)
        twin = ds.dense_sweeps_reference(
            y0.clone(), snap, p["edges"], p["scale"], small, offs, groups,
            b, n_neg, p["idx_full"], neg_weight=p["nw"],
            neighbor_exclusion=exclusion, parallel_kicks=parallel)
        y_max = float(y0.abs().max())
        err = float((slow - twin).abs().max())
        ok &= check(f"persistent {name}",
                    torch.equal(got, again) and torch.equal(got, pair)
                    and err <= SWEEP_REL * y_max,
                    f"vs pair bit-equal {torch.equal(got, pair)}, moved "
                    f"{float((got - y0).abs().max()):.3e}; at gamma 0.02 vs "
                    f"twin {err:.3e}, max|y| {y_max:.3e}")
    return ok


def host_pair(att, kick):
    """The pair's wrappers with the host-built launchers in place of the
    card's: the CUDA branch of ``dense_attraction_rows`` /
    ``dense_kick_rows`` (checks, alignment, output, launch) on CPU
    tensors."""
    def attraction(y, y_src, lo, edges, scale, gamma, b, f_min=1e-3,
                   mask=None, mask_p=1.0):
        ds._check_attraction(y, y_src, lo, edges, scale, mask)
        ds._check_aligned(y.shape[1], edges, y=y, y_src=y_src)
        out = torch.empty((edges.shape[0], y.shape[1]), dtype=torch.float32)
        assert att(*ds._attraction_args(y, y_src, lo, edges, scale, gamma, b,
                                        f_min, mask, mask_p, out), None) == 0
        return out

    def kicks(y, a, lo, offset, idx_full, scale, gamma, b, n_neg,
              neg_weight=None, neighbor_exclusion=True, parallel_kicks=False,
              flat=False, out=None):
        ds._check_kick(y, a, lo, offset, idx_full, scale, n_neg, neg_weight,
                       out)
        out = torch.empty_like(a) if out is None else out
        ds._check_aligned(y.shape[1], y=y, a=a, out=out)
        assert kick(*ds._kick_args(y, a, lo, offset, idx_full, scale, gamma,
                                   b, n_neg, neg_weight, neighbor_exclusion,
                                   parallel_kicks, flat, out), None) == 0
        return out
    return attraction, kicks


def run_node_blocks_d3(att, kick, n) -> bool:
    """``dense_optimize(n_blocks=3)`` at d = 3, whose second block starts
    at an odd row (its rows 4 bytes off an 8-byte word), each sweep's
    kicks written into y's own rows, through the host-built pair against
    the same call on the twins, at a step small enough that six sweeps
    stay within the pair's band."""
    from annembed_tpu_torch.optim import dense as td
    rng = np.random.default_rng(4)
    k, t = 6, torch.from_numpy
    idx = t(rng.integers(0, n, (n, k)).astype(np.int32))
    w = t(rng.uniform(0.05, 1.0, (n, k)).astype(np.float32))
    args = (t(rng.normal(size=(n, 3)).astype(np.float32) * 3), idx, w,
            2 * w, w.flip(0), 2 * w.flip(0),
            t(rng.uniform(0.5, 2.0, n).astype(np.float32)),
            t(rng.uniform(0.25, 4.0, n).astype(np.float32)))
    kw = dict(grad_step_init=0.02, b=1.0, n_sub=3, n_neg=5, nb_grad_batch=4,
              n_groups=2, batch0=0, batch1=2, n_blocks=3,
              offsets=[17, n - 4, 101, 5, n // 2, 62])
    saved = td.dense_attraction_rows, td.dense_kick_rows
    td.dense_attraction_rows, td.dense_kick_rows = host_pair(att, kick)
    try:
        got = td.dense_optimize(*args, **kw)
    finally:
        td.dense_attraction_rows, td.dense_kick_rows = saved
    twin = td.dense_optimize(*args, **kw)
    lo = td._block_bounds(n, 3)[1][0]
    y_max = float(args[0].abs().max())
    err = float((got - twin).abs().max())
    return check("node blocks d_3", lo % 2 == 1 and err <= SWEEP_REL * y_max,
                 f"second block from row {lo}, vs twins {err:.3e}, max|y| "
                 f"{y_max:.3e}")


def run_instances(base, runtime, n) -> bool:
    """The compile-time instances (d 2, kg 3; n_neg 5, 10) against the
    runtime-bound instance of d 2 (the source's runtime variant, built
    alike) on the same six sweeps, through the persistent launch and the
    pair: bit-equal."""
    ok = True
    for n_neg in (5, 10):
        p = inputs(3, n)
        offs = torch.tensor([17, n - 1, 101, 5, n // 2, 62])
        groups = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32)
        gammas = torch.tensor([0.9, 0.9, 0.9, 0.6, 0.6, 0.6])
        a = torch.empty_like(p["y"])
        got = []
        for att, kick, sweeps in (base, runtime):
            y = p["y"].clone()
            assert sweeps(*ds._sweeps_args(
                y, None, a, p["edges"], p["scale"], gammas, offs, groups,
                1.0, n_neg, p["idx_full"], 1e-3, p["nw"], True, False),
                None) == 0
            knobs = dict(offset=offs[0], nw=p["nw"], exclusion=True,
                         parallel=False)
            got += [y, *pair_sweep(att, kick, p["y"], p["y"], 0, n,
                                   p["edges"][0], p, 0.9, 1.0, n_neg, knobs,
                                   flat=True)]
        same = all(torch.equal(x, z) for x, z in zip(got[:3], got[3:]))
        ok &= check(f"instances n_neg {n_neg}", same,
                    "compile-time and runtime-bound bit-equal: persistent, "
                    "attraction, kicks")
    return ok


def run_all(workdir: Path, n: int) -> bool:
    """Every case of the source built as host code in ``workdir``."""
    base = ds._bind(ctypes.CDLL(str(build(workdir))))
    att, kick, sweeps = base
    ok = run_pair_cases(att, kick, n)
    ok = run_node_blocks_d3(att, kick, n) and ok
    ok = run_persistent_cases(att, kick, sweeps, n) and ok
    runtime = ds._bind(ctypes.CDLL(str(build(workdir, "runtime"))))
    return run_instances(base, runtime, n) and ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1503,
                    help="rows (above 512 every emulated thread of the "
                         "persistent launch takes several; not a multiple "
                         "of n_neg, so some rows fall outside the kick "
                         "groups)")
    ap.add_argument("--keep", type=Path, default=None,
                    help="build here instead of a temporary directory")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.keep or Path(tmp)
        workdir.mkdir(parents=True, exist_ok=True)
        ok = run_all(workdir, args.n)
    print("host check:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
