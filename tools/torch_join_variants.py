#!/usr/bin/env python3
"""Time variants of the IVF join kernels' sources on the card.

    python3 tools/torch_join_variants.py [--variants base tc ...]
        [--shapes slice_1m_x3_k12_float32 ...]

Each variant is ``csrc/ivf_join.cu`` (the SIMT route) or
``csrc/ivf_join_tc.cu`` (the tensor-core route), as it is or with parts
cut out by the patterns below, built by nvcc with the package's flags
into ``build/join_variants/``, all builds started together, and bound
with ``ops.ivf_join._bind`` / ``_bind_tc``.  On the join inputs of
chip_smoke.py's phases 3c and 4 (``knn.ivf.sorted_join_inputs``: the 11M
Higgs rows' large-graph join in bf16 at k 12, nprobe 24; the first 1M
rows in bf16 and in f32 at the parts' nprobe 32, and their first 16
columns in f32; the quality join at k 51; the parts' 1M x 2 clustered
cloud through the grid quantizer at k 10) and where the route rule's
TC_MIN_D and TC_MAX_K are set (the first 1M rows cut to 28, 16, 8, 5, 4
and 3 columns at k 6, 12, 16, 20, 24, 28 and 32, f32 and bf16, nprobe
32; the quality join's 300,000 x 3 rows at k 32), ``--shapes`` picking
some, each variant that serves the shape is
timed with CUDA events, in turns (every variant once, then in reverse,
twice; the mean of the four readings and their spread), and the result
of every variant marked held is held bit-equal to the first held
variant of its source.  The others cut out work to show where the time
goes and are timed only.  Prints each build's ptxas report, the card's
name and power limit and one JSON line; writes it to
build/join_variants/times.json.

Variants:
  base            csrc/ivf_join.cu as it is;
  wide_tile       every d <= 32 on the 32-column tile (the 4-, 8- and
                  16-column instances dropped);
  tc              csrc/ivf_join_tc.cu as it is;
  tc_no_select    without the selection (the filter and the quad's cap):
                  the pipeline, the products and the epilogue;
  tc_no_epilogue  without the merge and the rerank;
  tc_no_mma       without the selection and the products: the tile ring,
                  the prologue and the epilogue;
  tc_hot_only     the filter's minimum and compare and the quad's cap,
                  never the exact test (no list fills);
  tc_stages16     a ring of 16 tiles in place of 8;
  tc_no_cap       no quad cap: each thread's threshold from its own list;
  tc_cap4         the quad's cap every fourth tile;
  tc_one_wg       one consumer warpgroup a block at every k (several
                  blocks an SM, each with its own ring).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from annembed_tpu_torch.ops import _build  # noqa: E402
from annembed_tpu_torch.ops import ivf_join as ij  # noqa: E402

OUT = ROOT / "build" / "join_variants"
_SELECT = (r"(?s)    filter_tile<TC_BN / 8>\(acc.*?rs\[h\]\.tighten\(q\);\n"
           r"    \}\n", "    sm90::fence_regs(acc);\n")
_EPILOGUE = (r"(?s)    merge_quad\(lv, ls.*?rerank_write<4>\(a, q, mv \+ rb, "
             r"mid \+ rb, 1\);\n", "")
_HOT = (r"^    if \(m <= rs\[h\]\.thr\) \{$",
        "    if (m <= rs[h].thr && m < -3.0e38f) {")
_STAGES = (r"^constexpr int TC_STAGES = 8;", "constexpr int TC_STAGES = 16;")
_CAP = r"^    // the quad's cap on each row's k-th value, for the next tile\n"
_NO_CAP = (_CAP + r"(?s:.*?)rs\[h\]\.tighten\(q\);\n    \}\n", "")
_CAP4 = (_CAP + r"#pragma unroll\n    for \(int h = 0; h < 2; \+\+h\) \{",
         "#pragma unroll\n    for (int h = 0; h < 2 && (t & 3) == 3; ++h) {")
_ONE_WG = (r"^  for \(int c = slots == 12 \? 3 : 2; c >= 1; --c\) \{$",
           "  for (int c = 1; c >= 1; --c) {")
_MMA = (r"(?s)    sm90::wgmma_fence\(\);\n.*?sm90::wgmma_wait_all\(\);\n", "")
#: name -> (source, [(pattern, replacement)], held): each pattern must
#: match once (the SIMT dispatch lines: three)
VARIANTS = {
    "base": ("ivf_join", [], True),
    "wide_tile": ("ivf_join", [(r"^  if \(d <= (4|8|16)\) return .*\n", "")],
                  True),
    "tc": ("ivf_join_tc", [], True),
    "tc_no_select": ("ivf_join_tc", [_SELECT], False),
    "tc_no_epilogue": ("ivf_join_tc", [_EPILOGUE], False),
    "tc_no_mma": ("ivf_join_tc", [_SELECT, _MMA], False),
    "tc_hot_only": ("ivf_join_tc", [_HOT], False),
    "tc_stages16": ("ivf_join_tc", [_STAGES], True),
    "tc_no_cap": ("ivf_join_tc", [_NO_CAP], True),
    "tc_cap4": ("ivf_join_tc", [_CAP4], True),
    "tc_one_wg": ("ivf_join_tc", [_ONE_WG], True),
}
MATCHES = {"wide_tile": 3}


def patched(name: str) -> str:
    """The variant's source, the join's common header inlined so that
    patterns reach it too."""
    source, patterns, _ = VARIANTS[name]
    src = (_build.CSRC / f"{source}.cu").read_text().replace(
        '#include "ivf_join_common.cuh"\n',
        (_build.CSRC / "ivf_join_common.cuh").read_text()
        .replace("#pragma once\n", ""))
    matched = 0
    for pattern, repl in patterns:
        src, count = re.subn(pattern, repl, src, flags=re.M)
        matched += count
    if matched != MATCHES.get(name, len(patterns)):
        raise SystemExit(f"{name}: {matched} patterns matched, not "
                         f"{MATCHES.get(name, len(patterns))}")
    return src


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: patched(name) for name in names}
    procs, t0 = {}, time.perf_counter()
    for name in names:
        source = VARIANTS[name][0]
        cu = OUT / f"{name}.cu"
        cu.write_text(sources[name])
        cmd = [_build.find_nvcc(), *_build.nvcc_flags(source),
               f"-I{_build.CSRC}", "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    kernels, seconds = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name}:\n{err}")
        seconds[name] = time.perf_counter() - t0
        regs = sorted(set(re.findall(r"Used (\d+) registers", err)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", err)),
                        key=int)
        print(f"build {name}: {seconds[name]:.2f} s, registers {regs}, "
              f"spill stores {spills}", flush=True)
        bind = ij._bind_tc if VARIANTS[name][0] == "ivf_join_tc" else ij._bind
        kernels[name] = bind(ctypes.CDLL(str(OUT / f"{name}.so")))
    return kernels, seconds


def shapes(x):
    """name -> a thunk of (inputs, dtype) at the path's shapes and where
    the route rule's limits are set."""
    from annembed_tpu_torch.knn.ivf import sorted_join_inputs as plan

    def cols(d, rows=1_000_000):
        return x[:rows, :d].contiguous()

    def grid():
        rng = np.random.default_rng(cs.SEED)
        centers = rng.normal(0, 5, (8, 2))
        cloud = torch.from_numpy(
            (centers[rng.integers(0, 8, 1_000_000)]
             + rng.normal(0, 0.8, (1_000_000, 2))).astype(np.float32)).cuda()
        return plan(cloud, 10, quantizer="grid"), "float32"
    out = {"higgs_11m_bf16": lambda: (plan(x, 12, nprobe=24), "bfloat16"),
           "slice_1m_x28_bf16": lambda: (plan(cols(28), 12, nprobe=32),
                                         "bfloat16")}
    for d in (28, 16):
        out[f"slice_1m_x{d}_f32"] = (
            lambda d=d: (plan(cols(d), 12, nprobe=32), "float32"))
    for d in (28, 16, 8, 5, 4, 3):
        for k in (6, 12, 16, 20, 24, 28, 32):
            for dtype in ("float32", "bfloat16"):
                out[f"slice_1m_x{d}_k{k}_{dtype}"] = (
                    lambda d=d, k=k, dtype=dtype:
                    (plan(cols(d), k, nprobe=32), dtype))
    out["quality_300k_x3_k32"] = lambda: (
        plan(cols(3, 300_000), 32, nprobe=32), "float32")
    out["quality_300k_x3_k51"] = lambda: (
        plan(cols(3, 300_000), 51, nprobe=32), "float32")
    out["grid_1m_x2_k10"] = grid
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="the shapes to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    disable_tf32()
    kernels, seconds = build(args.variants)
    x = torch.from_numpy(zscore(synthetic_higgs(cs.N_ROWS,
                                                seed=cs.SEED))).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    record = {"nvcc_s": seconds, "shapes": {}}
    plans = shapes(x)
    for shape in args.shapes or plans:
        inp, dtype = plans[shape]()
        d, nprobe = inp["xs_pad"].shape[1], inp["cell_nbrs"].shape[1]
        runs = {name: (lambda kern=kern: ij._join(kern, stream, **inp,
                                                  dtype=dtype))
                for name, kern in kernels.items()
                if inp["k"] <= kern.max_k(d, int(dtype == "bfloat16"),
                                          nprobe)}
        first, out = {}, None
        for name, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            source, _, held = VARIANTS[name]
            if not held:
                continue
            if source not in first:
                first[source] = (name, out)
            elif not (torch.equal(out[0], first[source][1][0])
                      and torch.equal(out[1], first[source][1][1])):
                raise SystemExit(f"{name} differs from {first[source][0]} "
                                 f"at {shape}")
        del first, out
        order = list(runs)
        readings = {name: [] for name in order}
        for turn in (order, order[::-1], order, order[::-1]):
            for name in turn:
                readings[name].append(cs.cuda_ms(runs[name], 1))
        record["shapes"][shape] = {
            name: dict(ms=float(np.mean(r)), spread=float(np.ptp(r)),
                       readings=r) for name, r in readings.items()}
        print(shape, json.dumps({n: round(v["ms"], 4) for n, v in
                                 record["shapes"][shape].items()}),
              flush=True)
        del inp
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    record["card"] = smi
    print(smi)
    print(json.dumps(record))
    (OUT / "times.json").write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
