#!/usr/bin/env python3
"""Count what the tensor-core IVF join's selection does, on the host.

    python3 tools/ivf_join_tc_counts.py [--rows 30000] [--cells 36]
        [--nprobe 24] [--k 12] [--dtype bfloat16]

Builds the route's host emulation (``tools/ivf_join_host_check.py``'s
``load_tc``: the kernel's own filter, exact test and insertion from
``csrc/ivf_join_common.cuh`` on fragments of a plain product) with
counters added, and joins ``synthetic_higgs`` rows (seed 7, z-scored)
planned by ``knn.ivf.sorted_join_inputs``.  The defaults give cells of
~830 rows and nprobe 24, the windows of chip_smoke.py's 11M join at
a size the CPU runs in about a minute.  Prints per query the exact tests
and the insertions, the share of thread-row tiles whose minimum passes
the threshold, the share of warp-row tiles where some thread's does,
and the loop rounds a warp runs per warp-row tile (the largest number
of passing columns among its threads).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore  # noqa
from annembed_tpu_torch.knn.ivf import sorted_join_inputs  # noqa: E402
from annembed_tpu_torch.ops import ivf_join as ij  # noqa: E402
from tools import ivf_join_host_check as host  # noqa: E402

# (anchor in the host source, the same text with its counter)
PATCHES = [
    ("namespace ivfj {",
     "long long g_tests = 0, g_inserts = 0, g_enter = 0, g_rowtiles = 0,\n"
     "    g_rounds = 0, g_wenter = 0, g_wrowtiles = 0;\n"
     "int g_it[2];\nbool g_flag[2];\nnamespace ivfj {"),
    ("    list.insert(val, slot);", "    ++g_inserts;\n    list.insert(val, slot);"),
    ("    const float m = fminf(fminf(m4[0], m4[1]), fminf(m4[2], m4[3]));",
     "    const float m = fminf(fminf(m4[0], m4[1]), fminf(m4[2], m4[3]));\n"
     "    ++g_rowtiles;\n    g_flag[h] = m <= rs[h].thr;\n    g_it[h] = 0;\n"
     "    g_enter += g_flag[h];"),
    ("          rs[h].consider(x, slot0",
     "          ++g_tests;\n          ++g_it[h];\n          rs[h].consider(x, slot0"),
    ("      for (int t = 0; t < ntiles; ++t) {\n"
     "        for (int tid = 0; tid < threads; ++tid) {",
     "      for (int t = 0; t < ntiles; ++t) {\n        bool wflag[2];\n"
     "        int wr[2];\n        for (int tid = 0; tid < threads; ++tid) {"),
    ("          filter_tile<TC_BN / 8>(acc, mine, t * TC_BN, 2 * quad,\n"
     "                                 total - t * TC_BN, k);",
     "          if (tid % 32 == 0) {\n            wflag[0] = wflag[1] = false;\n"
     "            wr[0] = wr[1] = 0;\n          }\n"
     "          filter_tile<TC_BN / 8>(acc, mine, t * TC_BN, 2 * quad,\n"
     "                                 total - t * TC_BN, k);\n"
     "          for (int hh = 0; hh < 2; ++hh) {\n"
     "            wflag[hh] = wflag[hh] || g_flag[hh];\n"
     "            wr[hh] = std::max(wr[hh], g_it[hh]);\n          }\n"
     "          if (tid % 32 == 31) {\n            g_wrowtiles += 2;\n"
     "            g_wenter += wflag[0] + wflag[1];\n"
     "            g_rounds += wr[0] + wr[1];\n          }"),
]
READ = """
extern "C" void counts(long long* o) {
  const long long v[] = {g_tests, g_inserts, g_enter, g_rowtiles, g_rounds,
                         g_wenter, g_wrowtiles};
  for (int i = 0; i < 7; ++i) o[i] = v[i];
}
"""


def counted_source() -> str:
    src = host.tc_host_source()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, text)
    return src + READ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=30_000)
    ap.add_argument("--cells", type=int, default=36)
    ap.add_argument("--nprobe", type=int, default=24)
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        cpp, lib = Path(tmp) / "counted.cpp", Path(tmp) / "counted.so"
        cpp.write_text(counted_source())
        subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                       check=True)
        so = ctypes.CDLL(str(lib))
        join = host.host_join(*ij._bind_tc(so))
        x = torch.from_numpy(zscore(synthetic_higgs(args.rows, seed=7)))
        inp = sorted_join_inputs(x, args.k, nlist=args.cells,
                                 nprobe=args.nprobe)
        t0 = time.perf_counter()
        join(**inp, dtype=args.dtype)
        o = (ctypes.c_longlong * 7)()
        so.counts(o)
    tests, inserts, enter, rowtiles, rounds, wenter, wrowtiles = list(o)
    n = args.rows
    print(f"{n} rows, {args.cells} cells, nprobe {args.nprobe}, k {args.k}, "
          f"{args.dtype} ({time.perf_counter() - t0:.1f} s): per query "
          f"{tests / n:.1f} exact tests, {inserts / n:.1f} insertions; "
          f"thread-row tiles entering {enter / rowtiles:.4f}; warp-row "
          f"tiles entering {wenter / wrowtiles:.4f}, loop rounds a warp-row "
          f"tile {rounds / wrowtiles:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
