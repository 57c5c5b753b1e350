#!/usr/bin/env python3
"""Where the certified grid radius search of annembed_tpu_torch spends
the card's time: the tables, the candidate blocks, the brute fallback of
the uncertified rows, and a ``torch.profiler`` trace of a few blocks.

    python3 tools/torch_profile_grid_radius.py [--n 11000000] [--k 51]

On ``--n`` rows of a 2-D cloud of eight Gaussian clusters (centres
N(0, 5), spread 0.8, seed 7: chip_smoke's grid-quantizer cloud), every
row a query with ``--k`` columns (the full-fraction quality estimate at
radius_k = k - 1).  Prints the grid's shape, the seconds of the tables,
of all candidate blocks (one readback at the end) and of the brute
search of the uncertified rows: the parts of ``grid_radius_search``
timed apart; then, over ``--profile-blocks`` blocks under the
profiler, the kernel launches and device milliseconds a block, the busy
share, the device time by kind of kernel, and a block's byte bound (its
candidate coordinates read once at 3.35 TB/s); then one JSON line with
all of it.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from annembed_tpu_torch.knn import radius  # noqa: E402
from annembed_tpu_torch.knn.brute import knn_search_brute  # noqa: E402

H100_BYTES_PER_S = 3.35e12
KINDS = (("top-k, sort", ("topk", "Topk", "sort", "Sort", "radix", "Radix")),
         ("gathers (indexing)", ("index", "gather")),
         ("reductions", ("reduce", "Reduce")),
         ("copies, cat", ("copy", "Copy", "cat", "Cat")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise"


def seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=11_000_000)
    ap.add_argument("--k", type=int, default=51)
    ap.add_argument("--query-block", type=int, default=4096)
    ap.add_argument("--profile-blocks", type=int, default=20)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 5, (8, 2))
    y = torch.from_numpy((centers[rng.integers(0, 8, args.n)]
                          + rng.normal(0, 0.8, (args.n, 2))
                          ).astype(np.float32)).to("cuda")
    n, k, qb = args.n, args.k, args.query_block
    g, cap_cell = radius.grid_shape(n, k)
    w_own, w_adj = 5, 7
    cand = (w_own + 2 * w_adj) * cap_cell

    radius.grid_radius_search(y, torch.arange(qb, device="cuda"), k)  # warm
    tabs, t_tables = seconds(lambda: radius._grid_tables(y, g))
    ys, cells, *rest = tabs
    ys_pad = torch.cat([ys, ys.new_zeros((w_adj * cap_cell, 2))])
    cells = cells.to(torch.int64)
    s_all = torch.div(cells, g, rounding_mode="floor")
    j_all = cells - s_all * g

    def block(i0):
        sl = slice(i0, i0 + qb)
        return radius._grid_query_dists(
            ys_pad, y[sl], s_all[sl], j_all[sl], *rest, k, g, w_own, w_adj,
            cap_cell)

    def blocks():
        oks = [block(i0)[1] for i0 in range(0, n, qb)]
        return torch.nonzero(~torch.cat(oks)).squeeze(1)
    bad, t_blocks = seconds(blocks)
    _, t_fallback = seconds(lambda: knn_search_brute(y[bad], y, k=k))
    n_blocks = -(-n // qb)
    print(f"grid: n={n} k={k} g={g} cap_cell={cap_cell} candidates={cand} "
          f"blocks={n_blocks}; tables {t_tables:.3f} s, blocks "
          f"{t_blocks:.3f} s ({1e3 * t_blocks / n_blocks:.3f} ms a block), "
          f"fallback of {bad.numel()} rows {t_fallback:.3f} s", flush=True)

    starts = [(i * 7919 * qb) % (n - qb) for i in range(args.profile_blocks)]
    for i0 in starts[:2]:
        block(i0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i0 in starts:
            block(i0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    kinds: dict = {}
    for key, sec, _ in rows:
        kinds[kind_of(key)] = kinds.get(kind_of(key), 0.0) + sec
    nb = len(starts)
    bound_ms = 1e3 * qb * cand * 8 / H100_BYTES_PER_S
    by_kind = {k: round(1e3 * v / nb, 4) for k, v in kinds.items()}
    print(f"trace: {nb} blocks of {qb} queries, wall {1e3 * wall / nb:.3f} "
          f"ms a block, kernels {1e3 * busy / nb:.3f} ms a block, busy share "
          f"{busy / wall:.4f}, {launches / nb:.1f} launches a block "
          f"({busy / max(launches, 1) * 1e6:.2f} us a kernel); byte bound "
          f"{bound_ms:.4f} ms a block; by kind (ms a block) "
          f"{json.dumps(by_kind)}")
    for key, sec, count in rows[:args.top]:
        print(f"  {1e3 * sec / nb:8.4f} ms {count / nb:6.1f} x  {key[:110]}")
    print(json.dumps({
        "device": smi, "n": n, "k": k, "g": g, "cap_cell": cap_cell,
        "candidates": cand, "blocks": n_blocks, "tables_s": t_tables,
        "blocks_s": t_blocks, "fallback_rows": int(bad.numel()),
        "fallback_s": t_fallback,
        "trace_blocks": nb, "trace_ms_per_block": 1e3 * wall / nb,
        "device_ms_per_block": 1e3 * busy / nb, "busy_share": busy / wall,
        "launches_per_block": launches / nb, "byte_bound_ms": bound_ms,
        "by_kind_ms_per_block": {k: 1e3 * v / nb for k, v in kinds.items()},
        "kernels": [(k[:110], s, c) for k, s, c in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
