#!/usr/bin/env python3
"""Where the sampling optimizer of annembed_tpu_torch spends the card's
time: steps a second, CUDA launches a step and the device-busy share
(``torch.profiler``).

    python3 tools/torch_profile_sampling.py [--n 70000] [--steps 420]

On ``--n`` rows of the bench's ``synthetic_blobs`` (784 columns, seed
42): the exact 6-NN graph, the diffusion-maps initialization boxed to
size 10 and the edge probabilities, as ``embed`` makes them.  Then the
whole optimizer at its defaults (``EmbedderParams(optimizer=
"sampling")``: 20 batches, 10 samplings an edge) once without the
profiler, and ``--steps`` steps (one batch at 70,000 rows) at the first
batch's step under a profiler trace.  Prints the plain run's seconds and
steps a second, the trace's wall seconds (the clock stops before the
profiler collects its events), its kernels' device seconds, their ratio
(the busy share), kernel launches a step, device time by kind of kernel
and the kernels that took most of it; then one JSON line with all of
it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from annembed_tpu_torch.device import disable_tf32  # noqa: E402
from annembed_tpu_torch.graph.proba import to_proba_edges  # noqa: E402
from annembed_tpu_torch.io.synthetic import synthetic_blobs  # noqa: E402
from annembed_tpu_torch.knn.api import build_kgraph  # noqa: E402
from annembed_tpu_torch.optim import ce  # noqa: E402
from annembed_tpu_torch.optim.embedder import (Embedder,  # noqa: E402
                                               set_data_box)
from annembed_tpu_torch.params import EmbedderParams  # noqa: E402

#: kernel kinds by a substring of the kernel's name, first match wins
KINDS = (("random draws", ("philox", "Philox", "random", "Random")),
         ("index_add (scatter)", ("index_add", "indexFuncLargeIndex",
                                  "indexFuncSmallIndex", "scatter")),
         ("gathers (indexing)", ("index", "gather")),
         ("reductions", ("reduce", "Reduce")),
         ("copies, cat", ("copy", "Copy", "cat", "Cat")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=70_000)
    ap.add_argument("--steps", type=int, default=420)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    disable_tf32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    params = EmbedderParams(optimizer="sampling")
    x = torch.from_numpy(synthetic_blobs(args.n, 784, 42)).to(
        dev, torch.float32)
    g = build_kgraph(x, 6)
    y0 = set_data_box(Embedder.new(g, params)._dmap_initial(
        g, params.asked_dim), 10.0)
    es = ce.build_edge_set(g, to_proba_edges(g, params.scale_rho,
                                             params.beta))
    del x

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, info = ce.run_entropy_optimization(y0, es, params, compute_ce=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    steps = info["steps_per_batch"] * (params.nb_grad_batch - 1)
    print(f"plain: n={args.n} {steps} steps of {info['batch_size']} edges "
          f"in {plain_s:.3f} s, {steps / plain_s:.1f} steps/s", flush=True)

    gamma = ce.step_gamma(0, params.grad_step, info["steps_per_batch"],
                          params.nb_grad_batch)
    gen = torch.Generator(device=dev).manual_seed(1)

    def window():
        y = y0
        for _ in range(args.steps):
            y = ce.minibatch_update(
                y, ce.draw_step(es, info["batch_size"], gen), es, gamma,
                params.b)
        return y
    window()                                    # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
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
    print(f"trace: {args.steps} steps, wall {wall:.4f} s "
          f"({wall / args.steps * 1e3:.4f} ms a step), kernels {busy:.4f} s, "
          f"busy share {busy / wall:.4f}, {launches / args.steps:.1f} "
          f"launches a step ({busy / max(launches, 1) * 1e6:.2f} us a "
          f"kernel); by kind (s) "
          f"{json.dumps({k: round(v, 5) for k, v in kinds.items()})}")
    for key, sec, count in rows[:args.top]:
        print(f"  {sec:8.4f} s {count:8d} x  {key[:110]}")
    print(json.dumps({
        "device": smi, "n": args.n, "batch_size": info["batch_size"],
        "steps_per_batch": info["steps_per_batch"], "steps": steps,
        "plain_s": plain_s, "steps_per_s": steps / plain_s,
        "trace_steps": args.steps, "trace_wall_s": wall,
        "trace_device_s": busy, "busy_share": busy / wall,
        "launches_per_step": launches / args.steps, "by_kind_s": kinds,
        "kernels": [(k[:110], s, c) for k, s, c in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
