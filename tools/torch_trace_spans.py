#!/usr/bin/env python3
"""Lay the program's spans of one ``embed()`` call (``info["spans"]``)
on a ``torch.profiler`` trace of the same call, for a cell of the
benchmark (``portbench``): the card's idle seconds by the innermost span
open at each idle instant, the share of each kernel's device time that
lies inside the spans that launch it (a check that both clocks agree),
how much of the root span its children and the call's phases cover, and
the cell's per-layer metrics read from the traced call alone.

    python3 tools/torch_trace_spans.py --workload higgs11m.hier \
        [--seed 7] [--out chiprun_out/spans_higgs11m.hier.json]

As the benchmark runs the cell: the rows made from the seed, its
warm-up and set-up; then one embed without the profiler and one under
it (``portbench.tracing.capture``), both timed on the host.  No check of
the result.  Prints one JSON line and writes it to ``--out``.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, spans as sp, tracing  # noqa: E402

#: kernel-name parts and the span that has to hold each one's activities
#: (a name ending in "_": every span it begins)
KERNEL_SPANS = {"ivf_join": "ivf_join", "top1_l2_kernel": "projection",
                "sweeps_kernel": "entropy_optimization",
                "nndescent_round_kernel": "nndescent_round_"}


def depth(spans: list, i: int) -> int:
    d = 0
    while spans[i][1] != -1:
        i, d = spans[i][1], d + 1
    return d


def phases_cover(spans: list) -> float:
    """The share of the root that its children other than ``pipeline``
    and the children of ``pipeline`` (the frame of ``total_time``)
    cover."""
    frame = next(i for i, s in enumerate(spans) if s[0] == "pipeline")
    covered = sum(e - s for n, par, s, e in spans
                  if par == frame or (par == 0 and n != "pipeline"))
    return covered / (spans[0][3] - spans[0][2])


def idle_by_span(trace: tracing.Trace, spans: list) -> dict:
    """Seconds of the card's idle time under each innermost open span
    ("embed" where only the root is open, "(none)" outside the root)."""
    deep = [(depth(spans, i), s[0], s[2], s[3]) for i, s in enumerate(spans)]
    out: dict = {}
    for g0, g1 in trace.gaps():
        cuts = sorted({g0, g1} | {t for _, _, s, e in deep for t in (s, e)
                                   if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) // 2
            best = max(((d, name) for d, name, s, e in deep
                        if s <= mid < e), default=(-1, "(none)"))
            out[best[1]] = out.get(best[1], 0) + (b - a)
    return {k: v * 1e-9 for k, v in sorted(out.items(),
                                            key=lambda kv: -kv[1])}


def kernels_inside(trace: tracing.Trace, spans: list) -> dict:
    out = {}
    for part, name in KERNEL_SPANS.items():
        acts = [(s, e) for n, s, e in trace.device if part in n]
        if not acts:
            continue
        inside = sp.union((s, e) for n, _, s, e in spans if n == name
                          or (name.endswith("_") and n.startswith(name)))
        total = sum(e - s for s, e in acts)
        out[part] = {"device_s": total * 1e-9,
                     "inside_share": sp.overlap_ns(sp.union(acts), inside)
                     / total}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import annembed_tpu_torch as at
    cell, x_host, _, kw = harness.prepare(ROOT, args.workload, args.seed,
                                          "cuda")
    with tempfile.TemporaryDirectory(prefix="trace_spans_") as tmp:
        kw = harness.set_up(cell, x_host, kw, tmp,
                            lambda m: print(m, file=sys.stderr, flush=True))
        t0 = time.perf_counter()
        _, info = at.embed(x_host, **kw)
        plain_s = time.perf_counter() - t0
        info = harness._lean(info)
        t0 = time.perf_counter()
        (_, traced), trace = tracing.capture(lambda: at.embed(x_host, **kw))
        traced_s = time.perf_counter() - t0
        traced = harness._lean(traced)
    spans = traced["spans"]
    root = spans[0][3] - spans[0][2]
    run = harness.Run(config=cell.config, mix=cell.mix, n=x_host.shape[0],
                      infos=[info], window_s=plain_s, setup_s=0.0,
                      peak_bytes=None, reference={}, traced_info=traced,
                      trace=trace)
    metrics = {}
    for m in harness.metrics_of(cell.bench, args.workload, True):
        if m["source"] in ("program_span", "device_trace"):
            metrics[m["name"]] = harness.load_file(
                cell.base, "metrics", m["name"]).read(run)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "embed_s": plain_s, "traced_embed_s": traced_s,
        "root_s": root * 1e-9, "window_s": trace.window_s,
        "busy_s": trace.busy_s(),
        "children_cover": sum(e - s for _, par, s, e in spans if par == 0)
        / root,
        "phases_cover": phases_cover(spans),
        "idle_by_span_s": idle_by_span(trace, spans),
        "kernels_inside_their_spans": kernels_inside(trace, spans),
        "spans_untraced": [[n, par, (s - info["spans"][0][2]) * 1e-9,
                            (e - s) * 1e-9]
                           for n, par, s, e in info["spans"]],
        "counters": traced["counters"], "metrics": metrics}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
