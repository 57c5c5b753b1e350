"""The NN-descent rounds' roofline reader: its bound counted from the
pair counter and the graphs' shapes, its share against the device's
busy time inside the ``nndescent_round_*`` spans."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest

from portbench import harness, tracing

BASE = Path(__file__).resolve().parents[1]


def _metric(name):
    return harness.load_file(BASE, "metrics", name)


def test_nndescent_bound_reads_pairs_and_lists_over_its_spans():
    """The rounds' bound: each scored candidate's bf16 row once, each
    round's lists in and out once, over the busy time inside the
    ``nndescent_round_*`` spans; None without the counter or the
    spans."""
    m = _metric("nndescent_roofline")
    ms = 1_000_000
    rows = [("embed", -1, 0, 100), ("ivf_join", 0, 5, 10),
            ("nndescent_round_1", 0, 10, 20),
            ("nndescent_round_2", 0, 20, 30),
            ("nndescent_rerank", 0, 30, 32)]
    info = {"spans": [[n, p, s * ms, e * ms] for n, p, s, e in rows],
            "counters": {"knn.nndescent.pairs": 2 * 10 ** 9}}
    cfg = {"embed": {"nbng": 6, "dim": 2, "layer": 1,
                     "hierarchy_fraction": 0.04},
           "columns": 28,
           "knn_params": {"knbn": 6, "nprobe": 24, "dtype": "bfloat16",
                          "refine_rounds": 4, "nndescent_rho": 0.5}}
    # busy inside the rounds: 12-16 and 15-19 (7 ms), 25-31 gives 5 ms;
    # the join's and the rerank's device time lie outside
    trace = tracing.Trace(device=[("join", 5 * ms, 10 * ms),
                                  ("a", 12 * ms, 16 * ms),
                                  ("b", 15 * ms, 19 * ms),
                                  ("c", 25 * ms, 31 * ms)],
                          host=[], window_s=0.1, t0_ns=0, t1_ns=100 * ms)
    run = harness.Run(config=cfg, mix={}, n=11_000_000, infos=[info],
                      window_s=1.0, setup_s=1.0, peak_bytes=None,
                      reference={}, traced_info=info, trace=trace)
    # both graphs (440,000 and 11M rows) at build k 12, four rounds each
    lists = 16 * 12 * 4 * (440_000 + 11_000_000)
    bound = (2 * 10 ** 9 * 2 * 28 + lists) / 3.35e12
    assert m.bound_s(2 * 10 ** 9, 28, "bfloat16", [440_000, 11_000_000],
                     12, 4) == pytest.approx(bound)
    assert m.bound_s(10, 28, "float32", [], 12, 4) == pytest.approx(
        10 * 4 * 28 / 3.35e12)
    assert m.read(run) == pytest.approx(100 * bound / 12e-3)
    no_pairs = dict(info, counters={"knn.ivf.pairs": 5})
    assert m.read(dataclasses.replace(run, traced_info=no_pairs)) is None
    no_rounds = dict(info, spans=[s for s in info["spans"]
                                  if not s[0].startswith("nndescent_round")])
    assert m.read(dataclasses.replace(run, traced_info=no_rounds)) is None
    assert m.read(dataclasses.replace(run, trace=None)) is None
