"""The readers of the program's spans and counters (``portbench/spans.py``
and the metrics that use it): known values on hand-built records, None
on a program that keeps no such record, and the readings of a real tiny
embed on the CPU."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from portbench import harness, peaks, spans, tracing

BASE = Path(__file__).resolve().parents[1]
MS = 1_000_000


def _metric(name):
    return harness.load_file(BASE, "metrics", name)


def _info(t0=0):
    """One call's record: spans in ms from ``t0`` (root embed 0-100)."""
    rows = [("embed", -1, 0, 100), ("copy_in", 0, 1, 5),
            ("pipeline", 0, 5, 95), ("graph", 2, 5, 40),
            ("ivf_quantize", 3, 6, 16), ("rng.kmeans_sample", 4, 6, 8),
            ("ivf_join", 3, 16, 20), ("nndescent_round_1", 3, 20, 30),
            ("nndescent_rerank", 3, 30, 32), ("ivf_join", 3, 33, 35),
            ("proba_edges", 2, 41, 43), ("rng.relabel", 2, 44, 47),
            ("proba_edges", 2, 50, 51), ("readback", 2, 90, 94)]
    return {"spans": [[n, p, t0 + s * MS, t0 + e * MS]
                      for n, p, s, e in rows],
            "counters": {"knn.ivf.pairs": 10 ** 12}}


def _run(infos, traced=None, trace=None, n=11_000_000):
    cfg = {"embed": {"nbng": 6, "dim": 2, "layer": 1,
                     "hierarchy_fraction": 0.04},
           "columns": 28,
           "knn_params": {"knbn": 6, "nprobe": 24, "refine_rounds": 4}}
    return harness.Run(config=cfg, mix={}, n=n, infos=infos, window_s=1.0,
                       setup_s=1.0, peak_bytes=None, reference={},
                       traced_info=traced, trace=trace)


@pytest.mark.parametrize("name,want", [
    ("transfer_s", 0.008), ("proba_s", 0.003), ("knn.quantize_s", 0.010),
    ("knn.nndescent_s", 0.012), ("host_rng_s", 0.005)])
def test_span_seconds_are_the_window_mean(name, want):
    run = _run([_info(), _info(10 ** 12), {"total_time": 1.0}])
    assert _metric(name).read(run) == pytest.approx(want)
    if (BASE / "metrics" / f"{name}.reembed.py").is_file():
        assert _metric(f"{name}.reembed").read(run) == pytest.approx(want)


def test_union_and_overlap():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)]) == [
        (0, 3), (5, 9)]
    assert spans.overlap_ns([(0, 3), (5, 9)], [(2, 6), (8, 20)]) == 3


def test_no_spans_read_as_nothing():
    """What a program that keeps no spans returns: None, no error."""
    old = {"graph_build_time": 1.0, "total_time": 2.0}
    trace = tracing.Trace(device=[("k", 0, 5)], host=[], window_s=1e-8,
                          t0_ns=0, t1_ns=10)
    run = _run([old], traced=old, trace=trace)
    for name in ("transfer_s", "proba_s", "knn.quantize_s",
                 "knn.nndescent_s", "host_rng_s", "ivf_join_roofline",
                 "device.idle_unspanned", "transfer_s.reembed",
                 "proba_s.reembed", "host_rng_s.reembed",
                 "device.idle_unspanned.reembed"):
        assert _metric(name).read(run) is None, name


def test_idle_unspanned_counts_idle_time_outside_inner_spans():
    info = {"spans": [["embed", -1, 10, 90], ["a", 0, 10, 40],
                      ["b", 1, 20, 30], ["c", 0, 60, 85]]}
    # device busy 0-15, 35-65, 80-100 of the window 0-100: idle 15-35
    # (spanned by a), 65-80 (spanned by c); with the root alone open
    # nothing is spanned but a's and c's stretches
    trace = tracing.Trace(device=[("k", 0, 15), ("k", 35, 65),
                                  ("k", 80, 100)],
                          host=[], window_s=100e-9, t0_ns=0, t1_ns=100)
    m = _metric("device.idle_unspanned")
    assert m.read(_run([], info, trace)) == pytest.approx(0.0)
    info["spans"][3] = ["c", 0, 70, 85]       # 65-70 now unspanned
    assert m.read(_run([], info, trace)) == pytest.approx(100 * 5 / 35)
    info["spans"] = info["spans"][:1]         # the root alone
    assert m.read(_run([], info, trace)) == pytest.approx(100.0)
    # the frame of total_time is no phase
    info["spans"].append(["pipeline", 0, 11, 89])
    assert m.read(_run([], info, trace)) == pytest.approx(100.0)
    assert _metric("device.idle_unspanned.reembed").read(
        _run([], info, trace)) == pytest.approx(100.0)


def test_ivf_join_roofline_reads_the_pairs_over_busy_time_in_its_spans():
    m = _metric("ivf_join_roofline")
    info = _info()
    # busy inside the join spans (16-20, 33-35 ms): 16-18 and 17-19
    # overlap (3 ms), 34-36 gives 1 ms; 50-60 lies outside
    trace = tracing.Trace(device=[("tc", 16 * MS, 18 * MS),
                                  ("tc", 17 * MS, 19 * MS),
                                  ("sort", 34 * MS, 36 * MS),
                                  ("sweeps", 50 * MS, 60 * MS)],
                          host=[], window_s=0.1, t0_ns=0, t1_ns=100 * MS)
    flop_s = 2 * 28 * 1e12 / peaks.BF16_FLOPS
    assert m.read(_run([], info, trace)) == pytest.approx(
        100 * flop_s / 4e-3)
    # the bytes bound: both graphs (440,000 and 11M rows) read once,
    # their (n, 12) ids and distances written once
    rows = [440_000, 11_000_000]
    assert m.graph_rows(_run([]), _kp()) == rows
    assert m.bound_s(1, 28, rows, 12) == pytest.approx(
        sum(r * (4 * 28 + 8 * 12) for r in rows) / peaks.HBM_BYTES_PER_S)
    assert m.read(_run([], dict(info, counters={}), trace)) is None
    assert m.read(_run([], info, None)) is None


def _kp():
    from annembed_tpu_torch import KnnParams
    return KnnParams(knbn=6, nprobe=24, refine_rounds=4)


def test_readers_on_a_real_tiny_embed():
    """A tiny layer-1 embed through the IVF build on the CPU: every span
    reader finds its spans, and the knn ones add up to the graphs'
    phases."""
    import annembed_tpu_torch as att
    x = np.random.default_rng(3).normal(size=(2500, 6)).astype(np.float32)
    _, info = att.embed(x, nbng=6, batch=2, layer=1, device="cpu",
                        hierarchy_fraction=0.5,
                        knn_params=att.KnnParams(knbn=6,
                                                 brute_force_limit=1000))
    run = _run([info])
    phases = info["graph_build_phases"]
    for name, key in (("knn.quantize_s", "ivf_quantize"),
                      ("knn.nndescent_s", "nndescent_")):
        want = sum(v for k, v in phases.items() if key in k)
        assert _metric(name).read(run) == pytest.approx(want, rel=1e-9)
    for name in ("transfer_s", "proba_s", "host_rng_s"):
        assert _metric(name).read(run) > 0
    assert info["counters"]["knn.ivf.pairs"] > 0
