"""The roofline readers: bounds counted from shapes alone, shares
against the kernels' device time in a trace."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import harness, tracing

BASE = Path(__file__).resolve().parents[1]


def _metric(name):
    return harness.load_file(BASE, "metrics", name)


def _run(trace, info, n=11_000_000, layer=1):
    cfg = {"embed": {"nbng": 6, "dim": 2, "layer": layer,
                     "hierarchy_fraction": 0.04},
           "columns": 28, "params": {"hubness_weighting": True}}
    return harness.Run(config=cfg, mix={}, n=n, infos=[info],
                       window_s=1.0, setup_s=1.0, peak_bytes=None,
                       reference={}, traced_info=info, trace=trace)


def _trace(*kernels):
    dev = [(name, 0, int(sec * 1e9)) for name, sec in kernels]
    return tracing.Trace(device=dev, host=[], window_s=10.0, t0_ns=0,
                         t1_ns=int(10e9))


def test_top1_bound_counts_the_search_not_its_passes():
    m = _metric("top1_l2_roofline")
    # 2 n m d flop at the bf16 peak: 11M x 440k x 28 -> 274 ms
    assert m.bound_s(11_000_000, 440_000, 28) == pytest.approx(
        2 * 11e6 * 4.4e5 * 28 / 989e12)
    assert m.bound_s(11_000_000, 440_000, 28) == pytest.approx(0.2741, 1e-3)
    # a shape bound by its bytes: inputs once, outputs once
    assert m.bound_s(1000, 1, 4) == pytest.approx(
        4 * ((1000 + 1) * 4 + 2000) / 3.35e12)
    run = _run(_trace(("void top1_l2_kernel<2>(float const*)", 2.0),
                      ("split_corpus_kernel", 0.7416),
                      ("sweeps_kernel(Sweeps)", 5.0)), {})
    assert m.read(run) == pytest.approx(100 * 0.27408 / 2.7416, 1e-3)
    assert m.read(_run(None, {})) is None
    assert m.read(_run(_trace(("other", 1.0)), {})) is None
    assert m.read(_run(_trace(("top1_l2_kernel", 1.0)), {}, layer=0)) is None


def test_dense_sweep_bound_from_shapes_and_sweeps():
    m = _metric("dense_sweep_roofline")
    # phase 4's large step: 11M rows, kg 3, k 6, n_neg 5, d 2, hubness
    per = m.sweep_bound_s(11_000_000, 3, 6, 5, 2, True)
    once = (16 + 72 + 4 + 4 + 24) * 11_000_000
    assert per == pytest.approx(once / 3.35e12)
    assert per == pytest.approx(0.394e-3, 1e-2)
    info = {"optimizer": "dense", "sweeps": 2340, "n_groups": 2, "n_neg": 5,
            "first_step": {"optimizer": "dense", "sweeps": 11940,
                           "n_groups": 2, "n_neg": 5}}
    bound = 2340 * per + 11940 * m.sweep_bound_s(440_000, 3, 6, 5, 2, True)
    run = _run(_trace(("sweeps_kernel(Sweeps)", 5.0),
                      ("top1_l2_kernel", 3.0)), info)
    assert m.read(run) == pytest.approx(100 * bound / 5.0)
    sampling = dict(info, optimizer=None)
    assert m.read(_run(_trace(("sweeps_kernel", 5.0)), sampling)) is None
    assert m.read(_run(_trace(("x", 5.0)), info)) is None


def test_idle_share_is_the_union_of_intervals():
    m = _metric("device.idle_share")
    tr = tracing.Trace(device=[("a", 0, 2), ("b", 1, 4), ("c", 6, 8)],
                       host=[("op", 3, 7)], window_s=10e-9, t0_ns=0,
                       t1_ns=10)
    assert tr.busy_s() == pytest.approx(6e-9)
    assert m.read(_run(tr, {})) == pytest.approx(40.0)
    assert tr.gaps() == [(4, 6), (8, 10)]
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "b"
    assert b["idle_gaps"][0] == ["op", pytest.approx(2e-9)]
