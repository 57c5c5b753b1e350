"""The port's span recorder and counter registry (utils/profiling.py), on
the CPU: the spans of ``embed()`` nest and cover the call, every timing
``info`` reports is the duration of its span, the IVF plan's pair
counter equals a count taken from the plan by brute force, and the
kernels' launch counters read from the registry."""

import threading

import numpy as np
import pytest
import torch

import annembed_tpu_torch as ta
from annembed_tpu_torch.knn import ivf
from annembed_tpu_torch.ops import dense_sweep, ivf_join, top1
from annembed_tpu_torch.utils import profiling

KNN = ta.KnnParams(knbn=6, brute_force_limit=600)


def _rows(n=1500, d=6, seed=5):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _seconds(sp):
    return (sp[3] - sp[2]) * 1e-9


def _named(spans, name, parent=None):
    return [s for s in spans if s[0] == name
            and (parent is None or spans[s[1]][0] == parent)]


@pytest.mark.parametrize("layer", [0, 1])
def test_embed_spans_nest_cover_and_give_the_timings(layer):
    """Both graphs take the IVF build (above ``brute_force_limit``)."""
    y, info = ta.embed(_rows(), nbng=6, batch=2, layer=layer,
                       hierarchy_fraction=0.5, knn_params=KNN, device="cpu")
    sp = info["spans"]
    assert sp[0][:2] == ["embed", -1]
    for i, (name, parent, s, e) in enumerate(sp):
        assert s <= e, name
        if i:
            assert 0 <= parent < i, name
            assert sp[parent][2] <= s and e <= sp[parent][3], name
    root = sp[0][3] - sp[0][2]
    children = sum(e - s for _, p, s, e in sp if p == 0)
    assert children >= 0.98 * root, children / root
    names = [s[0] for s in sp if s[1] == 0]
    assert names[:4] == ["check_args", "read_rows", "copy_in", "pipeline"]
    # the phases cover the call too: the frame of total_time opened up
    frame = next(i for i, s in enumerate(sp) if s[0] == "pipeline")
    phases = sum(e - s for n, p, s, e in sp
                 if p == frame or (p == 0 and n != "pipeline"))
    assert phases >= 0.98 * root, phases / root
    assert "first_step" not in info or "spans" not in info["first_step"]

    # every timing in info is the duration of its span
    assert info["graph_build_time"] == _seconds(_named(sp, "graph")[0])
    assert info["total_time"] == _seconds(_named(sp, "pipeline")[0])
    opt = _named(sp, "entropy_optimization")
    assert info["optimize_time"] == _seconds(opt[-1])
    init = _named(sp, "initialization")
    assert len(init) == 1
    step = info["first_step"] if layer else info
    assert step["init_time"] == _seconds(init[0])
    assert len(_named(sp, "proba_edges")) == layer + 1
    assert len(_named(sp, "readback")) == 1
    assert len(_named(sp, "rng.relabel", "relabel")) == layer + 1
    graphs = ("small_graph", "large_graph") if layer else ("graph_build",)
    for g in graphs:
        assert _named(sp, "ivf_quantize", g) and _named(sp, "ivf_join", g)
        assert _named(sp, "rng.kmeans_init", "kmeans_fit")
    if layer:
        assert info["first_step"]["optimize_time"] == _seconds(opt[0])
        assert [s[0] for s in sp if sp[s[1]][0] == "seed"] == [
            "rng.seed_noise"]
        assert _named(sp, "rng.sample_ids", "graph_build")
        phases = info["graph_build_phases"]
        for key, got in phases.items():
            parent, _, name = key.rpartition("/")
            want = _named(sp, name, parent or "graph_build")
            assert got == pytest.approx(sum(map(_seconds, want)),
                                        rel=1e-12), key
    assert info["counters"]["knn.ivf.pairs"] > 0
    # every NN-descent round of both graphs counted on the route that
    # served it (the CPU: torch), and the candidates it scored
    rounds = len(graphs) * KNN.refine_rounds
    assert info["counters"]["ops.nndescent.torch"] == rounds
    assert "ops.nndescent.kernel" not in info["counters"]
    assert info["counters"]["knn.nndescent.pairs"] > 0
    assert len([s for s in sp if s[0].startswith("nndescent_round_")]) \
        == rounds


def test_cache_timings_are_their_spans(tmp_path):
    x = _rows(400)
    kw = dict(nbng=6, batch=2, device="cpu", graph_cache=str(tmp_path / "g"),
              embed_cache=str(tmp_path / "e"))
    _, first = ta.embed(x, graph_cache_eager=True, **kw)
    _, again = ta.embed(x, **kw)
    for info, keys in ((first, ("graph_save_s", "embedding_save_s")),
                       (again, ("graph_load_s", "embedding_load_s"))):
        assert set(info["checkpoints"]) == set(keys)
        for key in keys:
            (sp,) = _named(info["spans"], key[:-2])
            assert info["checkpoints"][key] == _seconds(sp)
    assert _named(first["spans"], "readback", "embedding_save")
    assert not _named(again["spans"], "graph_build")
    assert not _named(again["spans"], "readback")


def _pairs_by_brute_force(x, cells, cell_nbrs, nlist, cap, qcap, pad):
    """Each virtual row's queries against every probed cell's first
    min(count, cap) rows, from the sorted layout's row plan."""
    _, _, qstarts, parents, starts, counts = ivf.sorted_plan(
        x, cells, pad, nlist, qcap)
    counts, starts = counts.tolist(), starts.tolist()
    total = 0
    for q0, c in zip(qstarts.tolist(), parents.tolist()):
        q1 = min(q0 + qcap, starts[c] + counts[c])
        for p in cell_nbrs[c].tolist():
            total += (q1 - q0) * min(counts[p], cap)
    return total


@pytest.mark.parametrize("quantizer,d", [("kmeans", 5), ("grid", 2)])
def test_ivf_pair_counter_equals_the_plan(quantizer, d):
    x = torch.from_numpy(_rows(1200, d, seed=9))
    cells, cell_nbrs, nlist, cap, qcap, pad = ivf._quantize_cells(
        x, 8, 0, 6, quantizer, 0, 500_000, 10)
    want = _pairs_by_brute_force(x, cells, cell_nbrs, nlist, cap, qcap, pad)
    before = profiling.counters().get(ivf.PAIRS, 0)
    with profiling.record_call("build") as call:
        ivf.knn_graph_ivf(x, 8, nprobe=6, quantizer=quantizer)
    assert profiling.counters()[ivf.PAIRS] - before == want
    assert call.counters == {ivf.PAIRS: want}
    assert int(ivf.plan_pairs(cells, cell_nbrs, nlist, cap)) == want


def test_launch_counters_read_the_registry():
    """The readers chip_smoke, the harness and the tests use count what
    the wrappers add to the registry; CPU tensors launch nothing."""
    top1.reset_launch_count()
    dense_sweep.reset_launch_counts()
    ivf_join.reset_launch_counts()
    q = torch.randn(50, 4)
    top1.top1_l2(q, q[:7].contiguous())
    assert top1.launch_count() == 0
    assert ivf_join.launch_counts() == {"simt": 0, "tc": 0}
    with profiling.record_call("launches") as call:
        profiling.count(top1.LAUNCHES)
        for name, k in (("attraction", 2), ("kick", 2), ("persistent", 1),
                        ("persistent_sweeps", 60)):
            profiling.count(dense_sweep.PREFIX + name, k)
        profiling.count(ivf_join.PREFIX + "tc")
    assert top1.launch_count() == 1
    assert dense_sweep.launch_counts() == dict(pair=4, persistent=1,
                                               persistent_sweeps=60)
    assert ivf_join.launch_counts() == {"simt": 0, "tc": 1}
    assert call.counters["ops.dense_sweep.persistent_sweeps"] == 60
    top1.reset_launch_count()
    dense_sweep.reset_launch_counts()
    ivf_join.reset_launch_counts()
    assert top1.launch_count() == 0
    assert dense_sweep.launch_counts() == dict(pair=0, persistent=0,
                                               persistent_sweeps=0)


def test_spans_belong_to_the_call_open_on_their_thread():
    with profiling.span("outside") as out:
        pass
    assert out.end_ns >= out.start_ns
    seen = []

    def other():
        with profiling.span("other thread"):
            seen.append(profiling.PhaseTimer())

    with profiling.record_call("outer") as outer:
        timer = profiling.PhaseTimer()
        with timer.phase("a"):
            with profiling.record_call("inner") as inner:
                with profiling.span("b"):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive() and seen
    assert [s[:2] for s in outer.spans] == [["outer", -1], ["a", 0]]
    assert [s[:2] for s in inner.spans] == [["inner", -1], ["b", 0]]
    assert inner.seq > outer.seq
    assert timer.timings["a"] == _seconds(outer.spans[1])
