"""The JAX package's run of the port's bench workload, and the producer
of chip_smoke.py's reference constants.

``jax_bench_record(n)`` runs bench.py::run_once's one-step workload
(``annembed_tpu_torch.bench``) through annembed_tpu's functions on the
CPU backend, with the exact f32 brute graph the port builds, then the
bench's quality tail, and returns the record under the port bench's
keys.  Regenerate chip_smoke.py's ``JAX_NO_MATCH`` (``no_match``) and
``JAX_MANIFOLD_MEAN_MATCHED`` (``manifold_mean_matched``) with

    python -m tests.test_torch_bench_reference --n 70000 --seeds 0 1 2

(about two minutes a seed on a CPU; the fixtures are the port's numpy copies,
bit-identical to the JAX package's).  The sampling phase's constants
(``JAX_SAMPLING_*``: ``embed(**bench.SAMPLING_EMBED)`` with the sampling
optimizer and HDBSCAN*, over three seeds for the spread) and the
estimator phase's (``JAX_STATS_*``: the ``--stats`` numbers of the
blobs rows' 20-NN graph) come from

    python -m tests.test_torch_bench_reference --n 70000 \
        --optimizer sampling --seeds 0 1 2

(one JSON line a seed, then the estimators' line).  The dense-knob
phase's (``JAX_KNOB_NO_MATCH``: ``embed(**bench.KNOB_EMBED)`` on the
blobs rows with each of ``bench.DENSE_KNOBS``) come from

    python -m tests.test_torch_bench_reference --n 70000 --optimizer knobs

(one JSON line a knob).  The tests below run
each row through both packages at a small n and hold the port's
conservation, clusters and estimators to the JAX package's.
"""

import argparse
import json
import time

import numpy as np
import pytest
import torch

import annembed_tpu_torch as ta
from annembed_tpu_torch import bench as t_bench
from annembed_tpu_torch.io.synthetic import (synthetic_blobs,
                                             synthetic_clustered_manifold)
from annembed_tpu_torch.knn.api import sampled_exact_recall

SMALL_N = 1500


def jax_run_once(x, seed=0):
    """annembed_tpu_torch.bench.run_once through annembed_tpu, the
    optimizer's draws from ``seed``."""
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.embedder import set_data_box
    from annembed_tpu.params import DiffusionParams, EmbedderParams
    from annembed_tpu.spectral.diffmaps import DiffusionMaps

    idx, dist = knn_graph_brute(x, t_bench.KNBN,
                                block_rows=t_bench.BLOCK_ROWS)
    g = KGraph(indices=idx, dists=dist)
    dm = DiffusionMaps(params=DiffusionParams(
        asked_dim=t_bench.DIM, alfa=0.5, beta=-0.1, t=5.0, gnbn=12,
        svd_n_iter=1))
    init = set_data_box(dm.embed_from_kgraph(g), 10.0)
    npar = to_proba_edges(g)
    params = EmbedderParams(
        asked_dim=t_bench.DIM,
        nb_grad_batch=sum(b for b, _ in t_bench.SCHEDULE),
        n_sub_schedule=t_bench.SCHEDULE, dense_neighbor_exclusion=False,
        seed=seed)
    y, _ = run_dense_optimization(init, g, npar, params, n_sub=15)
    return y, g


def _conservation(g, y, prefix):
    from annembed_tpu.estimators.quality import quality_estimate
    q = quality_estimate(g, y, nbng=50, radius_k_compat=125)
    out = {f"{prefix}no_match": int(q.nb_without_match),
           f"{prefix}mean_matched": q.mean_nb_matched,
           f"{prefix}median_ratio": q.median_ratio,
           f"{prefix}compat_no_match": int(q.compat["nb_without_match"]),
           f"{prefix}compat_mean_matched": q.compat["mean_nb_matched"]}
    if not prefix:
        out["compat_median_ratio"] = q.compat["median_ratio"]
    return out


#: the bench's two rows: record-key prefix -> fixture at n rows
ROWS = {"": lambda n: synthetic_blobs(n, t_bench.D, 42),
        "manifold_": lambda n: synthetic_clustered_manifold(n, t_bench.D)}


def jax_bench_row(x, prefix, seed=0):
    """The JAX package's record of one bench row on rows ``x``."""
    import jax.numpy as jnp
    from annembed_tpu.knn.api import sampled_exact_recall

    xj = jnp.asarray(x, jnp.float32)
    y, g = jax_run_once(xj, seed)
    rec = _conservation(g, y, prefix)
    if not prefix:
        n = x.shape[0]
        sub = np.linspace(0, n - 1, min(2000, n)).astype(np.int32)
        rec["recall"] = sampled_exact_recall(xj, g, sample_ids=sub)
    return rec


def jax_bench_record(n, seed=0):
    """The JAX package's record of the bench workload at n rows."""
    rec = {}
    for prefix, make in ROWS.items():
        rec.update(jax_bench_row(make(n), prefix, seed))
    return rec


def jax_sampling_row(x, prefix, seed):
    """The JAX package's ``embed(**SAMPLING_EMBED)`` record of one row."""
    import annembed_tpu as ja
    _, info = ja.embed(x, seed=seed,
                       params=ja.EmbedderParams(optimizer="sampling"),
                       **t_bench.SAMPLING_EMBED)
    rec = t_bench.sampling_record(info, prefix)
    rec[prefix + "batch_size"] = info["batch_size"]
    rec[prefix + "steps_per_batch"] = info["steps_per_batch"]
    return rec


def jax_knob_record(x, knob):
    """The JAX package's ``embed(**KNOB_EMBED)`` quality on rows ``x``
    with the dense knob ``knob`` of ``DENSE_KNOBS`` set."""
    import annembed_tpu as ja
    _, info = ja.embed(x, params=ja.EmbedderParams(
        **t_bench.DENSE_KNOBS[knob]), **t_bench.KNOB_EMBED)
    q = info["quality"]
    return {f"{knob}_no_match": int(q["nb_without_match"]),
            f"{knob}_mean_matched": q["mean_nb_matched"],
            f"{knob}_compat_no_match": int(q["compat_nb_without_match"])}


def jax_stats_record(x):
    """The CLI's ``--stats`` numbers of the rows' 20-NN graph, through
    the JAX package."""
    import jax.numpy as jnp
    from annembed_tpu import (Hubness, KnnParams, build_kgraph,
                              intrinsic_dim_2nn, intrinsic_dim_levina_bickel)
    g = build_kgraph(jnp.asarray(x, jnp.float32), t_bench.STATS_NBNG,
                     params=KnnParams(knbn=t_bench.KNBN))
    hub = Hubness.new(g)
    return {"intrinsic_dim": list(intrinsic_dim_levina_bickel(g)),
            "intrinsic_dim_2nn": intrinsic_dim_2nn(g),
            "hubness_skew": hub.get_standard3m()}


def port_stats_record(x):
    """``jax_stats_record`` through the port on the CPU."""
    g = ta.build_kgraph(torch.from_numpy(x).to(torch.float32),
                        t_bench.STATS_NBNG,
                        params=ta.KnnParams(knbn=t_bench.KNBN))
    hub = ta.Hubness.new(g)
    return {"intrinsic_dim": list(ta.intrinsic_dim_levina_bickel(g)),
            "intrinsic_dim_2nn": ta.intrinsic_dim_2nn(g),
            "hubness_skew": hub.get_standard3m()}


@pytest.mark.parametrize("prefix", list(ROWS), ids=["blobs", "manifold"])
def test_port_bench_row_conserves_as_jax_does(prefix):
    """Same rows, independent random draws: conservation agrees within
    the spread of the chaotic sweep map at this size."""
    x = ROWS[prefix](SMALL_N)
    want = jax_bench_row(x, prefix)
    y, g, _ = t_bench.run_once(torch.from_numpy(x).to(torch.float32))
    got = t_bench.conservation(g, y, prefix)
    assert set(want) - set(got) <= {"recall"}
    assert y.shape == (SMALL_N, 2) and bool(torch.isfinite(y).all())
    if not prefix:
        sub = np.linspace(0, SMALL_N - 1, SMALL_N).astype(np.int32)
        assert want["recall"] == 1.0
        assert sampled_exact_recall(torch.from_numpy(x), g,
                                    sample_ids=sub) == 1.0
    assert abs(got[f"{prefix}no_match"]
               - want[f"{prefix}no_match"]) <= 0.03 * SMALL_N
    for key in ("mean_matched", "compat_mean_matched"):
        assert abs(got[prefix + key] - want[prefix + key]) < 0.25, key


@pytest.mark.parametrize("prefix", list(ROWS), ids=["blobs", "manifold"])
def test_port_sampling_row_matches_jax(prefix):
    """The sampling path at a small n: the same batch sizing, the same
    clusters, conservation within the chaotic run's spread."""
    x = ROWS[prefix](SMALL_N)
    want = jax_sampling_row(x, prefix, seed=0)
    _, info = ta.embed(x, params=ta.EmbedderParams(optimizer="sampling"),
                       device="cpu", **t_bench.SAMPLING_EMBED)
    got = t_bench.sampling_record(info, prefix)
    assert (info["batch_size"], info["steps_per_batch"]) == (
        want[prefix + "batch_size"], want[prefix + "steps_per_batch"])
    assert got[prefix + "n_clusters"] == want[prefix + "n_clusters"]
    assert got[prefix + "noise_fraction"] == want[prefix + "noise_fraction"]
    assert abs(got[prefix + "no_match"]
               - want[prefix + "no_match"]) <= 0.03 * SMALL_N
    for key in ("mean_matched", "compat_mean_matched"):
        assert abs(got[prefix + key] - want[prefix + key]) < 0.25, key
    rel = abs(got[prefix + "final_ce"] - want[prefix + "final_ce"])
    assert rel <= 0.05 * abs(want[prefix + "final_ce"])


def test_port_stats_match_jax_on_the_bench_rows():
    """The estimator record on the blobs rows' 20-NN graph: the exact
    graph is the same in both packages, so the numbers agree to f32
    rounding (1e-5 relative)."""
    x = ROWS[""](SMALL_N)
    want, got = jax_stats_record(x), port_stats_record(x)
    for key in ("intrinsic_dim_2nn", "hubness_skew"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    for g, w in zip(got["intrinsic_dim"], want["intrinsic_dim"]):
        assert abs(g - w) <= 1e-5 * abs(w)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=t_bench.N)
    p.add_argument("--optimizer", choices=["dense", "sampling", "knobs"],
                   default="dense",
                   help="dense: the bench workload's record; sampling: "
                        "embed(**SAMPLING_EMBED) a seed, then the "
                        "estimators' record; knobs: embed(**KNOB_EMBED) "
                        "on the blobs rows with each of DENSE_KNOBS")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = p.parse_args()
    n = args.n
    if args.optimizer == "dense":
        for seed in args.seeds:
            t0 = time.perf_counter()
            rec = jax_bench_record(n, seed)
            print(json.dumps({"n": n, "seed": seed,
                              "seconds": time.perf_counter() - t0, **rec}),
                  flush=True)
    elif args.optimizer == "knobs":
        x = ROWS[""](n)
        for knob in t_bench.DENSE_KNOBS:
            t0 = time.perf_counter()
            rec = jax_knob_record(x, knob)
            print(json.dumps({"n": n, "knob": knob,
                              "seconds": time.perf_counter() - t0, **rec}),
                  flush=True)
    else:
        rows = {prefix: make(n) for prefix, make in ROWS.items()}
        for seed in args.seeds:
            t0 = time.perf_counter()
            rec = {}
            for prefix, x in rows.items():
                rec.update(jax_sampling_row(x, prefix, seed))
            print(json.dumps({"n": n, "seed": seed, "optimizer": "sampling",
                              "seconds": time.perf_counter() - t0, **rec}),
                  flush=True)
        t0 = time.perf_counter()
        rec = jax_stats_record(rows[""])
        print(json.dumps({"n": n, "stats": "blobs",
                          "seconds": time.perf_counter() - t0, **rec}),
              flush=True)
