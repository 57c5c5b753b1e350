"""Parity of the port's by-product estimators with the JAX package on
the same inputs, JAX on the CPU: intrinsic dimension (Levina-Bickel and
2NN, 1e-5 relative, the JAX subsamples injected as ``sample_ids``),
hubness (1e-5), the entropies (1e-6), the Carre du champ operator
(1e-5 relative), HDBSCAN* (mutual-reachability graphs equal, MST edges
bit-equal for every backend, labels, probabilities and outlier scores
equal under each selection), and the entry points: ``embed(cluster=)``
with its ``clusters.csv``, and ``cli embed --stats --cluster`` printing
the JAX CLI's keys with values within 1e-5."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import annembed_tpu as ja
import annembed_tpu_torch as ta
from annembed_tpu import cli as j_cli
from annembed_tpu.estimators import cdc as jcdc
from annembed_tpu.estimators import dimension as jdim
from annembed_tpu.estimators import hdbscan as jh
from annembed_tpu.estimators.hubness import Hubness as JHubness
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.utils import entropy as jent
from annembed_tpu_torch import cli as t_cli
from annembed_tpu_torch.estimators import cdc as tcdc
from annembed_tpu_torch.estimators import dimension as tdim
from annembed_tpu_torch.estimators import hdbscan as th
from annembed_tpu_torch.interop import kgraph_from_numpy
from annembed_tpu_torch.utils import entropy as tent


def _clusters(rng, n=900, d=6, n_centers=5, noise=60):
    """Gaussian clusters of unequal spread plus uniform background."""
    centers = rng.normal(size=(n_centers, d)) * 8.0
    lab = rng.integers(0, n_centers, n - noise)
    spread = rng.uniform(0.5, 1.5, n_centers)[lab, None]
    x = centers[lab] + spread * rng.normal(size=(n - noise, d))
    bg = rng.uniform(x.min(0), x.max(0), (noise, d))
    return np.concatenate([x, bg]).astype(np.float32)


def _graphs(x, k):
    idx, dist = j_knn(x, k=k)
    return JKGraph(indices=idx, dists=dist), kgraph_from_numpy(idx, dist)


def _rel(got, want, tol):
    assert abs(got - want) <= tol * abs(want), (got, want)


# --- intrinsic dimension ----------------------------------------------------

@pytest.mark.parametrize("k,sample", [(20, None), (20, 300), (8, None),
                                      (3, None)])
def test_levina_bickel(k, sample, rng):
    jg, tg = _graphs(_clusters(rng), k)
    want = jdim.intrinsic_dim_levina_bickel(jg, sampling_size=sample, seed=4)
    ids = None
    if sample is not None:
        ids = torch.from_numpy(np.array(jax.random.choice(
            jax.random.PRNGKey(4), tg.nb_nodes, (sample,), replace=False)))
    got = tdim.intrinsic_dim_levina_bickel(tg, sample_ids=ids)
    for g, w in zip(got, want):
        _rel(g, w, 1e-5)


@pytest.mark.parametrize("sample", [None, 400])
def test_two_nn(sample, rng):
    x = _clusters(rng)
    x[10] = x[11]                       # one r1 = 0 row is filtered out
    jg, tg = _graphs(x, 10)
    want = jdim.intrinsic_dim_2nn(jg, sampling_size=sample, seed=9)
    ids = None
    if sample is not None:
        m = int((tg.dists[:, 0] > 0).sum())
        ids = torch.from_numpy(np.array(jax.random.choice(
            jax.random.PRNGKey(9), m, (sample,), replace=False)))
    _rel(tdim.intrinsic_dim_2nn(tg, sample_ids=ids), want, 1e-5)


def test_dimension_needs_three_neighbours(rng):
    _, tg = _graphs(_clusters(rng, n=100, noise=0), 2)
    with pytest.raises(ValueError):
        tdim.intrinsic_dim_levina_bickel(tg)


# --- hubness ---------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 20])
def test_hubness(k, rng):
    jg, tg = _graphs(_clusters(rng), k)
    jhub, thub = JHubness.new(jg), ta.Hubness.new(tg)
    np.testing.assert_array_equal(thub.get_counts().numpy(),
                                  np.asarray(jhub.get_counts()))
    _rel(thub.get_standard3m(), jhub.get_standard3m(), 1e-5)
    want = jhub.get_hubness_histogram()
    got = thub.get_hubness_histogram()
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-5 * max(abs(want[key]), 1.0)
    jids, jc = jhub.get_largest_hubs(10)
    tids, tc = thub.get_largest_hubs(10)
    np.testing.assert_array_equal(tc, jc)
    # ids agree wherever the count is not shared with another hub
    counts = thub.get_counts().numpy()
    unique = np.array([(counts == c).sum() == 1 for c in tc])
    np.testing.assert_array_equal(tids[unique], np.asarray(jids)[unique])


# --- entropies -------------------------------------------------------------

@pytest.mark.parametrize("order", [0.5, 1.0, 2.0, 3.5])
def test_entropies(order, rng):
    p = rng.random(50).astype(np.float32)
    p[rng.random(50) < 0.2] = 0.0
    q = rng.random(50).astype(np.float32) + 0.01
    pairs = [(tent.renyi_entropy(p, order), jent.renyi_entropy(p, order)),
             (tent.relative_renyi_entropy(p, q, order),
              jent.relative_renyi_entropy(p, q, order)),
             (tent.shannon_entropy(p), jent.shannon_entropy(p)),
             (tent.perplexity(p), jent.perplexity(p))]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)),
                                                           1.0)
    with pytest.raises(ValueError):
        tent.renyi_entropy(p, 0.0)


# --- Carre du champ ----------------------------------------------------------

@pytest.fixture
def cdc_pair(rng):
    x = _clusters(rng, n=400, d=5, noise=20)
    jg, tg = _graphs(x, 12)
    return (jcdc.CarreDuChamp(x, kgraph=jg),
            tcdc.CarreDuChamp(torch.from_numpy(x), kgraph=tg))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_cdc_kernel_rows_and_batch(cdc_pair):
    j, t = cdc_pair
    pts = np.array([0, 5, 17, 123, 399, 5])
    rows = t.kernel_rows(pts)
    _close(rows.numpy(), j.kernel_rows(jnp.asarray(pts)))
    np.testing.assert_allclose(rows.sum(1).numpy(), 1.0, atol=1e-5)
    jm, jc = j.get_cdc_batch(jnp.asarray(pts))
    tm, tc = t.get_cdc_batch(pts)
    _close(tm.numpy(), jm)
    _close(tc.numpy(), jc)
    mean, mat = t.get_cdc_at_point(17)
    _close(mat.mat.numpy(), tc[2].numpy())
    assert mat.get_trace() == pytest.approx(float(np.trace(jc[2])), rel=1e-5)
    jspec = jcdc.CdcMat(mat=jc[2]).get_spectrum()
    _close(mat.get_spectrum().numpy(), jspec)


def test_cdc_psd_dist_pairs(cdc_pair, rng):
    j, t = cdc_pair
    a = rng.integers(0, 400, 64)
    b = rng.integers(0, 400, 64)
    got = t.psd_dist_pairs(a, b)
    _close(got.numpy(), j.psd_dist_pairs(jnp.asarray(a), jnp.asarray(b)))
    # the pairwise form equals the bound between materialized matrices
    _, ca = t.get_cdc_at_point(int(a[0]))
    _, cb = t.get_cdc_at_point(int(b[0]))
    assert float(got[0]) == pytest.approx(
        tcdc.psd_dist_upper_bound(ca, cb), rel=1e-4, abs=1e-6)


def test_cdc_apply_fvec(cdc_pair):
    j, t = cdc_pair

    def f(v):
        return np.array([v[0] * v[1], np.sin(v[2])])

    def g(v):
        return np.array([v[3], v[4] ** 2, v[0]])
    _close(t.apply_fvec(33, f, g).numpy(), j.apply_fvec(33, f, g))
    assert t.apply_f1d(33, lambda v: v[0], lambda v: v[1]) == pytest.approx(
        j.apply_f1d(33, lambda v: v[0], lambda v: v[1]), rel=1e-5)


# --- HDBSCAN* ----------------------------------------------------------------

@pytest.mark.parametrize("min_samples", [1, 3, 11])
def test_mutual_reachability_equal(min_samples, rng):
    jg, tg = _graphs(_clusters(rng), 10)
    jm = jh.mutual_reachability(jg, min_samples)
    tm = th.mutual_reachability(tg, min_samples)
    np.testing.assert_array_equal(tm.dists.numpy(), np.asarray(jm.dists))
    np.testing.assert_array_equal(tm.indices.numpy(), np.asarray(jm.indices))


@pytest.mark.parametrize("backend", ["native", "numpy", "boruvka"])
def test_mst_bit_equal(backend, rng, monkeypatch):
    jg, tg = _graphs(_clusters(rng), 8)
    jm, tm = jh.mutual_reachability(jg, 5), th.mutual_reachability(tg, 5)
    want = jh.kruskal_mst(jm)
    if backend == "boruvka":
        np.testing.assert_array_equal(th.boruvka_mst(tm), jh.boruvka_mst(jm))
        got = th.boruvka_mst(tm)
        # Boruvka's forest has Kruskal's weights (the MST is unique up to
        # ties, its weight multiset is not)
        np.testing.assert_array_equal(np.sort(got[:, 2]), np.sort(want[:, 2]))
    else:
        if backend == "numpy":
            monkeypatch.setattr(th, "_native_mst_lib", lambda: None)
        got = th.kruskal_mst(tm)
        np.testing.assert_array_equal(got, want)
    assert th.BACKENDS["mst"] == backend


@pytest.mark.parametrize("threshold", [0.5, 2.0, 8.0])
def test_single_linkage_cut_equal(threshold, rng):
    jg, tg = _graphs(_clusters(rng), 8)
    jd, td = jh.single_linkage(jg), th.single_linkage(tg)
    np.testing.assert_array_equal(td.linkage, jd.linkage)
    np.testing.assert_array_equal(td.cluster_by_distance(threshold),
                                  jd.cluster_by_distance(threshold))


@pytest.mark.parametrize("kw", [
    dict(min_cluster_size=15),
    dict(min_cluster_size=15, cluster_selection_method="leaf"),
    dict(min_cluster_size=10, cluster_selection_epsilon=3.0),
    dict(min_cluster_size=40, min_samples=4, allow_single_cluster=True),
], ids=["eom", "leaf", "epsilon", "single"])
def test_hdbscan_equal(kw, rng):
    jg, tg = _graphs(_clusters(rng), 10)
    want = jh.hdbscan(jg, **kw)
    th.BACKENDS.clear()
    got = th.hdbscan(tg, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    np.testing.assert_array_equal(got.condensed, want.condensed)
    assert got.selected == want.selected and got.stability == want.stability
    np.testing.assert_array_equal(
        th.outlier_scores(got.condensed, tg.nb_nodes),
        jh.outlier_scores(want.condensed, jg.nb_nodes))
    assert len(got.selected) >= 2
    assert set(got.timings) == {"mutual_reachability", "mst", "linkage",
                                "condense", "extract"}
    assert th.BACKENDS == {"mst": "native", "linkage": "native",
                           "condense": "native"}


def test_hdbscan_numpy_stages_equal(rng, monkeypatch):
    """Without the native library every host stage runs its numpy copy
    and gives the same result."""
    jg, tg = _graphs(_clusters(rng), 10)
    want = jh.hdbscan(jg, min_cluster_size=15)
    monkeypatch.setattr(th, "_native_mst_lib", lambda: None)
    th.BACKENDS.clear()
    got = th.hdbscan(tg, min_cluster_size=15)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    assert th.BACKENDS == {"mst": "numpy", "linkage": "numpy",
                           "condense": "numpy"}


# --- entry points --------------------------------------------------------------

def test_embed_cluster_writes_clusters_csv(tmp_path, rng):
    x = _clusters(rng, n=600, noise=30)
    kw = dict(dim=2, nbng=8, batch=3, cluster=12)
    _, ij = ja.embed(x, **kw)
    y, it = ta.embed(x, outfile=str(tmp_path / "embedded.csv"),
                     device="cpu", **kw)
    assert set(it["cluster"]) == set(ij["cluster"]) | {"timings"}
    assert it["cluster"]["n_clusters"] == ij["cluster"]["n_clusters"] >= 2
    assert it["cluster"]["noise_fraction"] == ij["cluster"]["noise_fraction"]
    np.testing.assert_array_equal(it["cluster"]["labels"],
                                  ij["cluster"]["labels"])
    rows = np.loadtxt(tmp_path / "clusters.csv", delimiter=",")
    assert rows.shape == (600, 3)
    np.testing.assert_array_equal(rows[:, 0], it["cluster"]["labels"])
    np.testing.assert_allclose(rows[:, 1:], y, rtol=1e-5)
    with pytest.raises(ValueError):
        ta.embed(x, cluster=1, device="cpu")


def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_stats_and_cluster_match_jax(tmp_path, capsys, rng):
    src = tmp_path / "x.csv"
    np.savetxt(src, _clusters(rng, n=700, noise=40), delimiter=",",
               fmt="%.6f")
    common = ["--csv", str(src), "--nbng", "8", "--batch", "2", "--stats",
              "--cluster", "15"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jo = _cli_json(j_cli.main_embed, common + [
        "--outfile", str(tmp_path / "j" / "e.csv")], capsys)
    to = _cli_json(t_cli.main, ["embed"] + common + [
        "--outfile", str(tmp_path / "t" / "e.csv"), "--device", "cpu"],
        capsys)
    assert set(to) == set(jo)
    assert set(to["cluster"]) == set(jo["cluster"])
    assert to["cluster"]["n_clusters"] == jo["cluster"]["n_clusters"]
    for key in ("intrinsic_dim_2nn", "hubness_skew"):
        _rel(to[key], jo[key], 1e-5)
    for g, w in zip(to["intrinsic_dim"], jo["intrinsic_dim"]):
        _rel(g, w, 1e-5)
    assert set(to["hubness_hist"]) == set(jo["hubness_hist"])
    for key, w in jo["hubness_hist"].items():
        assert abs(to["hubness_hist"][key] - w) <= 1e-5 * max(abs(w), 1.0)
    assert (tmp_path / "t" / "clusters.csv").is_file()
