"""The hierarchical slice as a whole: ``embed(x, layer=1)`` in both
packages on 600 points of 3 blobs, each with its own random draws.
Held to: shape and finiteness, the large-step final CE within 5%
relative of the JAX package's, cluster accuracy >= 0.85 in both (as
tests/test_optim.py measures it), and the same info keys.  The same
again with ``brute_force_limit`` lowered so both graphs take the IVF +
NN-descent build, at grad_step 0.02 and with the JAX package's graph
draws (sample ids, k-means initial rows) injected."""

import numpy as np
import pytest
import torch

import jax

import annembed_tpu as ja
import annembed_tpu_torch as ta
from annembed_tpu.params import EmbedderParams as JEP
from annembed_tpu.params import KnnParams as JKP
from annembed_tpu_torch.params import EmbedderParams as TEP

KW = dict(dim=2, nbng=6, layer=1, hierarchy_fraction=0.2, scale=0.75,
          batch=10, seed=0)


def _blobs():
    rng = np.random.default_rng(4664397)
    centers = rng.normal(size=(3, 10)) * 10.0
    x = np.concatenate([c + rng.normal(size=(200, 10)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(3), 200)


def _accuracy(y, labels):
    mus = np.stack([y[labels == i].mean(0) for i in range(3)])
    d_to = np.linalg.norm(y[:, None] - mus[None], axis=-1)
    return float((d_to.argmin(1) == labels).mean())


def test_hierarchical_embed_matches_jax_statistically():
    x, labels = _blobs()
    yj, ij = ja.embed(x, params=JEP(grad_factor=2, hubness_weighting=True),
                      **KW)
    yt, it = ta.embed(x, params=TEP(grad_factor=2, hubness_weighting=True),
                      device="cpu", **KW)
    assert yt.shape == np.asarray(yj).shape == (600, 2)
    assert np.isfinite(yt).all()
    rel = abs(it["final_ce"] - ij["final_ce"]) / abs(ij["final_ce"])
    assert rel <= 0.05, f"large-step final_ce {it['final_ce']} vs " \
        f"{ij['final_ce']}: {rel:.3f} > 5% relative"
    for name, y in (("jax", np.asarray(yj)), ("torch", yt)):
        acc = _accuracy(y, labels)
        assert acc >= 0.85, f"{name} cluster accuracy {acc} < 0.85"
    assert set(ij) <= set(it), set(ij) - set(it)
    assert set(it) - set(ij) == {"graph_build_phases",
                                 "projection_distance_quantiles", "spans",
                                 "counters"}
    assert set(it["first_step"]) == set(ij["first_step"])
    assert it["first_step"]["final_ce"] < it["first_step"]["initial_ce"]


def _jax_choice(seed, n, m):
    return torch.from_numpy(np.array(jax.random.choice(
        jax.random.PRNGKey(seed), n, (m,), replace=False)))


def test_hierarchical_embed_ivf_matches_jax(monkeypatch):
    """Both graphs (120 and 600 rows) above a limit of 100: k-means, the
    sorted join, three NN-descent rounds.  The graph draws are the JAX
    package's; the optimizer's are each package's own, so the embedding
    is held as in the test above."""
    x, labels = _blobs()
    kp = dict(knbn=6, brute_force_limit=100)
    yj, ij = ja.embed(x, knn_params=JKP(**kp), return_graph=True,
                      params=JEP(grad_factor=2, hubness_weighting=True,
                                 grad_step=0.02), **KW)

    monkeypatch.setattr(
        ta.knn.hierarchy, "draw_sample_ids",
        lambda n, m, generator: torch.sort(_jax_choice(KW["seed"], n, m))[0])
    fit = ta.knn.ivf.kmeans_fit
    ivf_rows = []

    def fit_from_jax_rows(sub, nlist, **kw):
        ivf_rows.append(sub.shape[0])
        kw["init_ids"] = _jax_choice(kw["seed"], sub.shape[0], nlist)
        return fit(sub, nlist, **kw)
    monkeypatch.setattr(ta.knn.ivf, "kmeans_fit", fit_from_jax_rows)
    yt, it = ta.embed(x, knn_params=ta.KnnParams(**kp), return_graph=True,
                      params=TEP(grad_factor=2, hubness_weighting=True,
                                 grad_step=0.02), device="cpu", **KW)
    assert ivf_rows == [120, 600]
    gj, gt = ij.pop("kgraph"), it.pop("kgraph")
    same = gt.indices.numpy() == np.asarray(gj.indices)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(gt.dists.numpy()[same],
                               np.asarray(gj.dists)[same], rtol=1e-5)
    assert yt.shape == np.asarray(yj).shape == (600, 2)
    assert np.isfinite(yt).all()
    rel = abs(it["final_ce"] - ij["final_ce"]) / abs(ij["final_ce"])
    assert rel <= 0.05, f"large-step final_ce {it['final_ce']} vs " \
        f"{ij['final_ce']}: {rel:.3f} > 5% relative"
    for name, y in (("jax", np.asarray(yj)), ("torch", yt)):
        acc = _accuracy(y, labels)
        assert acc >= 0.85, f"{name} cluster accuracy {acc} < 0.85"
    assert set(it) - set(ij) == {"graph_build_phases",
                                 "projection_distance_quantiles", "spans",
                                 "counters"}
    phases = set(it["graph_build_phases"])
    assert {"small_graph", "large_graph", "projection"} < phases
    assert {f"large_graph/{p}" for p in (
        "ivf_quantize", "ivf_join", "nndescent_round_1", "nndescent_round_2",
        "nndescent_round_3")} < phases


def test_one_step_embed_runs():
    x, labels = _blobs()
    y, info = ta.embed(x, dim=2, nbng=6, batch=5, device="cpu")
    assert y.shape == (600, 2) and np.isfinite(y).all()
    assert info["final_ce"] < info["initial_ce"]
    assert _accuracy(y, labels) >= 0.85


# what the multi-device path refuses before any graph is built: more
# ranks than cards (never a fallback to fewer, or to the CPU), and a
# mesh that is not a parallel.sharded.Mesh
UNSUPPORTED = [dict(n_devices=2, device="cuda"), dict(mesh=object())]
# refused until they were ported: HDBSCAN* (``cluster``), the sampling
# optimizer, 600 rows above a limit of 100 (they never reach the brute
# build) and bfloat16 panels
FORMERLY_REFUSED = [
    dict(cluster=5), dict(params=TEP(optimizer="sampling")),
    dict(knn_params=ta.KnnParams(knbn=6, brute_force_limit=100)),
    dict(knn_params=ta.KnnParams(knbn=6, dtype="bfloat16")),
]
# refused until this slice: the dense knobs and ApproxTopK's recall
# target (exact off a TPU); the caches have their own tests
# (tests/test_torch_io.py)
DENSE_AND_TOPK = [
    dict(params=TEP(dense_gather_reuse=2)),
    dict(knn_params=ta.KnnParams(knbn=6, topk_recall=0.99)),
    dict(params=TEP(dense_parallel_kicks=True)),
    dict(params=TEP(dense_n_blocks=2)),
    dict(params=TEP(dense_scatter_free=False)),
]


def _no_graph_build(monkeypatch):
    """Make any kNN graph build fail the test."""
    def built(*args, **kwargs):
        raise AssertionError("a graph was built before the refusal")
    for mod in (ta.api, ta.knn.hierarchy):
        monkeypatch.setattr(mod, "build_kgraph", built)
    for name in ("knn_graph_brute", "knn_graph_ivf"):
        monkeypatch.setattr(ta.knn.api, name, built)


def _no_brute_above_limit(kwargs, monkeypatch):
    """Make the brute build fail the test when the rows are above the
    case's ``brute_force_limit``."""
    kp = kwargs.get("knn_params")
    if kp is not None and kp.brute_force_limit < 600:
        def brute(*args, **kw):
            raise AssertionError("the brute build ran above its limit")
        monkeypatch.setattr(ta.knn.api, "knn_graph_brute", brute)


@pytest.mark.parametrize("kwargs", UNSUPPORTED)
def test_unsupported_options_raise(kwargs, monkeypatch):
    x, _ = _blobs()
    _no_graph_build(monkeypatch)
    if "n_devices" in kwargs:
        kwargs = dict(kwargs, n_devices=torch.cuda.device_count() + 1)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        ta.embed(x, **dict(dict(nbng=6, batch=2, device="cpu"), **kwargs))


@pytest.mark.parametrize("name", ["Dense", "samplng"])
def test_unknown_optimizer_refused_before_graph_build(name, monkeypatch):
    x, _ = _blobs()
    _no_graph_build(monkeypatch)
    with pytest.raises(ValueError, match="unknown optimizer"):
        ta.embed(x, nbng=6, batch=2, device="cpu",
                 params=TEP(optimizer=name))


@pytest.mark.parametrize("kwargs", FORMERLY_REFUSED + DENSE_AND_TOPK)
def test_formerly_refused_options_run(kwargs, monkeypatch):
    x, labels = _blobs()
    _no_brute_above_limit(kwargs, monkeypatch)
    y, info = ta.embed(x, nbng=6, batch=5, device="cpu", **kwargs)
    assert y.shape == (600, 2) and np.isfinite(y).all()
    assert _accuracy(y, labels) >= 0.85


def test_dmap_embed_refuses_before_graph_build(monkeypatch):
    """More ranks than cards: refused, never run on fewer or on the
    CPU."""
    x, _ = _blobs()
    _no_graph_build(monkeypatch)
    with pytest.raises((RuntimeError, ValueError)):
        ta.dmap_embed(x, nbng=6, device="cuda",
                      n_devices=torch.cuda.device_count() + 1)


@pytest.mark.parametrize("kwargs", FORMERLY_REFUSED[2:])
def test_dmap_embed_formerly_refused_options_run(kwargs, monkeypatch):
    x, _ = _blobs()
    _no_brute_above_limit(kwargs, monkeypatch)
    y, info = ta.dmap_embed(x, nbng=6, device="cpu", **kwargs)
    assert y.shape == (600, 2) and np.isfinite(y).all()
    assert info["nb_embedded"] == 600


def test_csv_path_and_missing_card_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        ta.embed(tmp_path / "missing.csv", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ta.embed(np.zeros((10, 3), np.float32), device="cuda")
