"""The port's certified grid radius search (annembed_tpu_torch/knn/
radius.py) against the port's brute search and the JAX package's grid.

Certified rows and fallback rows alike must be bit-identical to
``knn_search_brute`` on the same inputs.  Against JAX's
``grid_radius_search`` the tables are equal, ``n_fallback`` is equal,
and the distances agree to 1 ulp: XLA's CPU backend contracts the
square sum into a fused multiply-add in both of the JAX package's
searches, the port's torch ops round each product (as its own brute
search does); the quality summaries agree in every count and within
1e-6 relative in the radius and ratio fields.  The quality estimator
takes the grid at d = 2 above 50,000 rows, in the sampled and the
full-fraction route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annembed_tpu.estimators.quality import quality_estimate as j_quality
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.knn.radius import _grid_tables as j_tables
from annembed_tpu.knn.radius import grid_radius_search as j_grid
from annembed_tpu_torch.estimators import quality as tq
from annembed_tpu_torch.graph.kgraph import KGraph as TKGraph
from annembed_tpu_torch.knn import radius as tr
from annembed_tpu_torch.knn.brute import knn_search_brute
from annembed_tpu_torch.params import KnnParams

CLOUDS = ["uniform", "clusters", "skewed"]


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """PyTorch's CPU ``torch.sqrt`` (2.13, x86-64) can compute one
    worker thread's share of the first vectorized call of a process
    inexactly (up to ~2e-3 absolute on values up to 100, in 3 of 24
    fresh processes under load); every later call gives the steady
    results.  One large call first, so that the comparisons below see
    those."""
    torch.sqrt(torch.ones(1 << 20))


def _cloud(dist, rng, n=30_000):
    """tests/test_radius.py's three clouds."""
    if dist == "uniform":
        return rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    if dist == "clusters":
        c = rng.normal(0, 8, (12, 2))
        return (c[rng.integers(0, 12, n)]
                + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    # heavy density skew: most mass in a tight blob + long tail
    return np.concatenate([
        rng.normal(0, 0.05, (n - n // 10, 2)),
        rng.uniform(-50, 50, (n // 10, 2))]).astype(np.float32)


def _brute(y, q_ids, k):
    yt = torch.from_numpy(y)
    return knn_search_brute(yt[torch.from_numpy(q_ids).long()], yt, k=k)[1]


def _check_equal(y, q_ids, k, **kw):
    sd, n_fb = tr.grid_radius_search(torch.from_numpy(y), q_ids, k, **kw)
    assert torch.equal(sd, _brute(y, q_ids, k))
    return n_fb


@pytest.mark.parametrize("dist", CLOUDS)
def test_grid_equals_brute(dist, rng):
    y = _cloud(dist, rng)
    q_ids = rng.choice(y.shape[0], 700, replace=False).astype(np.int32)
    _check_equal(y, q_ids, 61)


def test_grid_fallback_rows_exact(rng):
    """Tight windows and a raised occupancy fail the certificate on many
    rows; the fallback rows are still the brute rows."""
    y = rng.normal(0, 3, (12_000, 2)).astype(np.float32)
    q_ids = rng.choice(12_000, 300, replace=False).astype(np.int32)
    n_fb = _check_equal(y, q_ids, 101, w_own=3, w_adj=3, min_occupancy=140)
    assert n_fb > 0


def test_grid_duplicates_and_ties(rng):
    n = 20_000
    base = rng.integers(-5, 5, (n, 2)).astype(np.float32)
    y = base + rng.choice([0.0, 0.25], (n, 2)).astype(np.float32)
    q_ids = rng.choice(n, 500, replace=False).astype(np.int32)
    _check_equal(y, q_ids, 31)


def test_grid_small_n_delegates(rng):
    """A corpus too small for a grid of 4 x 4 cells goes to brute whole;
    every row counts as a fallback, as in the JAX package."""
    y = rng.normal(0, 1, (2_000, 2)).astype(np.float32)
    q_ids = np.arange(0, 2_000, 7, dtype=np.int32)
    assert tr.grid_shape(2_000, 61) == (None, None)
    assert tr.grid_shape(3_000, 61) == (4, 189)
    assert _check_equal(y, q_ids, 61) == q_ids.size
    assert j_grid(y, q_ids, 61)[1] == q_ids.size


def test_grid_self_included_and_keep_cols(rng):
    """Column 0 is the self distance (0); ``keep_cols`` keeps those
    columns of the full row."""
    y = rng.uniform(-1, 1, (30_000, 2)).astype(np.float32)
    q_ids = rng.choice(30_000, 200, replace=False).astype(np.int32)
    sd, _ = tr.grid_radius_search(torch.from_numpy(y), q_ids, 31)
    assert torch.equal(sd[:, 0], torch.zeros(200))
    kept, _ = tr.grid_radius_search(torch.from_numpy(y), q_ids, 31,
                                    keep_cols=(10, 30))
    assert torch.equal(kept, sd[:, [10, 30]])


@pytest.mark.parametrize("dist", CLOUDS)
def test_grid_matches_jax(dist, rng):
    y = _cloud(dist, rng)
    q_ids = rng.choice(y.shape[0], 700, replace=False).astype(np.int32)
    k = 61
    sd, n_fb = tr.grid_radius_search(torch.from_numpy(y), q_ids, k)
    jsd, j_fb = j_grid(y, q_ids, k)
    assert n_fb == j_fb
    a, b = sd.numpy(), np.asarray(jsd)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= ulp).all(), "distances beyond 1 ulp of JAX's"
    g, _ = tr.grid_shape(y.shape[0], k)
    names = ("ys", "cells", "starts", "counts", "bounds", "cummax_y",
             "cummin_y", "strip_cummax_x", "strip_cummin_x")
    for name, t, j in zip(names, tr._grid_tables(torch.from_numpy(y), g),
                          j_tables(jnp.asarray(y), g)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)


def _assert_summary_matches_jax(t, j):
    """Counts equal; radius and ratio fields within 1e-6 relative (the
    1-ulp distance difference of the square sum's contraction)."""
    assert t.keys() == j.keys()
    for key, v in j.items():
        if "ratio" in key or key.startswith("radius_"):
            np.testing.assert_allclose(t[key], v, rtol=1e-6, err_msg=key)
        else:
            assert t[key] == v, key


def _graph(rng, n, k=6):
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    dists = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    return (JKGraph(indices=jnp.asarray(idx), dists=jnp.asarray(dists)),
            TKGraph(indices=torch.from_numpy(idx),
                    dists=torch.from_numpy(dists)))


def test_quality_sampled_grid_matches_jax_and_brute(rng, monkeypatch):
    """tests/test_radius.py's sampled fixture: the summary through the
    grid matches JAX's and equals the port's brute route's."""
    n = 60_000
    y = np.concatenate([rng.normal(0, 1, (n // 2, 2)),
                        rng.normal(4, 1.5, (n - n // 2, 2))]
                       ).astype(np.float32)
    jg, tg = _graph(rng, n)
    kw = dict(nbng=10, sample_fraction=0.01, seed=3, radius_k=10,
              radius_k_compat=25)
    est = tq.quality_estimate(tg, torch.from_numpy(y), **kw)
    assert est.radius_search["route"] == "grid"
    _assert_summary_matches_jax(est.summary(),
                                j_quality(jg, y, **kw).summary())
    monkeypatch.setattr(tq, "GRID_MIN_ROWS", n)
    brute = tq.quality_estimate(tg, torch.from_numpy(y), **kw)
    assert brute.radius_search["route"] == "brute"
    assert est.summary() == brute.summary()
    assert torch.equal(est.radius, brute.radius)


def test_quality_full_fraction_grid_matches_jax_and_brute(rng):
    """The full fraction of a 55,000-row cloud keeps only the radius
    columns of the grid search: summary matching JAX's, radii of 500
    rows bit-equal to the brute search's columns."""
    n = 55_000
    y = (rng.normal(0, 2, (n, 2))
         + rng.choice([0.0, 5.0], (n, 1))).astype(np.float32)
    jg, tg = _graph(rng, n)
    kw = dict(nbng=10, radius_k=10, radius_k_compat=25)
    est = tq.quality_estimate(tg, torch.from_numpy(y), **kw)
    assert est.nb_sampled == n and est.radius_search["route"] == "grid"
    _assert_summary_matches_jax(est.summary(),
                                j_quality(jg, y, **kw).summary())
    sub = np.sort(rng.choice(n, 500, replace=False)).astype(np.int32)
    assert torch.equal(est.radius[torch.from_numpy(sub).long()],
                       _brute(y, sub, 26)[:, 10])


def test_full_fraction_at_d2_takes_the_grid(rng, monkeypatch):
    """Above 50,000 rows at d = 2 the full fraction goes through the
    grid whatever ``brute_force_limit`` says: no brute search ever gets
    all n rows as queries (an n x n search at 11M rows never returns)."""
    n = 52_000
    y = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    _, tg = _graph(rng, n)
    calls = []

    def spy(queries, corpus, k, **kw):
        calls.append(queries.shape[0])
        assert queries.shape[0] < n, "brute search over all n rows"
        return knn_search_brute(queries, corpus, k, **kw)

    monkeypatch.setattr(tq, "knn_search_brute", spy)
    monkeypatch.setattr(tr, "knn_search_brute", spy)
    est = tq.quality_estimate(tg, torch.from_numpy(y), nbng=10,
                              knn_params=KnnParams(brute_force_limit=1_000))
    assert est.nb_sampled == n
    assert est.radius_search["route"] == "grid"
    assert len(calls) == (1 if est.radius_search["n_fallback"] else 0)
