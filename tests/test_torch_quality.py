"""The port's quality estimator against annembed_tpu's on the same graph
and embedding: integer counts equal, float fields rtol 1e-5, per-node
arrays rtol 1e-5 (atol 1e-6), for the full and the sampled fraction,
with and without the compat radius, at d = 2 and d = 3, and on both
sides of the JAX package's n = 50,000 switch to its grid search."""

import numpy as np
import pytest
import torch

from annembed_tpu.estimators.quality import quality_estimate as j_quality
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu_torch.estimators.quality import (quality_estimate as
                                                   t_quality, quantiles)
from annembed_tpu_torch.graph.kgraph import KGraph as TKGraph
from annembed_tpu_torch.params import KnnParams

RTOL = 1e-5
_INT_FIELDS = ("nb_nodes", "nbng_used", "nbng_target", "nb_without_match",
               "nb_sampled")
_EXACT_FIELDS = ("mean_nb_matched", "mean_nb_matched_marginal",
                 "frac_without_match")
_FLOAT_FIELDS = ("median_ratio", "mean_ratio")


def _ring(n, d, seed):
    """A noisy closed curve embedded in d dims, and a graph along it:
    offsets +-1, +-2, +-3 and 3 random far edges per node, all 9 edges
    random on every fourth node (nodes with no conserved neighbour)."""
    rng = np.random.default_rng(seed)
    t = 2 * np.pi * np.arange(n) / n
    y = np.stack([np.cos(t), np.sin(t)] + [np.sin((j + 2) * t) * 0.1
                                           for j in range(d - 2)], 1)
    y = (y * 10 + rng.normal(scale=0.02, size=(n, d))).astype(np.float32)
    ar = np.arange(n)[:, None]
    near = (ar + np.array([1, -1, 2, -2, 3, -3])) % n
    far = rng.integers(0, n, size=(n, 3))
    idx = np.concatenate([near, far], 1).astype(np.int32)
    idx[::4] = rng.integers(0, n, size=idx[::4].shape)
    dists = np.ones(idx.shape, np.float32)
    return y, idx, dists


def _compare(tq, jq):
    for f in _INT_FIELDS:
        assert getattr(tq, f) == getattr(jq, f), f
    for f in _EXACT_FIELDS:
        assert getattr(tq, f) == getattr(jq, f), f
    for f in _FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tq, f), getattr(jq, f),
                                   rtol=RTOL, err_msg=f)
    for name in ("radii_quantiles", "ratio_quantiles"):
        t, j = getattr(tq, name), getattr(jq, name)
        assert t.keys() == j.keys()
        np.testing.assert_allclose(list(t.values()), list(j.values()),
                                   rtol=RTOL, err_msg=name)
    for name in ("first_dist", "ratio_by_node"):
        np.testing.assert_allclose(getattr(tq, name).numpy(),
                                   np.asarray(getattr(jq, name)),
                                   rtol=RTOL, atol=1e-6, err_msg=name)
    if jq.sample_ids is None:
        assert tq.sample_ids is None
    else:
        np.testing.assert_array_equal(tq.sample_ids, jq.sample_ids)
    assert (tq.compat is None) == (jq.compat is None)
    if jq.compat is not None:
        assert tq.compat.keys() == jq.compat.keys()
        for key, v in jq.compat.items():
            if key == "median_ratio":
                np.testing.assert_allclose(tq.compat[key], v, rtol=RTOL)
            else:
                assert tq.compat[key] == v, key
    assert tq.summary().keys() == jq.summary().keys()


@pytest.mark.parametrize("n,d,frac,compat,nbng", [
    # nbng 6: the radius-defining neighbour is itself a graph edge
    # (offset +-3), so `length <= radius` compares equal distances
    (1500, 2, 1.0, None, 6),     # full, d = 2 (JAX: brute graph rebuild)
    (1500, 2, 1.0, 30, 12),      # full, with compat
    (1200, 3, 1.0, 25, 12),      # full, d = 3
    (4000, 2, 0.1, 30, 12),      # sampled, n <= 50,000 (JAX: brute search)
    (4000, 3, 0.1, None, 6),     # sampled, d = 3
    (51_000, 2, 0.01, 30, 6),    # sampled, n > 50,000 (JAX: grid search)
])
def test_quality_matches_jax(n, d, frac, compat, nbng):
    y, idx, dists = _ring(n, d, seed=n + d)
    jq = j_quality(JKGraph(indices=idx, dists=dists), y, nbng=nbng,
                   sample_fraction=frac, seed=5, radius_k_compat=compat)
    tq = t_quality(TKGraph(indices=torch.from_numpy(idx),
                           dists=torch.from_numpy(dists)),
                   torch.from_numpy(y), nbng=nbng, sample_fraction=frac,
                   seed=5, radius_k_compat=compat)
    assert 0 < tq.nb_without_match < tq.nb_nodes
    _compare(tq, jq)


def test_full_fraction_above_the_brute_limit_raises_at_d3():
    """It raised until the IVF build was ported; now the d = 3 radius
    above the limit comes from the IVF rebuild of the embedded cloud
    (no refinement, f32 panels whatever the caller's dtype), which at
    nprobe = nlist is the exact search."""
    y, idx, dists = _ring(300, 3, seed=1)
    g = TKGraph(indices=torch.from_numpy(idx), dists=torch.from_numpy(dists))
    exact = t_quality(g, torch.from_numpy(y), nbng=5)
    q = t_quality(g, torch.from_numpy(y), nbng=5, radius_k_compat=9,
                  knn_params=KnnParams(brute_force_limit=100, nlist=8,
                                       nprobe=8, dtype="bfloat16"))
    assert q.nb_sampled == 300 and q.compat["radius_k"] == 9.0
    assert q.nb_without_match == exact.nb_without_match
    np.testing.assert_allclose(list(q.radii_quantiles.values()),
                               list(exact.radii_quantiles.values()),
                               rtol=1e-5)
    # at d = 2 the exact search serves any n
    q = t_quality(g, torch.from_numpy(y[:, :2]), nbng=5,
                  knn_params=KnnParams(brute_force_limit=100))
    assert q.nb_sampled == 300


def test_quantiles_beyond_torch_quantile_limit():
    """torch.quantile refuses > 2^24 elements; the port's sort-based
    linear interpolation must match np.quantile there."""
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, size=(1 << 24) + 4097).astype(np.float32)
    qs = (0.05, 0.25, 0.5, 0.75, 0.85, 0.95)
    np.testing.assert_allclose(quantiles(torch.from_numpy(x), qs),
                               np.quantile(x, qs), rtol=RTOL)


def test_embedder_getters_and_quality_entry(rng):
    """``Embedder.get_quality_estimate_from_edge_length`` is the estimator
    on the embedder's graph and embedding, seeded by its params."""
    from annembed_tpu_torch import Embedder, EmbedderParams, build_kgraph
    x = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    g = build_kgraph(x, 6)
    emb = Embedder.new(g, EmbedderParams(nb_grad_batch=2, seed=3))
    y = emb.embed()
    assert emb.get_embedded() is y and emb.get_embedded_reindexed() is y
    assert emb.get_initial_embedding().shape == (300, 2)
    assert torch.equal(emb.get_embedded_by_nodeid(7), y[7])
    assert torch.equal(emb.get_embedded_by_dataid(7), y[7])
    q = emb.get_quality_estimate_from_edge_length(nbng=10,
                                                  sample_fraction=0.5,
                                                  radius_k_compat=20)
    want = t_quality(g, y, nbng=10, sample_fraction=0.5, seed=3,
                     radius_k_compat=20)
    assert q.summary() == want.summary()
    np.testing.assert_array_equal(q.sample_ids, want.sample_ids)
