"""The four non-L2 metrics of the port against the JAX package: pair
forms and panels (rtol 1e-5, with the zero-norm and zero-component
cases), the brute graph and search per metric (ids equal outside
near-ties, dists rtol 1e-5), and the hierarchical projection through the
k=1 search."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from annembed_tpu.knn import distances as jd
from annembed_tpu.knn.brute import (knn_graph_brute as j_graph,
                                    knn_search_brute as j_search)
from annembed_tpu.knn.hierarchy import build_projection as j_projection
from annembed_tpu_torch.knn import distances as td
from annembed_tpu_torch.knn.brute import (knn_graph_brute as t_graph,
                                          knn_search_brute as t_search)
from annembed_tpu_torch.knn.hierarchy import build_projection as t_projection
from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count

RTOL = 1e-5
#: relative distance gap under which two neighbours are a near-tie
TIE_REL = 1e-5
METRICS = ["DistL1", "DistCosine", "DistJeffreys", "DistJensenShannon"]


def _data(rng, metric, n, d):
    """Rows for ``metric``: probability vectors with zero components for
    Jeffreys / JS, rows with a zero vector for cosine."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    if metric in ("DistJeffreys", "DistJensenShannon"):
        x = np.abs(x) * (rng.random((n, d)) > 0.3)
        x[:, 0] += 0.1
        x = (x / x.sum(1, keepdims=True)).astype(np.float32)
    elif metric == "DistCosine":
        x[3] = 0.0
    return x


@pytest.mark.parametrize("metric", METRICS)
def test_panel_and_pair_match_jax(rng, metric):
    q = _data(rng, metric, 33, 9)
    x = _data(rng, metric, 70, 9)
    tp = td.get_panel_fn(metric)(torch.from_numpy(q), torch.from_numpy(x))
    jp = jd.get_panel_fn(metric)(jnp.asarray(q), jnp.asarray(x))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=1e-6, err_msg=f"{metric} panel")
    tpair = td.get_pair_fn(metric)(torch.from_numpy(q[:, None]),
                                   torch.from_numpy(x[None]))
    jpair = jd.get_pair_fn(metric)(q[:, None], x[None])
    np.testing.assert_allclose(tpair.numpy(), np.asarray(jpair), rtol=RTOL,
                               atol=1e-6, err_msg=f"{metric} pair form")
    np.testing.assert_allclose(tp.numpy(), tpair.numpy(), rtol=RTOL,
                               atol=1e-6, err_msg="panel == pair form")


def test_degenerate_inputs_follow_hnsw_rs():
    z = torch.zeros(1, 4)
    v = torch.tensor([[1.0, 2.0, 0.0, 0.0]])
    assert td.cosine_panel(z, v).item() == 0.0
    assert td.cosine_pair(v, z).item() == 0.0
    p = torch.tensor([[1.0, 0.0]])
    r = torch.tensor([[0.0, 1.0]])
    # Jeffreys clamps the zero components at 1e-30
    expect = 2 * np.log(np.float32(1.0) / np.float32(1e-30))
    np.testing.assert_allclose(td.jeffreys_pair(p, r).item(), expect,
                               rtol=RTOL)
    # disjoint supports: JS divergence ln 2, distance its sqrt
    np.testing.assert_allclose(td.js_pair(p, r).item(), np.sqrt(np.log(2)),
                               rtol=RTOL)
    assert td.js_pair(p, p).item() == 0.0
    with pytest.raises(ValueError):
        td.get_panel_fn("DistHamming")


def _check_ids(t_out, j_out, what):
    """ids equal wherever the JAX row's distances are not near-tied at
    that column; dists rtol 1e-5 everywhere."""
    ti, tdist = t_out[0].numpy(), t_out[1].numpy()
    ji, jdist = np.asarray(j_out[0]), np.asarray(j_out[1])
    np.testing.assert_allclose(tdist, jdist, rtol=RTOL, atol=1e-6,
                               err_msg=f"{what}: dists")
    scale = np.maximum(np.abs(jdist), 1e-6)
    gap = np.full(jdist.shape, np.inf)
    gap[:, 1:] = np.diff(jdist, axis=1) / scale[:, 1:]
    gap[:, :-1] = np.minimum(gap[:, :-1], np.diff(jdist, axis=1)
                             / scale[:, :-1])
    clear = gap > TIE_REL
    assert (ti[clear] == ji[clear]).all(), f"{what}: ids differ off ties"
    assert clear.mean() > 0.9, f"{what}: too many near-ties to test"


@pytest.mark.parametrize("metric", METRICS)
def test_graph_and_search_match_jax(rng, metric):
    x = _data(rng, metric, 180, 12)
    _check_ids(t_graph(torch.from_numpy(x), 7, distance=metric,
                       block_rows=64),
               j_graph(x, 7, distance=metric, block_rows=64),
               f"{metric} graph")
    q = _data(rng, metric, 25, 12)
    _check_ids(t_search(torch.from_numpy(q), torch.from_numpy(x), 5,
                        distance=metric, block_rows=16),
               j_search(q, x, 5, distance=metric, block_rows=16),
               f"{metric} search")


@pytest.mark.parametrize("metric", ["DistL1", "DistJeffreys"])
def test_exact_ties_go_to_the_lower_index(rng, metric):
    """Small-integer rows tie on L1, duplicate rows on any metric: the
    selection must then equal lax.top_k's, lowest index first."""
    if metric == "DistL1":
        x = rng.integers(0, 3, size=(120, 4)).astype(np.float32)
    else:
        x = _data(rng, metric, 90, 6)
        x = np.concatenate([x, x[:30], x[:10]])
    ti, tdist = t_graph(torch.from_numpy(x), 9, distance=metric)
    ji, jdist = j_graph(x, 9, distance=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("metric", ["DistL1", "DistCosine"])
def test_projection_uses_the_metric(rng, metric):
    x = _data(rng, metric, 300, 6)
    jp = j_projection(x, 5, sample_fraction=0.2, seed=3, distance=metric)
    before = top1_launch_count()
    tp = t_projection(torch.from_numpy(x), 5, sample_fraction=0.2,
                      distance=metric,
                      sample_ids=torch.from_numpy(np.array(jp.sample_ids)))
    assert top1_launch_count() == before
    np.testing.assert_array_equal(tp.proj_small_idx.numpy(),
                                  np.asarray(jp.proj_small_idx))
    np.testing.assert_allclose(tp.proj_dist.numpy(), np.asarray(jp.proj_dist),
                               rtol=RTOL, atol=1e-6)
