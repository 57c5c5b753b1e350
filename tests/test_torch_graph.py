"""Parity of the port's graph/kgraph.py and graph/proba.py with the JAX
package on the same numpy inputs (rtol 1e-5; integer outputs equal)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from annembed_tpu.graph import kgraph as jk
from annembed_tpu.graph.proba import to_proba_edges as j_proba
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu_torch.graph import kgraph as tk
from annembed_tpu_torch.graph.proba import to_proba_edges as t_proba
from annembed_tpu_torch.interop import kgraph_from_numpy

RTOL = 1e-5


def _graph(rng, n=200, k=8, d=6):
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx, dist = j_knn(x, k=k)
    return np.array(idx), np.array(dist)


def _both(idx, dist):
    return (jk.KGraph(indices=jnp.asarray(idx), dists=jnp.asarray(dist)),
            kgraph_from_numpy(idx, dist))


@pytest.mark.parametrize("mode", ["mean", "max"])
@pytest.mark.parametrize("include_self", [False, True])
def test_symmetric_coo_matches_jax(rng, mode, include_self):
    idx, dist = _graph(rng)
    jg, tg = _both(idx, dist)
    jr, jc, jv = jk.symmetric_coo(jg, mode=mode, include_self=include_self)
    tr, tc, tv = tk.symmetric_coo(tg, mode=mode, include_self=include_self)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               err_msg="symmetric_coo vals, rtol 1e-5")
    n = idx.shape[0]
    np.testing.assert_allclose(
        tk.coo_to_dense(tr, tc, tv, n).numpy(),
        np.asarray(jk.coo_to_dense(jr, jc, jv, n)), rtol=RTOL,
        err_msg="coo_to_dense, rtol 1e-5")


def test_in_degree_counts_match_jax(rng):
    idx, dist = _graph(rng, n=150, k=5)
    jg, tg = _both(idx, dist)
    np.testing.assert_array_equal(tk.in_degree_counts(tg).numpy(),
                                  np.asarray(jk.in_degree_counts(jg)))


@pytest.mark.parametrize("scale_rho,beta", [(1.0, 1.0), (0.75, 1.0),
                                            (0.5, 2.0)])
def test_to_proba_edges_match_jax(rng, scale_rho, beta):
    idx, dist = _graph(rng, n=300, k=10)
    jg, tg = _both(idx, dist)
    jn = j_proba(jg, scale_rho=scale_rho, beta=beta)
    tn = t_proba(tg, scale_rho=scale_rho, beta=beta)
    np.testing.assert_allclose(tn.scale.numpy(), np.asarray(jn.scale),
                               rtol=RTOL, err_msg="scale, rtol 1e-5")
    np.testing.assert_allclose(tn.probas.numpy(), np.asarray(jn.probas),
                               rtol=RTOL, err_msg="probas, rtol 1e-5")


@pytest.mark.parametrize("value", [2.0, 0.0])
def test_to_proba_edges_all_equal_fallback(value):
    idx = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], np.int32)
    dist = np.full((4, 3), value, np.float32)
    jg, tg = _both(idx, dist)
    jn, tn = j_proba(jg), t_proba(tg)
    np.testing.assert_allclose(tn.probas.numpy(), np.asarray(jn.probas),
                               rtol=RTOL, err_msg="uniform rows, rtol 1e-5")
    np.testing.assert_allclose(tn.probas.numpy(), 1.0 / 3.0, rtol=RTOL)
    np.testing.assert_allclose(tn.scale.numpy(), np.asarray(jn.scale),
                               rtol=RTOL)


def test_to_proba_edges_sentinel_row(rng):
    """The IVF sentinel row (dist 1e30) of tests/test_graph.py: same
    guarded scales and probas in both packages."""
    idx, dist = _graph(rng, n=120, k=6)
    dist[7, :] = 1e30
    for v in (3, 11, 42):
        idx[v, 2] = 7
    jg, tg = _both(idx, dist)
    jn, tn = j_proba(jg), t_proba(tg)
    np.testing.assert_allclose(tn.scale.numpy(), np.asarray(jn.scale),
                               rtol=RTOL, err_msg="guarded scale, rtol 1e-5")
    np.testing.assert_allclose(tn.probas.numpy(), np.asarray(jn.probas),
                               rtol=RTOL, err_msg="probas, rtol 1e-5")
    assert torch.isfinite(tn.scale).all()
