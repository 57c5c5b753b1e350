"""Parity of the port's spectral initialization with the JAX package:
the wiki SVD fixture, the randomized COO SVD with the JAX Gaussian test
matrix injected (singular values rtol 1e-4, principal-angle sines of the
leading dim+1 vectors <= 1e-3), the diffusion-maps Laplacian (rtol 1e-5)
and ``DiffusionMaps.embed_from_kgraph`` on the exact-SVD path (equal up
to per-column sign, atol 1e-4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.linalg import rsvd as jr
from annembed_tpu.params import DiffusionParams as JDP
from annembed_tpu.spectral.diffmaps import DiffusionMaps as JDM
from annembed_tpu_torch.interop import kgraph_from_numpy
from annembed_tpu_torch.linalg import rsvd as tr
from annembed_tpu_torch.params import DiffusionParams as TDP
from annembed_tpu_torch.spectral.diffmaps import DiffusionMaps as TDM

WIKI = np.array([[1., 0., 0., 0., 2.],
                 [0., 0., 3., 0., 0.],
                 [0., 0., 0., 0., 0.],
                 [0., 2., 0., 0., 0.]], dtype=np.float32)
WIKI_SIGMA = np.array([3.0, np.sqrt(5.0), 2.0, 0.0], dtype=np.float32)
DMAP = dict(asked_dim=2, alfa=0.5, beta=-0.1, t=5.0, gnbn=12)


def _sin_max_angle(a: np.ndarray, b: np.ndarray) -> float:
    """Sine of the largest principal angle between span(a) and span(b)."""
    qa, _ = np.linalg.qr(a.astype(np.float64))
    qb, _ = np.linalg.qr(b.astype(np.float64))
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def test_full_svd_wiki():
    t = tr.full_svd_dense(torch.from_numpy(WIKI))
    j = jr.full_svd_dense(jnp.asarray(WIKI))
    np.testing.assert_allclose(t.s.numpy(), WIKI_SIGMA, atol=1e-5)
    np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), atol=1e-5)


def test_randomized_svd_wiki_with_jax_omega():
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(4664397),
                                         (5, 4), jnp.float32))
    j = jr.randomized_svd_dense(jnp.asarray(WIKI), rank=4, n_iter=6,
                                n_oversample=1)
    t = tr.randomized_svd_dense(torch.from_numpy(WIKI), rank=4, n_iter=6,
                                n_oversample=1, omega=omega)
    np.testing.assert_allclose(t.s.numpy(), WIKI_SIGMA, atol=1e-4)
    np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), atol=1e-4,
                               err_msg="singular values, atol 1e-4")


def _laplacians(x, k=10):
    idx, dist = j_knn(x, k=k)
    jdm, tdm = JDM(params=JDP(**DMAP)), TDM(params=TDP(**DMAP))
    jl = jdm.laplacian_from_kgraph(JKGraph(indices=idx, dists=dist))
    tl = tdm.laplacian_from_kgraph(kgraph_from_numpy(idx, dist))
    return idx, dist, jl, tl


def test_dmap_laplacian_matches_jax(rng):
    x = rng.normal(size=(300, 5)).astype(np.float32)
    _, _, jl, tl = _laplacians(x)
    np.testing.assert_array_equal(tl.rows.numpy(), np.asarray(jl.rows))
    np.testing.assert_array_equal(tl.cols.numpy(), np.asarray(jl.cols))
    for name in ("vals", "normalizer", "normed_scales"):
        np.testing.assert_allclose(
            getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
            rtol=1e-5, atol=1e-7, err_msg=f"laplacian {name}, rtol 1e-5")


def test_randomized_svd_coo_with_jax_omega(rng):
    """n = 4500 >= 4096 rows: the CholeskyQR3 branch of ``_qr_q``."""
    x = rng.normal(size=(4500, 4)).astype(np.float32)
    _, _, jl, _ = _laplacians(x, k=8)
    n, rank = 4500, 20
    key = jax.random.PRNGKey(4664397)
    omega = np.asarray(jax.random.normal(key, (n, rank + 10), jnp.float32))
    j = jr.randomized_svd_coo(jl.rows, jl.cols, jl.vals, key, n=n, rank=rank)
    t = tr.randomized_svd_coo(torch.from_numpy(np.array(jl.rows)),
                              torch.from_numpy(np.array(jl.cols)),
                              torch.from_numpy(np.array(jl.vals)), n=n,
                              rank=rank, omega=omega)
    np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), rtol=1e-4,
                               err_msg="singular values, rtol 1e-4")
    lead = DMAP["asked_dim"] + 1
    sin = _sin_max_angle(np.asarray(j.u)[:, :lead], t.u.numpy()[:, :lead])
    assert sin <= 1e-3, f"principal-angle sine {sin} > 1e-3"


@pytest.mark.parametrize("n", [400, 1200])
def test_embed_from_kgraph_matches_jax_up_to_sign(rng, n):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    idx, dist = j_knn(x, k=10)
    j = np.asarray(JDM(params=JDP(**DMAP)).embed_from_kgraph(
        JKGraph(indices=idx, dists=dist)))
    t = TDM(params=TDP(**DMAP)).embed_from_kgraph(
        kgraph_from_numpy(idx, dist)).numpy()
    assert t.shape == j.shape == (n, 2)
    sign = np.sign((t * j).sum(0))
    np.testing.assert_allclose(t * sign, j, atol=1e-4,
                               err_msg="dmap coords up to sign, atol 1e-4")
