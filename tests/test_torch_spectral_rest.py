"""The functions of ported modules that PRs 1-6 left out, each against
its JAX counterpart on the same numpy inputs, with the JAX draws
injected: the ``epsil`` truncation, the adaptive range finder and the
adaptive SVD (rank equal, singular values within 1e-4 relative), the
power-iteration estimate of sigma_1 (1e-5), the legacy and the
alfa-weighted Laplacians (1e-6), ``get_dmap_embedding`` and
``DiffusionMaps.embed_from_data`` (up to column sign, 1e-4), the graph
and probability statistics (1e-6); and that the SVD entry points do not
default to the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annembed_tpu.graph import kgraph as jk
from annembed_tpu.graph import laplacian as jl
from annembed_tpu.graph import proba as jp
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.linalg import rsvd as jr
from annembed_tpu.params import DiffusionParams as JDP
from annembed_tpu.spectral import diffmaps as jd
from annembed_tpu_torch.graph import kgraph as tk
from annembed_tpu_torch.graph import laplacian as tl
from annembed_tpu_torch.graph import proba as tp
from annembed_tpu_torch.interop import kgraph_from_numpy
from annembed_tpu_torch.linalg import rsvd as tr
from annembed_tpu_torch.params import DiffusionParams as TDP
from annembed_tpu_torch.spectral import diffmaps as td

WIKI = np.array([[1., 0., 0., 0., 2.],
                 [0., 0., 3., 0., 0.],
                 [0., 0., 0., 0., 0.],
                 [0., 2., 0., 0., 0.]], dtype=np.float32)
SVD_KEY = 4664397


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """PyTorch's CPU ``torch.sqrt`` (2.13, x86-64) can compute one
    worker thread's share of the first vectorized call of a process
    inexactly (up to ~2e-3 absolute on values up to 100, in 3 of 24
    fresh processes under load); every later call gives the steady
    results.  One large call first, so that the comparisons below see
    those."""
    torch.sqrt(torch.ones(1 << 20))


def _jax_block_draws(shape, max_rank, block_size, seed=SVD_KEY):
    """The per-block Gaussians of JAX's ``adaptive_range_finder``: one
    split of the carried key per block."""
    m, n = shape
    nb = -(-min(max_rank, m, n) // block_size)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(nb):
        key, k2 = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k2, (n, block_size),
                                                jnp.float32)))
    return np.stack(out)


def _rank_fixture(rng):
    """tests/test_rsvd.py's rank-discovery matrix: rank 20 in 300 x 250."""
    m, n, r = 300, 250, 20
    u = np.linalg.qr(rng.normal(size=(m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(n, r)))[0]
    return ((u * np.linspace(5.0, 1.0, r)) @ v.T).astype(np.float32)


def _closures(a):
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    return ((lambda x: ta @ x, lambda x: ta.T @ x),
            (lambda x: ja @ x, lambda x: ja.T @ x))


def test_epsil_truncation_matches_jax():
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(SVD_KEY),
                                         (5, 4), jnp.float32))
    j = jr.randomized_svd_dense(jnp.asarray(WIKI), rank=4, n_iter=6,
                                n_oversample=1, epsil=0.5)
    t = tr.randomized_svd_dense(torch.from_numpy(WIKI), rank=4, n_iter=6,
                                n_oversample=1, omega=omega, epsil=0.5)
    s = t.s.numpy()
    assert s[0] > 0 and (s[s < 0.5 * s[0]] == 0).all()
    np.testing.assert_array_equal(s == 0, np.asarray(j.s) == 0)
    np.testing.assert_allclose(s, np.asarray(j.s), rtol=1e-4)


@pytest.mark.parametrize("fixture, kw", [
    ("rank", dict(epsil=1e-3, max_rank=128, block_size=8)),
    ("wiki", dict(epsil=0.5, max_rank=4, block_size=2)),
])
def test_adaptive_finder_and_svd_match_jax(rng, fixture, kw):
    a = _rank_fixture(rng) if fixture == "rank" else WIKI
    (tmm, trmm), (jmm, jrmm) = _closures(a)
    omegas = _jax_block_draws(a.shape, kw["max_rank"], kw["block_size"])
    jq, jrank = jr.adaptive_range_finder(jmm, a.shape, **kw)
    tq, trank = tr.adaptive_range_finder(tmm, a.shape, omegas=omegas,
                                         device="cpu", **kw)
    assert trank == int(jrank)
    assert tq.shape == jq.shape
    np.testing.assert_allclose(tq.numpy()[:, :trank],
                               np.asarray(jq)[:, :trank], atol=1e-4)
    j = jr.randomized_svd_adaptive(jmm, jrmm, a.shape, **kw)
    t = tr.randomized_svd_adaptive(tmm, trmm, a.shape, omegas=omegas,
                                   device="cpu", **kw)
    js = np.asarray(j.s)
    np.testing.assert_array_equal(t.s.numpy() == 0, js == 0)
    np.testing.assert_allclose(t.s.numpy(), js, rtol=1e-4,
                               atol=1e-4 * js[0])
    if fixture == "rank":
        assert 20 <= trank <= 36
    else:
        s_nz = np.sort(t.s.numpy()[t.s.numpy() > 1e-5])[::-1]
        np.testing.assert_allclose(s_nz[:3], [3.0, np.sqrt(5.0), 2.0],
                                   atol=1e-4)


def test_first_singular_value_matches_jax(rng):
    a = rng.normal(size=(60, 60)).astype(np.float32)
    (tmm, trmm), (jmm, jrmm) = _closures(a)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (60, 1),
                                      jnp.float32))
    j = float(jr.estimate_first_singular_value(jmm, jrmm, 60, n_iter=50))
    t = float(tr.estimate_first_singular_value(tmm, trmm, 60, n_iter=50,
                                               v0=v0, device="cpu"))
    np.testing.assert_allclose(t, j, rtol=1e-5)
    np.testing.assert_allclose(t, np.linalg.svd(a, compute_uv=False)[0],
                               rtol=1e-3)


def test_svd_entry_points_do_not_default_to_the_cpu():
    """Without a device, the range finders draw and compute on the
    card: here, with no card, they raise instead of running on the
    CPU."""
    a = torch.from_numpy(WIKI)
    calls = (
        lambda: tr.randomized_svd_op(lambda x: a @ x, lambda x: a.T @ x,
                                     a.shape, rank=2),
        lambda: tr.subspace_range(lambda x: a @ x, lambda x: a.T @ x, 5,
                                  2, 1),
        lambda: tr.adaptive_range_finder(lambda x: a @ x, a.shape),
        lambda: tr.estimate_first_singular_value(lambda x: a @ x,
                                                 lambda x: a.T @ x, 5))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            out = out if isinstance(out, torch.Tensor) else out[0]
            assert out.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


def _graph(rng, n=300, k=10):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    idx, dist = j_knn(x, k=k)
    idx, dist = np.array(idx), np.array(dist)
    return x, jk.KGraph(indices=jnp.asarray(idx), dists=jnp.asarray(dist)), \
        kgraph_from_numpy(idx, dist)


def _assert_laplacians_close(t, j):
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    for name in ("vals", "normalizer"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_laplacian_from_probas_matches_jax(rng):
    _, jg, tg = _graph(rng)
    probas = np.array(jp.to_proba_edges(jg).probas)
    _assert_laplacians_close(
        tl.laplacian_from_probas(tg, torch.from_numpy(probas)),
        jl.laplacian_from_probas(jg, jnp.asarray(probas)))


def test_laplacian_alfa_weighted_matches_jax(rng):
    _, jg, _ = _graph(rng)
    rows, cols, vals = (np.array(a) for a in jk.symmetric_coo(
        jg, weights=jnp.exp(-jg.dists), mode="max", include_self=True))
    scales = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    j = jl.laplacian_alfa_weighted(rows, cols, vals, 300, 0.5,
                                   normed_scales=scales, mean_scale=1.5)
    t = tl.laplacian_alfa_weighted(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), 300, 0.5,
        normed_scales=torch.from_numpy(scales), mean_scale=1.5)
    _assert_laplacians_close(t, j)
    assert t.mean_scale == 1.5
    assert torch.equal(t.normed_scales, torch.from_numpy(scales))


def _up_to_sign(t, j):
    sign = np.sign((t * j).sum(0))
    np.testing.assert_allclose(t * sign, j, atol=1e-4,
                               err_msg="coords up to sign, atol 1e-4")


@pytest.mark.parametrize("t_opt", [None, 3.0])
def test_get_dmap_embedding_matches_jax(rng, t_opt):
    _, jg, tg = _graph(rng, n=400)
    probas = np.array(jp.to_proba_edges(jg).probas)
    j = np.asarray(jd.get_dmap_embedding(jg, jnp.asarray(probas), 2,
                                         t_opt=t_opt))
    t = td.get_dmap_embedding(tg, torch.from_numpy(probas), 2,
                              t_opt=t_opt).numpy()
    assert t.shape == j.shape == (400, 2)
    _up_to_sign(t, j)


def test_embed_from_data_matches_jax(rng):
    x = rng.normal(size=(400, 5)).astype(np.float32)
    params = dict(asked_dim=2, alfa=0.5, beta=-0.1, t=5.0, gnbn=12)
    j = np.asarray(jd.DiffusionMaps(params=JDP(**params)).embed_from_data(
        x, knbn=10))
    t = td.DiffusionMaps(params=TDP(**params)).embed_from_data(
        torch.from_numpy(x), knbn=10).numpy()
    assert t.shape == j.shape == (400, 2)
    _up_to_sign(t, j)


def test_graph_and_proba_statistics_match_jax(rng):
    _, jg, tg = _graph(rng)
    np.testing.assert_array_equal(tg.compute_max_edge().numpy(),
                                  np.asarray(jg.compute_max_edge()))
    t, j = tk.kgraph_stats(tg), jk.kgraph_stats(jg)
    assert t.keys() == j.keys()
    np.testing.assert_allclose(list(t.values()), list(j.values()), rtol=1e-6)
    jnp_ = jp.to_proba_edges(jg, scale_rho=0.75)
    tnp_ = tp.to_proba_edges(tg, scale_rho=0.75)
    assert (tnp_.nb_nodes, tnp_.max_nbng) == (jnp_.nb_nodes, jnp_.max_nbng)
    np.testing.assert_allclose(tnp_.perplexity().numpy(),
                               np.asarray(jnp_.perplexity()), rtol=1e-6)
    t, j = tp.proba_telemetry(tnp_), jp.proba_telemetry(jnp_)
    assert t.keys() == j.keys()
    np.testing.assert_allclose(list(t.values()), list(j.values()), rtol=1e-6)
