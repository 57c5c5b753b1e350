"""The port's NN-descent refinement against annembed_tpu's on the same
graph, with the JAX package's per-round uniforms injected
(``PRNGKey(seed + 1013)``, split once a round).

The reverse table, the union table and its sampled subset are integer
tables and must be equal.  A refined graph is compared as chip_smoke
compares graphs: distances to 1e-5 relative where the ids agree, ids
equal on the columns whose distance is further than TIE_REL (relative)
from both row neighbours' distances (candidates are scored by the exact
pair form, so all such columns must agree)."""

import jax
import numpy as np
import pytest
import torch

from annembed_tpu.knn import nndescent as jnd
from annembed_tpu.knn.brute import knn_graph_brute as j_brute
from annembed_tpu.knn.ivf import knn_graph_ivf as j_ivf
from annembed_tpu_torch.knn import nndescent as tnd
from annembed_tpu_torch.knn.api import recall_at_k

TIE_REL = 1e-5
D_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _clear_ties(dist):
    """Columns whose distance is further than TIE_REL (relative) from
    both row neighbours' distances (columns at inf are never clear)."""
    scale = np.maximum(np.abs(dist), 1e-6)
    gap = np.full(dist.shape, np.inf)
    with np.errstate(invalid="ignore"):
        step = np.diff(dist, axis=1)
        gap[:, 1:] = step / scale[:, 1:]
        gap[:, :-1] = np.minimum(gap[:, :-1], step / scale[:, :-1])
    return gap > TIE_REL


def assert_graphs_agree(ti, td, ji, jd, atol=0.0):
    ti, td = ti.numpy(), td.numpy()
    ji, jd = np.asarray(ji), np.asarray(jd)
    clear = _clear_ties(jd) & np.isfinite(jd)
    np.testing.assert_array_equal(ti[clear], ji[clear])
    same = (ti == ji) & np.isfinite(jd)
    np.testing.assert_allclose(td[same], jd[same], rtol=D_RTOL, atol=atol)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))


def _jax_uniforms(seed, n_rounds, shape):
    """The uniforms ``nndescent_refine`` of the JAX package draws."""
    key = jax.random.PRNGKey(seed + 1013)
    out = []
    for _ in range(n_rounds):
        key, k_s = jax.random.split(key)
        out.append(_t(jax.random.uniform(k_s, shape)))
    return out


def _graph(rng, n=1500, d=8, k=8, metric="DistL2"):
    """An approximate (low-probe IVF) graph of clustered rows, with the
    fix-up's duplicated neighbours in it."""
    centers = rng.normal(size=(10, d)) * 4
    x = (centers[rng.integers(0, 10, n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    if metric in ("DistJeffreys", "DistJensenShannon"):
        x = np.abs(x) + 0.05
        x /= x.sum(1, keepdims=True)
    idx, dist = j_ivf(x, k, distance=metric, nlist=48, nprobe=2)
    return x, np.asarray(idx), np.asarray(dist)


# --- tables: exact ---------------------------------------------------------

@pytest.mark.parametrize("with_dists", [False, True])
@pytest.mark.parametrize("capacity", [3, 8, 20])
def test_reverse_table_equal(rng, with_dists, capacity):
    n, k = 400, 8
    # hubs: many sources point at few destinations, so small capacities
    # overflow; quantized distances put ties inside a destination
    idx = np.minimum(rng.integers(0, n, size=(n, k)),
                     rng.integers(0, n, size=(n, k))).astype(np.int32)
    dist = (rng.integers(0, 6, size=(n, k)) / 4.0).astype(np.float32)
    jd, td = (dist, _t(dist)) if with_dists else (None, None)
    want = np.asarray(jnd._reverse_table(jax.numpy.asarray(idx), capacity,
                                         jd))
    got = tnd._reverse_table(_t(idx), capacity, td)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -1] < n).any() or capacity == 20


@pytest.mark.parametrize("s", [2, 7, 12])
def test_union_and_sampled_union_equal(rng, s):
    x, idx, dist = _graph(rng, n=600, k=6)
    jun = jnd._union_pp_impl(jax.numpy.asarray(idx), 6,
                             jax.numpy.asarray(dist))
    tun = tnd._union_pp(_t(idx), 6, _t(dist))
    np.testing.assert_array_equal(tun.numpy(), np.asarray(jun))
    assert tun.shape == (601, 12) and (tun[-1] == 600).all()
    key = jax.random.PRNGKey(5)
    want = jnd._sample_union_pp(key, jun, s)
    un = _t(jax.random.uniform(key, jun.shape))
    got = tnd._sample_union_pp(un, tun, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_rerank_slab_matches_jax(rng):
    x, idx, _ = _graph(rng, n=500, k=6)
    idx = idx.copy()
    idx[::9, -1] = 500             # a pad id stays last at inf
    rid = np.arange(500, dtype=np.int32)
    ji, jd = jnd._exact_rerank_slab(jax.numpy.asarray(x),
                                    jax.numpy.asarray(idx),
                                    jax.numpy.asarray(rid))
    ti, td = tnd._exact_rerank_slab(_t(x), _t(idx), _t(rid))
    assert_graphs_agree(ti, td, ji, jd)
    assert torch.isinf(td[::9, -1]).all() and (ti[::9, -1] == 500).all()


# --- a refinement round against the JAX package ----------------------------

@pytest.mark.parametrize("metric,rho,dtype", [
    ("DistL2", 1.0, "float32"), ("DistL2", 0.5, "float32"),
    ("DistL2", 0.5, "bfloat16"), ("DistCosine", 1.0, "float32"),
    ("DistL1", 0.5, "float32"), ("DistJensenShannon", 1.0, "bfloat16")])
def test_one_round_matches_jax(rng, metric, rho, dtype):
    x, idx, dist = _graph(rng, metric=metric)
    n, k = idx.shape
    kw = dict(n_rounds=1, distance=metric, dtype=dtype, rho=rho, seed=4)
    ji, jd = jnd.nndescent_refine(x, jax.numpy.asarray(idx),
                                  jax.numpy.asarray(dist), **kw)
    ti, td = tnd.nndescent_refine(
        _t(x), _t(idx), _t(dist),
        uniforms=_jax_uniforms(4, 1, (n + 1, 2 * k)), **kw)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    # cosine is 1 - cos and Jensen-Shannon a root of a difference of
    # logs: their rounding is absolute
    atol = 0.0 if metric in ("DistL2", "DistL1") else 2e-6
    assert_graphs_agree(ti, td, ji, jd, atol=atol)


def test_two_rounds_rho_half_match_jax_and_gain_recall(rng):
    """Two sampled rounds follow the JAX package's key chain; recall
    against the exact graph rises as the JAX package's does."""
    x, idx, dist = _graph(rng)
    n, k = idx.shape
    ei, _ = j_brute(x, k)
    kw = dict(n_rounds=2, rho=0.5, seed=0)
    ji, jd = jnd.nndescent_refine(x, jax.numpy.asarray(idx),
                                  jax.numpy.asarray(dist), **kw)
    ti, td = tnd.nndescent_refine(
        _t(x), _t(idx), _t(dist),
        uniforms=_jax_uniforms(0, 2, (n + 1, 2 * k)), **kw)
    assert_graphs_agree(ti, td, ji, jd)
    e = _t(ei)
    r0, r2 = recall_at_k(_t(idx), e), recall_at_k(ti, e)
    assert r2 > r0 + 0.05, (r0, r2)
    # no duplicate neighbours and no self edges are left
    assert all(len(set(r)) == k for r in ti.tolist())
    assert not (ti == torch.arange(n)[:, None]).any()


# --- inside the port --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_slab_and_many_bit_parity(rng, dtype):
    x, idx, dist = _graph(rng, n=900)
    kw = dict(n_rounds=2, rho=0.5, dtype=dtype, seed=3)
    i1, d1 = tnd.nndescent_refine(_t(x), _t(idx), _t(dist), **kw)
    i2, d2 = tnd.nndescent_refine(_t(x), _t(idx), _t(dist),
                                  slab_bytes=300_000, **kw)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    # the generator's draws depend on the seed alone
    i3, _ = tnd.nndescent_refine(_t(x), _t(idx), _t(dist),
                                 **{**kw, "seed": 9})
    assert not torch.equal(i1, i3)


def test_bf16_scoring_returns_f32_exact_distances(rng):
    x, idx, dist = _graph(rng, n=900)
    ti, td = tnd.nndescent_refine(_t(x), _t(idx), _t(dist), n_rounds=2,
                                  dtype="bfloat16")
    xt = _t(x)
    want = torch.sqrt(torch.square(xt[:, None, :] - xt[ti.long()]).sum(-1))
    np.testing.assert_allclose(td.numpy(), want.numpy(), rtol=1e-6)
    assert (td.diff(dim=1) >= 0).all()
