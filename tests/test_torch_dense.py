"""Parity of the port's dense CE optimizer with the JAX package on the
same inputs: one attraction and one repulsion sweep (atol 1e-5),
``reverse_edge_info`` (exact), ``ce_value_dense`` (rtol 1e-5), and a
whole ``run_dense_optimization`` of ~120 nodes x 3 batches with the JAX
relabel permutation and per-sweep offsets injected (atol 1e-3: f32 sums
taken in another order, compounded over 120 sweeps).

The whole run is compared at a small step (grad_step 0.02).  At the
default step 2.0 the sweep map is expansive on this fixture: a 6e-7
difference after the first sweep grows to 3e-5 by sweep 6 and 0.15 by
sweep 11, even between two JAX evaluations of the same sweeps (eager
versus scanned), so no tolerance tied to f32 rounding can hold there.
At grad_step 0.02 the same run agrees to ~4e-6 while a one-sweep shift
of the offsets moves it by ~0.1, so the comparison still pins the
draws and the schedule."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.graph.proba import to_proba_edges as j_proba
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.optim import dense as jd
from annembed_tpu.optim.ce import ce_value_dense as j_ce
from annembed_tpu.optim.embedder import hubness_sampling_weights as j_hub
from annembed_tpu.params import EmbedderParams as JEP
from annembed_tpu_torch.interop import kgraph_from_numpy, nodeparams_from_numpy
from annembed_tpu_torch.optim import dense as td
from annembed_tpu_torch.optim.ce import ce_value_dense as t_ce
from annembed_tpu_torch.optim.embedder import (hubness_sampling_weights as
                                               t_hub, median)
from annembed_tpu_torch.params import EmbedderParams as TEP


def _setup(rng, n_per=40, k=6):
    centers = rng.normal(size=(3, 10)) * 10.0
    x = np.concatenate([c + rng.normal(size=(n_per, 10)) for c in centers])
    idx, dist = j_knn(x.astype(np.float32), k=k)
    jg = JKGraph(indices=idx, dists=dist)
    jn = j_proba(jg, scale_rho=0.75)
    tg = kgraph_from_numpy(idx, dist)
    tn = nodeparams_from_numpy(jn.scale, jn.probas)
    y0 = rng.uniform(-3, 3, (3 * n_per, 2)).astype(np.float32)
    return jg, jn, tg, tn, y0


def _t(a):
    return torch.from_numpy(np.array(a))


def test_reverse_edge_info_exact(rng):
    jg, jn, *_ = _setup(rng)
    j = jd.reverse_edge_info(jg.indices, jn.probas)
    t = td.reverse_edge_info(_t(jg.indices), _t(jn.probas))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_ce_value_dense_matches_jax(rng):
    jg, jn, tg, tn, y0 = _setup(rng)
    j = float(j_ce(jnp.asarray(y0), jg, jn.probas, jn.scale, 1.0))
    t = t_ce(torch.from_numpy(y0), tg, tn.probas, tn.scale, 1.0).item()
    np.testing.assert_allclose(t, j, rtol=1e-5, err_msg="CE, rtol 1e-5")


def _group_inputs(rng):
    jg, jn, tg, tn, y0 = _setup(rng)
    params = JEP()
    (y0_r, idx_r, w, m_visit, w_rev, m_rev, emb_scale, neg_w, n_neg, _,
     _) = jd.prepare_dense_inputs(y0, jg, jn, params, n_sub=60, n_groups=2,
                                  neg_weights=j_hub(jg))
    idx_r = np.asarray(idx_r)
    sl = slice(0, 3)
    arrays = dict(
        yT=np.asarray(y0_r).T.copy(), idxT=idx_r[:, sl].T.copy(),
        wT=np.asarray(w)[:, sl].T.copy(), mT=np.asarray(m_visit)[:, sl].T.copy(),
        w_revT=np.asarray(w_rev)[:, sl].T.copy(),
        m_revT=np.asarray(m_rev)[:, sl].T.copy(),
        scale_iT=np.asarray(emb_scale)[None, :].copy(),
        scale_jT=np.asarray(emb_scale)[idx_r[:, sl]].T.copy())
    return arrays, idx_r.T.copy(), np.asarray(neg_w), n_neg


@pytest.mark.parametrize("gamma", [1.0, 0.35])
def test_attraction_sweep_matches_jax(rng, gamma):
    a, *_ = _group_inputs(rng)
    j = jd._attraction_sweep_sfT(*[jnp.asarray(v) for v in a.values()],
                                 jnp.float32(gamma), 1.0)
    t = td._attraction_sweep_sfT(*[torch.from_numpy(v) for v in a.values()],
                                 gamma, 1.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="attraction sweep, atol 1e-5")


@pytest.mark.parametrize("offset,hub,exclusion", [(0, False, True),
                                                  (17, True, True),
                                                  (93, True, False)])
def test_repulsion_sweep_matches_jax(rng, offset, hub, exclusion):
    a, idxT, neg_w, n_neg = _group_inputs(rng)
    j = jd._repulsion_sweep_rolledT(
        jnp.asarray(a["yT"]), jnp.int32(offset), jnp.asarray(idxT),
        jnp.asarray(a["scale_iT"]), jnp.float32(0.8), 1.0, n_neg,
        neg_weight=jnp.asarray(neg_w) if hub else None,
        neighbor_exclusion=exclusion)
    t = td._repulsion_sweep_rolledT(
        torch.from_numpy(a["yT"]), offset, torch.from_numpy(idxT),
        torch.from_numpy(a["scale_iT"]), 0.8, 1.0, n_neg,
        neg_weight=torch.from_numpy(neg_w.copy()) if hub else None,
        neighbor_exclusion=exclusion)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="repulsion sweep, atol 1e-5")


def _jax_draws(seed: int, n: int, n_groups: int, total_steps: int):
    """The relabel permutation and per-sweep offsets the JAX driver
    draws (run_dense_optimization -> dense_optimize -> _dense_segment)."""
    key, k_relabel = jax.random.split(jax.random.PRNGKey(seed))
    relabel = np.asarray(jax.random.permutation(k_relabel, n))
    assert jd._segment_cap(n, n_groups) >= total_steps, "one segment"
    seg_key = jax.random.split(key, 1)[0]
    step_keys = jax.random.split(seg_key, total_steps)
    offsets = jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(step_keys)
    return relabel, np.asarray(offsets).tolist()


@pytest.mark.parametrize("hub", [False, True])
def test_run_dense_optimization_matches_jax(rng, hub):
    jg, jn, tg, tn, y0 = _setup(rng)
    n, k = 120, 6
    jp = JEP(nb_grad_batch=3, seed=5, grad_step=0.02)
    tp = TEP(nb_grad_batch=3, seed=5, grad_step=0.02)
    relabel, offsets = _jax_draws(5, n, jd._auto_groups(k), 2 * 60)
    yj, ij = jd.run_dense_optimization(jnp.asarray(y0), jg, jn, jp, n_sub=60,
                                       neg_weights=j_hub(jg) if hub else None)
    yt, it = td.run_dense_optimization(
        torch.from_numpy(y0), tg, tn, tp, n_sub=60,
        neg_weights=t_hub(tg) if hub else None,
        relabel=relabel, offsets=offsets)
    assert it == ij
    assert np.abs(np.asarray(yj) - y0).max() > 0.3, "the run must move y"
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-3,
                               err_msg="120-sweep run, atol 1e-3")


def test_run_dense_optimization_schedule_and_refusals(rng):
    """A schedule runs its phases' sweeps; each dense knob runs (their
    parity is tests/test_torch_dense_knobs.py), and the combinations the
    JAX package refuses raise ValueError."""
    *_, tg, tn, y0 = _setup(rng)
    p = TEP(nb_grad_batch=4, n_sub_schedule=((2, 12), (2, 24)))
    y, info = td.run_dense_optimization(torch.from_numpy(y0), tg, tn, p)
    assert info["sweeps"] == 2 * 12 + 1 * 24
    assert torch.isfinite(y).all()
    for knob in (dict(dense_gather_reuse=2), dict(dense_n_blocks=2),
                 dict(dense_scatter_free=False),
                 dict(dense_parallel_kicks=True)):
        y, _ = td.run_dense_optimization(torch.from_numpy(y0), tg, tn,
                                         dataclasses.replace(p, **knob))
        assert torch.isfinite(y).all(), knob
    for knob in (dict(dense_n_blocks=2, dense_scatter_free=False),
                 dict(dense_n_blocks=5),
                 dict(dense_n_blocks=2, dense_gather_reuse=2)):
        with pytest.raises(ValueError):
            td.run_dense_optimization(torch.from_numpy(y0), tg, tn,
                                      dataclasses.replace(p, **knob))


@pytest.mark.parametrize("n", [1, 2, 7, 10])
def test_median_matches_jnp_quantile(rng, n):
    x = rng.normal(size=n).astype(np.float32)
    np.testing.assert_allclose(median(torch.from_numpy(x)).item(),
                               float(jnp.quantile(jnp.asarray(x), 0.5)),
                               rtol=1e-6)
