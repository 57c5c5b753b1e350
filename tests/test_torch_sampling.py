"""Parity of the port's sampling optimizer (optim/ce.py, utils/alias.py)
with the JAX package on the same inputs, JAX on the CPU.

The port takes its random draws as arguments; these tests rebuild the
JAX package's key tree (``keys = split(PRNGKey(seed), total_steps)``;
per step ``k_edge, k_neg = split(key)``; inside ``alias_sample``
``k1, k2 = split(k)`` -> ``randint``, ``uniform``) and inject the draws.
Held: alias tables bit-equal (both backends), the edge set equal,
``ce_value`` to 1e-5 relative, one ``minibatch_update`` to 1e-6 abs +
1e-5 relative, three batches of ``run_entropy_optimization`` at
grad_step 0.02 to 1e-4 (the sweep map is expansive at the default step,
as for the dense optimizer: tests/test_torch_dense.py), and the whole
``embed(optimizer="sampling")`` statistically: same info keys, final CE
within 10% of the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import annembed_tpu as ja
import annembed_tpu_torch as ta
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.graph.proba import to_proba_edges as j_proba
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.optim import ce as jce
from annembed_tpu.optim.embedder import hubness_sampling_weights as j_hub
from annembed_tpu.params import EmbedderParams as JEP
from annembed_tpu.utils import alias as jalias
from annembed_tpu_torch.interop import kgraph_from_numpy, nodeparams_from_numpy
from annembed_tpu_torch.optim import ce as tce
from annembed_tpu_torch.optim.embedder import hubness_sampling_weights as t_hub
from annembed_tpu_torch.params import EmbedderParams as TEP
from annembed_tpu_torch.utils import alias as talias
from annembed_tpu_torch.utils import native as tnative

NB_NEG = tce.NB_NEGATIVE


def _t(a):
    return torch.from_numpy(np.array(a))


# --- alias tables ----------------------------------------------------------

def _weights(kind, rng):
    if kind == "uniform":
        return np.ones(500, np.float32)
    if kind == "with_zeros":
        w = rng.exponential(size=800).astype(np.float32)
        w[rng.random(800) < 0.3] = 0.0
        return w
    if kind == "heavy_tail":
        return (rng.pareto(1.5, size=3000) + 1e-3).astype(np.float32)
    return rng.random(2000).astype(np.float32)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["random", "uniform", "with_zeros",
                                  "heavy_tail"])
def test_alias_tables_bit_equal_and_exact(kind, backend, rng, monkeypatch):
    w = _weights(kind, rng)
    jp, ja_ = jalias.build_alias_table(w)
    if backend == "numpy":
        monkeypatch.setattr(talias, "_native_alias", lambda w: None)
    tp, tal = talias.build_alias_table(torch.from_numpy(w))
    assert tnative.BACKENDS["alias"] == backend
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tal.numpy(), np.asarray(ja_))
    # each bucket keeps prob of itself and gives 1 - prob to its alias:
    # the table reconstructs the normalized weights
    prob, al = tp.numpy().astype(np.float64), tal.numpy()
    n = len(w)
    rec = prob.copy()
    np.add.at(rec, al, 1.0 - prob)
    np.testing.assert_allclose(rec / n, w / w.astype(np.float64).sum(),
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_alias_zero_weights_raise(backend, monkeypatch):
    if backend == "numpy":
        monkeypatch.setattr(talias, "_native_alias", lambda w: None)
    with pytest.raises(ValueError):
        talias.build_alias_table(torch.zeros(10))


def test_alias_sample_with_injected_draws(rng):
    w = _weights("random", rng)
    jp, jal = jalias.build_alias_table(w)
    key = jax.random.PRNGKey(3)
    want = jalias.alias_sample(key, jp, jal, (4000,))
    k1, k2 = jax.random.split(key)
    ids = jax.random.randint(k1, (4000,), 0, len(w), dtype=jnp.int32)
    u = jax.random.uniform(k2, (4000,))
    tp, tal = talias.build_alias_table(torch.from_numpy(w))
    got = talias.alias_sample(tp, tal, _t(ids), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- edge set, CE, one step ------------------------------------------------

def _setup(rng, n_per=60, k=6, hub=False):
    centers = rng.normal(size=(3, 10)) * 10.0
    x = np.concatenate([c + rng.normal(size=(n_per, 10)) for c in centers])
    idx, dist = j_knn(x.astype(np.float32), k=k)
    jg = JKGraph(indices=idx, dists=dist)
    jn = j_proba(jg, scale_rho=0.75)
    tg = kgraph_from_numpy(idx, dist)
    tn = nodeparams_from_numpy(jn.scale, jn.probas)
    jes = jce.build_edge_set(jg, jn, j_hub(jg) if hub else None)
    tes = tce.build_edge_set(tg, tn, t_hub(tg) if hub else None)
    y0 = rng.uniform(-3, 3, (3 * n_per, 2)).astype(np.float32)
    return jes, tes, y0


@pytest.mark.parametrize("hub", [False, True], ids=["uniform_neg", "hub_neg"])
def test_build_edge_set_fields_equal(hub, rng):
    jes, tes, _ = _setup(rng, hub=hub)
    for name in ("src", "dst", "weight", "neighbors", "embedded_scale",
                 "edge_prob", "edge_alias", "neg_prob", "neg_alias"):
        j, t = getattr(jes, name), getattr(tes, name)
        if j is None:
            assert t is None, name
            continue
        if name == "embedded_scale":
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    assert (tes.nb_edges, tes.nb_nodes) == (jes.nb_edges, jes.nb_nodes)


def test_ce_value(rng):
    jes, tes, y0 = _setup(rng)
    want = float(jce.ce_value(jnp.asarray(y0), jes))
    got = float(tce.ce_value(torch.from_numpy(y0), tes))
    assert abs(got - want) <= 1e-5 * abs(want)


def jax_step_draws(keys, batch_size, nb_edges, nb_nodes, hub):
    """The draws of JAX's ``minibatch_update`` for each key of ``keys``
    (vmapped; JAX's random functions are elementwise in the key)."""
    def one(k):
        k_edge, k_neg = jax.random.split(k)
        k1, k2 = jax.random.split(k_edge)
        out = dict(edge_ids=jax.random.randint(k1, (batch_size,), 0, nb_edges,
                                               dtype=jnp.int32),
                   edge_u=jax.random.uniform(k2, (batch_size,)))
        shape = (batch_size, NB_NEG)
        if hub:
            n1, n2 = jax.random.split(k_neg)
            out["neg_ids"] = jax.random.randint(n1, shape, 0, nb_nodes,
                                                dtype=jnp.int32)
            out["neg_u"] = jax.random.uniform(n2, shape)
        else:
            out["neg_ids"] = jax.random.randint(k_neg, shape, 0, nb_nodes,
                                                dtype=jnp.int32)
        return out
    d = {k: np.array(v) for k, v in jax.vmap(one)(keys).items()}
    return [tce.StepDraws(**{k: torch.from_numpy(v[s]) for k, v in d.items()})
            for s in range(keys.shape[0])]


@pytest.mark.parametrize("hub", [False, True], ids=["uniform_neg", "hub_neg"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_minibatch_update_with_injected_draws(mode, hub, rng):
    jes, tes, y0 = _setup(rng, hub=hub)
    key = jax.random.PRNGKey(11)
    batch = 256
    want = jce.minibatch_update(jnp.asarray(y0), key, jes, jnp.float32(1.3),
                                1.0, batch, collision_mode=mode)
    draws = jax_step_draws(key[None], batch, jes.nb_edges, jes.nb_nodes, hub)
    got = tce.minibatch_update(torch.from_numpy(y0), draws[0], tes, 1.3, 1.0,
                               collision_mode=mode)
    want = np.asarray(want)
    assert np.abs(want - y0).max() > 1e-3      # the step moved points
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("hub", [False, True], ids=["uniform_neg", "hub_neg"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_run_entropy_optimization_three_batches(mode, hub, rng):
    """Three batches at grad_step 0.02: the third runs at gamma 0 and is
    skipped, so 2 * steps_per_batch steps take the JAX draws in order."""
    jes, tes, y0 = _setup(rng, hub=hub)
    kw = dict(nb_grad_batch=3, grad_step=0.02, seed=5, collision_mode=mode)
    yj, ij = jce.run_entropy_optimization(jnp.asarray(y0), jes, JEP(**kw))
    spb = ij["steps_per_batch"]
    keys = jax.random.split(jax.random.PRNGKey(5), 2 * spb)
    draws = jax_step_draws(keys, ij["batch_size"], jes.nb_edges, jes.nb_nodes,
                           hub)
    seen = []

    def injected(step):
        seen.append(step)
        return draws[step]
    yt, it = tce.run_entropy_optimization(torch.from_numpy(y0), tes,
                                          TEP(**kw), draws=injected)
    assert seen == list(range(2 * spb))
    assert (it["batch_size"], it["steps_per_batch"]) == (ij["batch_size"], spb)
    assert set(it) == set(ij)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
    for name in ("initial_ce", "final_ce"):
        assert abs(float(it[name]) - float(ij[name])) \
            <= 1e-5 * abs(float(ij[name])), name


@pytest.mark.parametrize("n,e,params", [
    (210, 1260, dict()), (70_000, 420_000, dict()),
    (70_000, 420_000, dict(collision_mode="mean")),
    (1000, 200, dict(batch_size=128))])
def test_batch_size_and_steps_match(n, e, params):
    """bench.py's operating point: n 70,000, E 420,000 -> batch 10,000
    (the n // 7 collision cap) and 420 steps a batch."""
    got = tce.sampling_batch_size(TEP(**params), e, n)
    if params.get("collision_mode") == "mean":
        want = min(16384, max(256, e))
    else:
        want = min(params.get("batch_size", 16384), max(256, n // 7),
                   max(256, e))
    assert got == want
    if (n, e, params) == (70_000, 420_000, {}):
        assert got == 10_000 and -(-10 * e // got) == 420


# --- the whole optimizer through embed -------------------------------------

def _blobs(n_per=334):
    rng = np.random.default_rng(4664397)
    centers = rng.normal(size=(3, 10)) * 10.0
    x = np.concatenate([c + rng.normal(size=(n_per, 10)) for c in centers])
    return x.astype(np.float32)[:1000]


def test_embed_sampling_matches_jax_statistically():
    x = _blobs()
    kw = dict(dim=2, nbng=6, batch=5, seed=0)
    yj, ij = ja.embed(x, params=JEP(optimizer="sampling"), **kw)
    yt, it = ta.embed(x, params=TEP(optimizer="sampling"), device="cpu", **kw)
    assert yt.shape == np.asarray(yj).shape == (1000, 2)
    assert np.isfinite(yt).all()
    assert set(it) == set(ij) | {"spans", "counters"}
    assert (it["batch_size"], it["steps_per_batch"]) == \
        (ij["batch_size"], ij["steps_per_batch"])
    assert it["final_ce"] < it["initial_ce"]
    rel = abs(it["final_ce"] - ij["final_ce"]) / abs(ij["final_ce"])
    assert rel <= 0.10, f"final_ce {it['final_ce']} vs {ij['final_ce']}"


def test_hierarchical_embed_runs_the_sampling_optimizer():
    """Both steps of ``h_embed`` take the sampling optimizer.  The large
    step's CE is not held to fall: at the hierarchical operating point
    it can rise in both packages (PERF.md); the clusters are held."""
    x = _blobs()
    y, info = ta.embed(x, dim=2, nbng=6, batch=4, layer=1,
                       hierarchy_fraction=0.2, device="cpu",
                       params=TEP(optimizer="sampling", grad_factor=2))
    assert y.shape == (1000, 2) and np.isfinite(y).all()
    for step in (info, info["first_step"]):
        assert {"batch_size", "steps_per_batch"} <= set(step)
        assert np.isfinite(step["final_ce"])
    first = info["first_step"]
    assert first["final_ce"] < first["initial_ce"]
    labels = np.repeat(np.arange(3), 334)[:1000]
    mus = np.stack([y[labels == i].mean(0) for i in range(3)])
    nearest = np.linalg.norm(y[:, None] - mus[None], axis=-1).argmin(1)
    assert (nearest == labels).mean() >= 0.85
