"""Parity of the port's dense-optimizer knobs with the JAX package.

* ``_segments`` against the segment list the JAX ``dense_optimize``
  hands to ``_dense_segment`` (recorded, exact), at the Higgs sizes
  where the program cap places the stale-gather blocks;
* the row-major sweeps and the stacked kicks, one sweep each (atol
  1e-5);
* whole ``run_dense_optimization`` runs of 120 nodes x 3 batches with
  each knob, the JAX relabel permutation and per-segment offsets
  injected (grad_step 0.02, atol 1e-3: f32 sums in another order over
  120 sweeps; see tests/test_torch_dense.py for why the step is small);
* ``dense_packed_gather`` gives the output of the plain gather, bit for
  bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.graph.proba import to_proba_edges as j_proba
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.optim import dense as jd
from annembed_tpu.optim.embedder import hubness_sampling_weights as j_hub
from annembed_tpu.params import EmbedderParams as JEP
from annembed_tpu_torch.interop import kgraph_from_numpy, nodeparams_from_numpy
from annembed_tpu_torch.optim import dense as td
from annembed_tpu_torch.optim.embedder import hubness_sampling_weights as t_hub
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


def _jax_segments(monkeypatch, n, n_groups, n_blocks, n_sub, nb_grad_batch,
                  batch0, batch1, gather_reuse, after):
    """The (step0, steps, S) of every ``_dense_segment`` call the JAX
    ``dense_optimize`` makes (the segment bodies are not run)."""
    seen = []

    def record(y, *args, step0, seg_steps, gather_reuse, **kw):
        seen.append((int(step0), seg_steps, gather_reuse))
        return y

    monkeypatch.setattr(jd, "_dense_segment", record)
    jd.dense_optimize(np.empty((n, 2), np.float32), None, None, None, None,
                      None, None, jax.random.PRNGKey(0), None,
                      grad_step_init=1.0, b=1.0, n_sub=n_sub, n_neg=1,
                      nb_grad_batch=nb_grad_batch, n_groups=n_groups,
                      batch0=batch0, batch1=batch1, n_blocks=n_blocks,
                      gather_reuse=gather_reuse, gather_reuse_after=after)
    return seen


@pytest.mark.parametrize("n,n_blocks,n_sub,nb,batch0,batch1,S,after", [
    (11_000_000, 1, 60, 40, 0, 40, 12, 0.0),    # cap 13 -> blocks of 12
    (11_000_000, 1, 60, 40, 0, 40, 8, 0.25),    # fresh range, then S = 8
    (440_000, 1, 60, 200, 0, 200, 12, 0.5),     # the first step's size
    (440_000, 1, 120, 60, 40, 60, 12, 0.5),     # a later schedule phase
    (70_000, 1, 120, 40, 0, 40, 1, 0.0),        # several fresh segments
    (2_000_000, 4, 120, 10, 0, 10, 1, 0.0),     # node blocks widen the cap
    (120, 1, 60, 3, 0, 3, 7, 0.5),              # S-aligned, a remainder
])
def test_segments_match_jax(monkeypatch, n, n_blocks, n_sub, nb, batch0,
                            batch1, S, after):
    want = _jax_segments(monkeypatch, n, 2, n_blocks, n_sub, nb, batch0,
                         batch1, S, after)
    total = (min(batch1, nb - 1) - batch0) * n_sub
    got = td._segments(total, n, 2, n_blocks, n_sub, nb, batch0, S, after)
    assert got == want
    assert sum(steps for _, steps, _ in got) == total


def _row_inputs(rng, hub=False):
    jg, jn, *_ , y0 = _setup(rng)
    (y0_r, idx_r, w, m_visit, w_rev, m_rev, emb_scale, neg_w, n_neg, _,
     _) = jd.prepare_dense_inputs(y0, jg, jn, JEP(), n_sub=60, n_groups=2,
                                  neg_weights=j_hub(jg) if hub else None)
    sl = slice(0, 3)
    a = dict(y=np.array(y0_r), indices=np.array(idx_r)[:, sl],
             w=np.array(w)[:, sl], m_e=np.array(m_visit)[:, sl],
             w_rev=np.array(w_rev)[:, sl], m_rev=np.array(m_rev)[:, sl],
             emb_scale=np.array(emb_scale))
    return a, np.array(idx_r), (None if neg_w is None
                                else np.array(neg_w)), n_neg


def _both(a):
    return ([jnp.asarray(v) for v in a.values()],
            [torch.from_numpy(np.array(v)) for v in a.values()])


@pytest.mark.parametrize("gamma", [1.0, 0.35])
def test_row_major_attraction_matches_jax(rng, gamma):
    a, *_ = _row_inputs(rng)
    ja_, ta_ = _both(a)
    js, jr = jd._attraction_sweep(*ja_, jnp.float32(gamma), 1.0)
    ts, tr = td._attraction_sweep(*ta_, gamma, 1.0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               err_msg="delta_self, atol 1e-5")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               err_msg="delta_rev, atol 1e-5")
    j = jd._attraction_sweep_scatter_free(*ja_, jnp.float32(gamma), 1.0)
    t = td._attraction_sweep_scatter_free(*ta_, gamma, 1.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="scatter-free row-major, atol 1e-5")


@pytest.mark.parametrize("offset,hub", [(0, False), (29, True)])
def test_row_major_repulsion_matches_jax(rng, offset, hub):
    a, idx, neg_w, n_neg = _row_inputs(rng, hub)
    y, scale = a["y"], a["emb_scale"]
    j = jd._repulsion_sweep_rolled(
        jnp.asarray(y), jnp.int32(offset), jnp.asarray(idx),
        jnp.asarray(scale), jnp.float32(0.8), 1.0, n_neg,
        neg_weight=None if neg_w is None else jnp.asarray(neg_w))
    t = td._repulsion_sweep_rolled(
        torch.from_numpy(y), offset, torch.from_numpy(idx),
        torch.from_numpy(scale), 0.8, 1.0, n_neg,
        neg_weight=None if neg_w is None else torch.from_numpy(neg_w))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="rolled row-major kicks, atol 1e-5")
    perm = rng.permutation(y.shape[0]).astype(np.int32)
    j = jd._repulsion_sweep(jnp.asarray(y), jnp.asarray(y[perm]), offset,
                            jnp.asarray(idx), jnp.asarray(scale),
                            jnp.float32(0.8), 1.0, jnp.asarray(perm), n_neg)
    t = td._repulsion_sweep(torch.from_numpy(y), torch.from_numpy(y[perm]),
                            offset, torch.from_numpy(idx),
                            torch.from_numpy(scale), 0.8, 1.0,
                            torch.from_numpy(perm), n_neg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="summed pool kicks, atol 1e-5")


@pytest.mark.parametrize("lo,hub", [(0, False), (37, True)])
def test_parallel_kicks_block_matches_jax(rng, lo, hub):
    """The stacked kicks of one node block [lo, lo + 50)."""
    a, idx, neg_w, n_neg = _row_inputs(rng, hub)
    yT = a["y"].T.copy()
    n, nb = yT.shape[1], 50
    ext = np.concatenate([yT, yT[:, :nb]], axis=1)
    nw_ext = None if neg_w is None else np.concatenate([neg_w, neg_w[:nb]])
    blk = yT[:, lo:lo + nb].copy()
    idxT = idx[lo:lo + nb].T.copy()
    sc = a["emb_scale"][None, lo:lo + nb].copy()
    j = jd._repulsion_block_T(
        jnp.asarray(ext), jnp.asarray(blk), lo, n, jnp.int32(11),
        jnp.asarray(idxT), jnp.asarray(sc), jnp.float32(0.8), 1.0, n_neg,
        neg_weight_ext=None if nw_ext is None else jnp.asarray(nw_ext),
        parallel_kicks=True)
    t = td._repulsion_block_T(
        torch.from_numpy(ext), torch.from_numpy(blk), lo, n, 11,
        torch.from_numpy(idxT), torch.from_numpy(sc), 0.8, 1.0, n_neg,
        neg_weight_ext=None if nw_ext is None else torch.from_numpy(nw_ext),
        parallel_kicks=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               err_msg="stacked kicks, atol 1e-5")


def _jax_draws(seed, n, segments, n_blocks):
    """The relabel permutation and per-sweep offsets the JAX optimizer draws
    for a one-phase run over ``segments``: one key a segment, one a step
    within it (the node-block branch takes its offset from the second
    half of the step key)."""
    key, k_relabel = jax.random.split(jax.random.PRNGKey(seed))
    relabel = np.asarray(jax.random.permutation(k_relabel, n))
    offsets = []
    for seg_key, (_, steps, _) in zip(jax.random.split(key, len(segments)),
                                      segments):
        keys = jax.random.split(seg_key, steps)
        if n_blocks > 1:
            keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        offsets += np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, n))(keys)).tolist()
    return relabel, offsets


KNOBS = [
    dict(dense_n_blocks=2),
    dict(dense_scatter_free=False),
    dict(dense_parallel_kicks=True),
    dict(dense_gather_reuse=4),
    # two segments: 60 fresh sweeps, then S = 7 blocks with a remainder
    dict(dense_gather_reuse=7, dense_gather_reuse_after=0.5),
]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(
    f"{a[6:]}={b}" for a, b in k.items()))
@pytest.mark.parametrize("hub", [False, True])
def test_run_dense_optimization_knob_matches_jax(rng, knobs, hub):
    jg, jn, tg, tn, y0 = _setup(rng)
    n, k, n_sub, nb = 120, 6, 60, 3
    jp = JEP(nb_grad_batch=nb, seed=5, grad_step=0.02, **knobs)
    tp = TEP(nb_grad_batch=nb, seed=5, grad_step=0.02, **knobs)
    n_blocks = jp.dense_n_blocks
    segments = td._segments((nb - 1) * n_sub, n, jd._auto_groups(k),
                            n_blocks, n_sub, nb, 0, jp.dense_gather_reuse,
                            jp.dense_gather_reuse_after)
    if "dense_gather_reuse_after" in knobs:
        assert [s for _, _, s in segments] == [1, 7]
    relabel, offsets = _jax_draws(5, n, segments, n_blocks)
    yj, ij = jd.run_dense_optimization(jnp.asarray(y0), jg, jn, jp,
                                       n_sub=n_sub,
                                       neg_weights=j_hub(jg) if hub else None)
    yt, it = td.run_dense_optimization(
        torch.from_numpy(y0), tg, tn, tp, n_sub=n_sub,
        neg_weights=t_hub(tg) if hub else None, relabel=relabel,
        offsets=offsets)
    assert it == ij
    assert np.abs(np.asarray(yj) - y0).max() > 0.3, "the run must move y"
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-3,
                               err_msg="120-sweep run, atol 1e-3")


def test_packed_gather_equals_the_plain_gather(rng):
    *_, tg, tn, y0 = _setup(rng)
    p = TEP(nb_grad_batch=3, seed=5)
    plain, _ = td.run_dense_optimization(torch.from_numpy(y0), tg, tn, p)
    packed, info = td.run_dense_optimization(
        torch.from_numpy(y0), tg, tn,
        dataclasses.replace(p, dense_packed_gather=True))
    assert torch.equal(packed, plain)
    assert "packed_gather" not in info
