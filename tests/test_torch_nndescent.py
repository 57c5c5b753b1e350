"""The port's NN-descent refinement against annembed_tpu's on the same
graph, with the JAX package's per-round uniforms injected
(``PRNGKey(seed + 1013)``, split once a round).

The reverse table, the union table and its sampled subset are integer
tables and must be equal.  A refined graph is compared as chip_smoke
compares graphs: distances to 1e-5 relative where the ids agree, ids
equal on the columns whose distance is further than 1e-5 (relative)
from both row neighbours' distances (candidates are scored by the exact
pair form, so all such columns must agree).

The round kernel (``ops/nndescent.py``, ``csrc/nndescent.cu``): its
route rule, the ``knn.nndescent.pairs`` and route counters, and its
source built as host C++ (``tools/nndescent_host_check.py``) held to the
torch round, bit for bit on integer rows, and through a whole refine to
the JAX package; the JAX refine that ``tests/test_torch_nndescent_card.py``
holds the kernel to on the card (that file imports no JAX), recorded
here and held to the JAX package."""

import shutil

import jax
import numpy as np
import pytest
import torch

from annembed_tpu.knn import nndescent as jnd
from annembed_tpu.knn.brute import knn_graph_brute as j_brute
from annembed_tpu.knn.ivf import knn_graph_ivf as j_ivf
from annembed_tpu_torch.knn import nndescent as tnd
from annembed_tpu_torch.knn.api import recall_at_k
from annembed_tpu_torch.ops import nndescent as ndops
from annembed_tpu_torch.utils.profiling import count, counters
from tools import nndescent_host_check as nnd_host

import test_torch_nndescent_card as card

D_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


_clear_ties = nnd_host._clear_ties


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


# --- the round's routes, its counters and its kernel ------------------------

@pytest.mark.parametrize("args,want", [
    # the Higgs cell's rounds (k 12, rho 0.5: s 12, u 24) on both graphs
    (("cuda", "DistL2", "bfloat16", 12, 168, 28), "kernel"),
    (("cuda", "DistL2", "float32", 12, 168, 28), "kernel"),
    # the edges of the kernel's limits
    (("cuda", "DistL2", "float32", 32, 512, 256), "kernel"),
    (("cuda", "DistL2", "float32", 33, 168, 28), "torch"),
    (("cuda", "DistL2", "float32", 12, 513, 28), "torch"),
    (("cuda", "DistL2", "float32", 12, 168, 257), "torch"),
    # the default knobs at nbng 10 (k 20, rho 1: C = 40^2 + 40)
    (("cuda", "DistL2", "float32", 20, 1640, 28), "torch"),
    (("cpu", "DistL2", "bfloat16", 12, 168, 28), "torch"),
    (("cuda", "DistCosine", "float32", 12, 168, 28), "torch"),
    (("cuda", "DistL1", "bfloat16", 12, 168, 28), "torch"),
    (("cuda", "DistJeffreys", "float32", 12, 168, 28), "torch"),
    (("cuda", "DistJensenShannon", "float32", 12, 168, 28), "torch"),
    (("cuda", "DistL2", "float16", 12, 168, 28), "torch")])
def test_round_route(args, want):
    assert ndops.round_route(*args) == want


def _direct_pairs(idx, inner_pp, union_pp):
    """The candidates one round scores, counted row by row in numpy:
    ids below n, not the row, not a repeat, not in its list."""
    idx, inner, union = (np.asarray(t) for t in (idx, inner_pp, union_pp))
    n = idx.shape[0]
    total = 0
    for i in range(n):
        cand = np.concatenate([inner[inner[i]].ravel(), union[i]])
        cand = np.unique(cand)
        total += int(((cand < n) & (cand != i)
                      & ~np.isin(cand, idx[i])).sum())
    return total


@pytest.mark.parametrize("rho", [0.5, 1.0])
def test_pairs_counter_counts_the_scored_candidates(rng, rho):
    """``knn.nndescent.pairs`` counts the twin's finite candidates, the
    same for one slab and for many."""
    x, idx, dist = _graph(rng, n=700)
    n, k = idx.shape
    un = _t(rng.random((n + 1, 2 * k)).astype(np.float32))
    union_pp = tnd._union_pp(_t(idx), k, _t(dist))
    inner_pp = union_pp
    s = 2 * k if rho >= 1.0 else max(2, int(round(rho * 2 * k)))
    if s < 2 * k:
        inner_pp = tnd._sample_union_pp(un, union_pp, s)
    want = _direct_pairs(idx, inner_pp, union_pp)
    got = []
    for slab_bytes in (tnd.PANEL_BYTES, 200_000):
        before = counters().get(tnd.PAIRS, 0)
        tnd.nndescent_refine(_t(x), _t(idx), _t(dist), n_rounds=1, rho=rho,
                             uniforms=[un], slab_bytes=slab_bytes)
        got.append(counters()[tnd.PAIRS] - before)
    assert got == [want, want] and want > 0


def test_torch_route_counts_each_round(rng):
    x, idx, dist = _graph(rng, n=400)
    ndops.reset_launch_counts()
    tnd.nndescent_refine(_t(x), _t(idx), _t(dist), n_rounds=3, rho=0.5,
                         dtype="bfloat16")
    assert ndops.launch_counts() == {"kernel": 0, "torch": 3}


@pytest.fixture(scope="module")
def host_round(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    return nnd_host.load(tmp_path_factory.mktemp("nndescent_host"))


@pytest.fixture(scope="module")
def round_cases():
    return {name: (inp, exact) for name, inp, exact in nnd_host.cases()}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", nnd_host.CASE_NAMES)
def test_host_kernel_matches_twin(host_round, round_cases, one_thread, name):
    """The kernel's source built for the host against the torch round:
    bit for bit on the integer rows (ties, rows short of k finite
    entries, repeats in the lists), else ids off near-ties and
    distances; the scored count equal."""
    inp, exact = round_cases[name]
    ok, detail = nnd_host.run_case(host_round, inp, exact)
    assert ok, detail


def test_host_kernel_mesh_ranks_sum_to_the_round(host_round, round_cases,
                                                 one_thread):
    inp, _ = round_cases["ints_k12_rho05_bf16_d28"]
    for size in (2, 3):
        ok, detail = nnd_host.run_mesh(host_round, inp, size)
        assert ok, detail


def test_agreement_excuses_ties_and_catches_swapped_pairs(round_cases):
    """``nnd_host.agreement``: tied entries swapped whole pass; an id
    changed with its distance kept fails at a near-tie of the last
    column (its distance is not its own) and at a clear column."""
    inp, _ = round_cases["ints_k12_rho05_bf16_d28"]
    wi, wd = ndops.nndescent_round_reference(**inp)

    def agree(gi, gd):
        out = nnd_host.agreement(gi, gd, wi, wd, inp["x_pad"])
        return out["id_mismatch"], out["own_mismatch"], out["dist_mismatch"]

    assert agree(wi, wd) == (0, 0, 0)
    tie = ((wd[:, 1:] == wd[:, :-1]) & (wi[:, 1:] != wi[:, :-1])
           & torch.isfinite(wd[:, 1:])).nonzero()[0]
    r, c = int(tie[0]), int(tie[1])
    gi = wi.clone()
    gi[r, [c, c + 1]] = wi[r, [c + 1, c]]
    assert agree(gi, wd) == (0, 0, 0)
    n, k = wi.shape
    row = int(torch.isfinite(wd[:, -1]).nonzero()[0])
    stranger = next(j for j in range(n) if j != row
                    and j not in wi[row].tolist()
                    and float(torch.dist(inp["x_pad"][row].float(),
                                         inp["x_pad"][j].float()))
                    != float(wd[row, -1]))
    gi = wi.clone()
    gi[row, -1] = stranger
    assert agree(gi, wd)[1] == 1
    clear = torch.from_numpy(nnd_host._clear_ties(wd.numpy()))
    r, c = (int(v) for v in (clear[:, :-1]).nonzero()[0])
    gi = wi.clone()
    gi[r, c] = (wi[r, c] + 1) % n
    assert agree(gi, wd)[0] == 1


def test_cases_cover_the_edges(round_cases):
    """Ties inside a row's output, rows short of k finite entries and
    repeated list entries all occur among the exact cases."""
    inf_rows = tie_rows = repeat_rows = 0
    for inp, exact in round_cases.values():
        if not exact:
            continue
        _, wd = ndops.nndescent_round_reference(**inp)
        ci = inp["indices"]
        inf_rows += int(torch.isinf(wd).any(1).sum())
        tie_rows += int(((wd.diff(dim=1) == 0)
                         & torch.isfinite(wd[:, 1:])).any(1).sum())
        repeat_rows += int(((ci[:, :, None] == ci[:, None, :]).sum((1, 2))
                            > ci.shape[1]).sum())
    assert inf_rows and tie_rows and repeat_rows


def test_refine_through_the_kernel_route(host_round, one_thread, rng,
                                         monkeypatch):
    """A whole refine at the Higgs cell's shape (k 12, rho 0.5, bf16, d
    28) with every round sent to the host-built kernel: the same graph
    as the torch route and as the JAX package (ids off near-ties,
    distances; the JAX draws injected), the same scored count, one
    kernel count a round."""
    x, idx, dist = _graph(rng, n=400, d=28, k=12)
    n, k = idx.shape
    kw = dict(n_rounds=2, rho=0.5, dtype="bfloat16", seed=2)
    ji, jd = jnd.nndescent_refine(x, jax.numpy.asarray(idx),
                                  jax.numpy.asarray(dist), **kw)
    kw["uniforms"] = _jax_uniforms(2, 2, (n + 1, 2 * k))
    before = counters().get(tnd.PAIRS, 0)
    wi, wd = tnd.nndescent_refine(_t(x), _t(idx), _t(dist), **kw)
    want_pairs = counters()[tnd.PAIRS] - before

    def kernel_round(x_pad, inner_pp, union_pp, indices, dists, slab,
                     distance, rank, size, pairs):
        assert ndops.round_route("cuda", distance, "bfloat16",
                                 indices.shape[1], inner_pp.shape[1] ** 2
                                 + union_pp.shape[1],
                                 x_pad.shape[1]) == "kernel"
        count(ndops.PREFIX + "kernel")
        return host_round(x_pad=x_pad, inner_pp=inner_pp, union_pp=union_pp,
                          indices=indices, dists=dists, slab=slab, rank=rank,
                          size=size, pairs=pairs)

    monkeypatch.setattr(tnd, "nndescent_round", kernel_round)
    ndops.reset_launch_counts()
    before = counters()[tnd.PAIRS]
    gi, gd = tnd.nndescent_refine(_t(x), _t(idx), _t(dist), **kw)
    assert counters()[tnd.PAIRS] - before == want_pairs
    assert ndops.launch_counts() == {"kernel": 2, "torch": 0}
    assert_graphs_agree(gi, gd, wi, wd)
    assert_graphs_agree(gi, gd, ji, jd)


def test_kernel_branch_checks_its_inputs(host_round, round_cases):
    inp, _ = round_cases["ints_k12_rho05_bf16_d28"]
    with pytest.raises(ValueError, match="contiguous"):
        host_round(**dict(inp, indices=inp["indices"].t().contiguous().t()))
    with pytest.raises(TypeError, match="int32"):
        host_round(**dict(inp, union_pp=inp["union_pp"].long()))
    with pytest.raises(ValueError, match="rank"):
        host_round(**inp, rank=2, size=2)
    wide = torch.zeros((inp["x_pad"].shape[0], ndops.MAX_D + 1),
                       dtype=inp["x_pad"].dtype)
    with pytest.raises(ValueError, match="above the round kernel"):
        host_round(**dict(inp, x_pad=wide))
    # a contiguous view two bytes off the bf16 rows' 8-byte boundary
    x_pad = inp["x_pad"]
    shifted = x_pad.new_zeros(x_pad.numel() + 1)[1:].view(x_pad.shape)
    shifted.copy_(x_pad)
    with pytest.raises(ValueError, match="boundary"):
        host_round(**dict(inp, x_pad=shifted))


# --- the recorded JAX refine the card's tests hold the kernel to ----------

def _card_fixture():
    """The JAX package's refine at the Higgs cell's shape (k 12, rho 0.5,
    bf16 scoring, d 28) with its inputs and per-round uniforms, as
    ``tests/test_torch_nndescent_card.py`` reads it (that file runs on
    the card without JAX).  Rewrite it with
    ``np.savez_compressed(card.FIXTURE, **_card_fixture())``."""
    x, idx, dist = _graph(np.random.default_rng(card.FIXTURE_SEED),
                          n=card.FIXTURE_ROWS, d=28, k=12)
    n, k = idx.shape
    ji, jd = jnd.nndescent_refine(x, jax.numpy.asarray(idx),
                                  jax.numpy.asarray(dist), **card.KNOBS)
    uni = _jax_uniforms(card.KNOBS["seed"], card.KNOBS["n_rounds"],
                        (n + 1, 2 * k))
    return dict(x=x, indices=idx, dists=dist,
                uniforms=np.stack([u.numpy() for u in uni]),
                jax_indices=np.asarray(ji), jax_dists=np.asarray(jd))


def test_card_fixture_is_the_jax_refine():
    """The recorded inputs and draws are what ``_card_fixture`` makes,
    its graph what the JAX package computes from them, and the torch
    route's refine on them agrees with it."""
    rec = np.load(card.FIXTURE)
    now = _card_fixture()
    for key in ("x", "indices", "dists", "uniforms"):
        np.testing.assert_array_equal(rec[key], now[key])
    assert_graphs_agree(_t(rec["jax_indices"]), _t(rec["jax_dists"]),
                        now["jax_indices"], now["jax_dists"])
    ti, td = tnd.nndescent_refine(
        _t(rec["x"]), _t(rec["indices"]), _t(rec["dists"]),
        uniforms=[_t(u) for u in rec["uniforms"]], **card.KNOBS)
    assert_graphs_agree(ti, td, rec["jax_indices"], rec["jax_dists"])
