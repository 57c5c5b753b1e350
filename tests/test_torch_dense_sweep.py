"""The dense sweep's kernels (ops/dense_sweep.py): the plain twins of the
per-sweep pair against the JAX package's ``_attraction_sweep_sfT`` and
``_repulsion_block_T`` on the same inputs (atol 1e-5, as
tests/test_torch_dense.py), for the knobs that file does not cover; the
port's ``dense_optimize`` on the CPU bit-equal to the same sweeps
composed of optim/dense.py's per-sweep functions in the (d, n) layout,
as it ran them before the kernels, and to the persistent launch's twin
run over its runs; the packed edge records; the dispatch and the launch
plan; and, on a card, the CUDA kernels against the twins, two launches
bit-equal, the persistent launch bit-equal to the pair."""

import shutil

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from annembed_tpu.optim import dense as jd
from annembed_tpu_torch.ops import dense_sweep as ds
from annembed_tpu_torch.optim import dense as td
from annembed_tpu_torch.utils.profiling import counters

# chip_smoke.py's tolerances for the kernel against its twin, relative to
# max|y|: the attraction half, then the whole sweep (the kicks chain
# n_neg steps, each of which can scale a rounding difference by up to 3)
ATT_REL, SWEEP_REL = 1e-5, 1e-4


def _inputs(seed, n=300, k=6, kg=3, d=2, lo=0, rows=None, hub=True):
    """One sweep's inputs as numpy arrays in the kernel's layout: y
    (n, d), the rows' tables (kg, rows) and neighbour ids (k, rows)."""
    rng = np.random.default_rng(seed)
    rows = n - lo if rows is None else rows
    idx_full = np.stack([rng.choice(np.delete(np.arange(n), i), k,
                                    replace=False)
                         for i in range(lo, lo + rows)]).astype(np.int32).T
    w = rng.uniform(0.05, 1.0, (kg, rows)).astype(np.float32)
    w_rev = np.where(rng.uniform(size=(kg, rows)) < 0.5,
                     rng.uniform(0.05, 1.0, (kg, rows)), 0.0)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    idx = np.ascontiguousarray(idx_full[:kg])
    return dict(y=rng.normal(size=(n, d)).astype(np.float32),
                idx=idx, w=w, m=2.0 * w, w_rev=w_rev.astype(np.float32),
                m_rev=(2.0 * w_rev).astype(np.float32),
                scale_j=scale[idx], scale=scale,
                neg_weight=(rng.uniform(0.25, 4.0, n).astype(np.float32)
                            if hub else None),
                idx_full=np.ascontiguousarray(idx_full),
                y_src=(rng.normal(size=(n, d)) * 0.1).astype(np.float32),
                mask=(rng.uniform(size=(kg, rows)) < 0.7).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _edges(p, device="cpu"):
    """The rows' packed edge records of ``_inputs``' (kg, rows) tables."""
    return ds.pack_groups(*(_t(p[key]).T for key in ("idx", "w", "m",
                                                     "w_rev", "m_rev")),
                          _t(p["scale"]))[0].to(device)


CASES = {
    # a node block whose partner windows wrap past n
    "block_wrap": dict(lo=170, rows=111, offset=280),
    "parallel_kicks": dict(parallel=True, offset=41),
    "mask": dict(mask_p=0.7, offset=7),
    "b_1.5": dict(b=1.5, offset=150),
    "d_3": dict(d=3, offset=299),
    "stale": dict(stale=True, offset=123, lo=40, rows=200),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twins_match_jax(case):
    c = CASES[case]
    lo = c.get("lo", 0)
    p = _inputs(7, d=c.get("d", 2), lo=lo, rows=c.get("rows"))
    n, rows = p["y"].shape[0], p["idx"].shape[1]
    b, gamma, n_neg = c.get("b", 1.0), 0.9, 5
    mask_p = c.get("mask_p", 1.0)
    mask = p["mask"] if mask_p < 1.0 else None
    y_src = p["y"] + p["y_src"] if c.get("stale") else p["y"]
    tables = [p[key] for key in ("idx", "w", "m", "w_rev", "m_rev",
                                 "scale_j")]
    a = ds.dense_attraction_rows(
        _t(p["y"]), _t(y_src), lo, _edges(p), _t(p["scale"]), gamma, b,
        mask=_t(mask), mask_p=mask_p)
    own = p["y"][lo:lo + rows].T
    j = own + np.asarray(jd._attraction_sweep_sfT(
        jnp.asarray(p["y"].T), *map(jnp.asarray, tables[:5]),
        jnp.asarray(p["scale"][None, lo:lo + rows]),
        jnp.asarray(p["scale_j"]), jnp.float32(gamma), b,
        mask=None if mask is None else jnp.asarray(mask), mask_p=mask_p,
        y_ownT=jnp.asarray(own),
        yjT=jnp.asarray(y_src.T[:, p["idx"]])))
    np.testing.assert_allclose(a.numpy(), j.T, atol=1e-5,
                               err_msg=f"{case}: attraction, atol 1e-5")
    # the kicks of both from the JAX attraction's rows
    a_np = np.ascontiguousarray(j.T)
    got = ds.dense_kick_rows(
        _t(p["y"]), _t(a_np), lo, c["offset"], _t(p["idx_full"]),
        _t(p["scale"]), gamma, b, n_neg, neg_weight=_t(p["neg_weight"]),
        parallel_kicks=c.get("parallel", False))
    snap = p["y"].T.copy()
    snap[:, lo:lo + rows] = j
    ext = np.concatenate([snap, snap[:, :rows]], axis=1)
    nw = p["neg_weight"]
    want = jd._repulsion_block_T(
        jnp.asarray(ext), jnp.asarray(j), lo, n, jnp.int32(c["offset"]),
        jnp.asarray(p["idx_full"]),
        jnp.asarray(p["scale"][None, lo:lo + rows]), jnp.float32(gamma), b,
        n_neg, neg_weight_ext=jnp.asarray(np.concatenate([nw, nw[:rows]])),
        parallel_kicks=c.get("parallel", False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, atol=1e-5,
                               err_msg=f"{case}: kicks, atol 1e-5")


def _sweeps_before(y0, idx, w, m, w_rev, m_rev, scale, nw, offsets, gammas,
                   b, n_neg, n_groups, n_blocks=1, mask_p=1.0, gen=None,
                   reuse=1, exclusion=True, parallel=False):
    """The transposed sweeps composed of optim/dense.py's per-sweep
    functions in the (d, n) layout, as ``dense_optimize`` ran them before
    the kernel pair: whole-array sweeps formed as y + displacement, node
    blocks written in place, the stale gather one (d, k, n) gather per
    ``reuse`` sweeps (one segment)."""
    n, k = idx.shape
    kg = k // n_groups
    idx64 = idx.to(torch.int64)
    yT = y0.T.contiguous().clone()
    kick = dict(neighbor_exclusion=exclusion, parallel_kicks=parallel)
    bounds = td._block_bounds(n, n_blocks)
    yj_full = None
    for s, (offset, gamma) in enumerate(zip(offsets, gammas)):
        c, blk = divmod(s % (n_groups * n_blocks), n_blocks)
        lo, hi = bounds[blk]
        sl = slice(c * kg, (c + 1) * kg)
        tab = [t[lo:hi, sl].T.contiguous() for t in (idx64, w, m, w_rev,
                                                     m_rev)]
        mask = None
        if mask_p < 1.0:
            mask = (torch.rand((kg, hi - lo), generator=gen)
                    < mask_p).float()
        scale_j = scale[idx64[lo:hi, sl]].T.contiguous()
        if n_blocks == 1:
            if reuse > 1 and s % reuse == 0:
                yj_full = yT[:, idx64.T.contiguous()]
            yT = yT + td._attraction_sweep_sfT(
                yT, *tab, scale[None, :], scale_j, gamma, b, mask=mask,
                mask_p=mask_p,
                yjT=None if reuse == 1 else yj_full[:, sl])
            yT = yT + td._repulsion_sweep_rolledT(
                yT, offset, idx64.T.contiguous(), scale[None, :], gamma, b,
                n_neg, neg_weight=nw, **kick)
            continue
        y_blk = yT[:, lo:hi] + td._attraction_sweep_sfT(
            yT, *tab, scale[None, lo:hi], scale_j, gamma, b, mask=mask,
            mask_p=mask_p, y_ownT=yT[:, lo:hi])
        yT[:, lo:hi] = y_blk
        ext = torch.cat([yT, yT[:, :hi - lo]], dim=1)
        nw_ext = None if nw is None else torch.cat([nw, nw[:hi - lo]])
        yT[:, lo:hi] = td._repulsion_block_T(
            ext, y_blk, lo, n, offset, idx64[lo:hi].T.contiguous(),
            scale[None, lo:hi], gamma, b, n_neg, neg_weight_ext=nw_ext,
            **kick)
    return yT.T.contiguous()


KNOBS = {
    "default": dict(),
    "n_blocks": dict(n_blocks=3),
    "parallel_kicks": dict(parallel=True),
    "mask": dict(mask_p=0.6),
    "stale": dict(reuse=2),
    "no_exclusion": dict(exclusion=False, hub=False),
    "b_1.5": dict(b=1.5),
    "d_3": dict(d=3),
    "n_blocks_d_3": dict(n_blocks=3, d=3),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_dense_optimize_bit_equal_to_per_sweep_functions(knob):
    kw = dict(KNOBS[knob])
    hub, d, b = kw.pop("hub", True), kw.pop("d", 2), kw.pop("b", 1.0)
    p = _inputs(11, n=240, d=d, hub=hub)
    n = 240
    full = np.ascontiguousarray(p["idx_full"].T)              # (n, k)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.05, 1.0, full.shape).astype(np.float32)
    w_rev = td.reverse_edge_info(_t(full), _t(w))
    offsets = [17, 239, 101]
    args = (_t(p["y"]), _t(full), _t(w), _t(2 * w), w_rev, 2 * w_rev,
            _t(p["scale"]), _t(p["neg_weight"]))
    got = td.dense_optimize(
        *args, grad_step_init=2.0, b=b, n_sub=3, n_neg=5, nb_grad_batch=2,
        n_groups=2, mask_p=kw.get("mask_p", 1.0), batch0=0, batch1=1,
        n_blocks=kw.get("n_blocks", 1),
        neighbor_exclusion=kw.get("exclusion", True),
        parallel_kicks=kw.get("parallel", False),
        gather_reuse=kw.get("reuse", 1), offsets=offsets,
        generator=torch.Generator().manual_seed(5))
    gammas = [td._gamma(2.0, 1, 2)] * 3
    want = _sweeps_before(*args, offsets, gammas, b, 5, 2,
                          gen=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("kg", [1, 2, 3, 4, 5])
def test_pack_groups_round_trip(kg):
    p = _inputs(4, n=50, k=6, kg=kg)
    edges = _edges(p)
    rows, words = edges.shape
    assert (rows, words) == (50, ds.edge_words(kg))
    assert words % 4 == 0 and 6 * kg <= words < 6 * kg + 4
    assert torch.equal(edges[:, 6 * kg:], torch.zeros_like(edges[:, 6 * kg:]))
    for key, got in zip(ds.EDGE_FIELDS, ds.unpack_edges(edges)):
        assert got.is_contiguous() and torch.equal(got, _t(p[key])), key
    if 6 % kg == 0:
        # every column group of (rows, k) tables, each as its own pack
        full = [_t(p["idx_full"]).T] + [torch.rand(50, 6) for _ in range(4)]
        scale = _t(p["scale"])
        groups = ds.pack_groups(*full, scale, 6 // kg)
        for c in range(6 // kg):
            sl = slice(c * kg, (c + 1) * kg)
            assert torch.equal(groups[c], ds.pack_groups(
                *(t[:, sl] for t in full), scale)[0])


def _optimize_inputs(d=2, hub=True, n=240):
    p = _inputs(11, n=n, d=d, hub=hub)
    full = np.ascontiguousarray(p["idx_full"].T)              # (n, k)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.05, 1.0, full.shape).astype(np.float32)
    w_rev = td.reverse_edge_info(_t(full), _t(w))
    return p, (_t(p["y"]), _t(full), _t(w), _t(2 * w), w_rev, 2 * w_rev,
               _t(p["scale"]), _t(p["neg_weight"]))


# the knobs the persistent launch serves
PERSISTENT_KNOBS = {
    "default": dict(),
    "stale": dict(reuse=2),
    "parallel_kicks": dict(parallel=True),
    "no_exclusion": dict(exclusion=False, hub=False),
    "b_1.5": dict(b=1.5),
    "d_3": dict(d=3),
}


@pytest.mark.parametrize("knob", list(PERSISTENT_KNOBS))
def test_persistent_twin_bit_equal_to_dense_optimize(knob):
    """The persistent launch's twin, called on every run of sweeps with
    each sweep's gamma, pool offset and column group (two batches, so
    gamma changes inside a run; rotation from rot_base 1), against
    ``dense_optimize``."""
    kw = dict(PERSISTENT_KNOBS[knob])
    p, args = _optimize_inputs(d=kw.pop("d", 2), hub=kw.pop("hub", True))
    b, reuse = kw.pop("b", 1.0), kw.pop("reuse", 1)
    y0, full, w, m, w_rev, m_rev, scale, nw = args
    n, k = full.shape
    offsets = [17, 239, 101, 5, 400, 62]
    knobs = dict(neighbor_exclusion=kw.get("exclusion", True),
                 parallel_kicks=kw.get("parallel", False))
    got = td.dense_optimize(
        *args, grad_step_init=2.0, b=b, n_sub=3, n_neg=5, nb_grad_batch=4,
        n_groups=2, batch0=0, batch1=2, rot_base=1, gather_reuse=reuse,
        offsets=offsets, **knobs)
    sl = [slice(c * 3, (c + 1) * 3) for c in range(2)]
    edges = torch.stack([ds.pack_groups(full[:, s].int(), w[:, s], m[:, s],
                                        w_rev[:, s], m_rev[:, s], scale)[0]
                         for s in sl])
    gammas = torch.tensor([td._gamma(2.0, 1 + s // 3, 4) for s in range(6)],
                          dtype=torch.float32)
    assert gammas[0] != gammas[3]
    offs = torch.tensor([o % n for o in offsets], dtype=torch.int64)
    groups = torch.tensor([(1 + s) % 2 for s in range(6)], dtype=torch.int32)
    y = y0.clone()
    for first in range(0, 6, reuse):
        run = slice(first, first + reuse) if reuse > 1 else slice(0, 6)
        snap = y.clone() if reuse > 1 else None
        ds.dense_sweeps_reference(
            y, snap, edges, scale, gammas[run], offs[run], groups[run], b, 5,
            full.int().T.contiguous(), neg_weight=nw, **knobs)
        if reuse == 1:
            break
    assert torch.equal(got, y), float((got - y).abs().max())


def _plan_counts(plan, steps):
    """The launch counts a card shows for a plan: two launches a sweep on
    the pair, one a run on the persistent route."""
    persistent = plan["route"] == "persistent"
    return dict(pair=0 if persistent else 2 * steps,
                persistent=len(plan["runs"]) if persistent else 0,
                persistent_sweeps=steps if persistent else 0)


def test_launch_plan_routes():
    """Which knob takes the persistent launch and which the per-sweep
    pair, and the launch counts a card would show, from the routing
    function alone."""
    def plan(n=240, steps=6, **kw):
        args = dict(total_steps=steps, n=n, n_groups=2, n_blocks=1, n_sub=3,
                    nb_grad_batch=4, batch0=0, gather_reuse=1,
                    gather_reuse_after=0.0, mask_p=1.0)
        got = td.launch_plan(**dict(args, **kw))
        return dict(got, launches=_plan_counts(got, steps))

    def covers(runs, steps):
        ends = [first + count for first, count, _ in runs]
        return [first for first, _, _ in runs] == [0] + ends[:-1] and \
            ends[-1] == steps

    got = plan()
    assert got["route"] == "persistent" and got["runs"] == [(0, 6, False)]
    assert got["launches"] == dict(pair=0, persistent=1, persistent_sweeps=6)
    got = plan(gather_reuse=2)
    assert got["runs"] == [(0, 2, True), (2, 2, True), (4, 2, True)]
    assert got["launches"] == dict(pair=0, persistent=3, persistent_sweeps=6)
    # the stale gather after half the schedule: fresh runs, then S = 4
    # blocks, the segment's last one short
    got = plan(steps=9, gather_reuse=4, gather_reuse_after=0.5)
    assert got["runs"] == [(0, 6, False), (6, 3, True)]
    for kw in (dict(mask_p=0.7), dict(n_blocks=3)):
        got = plan(**kw)
        assert got["route"] == "pair", kw
        assert got["launches"] == dict(pair=12, persistent=0,
                                       persistent_sweeps=0)
    # phase 4's 11M large step: 13-sweep segments (the JAX program cap),
    # one launch each
    got = plan(n=11_000_000, steps=2_340, n_sub=60, nb_grad_batch=40)
    assert got["launches"] == dict(pair=0, persistent=180,
                                   persistent_sweeps=2_340)
    assert covers(got["runs"], 2_340)
    got = plan(n=11_000_000, steps=2_340, n_sub=60, nb_grad_batch=40,
               gather_reuse=12)
    assert got["launches"]["persistent"] == 2_340 // 12
    assert all(count == 12 and stale for _, count, stale in got["runs"])
    assert covers(got["runs"], 2_340)


def test_host_build_of_kernel_source_matches_twins(tmp_path):
    """``csrc/dense_sweep.cu`` compiled as host C++
    (tools/dense_sweep_host_check.py; the grid barrier a std::barrier
    over one OS thread per emulated GPU thread): every pair case within
    chip_smoke's bands of the twins, the persistent launch bit-equal to
    the pair over the same six sweeps and to itself."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    from tools import dense_sweep_host_check as host
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert host.run_all(tmp_path, n=1503)
    finally:
        torch.set_num_threads(torch_threads)


def test_alignment_rule():
    """Only a d = 2 row is read as one 8-byte word: the node blocks and
    mesh row shares of a 3-D embedding, which start at odd rows, pass;
    at d = 2 a row pointer 4 bytes off raises, as do edge records off 16
    bytes."""
    lo = td._block_bounds(5003, 3)[1][0]
    assert lo % 2 == 1
    y3 = torch.zeros((5003, 3))
    ds._check_aligned(3, y=y3, a=y3[lo:lo + 9], out=y3[lo:lo + 9])
    flat = torch.zeros(102)
    ds._check_aligned(2, y=flat[2:].view(50, 2))
    with pytest.raises(ValueError, match="out must be 8-byte"):
        ds._check_aligned(2, out=flat[1:101].view(50, 2))
    records = torch.zeros(40, dtype=torch.int32)
    ds._check_aligned(3, records[12:].view(2, 14))
    with pytest.raises(ValueError, match="edges must be 16-byte"):
        ds._check_aligned(3, records[1:29].view(2, 14))


def test_refused_launch_raises():
    # the wrappers raise on a launch's error code, with no other launch
    with pytest.raises(RuntimeError, match="persistent sweep.*720"):
        ds._raise_on(720, "persistent sweep")
    ds._raise_on(0, "persistent sweep")


def test_dispatch():
    p = _inputs(2, n=64)
    edges = _edges(p)
    y, scale = _t(p["y"]), _t(p["scale"])
    before = ds.launch_counts()
    # CPU tensors run the twins and launch nothing
    a = ds.dense_attraction_rows(y, y, 0, edges, scale, 0.9, 1.0)
    assert torch.equal(a, ds.dense_attraction_rows_reference(
        y, y, 0, edges, scale, 0.9, 1.0))
    out = torch.empty_like(a)
    got = ds.dense_kick_rows(y, a, 0, 5, _t(p["idx_full"]), scale, 0.9, 1.0,
                             5, out=out)
    assert got is out and torch.equal(out, ds.dense_kick_rows_reference(
        y, a, 0, 5, _t(p["idx_full"]), scale, 0.9, 1.0, 5))
    plan = (torch.tensor([0.9], dtype=torch.float32),
            torch.tensor([5], dtype=torch.int64),
            torch.tensor([0], dtype=torch.int32))
    yy = y.clone()
    got = ds.dense_sweeps(yy, None, edges[None], scale, *plan, 1.0, 5,
                          _t(p["idx_full"]))
    assert got is yy and torch.equal(yy, ds.dense_kick_rows_reference(
        y, a, 0, 5, _t(p["idx_full"]), scale, 0.9, 1.0, 5, flat=True))
    assert ds.launch_counts() == before
    # any other device, a wrong dtype, shape or layout raises
    meta = y.to("meta")
    with pytest.raises(ValueError, match="device"):
        ds.dense_attraction_rows(meta, meta, 0, edges, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="device"):
        ds.dense_kick_rows(meta, a.to("meta"), 0, 5, _t(p["idx_full"]),
                           scale, 0.9, 1.0, 5)
    with pytest.raises(ValueError, match="device"):
        ds.dense_sweeps(meta, None, edges[None], scale, *plan, 1.0, 5,
                        _t(p["idx_full"]))
    with pytest.raises(TypeError, match="edges"):
        ds.dense_attraction_rows(y, y, 0, edges.float(), scale, 0.9, 1.0)
    with pytest.raises(TypeError, match="y"):
        ds.dense_attraction_rows(y.double(), y, 0, edges, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="shape"):
        ds.dense_attraction_rows(y, y, 0, edges[:, :17], scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="outside"):
        ds.dense_attraction_rows(y, y, 10, edges, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ds.dense_kick_rows(y, a, 0, 5, _t(p["idx_full"]).T.contiguous().T,
                           scale, 0.9, 1.0, 5)
    with pytest.raises(ValueError, match="shape"):
        ds.dense_kick_rows(y, a[:10], 0, 5, _t(p["idx_full"]), scale, 0.9,
                           1.0, 5)
    with pytest.raises(TypeError, match="offsets"):
        ds.dense_sweeps(y, None, edges[None], scale, plan[0],
                        plan[1].int(), plan[2], 1.0, 5, _t(p["idx_full"]))
    with pytest.raises(ValueError, match="shape"):
        ds.dense_sweeps(y, None, edges[None], scale, plan[0],
                        plan[1][:0], plan[2], 1.0, 5, _t(p["idx_full"]))


def kick_launches() -> int:
    return counters(ds.PREFIX).get("kick", 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES) + ["whole", "d_5"])
def test_kernel_matches_twin_on_card(cuda_device, case):
    c = dict(CASES.get(case, {}), **({"d": 5} if case == "d_5" else {}))
    lo = c.get("lo", 0)
    p = _inputs(13, n=5003, d=c.get("d", 2), lo=lo, rows=c.get("rows"))
    dev = cuda_device
    y = _t(p["y"]).to(dev)
    n, rows = y.shape[0], p["idx"].shape[1]
    y_src = y + _t(p["y_src"]).to(dev) if c.get("stale") else y
    edges = _edges(p, dev)
    scale, nw = _t(p["scale"]).to(dev), _t(p["neg_weight"]).to(dev)
    mask_p = c.get("mask_p", 1.0)
    mask = _t(p["mask"]).to(dev) if mask_p < 1.0 else None
    b = c.get("b", 1.0)
    kick = dict(neg_weight=nw, parallel_kicks=c.get("parallel", False),
                flat=rows == n)

    def sweep(att, kck):
        a = att(y, y_src, lo, edges, scale, 0.9, b, mask=mask,
                mask_p=mask_p)
        return a, kck(y, a, lo, c.get("offset", 4999), _t(p["idx_full"])
                      .to(dev), scale, 0.9, b, 5, **kick)

    before = kick_launches()
    a_k, o_k = sweep(ds.dense_attraction_rows, ds.dense_kick_rows)
    a_k2, o_k2 = sweep(ds.dense_attraction_rows, ds.dense_kick_rows)
    a_t, o_t = sweep(ds.dense_attraction_rows_reference,
                     ds.dense_kick_rows_reference)
    torch.cuda.synchronize()
    assert kick_launches() == before + 2
    y_max = float(y.abs().max())
    assert float((a_k - a_t).abs().max()) <= ATT_REL * y_max
    assert float((o_k - o_t).abs().max()) <= SWEEP_REL * y_max
    assert torch.equal(a_k, a_k2) and torch.equal(o_k, o_k2)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", list(PERSISTENT_KNOBS))
def test_persistent_matches_pair_and_twin_on_card(cuda_device, knob):
    """The persistent launch over six sweeps against the per-sweep pair
    over the same sweeps (bit-equal) and against itself (bit-equal), one
    launch and six sweeps counted each; against its twin at gamma 0.02
    then 0.01 (the pair's band: at the default step the expansive map
    amplifies a summation order's ulp over several sweeps past any
    band, as tests/test_torch_dense.py pins whole runs)."""
    kw = dict(PERSISTENT_KNOBS[knob])
    d, hub = kw.pop("d", 2), kw.pop("hub", True)
    p = _inputs(13, n=5003, d=d, hub=hub)
    dev = cuda_device
    y0 = _t(p["y"]).to(dev)
    n = y0.shape[0]
    edges = torch.stack([_edges(p, dev), _edges(dict(p, idx=p["idx_full"][3:],
                                                     scale_j=None), dev)])
    idx_full = _t(p["idx_full"]).to(dev)
    scale = _t(p["scale"]).to(dev)
    nw = _t(p["neg_weight"]).to(dev) if hub else None
    b = kw.get("b", 1.0)
    gammas = torch.tensor([0.9, 0.9, 0.9, 0.6, 0.6, 0.6], device=dev)
    offs = torch.tensor([17, 4999, 101, 5, 2400, 62], device=dev)
    groups = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32, device=dev)
    snap = y0 + _t(p["y_src"]).to(dev) if kw.get("reuse") else None
    knobs = dict(neg_weight=nw, neighbor_exclusion=kw.get("exclusion", True),
                 parallel_kicks=kw.get("parallel", False))
    args = (edges, scale, gammas, offs, groups, b, 5, idx_full)
    before = ds.launch_counts()
    got = ds.dense_sweeps(y0.clone(), snap, *args, **knobs)
    again = ds.dense_sweeps(y0.clone(), snap, *args, **knobs)
    counts = ds.launch_counts()
    assert counts["persistent"] == before["persistent"] + 2
    assert counts["persistent_sweeps"] == before["persistent_sweeps"] + 12
    pair = y0.clone()
    for s in range(6):
        g = float(gammas[s])
        a = ds.dense_attraction_rows(pair, pair if snap is None else snap, 0,
                                     edges[int(groups[s])], scale, g, b)
        ds.dense_kick_rows(pair, a, 0, int(offs[s]), idx_full, scale, g, b,
                           5, flat=True, out=pair, **knobs)
    small = (edges, scale, gammas / 45.0, offs, groups, b, 5, idx_full)
    slow = ds.dense_sweeps(y0.clone(), snap, *small, **knobs)
    twin = ds.dense_sweeps_reference(y0.clone(), snap, *small, **knobs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, pair), float((got - pair).abs().max())
    y_max = float(y0.abs().max())
    assert float((slow - twin).abs().max()) <= SWEEP_REL * y_max


@pytest.mark.gpu
def test_node_blocks_at_d_3_on_card(cuda_device):
    """``dense_optimize(n_blocks=3)`` at d = 3 on 5,003 rows, whose second
    block starts at an odd row (4 bytes off an 8-byte word), through the
    pair on the card against the same call on the CPU (the twins), at a
    step small enough that six sweeps keep the kernels within the pair's
    band."""
    _, args = _optimize_inputs(d=3, n=5003)
    assert td._block_bounds(5003, 3)[1][0] % 2 == 1
    kw = dict(grad_step_init=0.02, b=1.0, n_sub=3, n_neg=5, nb_grad_batch=4,
              n_groups=2, batch0=0, batch1=2, n_blocks=3,
              offsets=[17, 4999, 101, 5, 2400, 62])
    before = ds.launch_counts()
    got = td.dense_optimize(*(a.to(cuda_device) for a in args), **kw)
    counts = ds.launch_counts()
    twin = td.dense_optimize(*args, **kw)
    assert counts["pair"] == before["pair"] + 12
    assert counts["persistent"] == before["persistent"]
    y_max = float(args[0].abs().max())
    assert float((got.cpu() - twin).abs().max()) <= SWEEP_REL * y_max


@pytest.mark.gpu
def test_refused_persistent_launch_raises_on_card(cuda_device, monkeypatch):
    p = _inputs(2, n=64)
    dev = cuda_device
    y = _t(p["y"]).to(dev)
    kernels = ds._kernels()
    # the card refuses the cooperative launch (cudaErrorCooperativeLaunch
    # TooLarge): the wrapper raises, counts nothing and launches nothing
    monkeypatch.setattr(ds, "_kernels",
                        lambda: (*kernels[:2], lambda *a: 720))
    before = ds.launch_counts()
    with pytest.raises(RuntimeError, match="720"):
        ds.dense_sweeps(y, None, _edges(p, dev)[None], _t(p["scale"]).to(dev),
                        torch.tensor([0.9], device=dev),
                        torch.tensor([5], device=dev),
                        torch.tensor([0], dtype=torch.int32, device=dev), 1.0,
                        5, _t(p["idx_full"]).to(dev))
    assert ds.launch_counts() == before
    assert torch.equal(y, _t(p["y"]).to(dev))
