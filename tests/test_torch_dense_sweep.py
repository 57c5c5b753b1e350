"""The dense sweep's kernel pair (ops/dense_sweep.py): its plain twins
against the JAX package's ``_attraction_sweep_sfT`` and
``_repulsion_block_T`` on the same inputs (atol 1e-5, as
tests/test_torch_dense.py), for the knobs that file does not cover; the
port's ``dense_optimize`` on the CPU bit-equal to the same sweeps
composed of optim/dense.py's per-sweep functions in the (d, n) layout,
as it ran them before the kernel pair; the dispatch; and, on a card, the
CUDA kernels against the twins, two launches bit-equal."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from annembed_tpu.optim import dense as jd
from annembed_tpu_torch.ops import dense_sweep as ds
from annembed_tpu_torch.optim import dense as td

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
        _t(p["y"]), _t(y_src), lo, *map(_t, tables), _t(p["scale"]), gamma,
        b, mask=_t(mask), mask_p=mask_p)
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


def test_dispatch():
    p = _inputs(2, n=64)
    tables = [_t(p[key]) for key in ("idx", "w", "m", "w_rev", "m_rev",
                                     "scale_j")]
    y, scale = _t(p["y"]), _t(p["scale"])
    before = (ds.dense_attraction_rows.launches, ds.dense_kick_rows.launches)
    # CPU tensors run the twins and launch nothing
    a = ds.dense_attraction_rows(y, y, 0, *tables, scale, 0.9, 1.0)
    assert torch.equal(a, ds.dense_attraction_rows_reference(
        y, y, 0, *tables, scale, 0.9, 1.0))
    out = torch.empty_like(a)
    got = ds.dense_kick_rows(y, a, 0, 5, _t(p["idx_full"]), scale, 0.9, 1.0,
                             5, out=out)
    assert got is out and torch.equal(out, ds.dense_kick_rows_reference(
        y, a, 0, 5, _t(p["idx_full"]), scale, 0.9, 1.0, 5))
    assert (ds.dense_attraction_rows.launches,
            ds.dense_kick_rows.launches) == before
    # any other device, a wrong dtype, shape or layout raises
    meta = y.to("meta")
    with pytest.raises(ValueError, match="device"):
        ds.dense_attraction_rows(meta, meta, 0, *tables, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="device"):
        ds.dense_kick_rows(meta, a.to("meta"), 0, 5, _t(p["idx_full"]),
                           scale, 0.9, 1.0, 5)
    with pytest.raises(TypeError, match="idx"):
        ds.dense_attraction_rows(y, y, 0, tables[0].long(), *tables[1:],
                                 scale, 0.9, 1.0)
    with pytest.raises(TypeError, match="y"):
        ds.dense_attraction_rows(y.double(), y, 0, *tables, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="shape"):
        ds.dense_attraction_rows(y, y, 0, tables[0], tables[1][:, :5],
                                 *tables[2:], scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="outside"):
        ds.dense_attraction_rows(y, y, 10, *tables, scale, 0.9, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ds.dense_kick_rows(y, a, 0, 5, _t(p["idx_full"]).T.contiguous().T,
                           scale, 0.9, 1.0, 5)
    with pytest.raises(ValueError, match="shape"):
        ds.dense_kick_rows(y, a[:10], 0, 5, _t(p["idx_full"]), scale, 0.9,
                           1.0, 5)


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
    tables = [_t(p[key]).to(dev) for key in ("idx", "w", "m", "w_rev",
                                             "m_rev", "scale_j")]
    scale, nw = _t(p["scale"]).to(dev), _t(p["neg_weight"]).to(dev)
    mask_p = c.get("mask_p", 1.0)
    mask = _t(p["mask"]).to(dev) if mask_p < 1.0 else None
    b = c.get("b", 1.0)
    kick = dict(neg_weight=nw, parallel_kicks=c.get("parallel", False),
                flat=rows == n)

    def sweep(att, kck):
        a = att(y, y_src, lo, *tables, scale, 0.9, b, mask=mask,
                mask_p=mask_p)
        return a, kck(y, a, lo, c.get("offset", 4999), _t(p["idx_full"])
                      .to(dev), scale, 0.9, b, 5, **kick)

    before = ds.dense_kick_rows.launches
    a_k, o_k = sweep(ds.dense_attraction_rows, ds.dense_kick_rows)
    a_k2, o_k2 = sweep(ds.dense_attraction_rows, ds.dense_kick_rows)
    a_t, o_t = sweep(ds.dense_attraction_rows_reference,
                     ds.dense_kick_rows_reference)
    torch.cuda.synchronize()
    assert ds.dense_kick_rows.launches == before + 2
    y_max = float(y.abs().max())
    assert float((a_k - a_t).abs().max()) <= ATT_REL * y_max
    assert float((o_k - o_t).abs().max()) <= SWEEP_REL * y_max
    assert torch.equal(a_k, a_k2) and torch.equal(o_k, o_k2)
