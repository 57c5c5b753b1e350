"""The tensor-core route of the IVF join (``csrc/ivf_join_tc.cu``,
``ops/ivf_join.py``'s "tc" route) without a card, and on the card.

Two CPU models of the route, both held to the torch join
(``_ivf_join_sorted``) after the fix-up, bit for bit on rows of small
integers (every product and sum exact in either precision, so ties are
exact ties: slot order decides, across probes and across the four threads
of a quad), else by ``ops.ivf_join.join_agreement``:

* ``emulate_tc_join`` below, in torch: the operands as the prologue
  kernel writes them (-2 x and the norm's pieces in the padding columns,
  bf16 or TF32 hi / lo; the query row with ones there), the accumulator
  |c|^2 - 2 q.c (bf16 exact products summed once, or the three TF32
  products lo.hi + hi.lo + hi.hi), the value sqrt(max(|q|^2 + acc, 0)),
  each emulated thread's top-k over the columns it holds in wgmma's
  m64n128 fragment (slot % 8 in {2 quad, 2 quad + 1}), the merge of a
  quad's four lists by (value, slot), the exact rerank and stable sort;
* the kernel's own selection, merge and rerank (``ivf_join_common.cuh``)
  built as host C++ and fed fragments from a plain product
  (``tools/ivf_join_host_check.py``'s ``load_tc``).

Both models, and the SIMT kernel's host build, are also held bit for bit
to the JAX package's sorted join (``annembed_tpu.knn.ivf.
_ivf_join_sorted``) on integer rows, at k 6, 12 and 24 with k-th values
tied across probes and across the threads of a quad.  Also the route
rule's truth table, the 3xTF32 split against one TF32 product, and the
host build's mesh shares.  On the card (``-m gpu``) the route against the
twin and the SIMT route."""

import functools
import shutil

import numpy as np
import pytest
import torch

from annembed_tpu_torch.knn import ivf as tivf
from annembed_tpu_torch.knn.distances import _PAIRS
from annembed_tpu_torch.ops import ivf_join as ij
from tools import ivf_join_host_check as host

# the cases of tools/ivf_join_host_check.py that the route serves (d <=
# TC_MAX_D, k within its lists)
TC_CASE_NAMES = ("ties_float32", "ties_bfloat16", "ties_k24", "d28_k12_bf16",
                 "d28_k12_f32_cut", "d9_k20_cut", "d2_grid_sentinel",
                 "underfilled")


@pytest.fixture(scope="module")
def cases():
    return host.cases()


@pytest.fixture(scope="module")
def tc_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the route's selection as host code")
    return host.load_tc_kernel(tmp_path_factory.mktemp("ivf_join_tc_host"))


@pytest.fixture(scope="module")
def tc_join(tc_kernel):
    return host.host_join(*tc_kernel)


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# --- the CPU emulation ------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32, to nearest, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def operands(xs, sqn, dtype, products=3):
    """(A, B) of every row, f32 values: A the query operand, B the
    candidate's, as lists of (A_part, B_part) whose products the route
    sums (one pair in bf16; lo.hi, hi.lo, hi.hi in TF32, or hi.hi alone
    with ``products`` 1)."""
    n1, d = xs.shape
    if dtype == "bfloat16":
        dp = 16 if d + 3 <= 16 else 32
        a = torch.zeros((n1, dp))
        b = torch.zeros((n1, dp))
        a[:, :d] = bf16(xs)
        a[:, d:d + 3] = 1.0
        b[:, :d] = bf16(-2.0 * xs)
        h = bf16(sqn)
        m = bf16(sqn - h)
        b[:, d], b[:, d + 1], b[:, d + 2] = h, m, bf16((sqn - h) - m)
        return [(a, b)]
    dp = 8 if d + 1 <= 8 else (16 if d + 1 <= 16 else 32)
    a = torch.zeros((n1, dp))
    b = torch.zeros((n1, dp))
    a[:, :d], a[:, d] = xs, 1.0
    b[:, :d], b[:, d] = -2.0 * xs, sqn
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return [(ah, bh)] if products == 1 else [(al, bh), (ah, bl), (ah, bh)]


def accumulate(parts, qpos, cpos):
    """acc (Q, W) in f32: each product pass summed exactly (float64) and
    rounded once, the passes added in the route's order."""
    acc = None
    for a, b in parts:
        p = (a[qpos].double() @ b[cpos].double().T).float()
        acc = p if acc is None else acc + p
    return acc


def row_windows(inp, r):
    """Virtual row r's queries and its candidates' sorted positions in
    slot order."""
    n = inp["xs_pad"].shape[0] - 1
    parent = int(inp["qparents"][r])
    qstart = int(inp["qstarts"][r])
    end = int(inp["starts"][parent]) + int(inp["counts"][parent])
    qn = min(end - qstart, inp["qcap"])
    probes = inp["cell_nbrs"][parent].long()
    pos = torch.cat([torch.arange(int(inp["starts"][c]),
                                  int(inp["starts"][c])
                                  + min(int(inp["counts"][c]), inp["cap"]))
                     for c in probes] + [torch.zeros(0, dtype=torch.long)])
    return torch.arange(qstart, qstart + max(qn, 0)), pos, n


def emulate_tc_join(inp, dtype, products=3, ranked=False):
    """(idx, dist) (n, k) as the route computes them; with ``ranked``
    also the selected (ids, values) before the rerank."""
    xs, sqn, k = inp["xs_pad"], inp["sqnorm"], inp["k"]
    n = xs.shape[0] - 1
    parts = operands(xs, sqn, dtype, products)
    idx = torch.zeros((n, k), dtype=torch.int32)
    dist = torch.zeros((n, k))
    rank_i = torch.zeros((n, k), dtype=torch.int32)
    rank_v = torch.zeros((n, k))
    inf = float("inf")
    for r in range(inp["qstarts"].shape[0]):
        qpos, cpos, _ = row_windows(inp, r)
        if qpos.numel() == 0:
            continue
        w = cpos.numel()
        val = torch.full((qpos.numel(), max(w, 1)), inf)
        if w:
            e = sqn[qpos][:, None] + accumulate(parts, qpos, cpos)
            val[:, :w] = torch.sqrt(e.clamp_min(0.0))
            # the query itself (the first window holding it)
            is_self = cpos[None, :] == qpos[:, None]
            first = is_self & (is_self.cumsum(1) == 1)
            val[first] = inf
        slots = torch.arange(val.shape[1])
        quad = (slots % 8) // 2
        lists_v, lists_s = [], []
        for q in range(4):
            cols = slots[quad == q]
            v = val[:, cols]
            order = torch.sort(v, dim=1, stable=True).indices[:, :k]
            vq = v.gather(1, order)
            sq = cols[order]
            pad = k - vq.shape[1]
            lists_v.append(torch.cat([vq, torch.full((vq.shape[0], pad),
                                                     inf)], 1))
            lists_s.append(torch.cat([sq, torch.full((sq.shape[0], pad),
                                                     2**31 - 1)], 1))
        mv, ms = torch.cat(lists_v, 1), torch.cat(lists_s, 1)
        by_slot = torch.sort(ms, dim=1, stable=True).indices
        mv, ms = mv.gather(1, by_slot), ms.gather(1, by_slot)
        by_val = torch.sort(mv, dim=1, stable=True).indices[:, :k]
        sel_v, sel_s = mv.gather(1, by_val), ms.gather(1, by_val)
        live = torch.isfinite(sel_v)
        ids = torch.where(live, cpos[sel_s.clamp_max(max(w - 1, 0))]
                          if w else torch.full_like(sel_s, n), n)
        rank_i[qpos], rank_v[qpos] = ids.int(), sel_v
        diff = xs[qpos][:, None, :] - xs[ids]
        ex = torch.where(live, torch.sqrt(torch.square(diff).sum(-1)
                                          .clamp_min(0.0)), inf)
        order = torch.sort(ex, dim=1, stable=True).indices
        idx[qpos] = ids.gather(1, order).int()
        dist[qpos] = ex.gather(1, order)
    return (idx, dist, rank_i, rank_v) if ranked else (idx, dist)


def hold_to_twin(inp, dtype, exact, got):
    gi, gd = host.fixed(inp, *got)
    wi, wd = host.fixed(inp, *ij.ivf_join_reference(**inp, dtype=dtype))
    if exact:
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        return
    agree = ij.join_agreement(inp["xs_pad"], dtype, gi, gd, wi, wd)
    assert agree["mismatch_rows"] == 0 and agree["unsorted_rows"] == 0, agree
    assert agree["max_rel_dist_err"] <= ij.DIST_REL, agree


@pytest.mark.parametrize("name", TC_CASE_NAMES)
def test_emulated_route_matches_twin(cases, one_thread, name):
    inp, dtype, exact = cases[name]
    hold_to_twin(inp, dtype, exact, emulate_tc_join(inp, dtype))


def test_emulated_route_on_integer_rows_both_dtypes(cases, one_thread):
    """The integer cases in both operand types: bit-equal to the twin
    (the bf16 norms' three pieces are exact)."""
    inp = cases["ties_k24"][0]
    for dtype in ("float32", "bfloat16"):
        hold_to_twin(inp, dtype, True, emulate_tc_join(inp, dtype))


def test_three_tf32_products_hold_the_tie_window(cases, one_thread):
    """The 3xTF32 expansion errs far below TIE_REL of |q|^2 + |c|^2 on
    the f32 case at d 28; one TF32 product (hi.hi) does not."""
    inp, dtype, _ = cases["d28_k12_f32_cut"]
    errs = []
    for products in (3, 1):
        _, _, ri, rv = emulate_tc_join(inp, dtype, products, ranked=True)
        errs.append(ij.expansion_error(inp["xs_pad"], dtype, ri, rv))
    assert errs[0] < ij.TIE_REL / 10 < ij.TIE_REL < errs[1], errs


# --- the kernel's selection built as host C++ --------------------------------

@pytest.mark.parametrize("name", TC_CASE_NAMES)
def test_host_route_matches_torch_join(tc_join, cases, one_thread, name):
    inp, dtype, exact = cases[name]
    ok, detail = host.run_case(tc_join, inp, dtype, exact)
    assert ok, detail


def test_host_route_equals_emulation_on_integer_rows(tc_join, cases,
                                                     one_thread):
    """Two models of the route, one graph: the host-built selection and
    the torch emulation agree bit for bit before the fix-up, ranked
    values included."""
    for name in ("ties_float32", "ties_bfloat16"):
        inp, dtype, _ = cases[name]
        got = tc_join(**inp, dtype=dtype, ranked=True)
        want = emulate_tc_join(inp, dtype, ranked=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_host_route_expansion_error(tc_join, cases, one_thread):
    inp, dtype, _ = cases["d28_k12_f32_cut"]
    _, _, ri, rv = tc_join(**inp, dtype=dtype, ranked=True)
    assert ij.expansion_error(inp["xs_pad"], dtype, ri, rv) < ij.TIE_REL / 10


def test_host_route_mesh_split(tc_join, cases, one_thread):
    inp, dtype, _ = cases["d28_k12_bf16"]
    assert host.run_mesh_split(tc_join, inp, dtype)


# --- held to the JAX package's join ------------------------------------------

#: name -> (rows, d, k, nlist, nprobe, cap, qcap, seed) of integer rows:
#: "k6" the SIMT kernel's JAX case; "quad_k12" / "quad_k24" k-th values
#: shared by candidates of several probes and of several threads of a quad
JAX_CASES = {"k6": (700, 5, 6, 12, 4, 40, 24, 5),
             "quad_k12": (1200, 5, 12, 20, 4, 60, 40, 13),
             "quad_k24": (1200, 5, 24, 20, 4, 60, 40, 13)}


@functools.cache
def jax_case(name):
    rows, d, k, nlist, nprobe, cap, qcap, seed = JAX_CASES[name]
    x = host.integer_rows(np.random.default_rng(seed), rows, d)
    return tivf.sorted_join_inputs(x, k, nlist=nlist, nprobe=nprobe, cap=cap,
                                   qcap=qcap)


@functools.cache
def jax_graph(name, dtype):
    """The JAX package's sorted join (``annembed_tpu.knn.ivf.
    _ivf_join_sorted``) of ``jax_case(name)``, scattered and fixed up as
    its knn_graph_ivf does."""
    from annembed_tpu.knn import ivf as jivf
    inp = jax_case(name)
    k, cap, qcap = inp["k"], inp["cap"], inp["qcap"]
    n, d = inp["xs_pad"].shape[0] - 1, inp["xs_pad"].shape[1]
    xs = np.zeros((max(n + 1, cap, qcap), d), np.float32)
    xs[:n] = inp["xs_pad"][:n].numpy()
    members, idx, dist = jivf._ivf_join_sorted(
        xs, inp["qstarts"].numpy(), inp["qparents"].numpy(),
        inp["starts"].numpy(), inp["counts"].numpy(),
        inp["cell_nbrs"].numpy(), k, qcap, cap, n, dtype)
    ji = np.zeros((n + 1, k), np.int32)
    jd = np.zeros((n + 1, k), np.float32)
    m = np.asarray(members).reshape(-1)
    ji[m] = np.asarray(idx).reshape(-1, k)
    jd[m] = np.asarray(dist).reshape(-1, k)
    ji, jd = jivf._fixup_underfilled(ji[:n], np.maximum(jd[:n], 0.0), n)
    return np.asarray(ji), np.asarray(jd)


@pytest.fixture(scope="module")
def simt_join(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    return host.load(tmp_path_factory.mktemp("ivf_join_simt_host"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
@pytest.mark.parametrize("model", ["tc_host", "tc_emulated", "simt_host"])
def test_routes_match_jax_join(request, one_thread, model, name, dtype):
    """Integer rows, cells cut at cap and split at qcap: each model of
    the two kernels, after the fix-up, equals the JAX package's sorted
    join bit for bit (every value exact, so the tie rule decides alone)."""
    inp = jax_case(name)
    if model == "tc_emulated":
        got = emulate_tc_join(inp, dtype)
    else:
        join = request.getfixturevalue(
            "tc_join" if model == "tc_host" else "simt_join")
        got = join(**inp, dtype=dtype)
    gi, gd = host.fixed(inp, *got)
    ji, jd = jax_graph(name, dtype)
    np.testing.assert_array_equal(gi.numpy(), ji)
    np.testing.assert_array_equal(gd.numpy(), jd)


@pytest.mark.parametrize("name", ["quad_k12", "quad_k24"])
def test_jax_cases_tie_across_probes_and_quads(name):
    """In the quad cases many queries' k-th ranked value is shared by
    candidates that straddle the cut (some kept, some not) and lie in
    two or more probes and in the columns of two or more threads of a
    quad: the per-thread lists, their merge and slot order decide there."""
    inp = jax_case(name)
    k, found = inp["k"], 0
    for r in range(inp["qstarts"].shape[0]):
        qpos, cpos, _ = row_windows(inp, r)
        if qpos.numel() == 0:
            continue
        probe = torch.cat([torch.full((min(int(inp["counts"][c]),
                                           inp["cap"]),), i)
                           for i, c in enumerate(
                               inp["cell_nbrs"][inp["qparents"][r]].long())])
        quad = (torch.arange(cpos.numel()) % 8) // 2
        for q in qpos.tolist():
            keep = cpos != q
            v, _ = ij.ranked_value(inp["xs_pad"], q, cpos[keep], "float32")
            if v.numel() <= k:
                continue
            kth = torch.sort(v).values[k - 1]
            tied, below = v == kth, int((v < kth).sum())
            found += (below < k < below + int(tied.sum())
                      and probe[keep][tied].unique().numel() > 1
                      and quad[keep][tied].unique().numel() > 1)
    assert found > 50, found


def test_route_limits(tc_kernel):
    """What the library serves: every d up to TC_MAX_D in both types at
    k up to TC_MAX_K (the rule's limit, its largest register list) and
    nprobe 32 or 256; no d above TC_MAX_D; and the operand copy's bytes
    (16 a plane and row)."""
    for bf16 in (0, 1):
        for d in (1, 2, 3, 5, 9, 16, 28, ij.TC_MAX_D):
            for nprobe in (32, 256):
                assert tc_kernel.max_k(d, bf16, nprobe) == ij.TC_MAX_K, (
                    d, bf16, nprobe)
        assert tc_kernel.max_k(ij.TC_MAX_D + 1, bf16, 32) == 0
    # 11M x 28: 4 bf16 planes (0.70 GB), 16 TF32 planes (2.8 GB)
    assert tc_kernel.operand_bytes(11_000_000, 28, 1) == 16 * 4 * 11_000_001
    assert tc_kernel.operand_bytes(11_000_000, 28, 0) == 16 * 16 * 11_000_001


def test_cases_span_tiles_and_windows(cases):
    """Rows whose candidates run over several 128-slot tiles, tiles that
    hold pieces of two or more windows, and rows cut at qcap into
    several virtual rows of one cell."""
    inp = cases["d28_k12_f32_cut"][0]
    multi, spans = 0, 0
    for r in range(inp["qstarts"].shape[0]):
        _, cpos, _ = row_windows(inp, r)
        w = cpos.numel()
        multi += w > 128
        breaks = (cpos.diff() != 1).nonzero().squeeze(1) + 1
        spans += bool(((breaks % 128) != 0).any())
    assert multi > 0 and spans > 0
    parents = inp["qparents"]
    assert int(torch.unique(parents, return_counts=True)[1].max()) > 1


# --- the route rule ----------------------------------------------------------

def test_join_route_truth_table():
    """(device, layout, metric, d, k) -> torch join / SIMT / tensor
    cores: only the sorted layout's DistL2 join on a CUDA tensor runs a
    kernel, the tensor-core one at 4 <= d <= 29 for k <= 12 and at 16 <=
    d <= 29 for 12 < k <= 24, where it measured faster."""
    ds = (1, 2, 3, 4, 5, 8, 15, 16, 28, 29, 30, 40, 784)
    ks = (1, 6, 12, 13, 20, 24, 25, 32, 51, 251)
    for dev in ("cpu", "cuda"):
        for layout in ("sorted", "gathered"):
            for distance in _PAIRS:
                for d in ds:
                    for k in ks:
                        got = ij.join_route(dev, layout, distance, d, k)
                        if (dev, layout, distance) != ("cuda", "sorted",
                                                       "DistL2"):
                            want = "torch"
                        elif ((k <= 12 and 4 <= d <= 29)
                              or (12 < k <= 24 and 16 <= d <= 29)):
                            want = "tc"
                        else:
                            want = "simt"
                        assert got == want, (dev, layout, distance, d, k)
    # the path's joins: phase 4 and the parts (d 28, k 12), the default
    # build k (2 x 10) at d 28 and at d 8, a 3-D embedding's graph at k
    # 12, the grid quantizer's 2-D join, the quality radius's rebuild (k
    # 51) and the compat radius (k 251)
    assert ij.join_route("cuda", "sorted", "DistL2", 28, 12) == "tc"
    assert ij.join_route("cuda", "sorted", "DistL2", 28, 20) == "tc"
    assert ij.join_route("cuda", "sorted", "DistL2", 8, 20) == "simt"
    assert ij.join_route("cuda", "sorted", "DistL2", 3, 12) == "simt"
    assert ij.join_route("cuda", "sorted", "DistL2", 2, 10) == "simt"
    assert ij.join_route("cuda", "sorted", "DistL2", 3, 51) == "simt"
    assert ij.join_route("cuda", "sorted", "DistL2", 2, 251) == "simt"


def test_cpu_wrapper_counts_nothing(cases):
    """On CPU tensors no route launches and no count moves."""
    inp, dtype, _ = cases["d9_k20_cut"]
    ij.reset_launch_counts()
    ij.ivf_join(**inp, dtype=dtype)
    assert ij.launch_counts() == {"simt": 0, "tc": 0}


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(dev, inp):
    return {key: (v.to(dev) if torch.is_tensor(v) else v)
            for key, v in inp.items()}


def _launch(route, inp, dtype):
    """One launch of the ``route`` kernel, whatever the rule says."""
    return ij._join(ij._kernel(route), torch.cuda.current_stream().cuda_stream,
                    **inp, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TC_CASE_NAMES)
def test_tc_route_matches_twin_on_card(cuda_device, cases, name):
    """The tensor-core kernel against the torch join on the same CUDA
    tensors, two launches bit-equal; where the rule picks it, the
    wrapper launches it once, one count a launch."""
    inp, dtype, exact = cases[name]
    inp = _on(cuda_device, inp)
    got = _launch("tc", inp, dtype)
    again = _launch("tc", inp, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    hold_to_twin(inp, dtype, exact, got)
    d = inp["xs_pad"].shape[1]
    if ij.join_route("cuda", "sorted", "DistL2", d, inp["k"]) == "tc":
        before = ij.launch_counts()
        wrapped = ij.ivf_join(**inp, dtype=dtype)
        torch.cuda.synchronize()
        assert ij.launch_counts() == dict(before, tc=before["tc"] + 1)
        assert torch.equal(wrapped[0], got[0])
        assert torch.equal(wrapped[1], got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", TC_CASE_NAMES)
def test_tc_route_matches_simt_on_card(cuda_device, cases, name):
    inp, dtype, exact = cases[name]
    inp = _on(cuda_device, inp)
    gi, gd = host.fixed(inp, *_launch("tc", inp, dtype))
    wi, wd = host.fixed(inp, *_launch("simt", inp, dtype))
    if exact:
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        return
    agree = ij.join_agreement(inp["xs_pad"], dtype, gi, gd, wi, wd)
    assert agree["mismatch_rows"] == 0, agree
