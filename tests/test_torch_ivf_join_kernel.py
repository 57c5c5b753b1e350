"""The IVF join kernel (``csrc/ivf_join.cu``, ``ops/ivf_join.py``).

Without a card: the kernel's source built as host C++
(tools/ivf_join_host_check.py: one OS thread per GPU thread of a block,
``__syncthreads()`` a barrier) and held to the torch join
(``_ivf_join_sorted``) at small ragged shapes, every instance of the
source; on rows of small integers, whose distances are exact, bit for bit
and also to the JAX package's ``_ivf_join_sorted``; elsewhere ids equal
outside near-ties (``ops.ivf_join.join_agreement``: the ranked value
within TIE_REL of |q|^2 + |c|^2) and dists within 1e-5 relative.  The
router of knn/ivf.py: which (device, layout, distance) run a kernel, a
routed build through the host-built kernel, and a kernel error that
propagates.  On the card (``-m gpu``): the kernel against its twin."""

import shutil

import numpy as np
import pytest
import torch

from annembed_tpu.knn import ivf as jivf
from annembed_tpu_torch.knn import ivf as tivf
from annembed_tpu_torch.knn.distances import _PAIRS
from annembed_tpu_torch.ops import ivf_join as ij
from tools import ivf_join_host_check as host

CASE_NAMES = ("ties_float32", "ties_bfloat16", "ties_k40", "ties_k24",
              "ties_k251",
              "d28_k12_bf16", "d28_k12_f32_cut", "d28_k32", "d9_k20_cut",
              "d3_k51",
              "d40_chunks", "d2_grid_sentinel", "underfilled")


@pytest.fixture(scope="module")
def host_join(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    return host.load(tmp_path_factory.mktemp("ivf_join_host"))


@pytest.fixture(scope="module")
def cases():
    return host.cases()


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_host_kernel_matches_torch_join(host_join, cases, one_thread, name):
    inp, dtype, exact = cases[name]
    ok, detail = host.run_case(host_join, inp, dtype, exact)
    assert ok, detail


def test_cases_cover_the_edges(cases):
    """The cases hold what they are named for: every column tile (4, 8,
    16, 32, chunks), a k whose lists leave room for fewer than 128
    threads a block, windows cut at cap, cells split over several virtual
    rows, underfilled rows, the grid's sentinel cell, a probed window that
    ends at the corpus's end."""
    assert set(cases) == set(CASE_NAMES)
    ks = {inp["k"] for inp, _, _ in cases.values()}
    ds = {inp["xs_pad"].shape[1] for inp, _, _ in cases.values()}
    assert min(ks) <= 8 and max(ks) == 251
    assert {2, 5, 9, 28, 40} <= ds
    cut = cases["d28_k12_f32_cut"][0]
    assert int(cut["counts"].max()) > cut["cap"]
    assert int(torch.unique(cut["qparents"], return_counts=True)[1].max()) > 1
    ties = cases["ties_float32"][0]
    assert int(ties["counts"].max()) > ties["cap"] > ties["qcap"]
    grid = cases["d2_grid_sentinel"][0]
    nlist = grid["cell_nbrs"].shape[0]
    assert int(grid["cell_nbrs"].max()) == nlist == grid["counts"].shape[0] - 1
    under = cases["underfilled"][0]
    _, d_under = ij.ivf_join_reference(**under)
    assert bool(torch.isinf(d_under).any())
    for inp, _, _ in cases.values():
        n = inp["xs_pad"].shape[0] - 1
        ends = inp["starts"].long() + inp["counts"].long()
        assert bool((ends[inp["cell_nbrs"].long()] == n).any())


def test_exact_ties_cross_probes(cases):
    """On the integer rows some query's k-th ranked value is shared by
    candidates of two probes, some selected and some not: slot order
    decides there, and the exact cases hold the kernel to it."""
    inp = cases["ties_float32"][0]
    k, cap = inp["k"], inp["cap"]
    found = 0
    for r in range(inp["qstarts"].shape[0]):
        qpos = int(inp["qstarts"][r])
        probes = inp["cell_nbrs"][inp["qparents"][r].long()].long()
        wins = [(int(inp["starts"][c]), min(int(inp["counts"][c]), cap))
                for c in probes]
        pos = torch.cat([torch.arange(s, s + m) for s, m in wins])
        probe = torch.cat([torch.full((m,), i) for i, (_, m) in
                           enumerate(wins)])
        keep = pos != qpos
        v, _ = ij.ranked_value(inp["xs_pad"], qpos, pos[keep], "float32")
        kth = torch.sort(v).values[k - 1]
        straddle = int((v < kth).sum()) < k < int((v <= kth).sum())
        found += straddle and probe[keep][v == kth].unique().numel() > 1
    assert found > 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_kernel_matches_jax_join(host_join, one_thread, dtype):
    """Integer rows, cells cut at cap and split at qcap: the host-built
    kernel's graph after the fix-up equals the JAX package's sorted join
    scattered and fixed up as its knn_graph_ivf does."""
    rng = np.random.default_rng(5)
    x = host.integer_rows(rng, 700, 5)
    k, cap, qcap = 6, 40, 24
    inp = tivf.sorted_join_inputs(x, k, nlist=12, nprobe=4, cap=cap,
                                  qcap=qcap)
    gi, gd = host.fixed(inp, *host_join(**inp, dtype=dtype))
    n, d = x.shape
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
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(jd))


# --- the router --------------------------------------------------------------

def test_join_route():
    """Only the sorted layout's DistL2 join on a CUDA tensor runs a
    kernel, whatever d and k; every other combination runs the torch
    join."""
    for dev in ("cpu", "cuda"):
        for layout in ("sorted", "gathered"):
            for distance in _PAIRS:
                for d, k in ((2, 6), (28, 12), (3, 51), (40, 251)):
                    assert (ij.join_route(dev, layout, distance, d, k)
                            != "torch") == ((dev, layout, distance)
                                            == ("cuda", "sorted", "DistL2"))


def _routed(monkeypatch, join):
    """knn/ivf.py with CPU tensors routed as CUDA ones, ``join`` in place
    of the kernel's wrapper; returns the calls it receives."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[-2:])
        return join(*args, **kw)
    monkeypatch.setattr(tivf, "join_route",
                        lambda dev, layout, distance, d, k: "simt"
                        if (layout, distance) == ("sorted", "DistL2")
                        else "torch")
    monkeypatch.setattr(tivf, "ivf_join", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_build_runs_the_kernel(host_join, monkeypatch, one_thread,
                                      dtype):
    """``knn_graph_ivf`` routed to the host-built kernel: one launch of
    every virtual row, and on integer rows the graph of the torch join
    bit for bit; the gathered layout and cosine never reach the kernel."""
    rng = np.random.default_rng(8)
    x = host.integer_rows(rng, 1200, 6)
    kw = dict(k=7, nlist=20, nprobe=5, dtype=dtype)
    want = tivf.knn_graph_ivf(x, **kw)
    calls = _routed(monkeypatch, host_join)
    got = tivf.knn_graph_ivf(x, **kw)
    assert calls == [(0, 1)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tivf.knn_graph_ivf(x, layout="gathered", **kw)
    tivf.knn_graph_ivf(x, distance="DistCosine", **kw)
    assert len(calls) == 1


class _ThreadMesh:
    """Two ranks as threads of one process: ``all_reduce_sum`` sums the
    ranks' tensors in place; the tables are replicated by construction."""

    def __init__(self, rank, board):
        self.rank, self.size, self.board = rank, len(board["parts"]), board

    def broadcast(self, *tensors):
        pass

    def all_reduce_sum(self, *tensors):
        self.board["parts"][self.rank] = [t.clone() for t in tensors]
        self.board["barrier"].wait()
        for i, t in enumerate(tensors):
            t.copy_(sum(p[i] for p in self.board["parts"]))
        self.board["barrier"].wait()


def test_routed_mesh_build_sums_row_shares(host_join, monkeypatch,
                                           one_thread):
    """Under a mesh each rank launches the kernel on every size-th
    virtual row and the shares are summed: every rank ends with the
    single device's graph, bit for bit."""
    import threading
    lock = threading.Lock()

    def serial(*args, **kw):
        with lock:
            return host_join(*args, **kw)
    calls = _routed(monkeypatch, serial)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(1500, 6)).astype(np.float32))
    kw = dict(k=8, nlist=16, nprobe=4, dtype="bfloat16")
    want = tivf.knn_graph_ivf(x, **kw)
    board = dict(parts=[None, None], barrier=threading.Barrier(2))
    out = [None, None]

    def rank(r):
        out[r] = tivf.knn_graph_ivf(x, mesh=_ThreadMesh(r, board), **kw)
    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(calls) == [(0, 1), (0, 2), (1, 2)]
    for got in out:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_error_propagates(host_join, monkeypatch):
    """A launch error, a build error and a k the kernel does not serve
    raise out of the build: no code gives way to the torch join."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(400, 4))
                         .astype(np.float32))
    failing = host.host_join(lambda *args: 9, 800)
    _routed(monkeypatch, failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        tivf.knn_graph_ivf(x, 5, nlist=8, nprobe=3)

    def no_build(*args, **kw):
        raise RuntimeError("nvcc failed (1) building ivf_join.cu")
    monkeypatch.setattr(tivf, "ivf_join", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tivf.knn_graph_ivf(x, 5, nlist=8, nprobe=3)
    small = host.host_join(lambda *args: 0, 4)
    monkeypatch.setattr(tivf, "ivf_join", small)
    with pytest.raises(ValueError, match="largest"):
        tivf.knn_graph_ivf(x, 5, nlist=8, nprobe=3)


def test_cpu_wrapper_runs_the_twin(cases):
    """On CPU tensors the wrapper is the twin and launches nothing; a
    rank's share is the twin of its rows, the others 0."""
    inp, dtype, _ = cases["d9_k20_cut"]
    before = ij.launch_counts()
    got = ij.ivf_join(**inp, dtype=dtype)
    want = ij.ivf_join_reference(**inp, dtype=dtype)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    parts = [ij.ivf_join(**inp, dtype=dtype, rank=r, size=2) for r in (0, 1)]
    assert torch.equal(parts[0][0] + parts[1][0], got[0])
    assert torch.equal(parts[0][1] + parts[1][1], got[1])
    assert ij.launch_counts() == before
    with pytest.raises(ValueError, match="rank"):
        ij.ivf_join(**inp, rank=2, size=2)
    with pytest.raises(TypeError, match="int32"):
        ij.ivf_join(**dict(inp, qstarts=inp["qstarts"].long()))


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASE_NAMES)
def test_kernel_matches_twin_on_card(cuda_device, cases, name):
    """The kernel on the card against the torch join on the same CUDA
    tensors: bit for bit on the integer rows, else ids equal outside
    near-ties and dists within 1e-5 relative; one launch a call."""
    inp, dtype, exact = cases[name]
    inp = {key: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for key, v in inp.items()}
    before = sum(ij.launch_counts().values())
    got = ij.ivf_join(**inp, dtype=dtype)
    again = ij.ivf_join(**inp, dtype=dtype)
    torch.cuda.synchronize()
    assert sum(ij.launch_counts().values()) == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = ij.ivf_join_reference(**inp, dtype=dtype)
    gi, gd = host.fixed(inp, *got)
    wi, wd = host.fixed(inp, *want)
    if exact:
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        return
    agree = ij.join_agreement(inp["xs_pad"], dtype, gi, gd, wi, wd)
    assert agree["mismatch_rows"] == 0 and agree["unsorted_rows"] == 0, agree
    assert agree["max_rel_dist_err"] <= ij.DIST_REL, agree
