"""The NN-descent round kernel (``csrc/nndescent.cu``) on the card: held
to its twin, the torch round, on the cases of
``tools/nndescent_host_check.py``, and a whole refine at the Higgs
cell's shape through the kernel route held to the JAX package's refine
of the same inputs, recorded on the CPU in
``tests/data/nndescent_jax_k12_rho05_bf16_d28.npz``
(``tests/test_torch_nndescent.py`` holds the record to the JAX package
and writes it anew).  This file imports no JAX, so it runs on the card:
``python -m pytest tests/test_torch_nndescent_card.py -m gpu``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from annembed_tpu_torch.knn import nndescent as tnd
from annembed_tpu_torch.ops import nndescent as ndops
from tools import nndescent_host_check as nnd_host

FIXTURE = Path(__file__).resolve().parent / "data" / \
    "nndescent_jax_k12_rho05_bf16_d28.npz"
FIXTURE_SEED, FIXTURE_ROWS = 15, 300
#: the refine's knobs at the Higgs cell (k 12 = 2 knbn, rho 0.5: 168
#: candidates a row, bf16 scoring)
KNOBS = dict(n_rounds=2, rho=0.5, dtype="bfloat16", seed=7)


@pytest.fixture(scope="module")
def round_cases():
    return {name: (inp, exact) for name, inp, exact in nnd_host.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ints_k12_rho05_bf16_d28",
                                  "float_k12_rho05_bf16_d28",
                                  "ints_k12_rho05_f32_d28",
                                  "float_k10_rho1_f32_d16",
                                  "pads_and_repeats"])
def test_kernel_matches_twin_on_card(cuda_device, round_cases, name):
    """The kernel on the card against the torch round on the same CUDA
    tensors (the cell's shape, f32, rows of pads and repeats): bit for
    bit on the integer rows, else as ``nnd_host.agreement`` holds them;
    one kernel count a round, two launches bit-equal."""
    inp, exact = round_cases[name]
    inp = {key: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for key, v in inp.items()}
    before = ndops.launch_counts()["kernel"]
    ok, detail = nnd_host.run_case(ndops.nndescent_round, inp, exact)
    again = ndops.nndescent_round(**inp)
    first = ndops.nndescent_round(**inp)
    torch.cuda.synchronize()
    assert ok, detail
    assert ndops.launch_counts()["kernel"] == before + 3
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])


@pytest.mark.gpu
def test_kernel_mesh_ranks_sum_to_the_round_on_card(cuda_device,
                                                    round_cases):
    inp, _ = round_cases["ints_k12_rho05_bf16_d28"]
    inp = {key: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for key, v in inp.items()}
    for size in (2, 4):
        ok, detail = nnd_host.run_mesh(ndops.nndescent_round, inp, size)
        assert ok, detail


@pytest.mark.gpu
def test_kernel_route_matches_jax_on_card(cuda_device):
    """A refine at the cell's shape on the card, every round on the
    kernel, against the JAX package's refine of the same graph with the
    same draws: ids equal on the columns clear of their row neighbours
    by TIE_REL, distances to D_RTOL where the ids agree, inf where JAX
    has inf."""
    rec = np.load(FIXTURE)
    on = {key: torch.from_numpy(rec[key]).to(cuda_device)
          for key in ("x", "indices", "dists", "uniforms")}
    ndops.reset_launch_counts()
    gi, gd = tnd.nndescent_refine(on["x"], on["indices"], on["dists"],
                                  uniforms=list(on["uniforms"]), **KNOBS)
    assert ndops.launch_counts() == {"kernel": KNOBS["n_rounds"],
                                     "torch": 0}
    gi, gd = gi.cpu().numpy(), gd.cpu().numpy()
    ji, jd = rec["jax_indices"], rec["jax_dists"]
    clear = nnd_host._clear_ties(jd)
    np.testing.assert_array_equal(gi[clear], ji[clear])
    same = (gi == ji) & np.isfinite(jd)
    np.testing.assert_allclose(gd[same], jd[same], rtol=nnd_host.D_RTOL)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(jd))
