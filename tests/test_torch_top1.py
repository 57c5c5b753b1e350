"""The arithmetic of the CUDA top-1 kernel (csrc/top1_l2.cu), emulated on
the CPU, against the JAX package's Pallas kernel in interpret mode and
against the port's f32 twin; and the build key of the kernel sources.

The kernel forms q.c on the tensor cores from TF32 halves ("3xTF32"):
hi = tf32_rna(x), lo = tf32_rna(x - hi), q.c ~ lo.hi + hi.lo + hi.hi,
then d^2 = fma(-2, q.c, |q|^2 + |c|^2), a strict-< running argmin in
corpus order (ties to the lowest index) and sqrt(max(d^2, 0)).  The
emulation below rounds to TF32 by bit operations on the int32 view, as
``cvt.rna.tf32.f32`` does, and sums the three products in f32; each
product of two TF32 values is exact in f32.  Tolerances are
chip_smoke.py's: indices equal outside near-ties (best and second-best
d^2 closer than TIE_REL of |q|^2 + |c|^2), d^2 within D2_REL of it.
"""

import numpy as np
import pytest
import torch

from annembed_tpu.ops.top1 import top1_l2 as j_top1
from annembed_tpu_torch.io.synthetic import (synthetic_blobs,
                                             synthetic_higgs, zscore)
from annembed_tpu_torch.ops import _build
from annembed_tpu_torch.ops.top1 import top1_l2_reference

TIE_REL = 1e-5
D2_REL = 1e-5


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (10 explicit mantissa bits), to nearest, ties away
    from zero: add half of the dropped 13 bits to the magnitude, then
    clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def split3(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulate_kernel(q: np.ndarray, c: np.ndarray):
    """(idx int32, dist f32) as the kernel computes them."""
    qh, ql = split3(q)
    ch, cl = split3(c)
    cross = (ql @ ch.T + qh @ cl.T) + qh @ ch.T           # f32 sums
    base = (np.square(q).sum(1, dtype=np.float32)[:, None]
            + np.square(c).sum(1, dtype=np.float32)[None, :])
    d2 = (base.astype(np.float64) - 2.0 * cross).astype(np.float32)  # fma
    idx = np.argmin(d2, axis=1)                           # first = lowest
    best = d2[np.arange(len(q)), idx]
    return idx.astype(np.int32), np.sqrt(np.maximum(best, 0.0))


def exact_top2(q: np.ndarray, c: np.ndarray):
    """Best and second-best d^2 in f64, and the expansion's scale."""
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    qn, cn = np.square(q64).sum(1), np.square(c64).sum(1)
    d2 = qn[:, None] + cn[None, :] - 2.0 * q64 @ c64.T
    order = np.argsort(d2, axis=1, kind="stable")[:, :2]
    top2 = np.take_along_axis(d2, order, axis=1)
    return top2, qn + cn[order[:, 0]]


def assert_agree(a, b, q, c, what):
    (ai, ad), (bi, bd) = a, b
    ai, bi = np.asarray(ai), np.asarray(bi)
    ad, bd = np.asarray(ad, np.float64), np.asarray(bd, np.float64)
    top2, scale = exact_top2(q, c)
    clear = (top2[:, 1] - top2[:, 0]) > TIE_REL * scale
    bad_idx = int(((ai != bi) & clear).sum())
    bad_d2 = int((np.abs(ad ** 2 - bd ** 2) > D2_REL * scale).sum())
    assert bad_idx == 0, f"{what}: {bad_idx} index mismatches outside ties"
    assert bad_d2 == 0, f"{what}: {bad_d2} squared distances beyond D2_REL"


def _higgs(nq, m, seed):
    x = zscore(synthetic_higgs(nq + m, seed=seed))
    return x[:nq], x[nq:]


def _blobs(nq, m, seed):
    x = synthetic_blobs(nq + m, 784, seed).astype(np.float32)
    return x[:nq], x[nq:]


def _offset(nq, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, 5)).astype(np.float32),
            rng.normal(size=(m, 5)).astype(np.float32) + 10.0)


DATA = {"higgs_d28": (_higgs, 300, 700), "blobs_d784": (_blobs, 120, 260),
        "offset_d5": (_offset, 77, 131)}


@pytest.mark.parametrize("name", sorted(DATA))
def test_emulated_kernel_matches_pallas_interpret(name):
    make, nq, m = DATA[name]
    q, c = make(nq, m, 3)
    j_out = j_top1(q, c, block_q=64, tile_m=128, interpret=True)
    assert_agree(emulate_kernel(q, c), j_out, q, c, f"{name}: emulation "
                 "vs Pallas interpret")


@pytest.mark.parametrize("name", sorted(DATA))
def test_emulated_kernel_matches_twin(name):
    make, nq, m = DATA[name]
    q, c = make(nq, m, 4)
    t_out = top1_l2_reference(torch.from_numpy(q), torch.from_numpy(c))
    assert_agree(emulate_kernel(q, c), (t_out[0].numpy(), t_out[1].numpy()),
                 q, c, f"{name}: emulation vs twin")


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = np.float32(2.0 ** -10)             # TF32's ulp at 1
    x = np.array([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -11 - 2.0 ** -20, 0.0, -0.0], np.float32)
    want = np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 0.0, -0.0],
                    np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got, want)
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    rng = np.random.default_rng(0)
    y = rng.normal(size=1000).astype(np.float32)
    hi, lo = split3(y)
    assert (np.abs(y - hi) <= np.abs(y) * 2.0 ** -11).all()
    assert (np.abs(y - hi - lo) <= np.abs(y) * 2.0 ** -21).all()


def test_three_products_hold_the_tolerance_one_does_not():
    """On z-scored d = 28 rows the 3xTF32 cross term stays inside D2_REL
    of |q|^2 + |c|^2, while plain TF32 (hi.hi alone) leaves it, which is
    why the kernel splits every operand."""
    q, c = _higgs(200, 400, 5)
    exact = q.astype(np.float64) @ c.astype(np.float64).T
    scale = (np.square(q.astype(np.float64)).sum(1)[:, None]
             + np.square(c.astype(np.float64)).sum(1)[None, :])
    qh, ql = split3(q)
    ch, cl = split3(c)
    three = (ql @ ch.T + qh @ cl.T) + qh @ ch.T
    one = qh @ ch.T
    assert (2.0 * np.abs(three - exact) / scale).max() < 0.1 * D2_REL
    assert (2.0 * np.abs(one - exact) / scale).max() > D2_REL


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A header edit must change the build's hash (no stale library), and
    a source that includes CuTe gets CUTLASS's include path when it is
    installed."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    files, uses_cutlass = _build.source_files("k")
    assert sorted(p.name for p in files) == ["a.cuh", "b.cuh", "k.cu"]
    assert not uses_cutlass
    before = _build.library_path("k")
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert _build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != before
    (tmp_path / "b.cuh").write_text("#include <cute/tensor.hpp>\n")
    monkeypatch.setattr(_build, "CUTLASS_INCLUDE", tmp_path)
    assert _build.source_files("k")[1]
    assert f"-I{tmp_path}" in _build.nvcc_flags("k")


def test_package_sources_are_keyed():
    """The shipped kernel's key covers its PTX helper header."""
    files, uses_cutlass = _build.source_files("top1_l2")
    assert sorted(p.name for p in files) == ["sm90_ptx.cuh", "top1_l2.cu"]
    assert not uses_cutlass
    assert "-Xptxas" in _build.nvcc_flags("top1_l2")
