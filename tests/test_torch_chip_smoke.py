"""chip_smoke.py's reference margins, checked on the CPU against the
readings they must tell apart (PERF.md section 6): phase 5's dense
bench margins admit every H100 reading of the dense optimizer over PRs
2-5 and the JAX seeds, and reject the sampling optimizer's readings on
the same rows; phase 12's knob references sit where their readings
are."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)


def _blobs_ok(no_match):
    return abs(no_match - cs.JAX_NO_MATCH) / cs.JAX_NO_MATCH <= cs.NO_MATCH_REL


def _manifold_ok(mean_matched):
    return abs(mean_matched - cs.JAX_MANIFOLD_MEAN_MATCHED) <= \
        cs.MANIFOLD_MATCHED_ABS


@pytest.mark.parametrize("no_match", [57_183, 57_717, 57_647, 57_436,
                                      57_335, 57_451])
def test_phase5_admits_the_dense_readings(no_match):
    assert _blobs_ok(no_match)


@pytest.mark.parametrize("mean_matched", [5.1574, 5.1807, 5.17503, 5.18])
def test_phase5_admits_the_dense_manifold_readings(mean_matched):
    assert _manifold_ok(mean_matched)


@pytest.mark.parametrize("no_match, mean_matched", [
    (54_936, 4.8284), (55_212, 4.8561), (55_037, 4.8325)])
def test_phase5_rejects_the_sampling_readings(no_match, mean_matched):
    assert not _blobs_ok(no_match)
    assert not _manifold_ok(mean_matched)


def test_phase12_references_cover_every_knob():
    from annembed_tpu_torch import bench
    assert set(cs.JAX_KNOB_NO_MATCH) == set(bench.DENSE_KNOBS)
