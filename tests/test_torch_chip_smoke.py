"""chip_smoke.py's reference margins, checked on the CPU against the
readings they must tell apart (PERF.md section 6): phase 5's dense
bench margins admit every H100 reading of the dense optimizer over PRs
2-5 and the JAX seeds, and reject the sampling optimizer's readings on
the same rows; phase 12's knob references sit where their readings
are; the dense sweep's route check."""

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


# phases 4, 11, 13: the grid's radius rows against brute, bit for bit
def test_radius_rows_must_be_bit_equal():
    import torch
    a = torch.linspace(0.1, 3.0, 2_000)[:, None]
    assert cs.rows_bit_equal(a, a.clone())
    b = a.clone()
    b[1_234, 0] = torch.nextafter(b[1_234, 0], torch.tensor(10.0))
    assert not cs.rows_bit_equal(a, b)            # one ulp on one row
    assert not cs.rows_bit_equal(a, a[:1_999])


# phase 13: the full fraction within the band of phase 4's sampled
# reading; 3 binomial sd of 55,000 rows at ~0.947 is 0.0029, the stale
# gather's shift at S = 12 (+0.0235-0.0247, PERF.md section 5) is not
@pytest.mark.parametrize("full, ok", [
    (0.9474, True), (0.9474 + 0.0029, True), (0.9474 - 0.0029, True),
    (0.97087, False), (0.9474 + 0.0235, False), (0.9474 - 0.0060, False)])
def test_phase13_band(full, ok):
    assert cs.frac_within_band(full, 0.9474) is ok


# phase 14: the adaptive SVD's cluster modes against the fixed-rank SVD
# (10,000 blobs rows on the CPU: 2.3e-5 at diffusion time 32, 2.6e-4 at
# 16; 0.36-0.40 at time 1, where the one-pass finder misses the bulk)
@pytest.mark.parametrize("rel, ok", [(2.3e-5, True), (2.6e-4, True),
                                     (2e-3, False), (0.36, False)])
def test_phase14_adaptive_agreement(rel, ok):
    import torch
    ref = torch.ones(cs.ADAPTIVE_LEAD)
    s = ref.clone()
    s[-1] = 1.0 + rel
    assert (cs.singular_values_agree(s, ref) <= cs.ADAPTIVE_REL) is ok


# phase 15: the ranks' embeddings held bit-equal through a checksum
# all-gather; any one-bit change or a swap of two rows must show
def test_phase15_checksum_sees_one_bit_and_row_order():
    import torch
    y = torch.randn(1_000, 2, generator=torch.Generator().manual_seed(0))
    c = cs.rank_checksum(y)
    assert c == cs.rank_checksum(y.clone())
    flip = y.clone()
    flip.view(torch.int32)[417, 1] ^= 1             # the last mantissa bit
    swap = y.clone()
    swap[[3, 900]] = swap[[900, 3]]
    for other in (flip, swap):
        assert cs.rank_checksum(other) != c
    assert cs.checksums_agree([c, c, c, c])
    assert not cs.checksums_agree([c, c, cs.rank_checksum(flip), c])
    assert not cs.checksums_agree([])


# phase 15 (a): the sampled frac_without_match of the mesh run within
# +-0.005 of phase 4's (phase 11's band: 2.5x the spread of the S = 1
# readings 0.9461-0.9480, PERF.md section 5); (d): the full fraction of
# the same graph rebuild within 0.001
@pytest.mark.parametrize("frac, ok", [
    (0.9474, True), (0.9461, True), (0.9480, True), (0.9474 + 0.0049, True),
    (0.9474 - 0.0051, False), (0.97087, False)])
def test_phase15_sampled_band(frac, ok):
    assert cs.within_band(frac, 0.9474, cs.MESH_FRAC_ABS) is ok


@pytest.mark.parametrize("frac, ok", [
    (0.5, True), (0.5009, True), (0.4991, True), (0.5011, False),
    (0.498, False)])
def test_phase15_full_fraction_band(frac, ok):
    assert cs.within_band(frac, 0.5, cs.MESH_FULL_FRAC_ABS) is ok


def test_phase15_graph_agreement_ignores_near_ties_only():
    import torch
    d = torch.tensor([[1.0, 2.0, 3.0], [1.0, 1.0 + 1e-7, 2.0]])
    i = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    assert cs.graph_agreement(i, d, i, d) == (1.0, 0, 0.0)
    tie = i.clone()
    tie[1, [0, 1]] = tie[1, [1, 0]]                  # a near-tie swapped
    agree, rows, _ = cs.graph_agreement(tie, d, i, d)
    assert agree == 1.0 and rows == 1
    clear = i.clone()
    clear[0, 2] = 11                                 # a clear column
    assert cs.graph_agreement(clear, d, i, d)[0] < cs.MESH_GRAPH_AGREE


@pytest.mark.parametrize("counts, route, ok", [
    (dict(pair=0, persistent=13, persistent_sweeps=120), "persistent", True),
    (dict(pair=2, persistent=13, persistent_sweeps=120), "persistent", False),
    (dict(pair=0, persistent=0, persistent_sweeps=0), "persistent", False),
    (dict(pair=240, persistent=0, persistent_sweeps=0), "pair", True),
    (dict(pair=240, persistent=1, persistent_sweeps=2), "pair", False),
    (dict(pair=0, persistent=0, persistent_sweeps=0), None, True),
    (dict(pair=2, persistent=0, persistent_sweeps=0), None, False)])
def test_dense_route_check(counts, route, ok):
    """Each dense path's counts must show its route alone: whole arrays
    the persistent launch, node blocks and mesh ranks the pair, the
    row-major knob neither."""
    if ok:
        cs.require_route("path", counts, route)
    else:
        with pytest.raises(AssertionError, match="route"):
            cs.require_route("path", counts, route)


@pytest.mark.parametrize("joins, route, ok", [
    ({"tc": 2, "simt": 0}, "tc", True),
    ({"tc": 0, "simt": 0}, "tc", False),
    ({"tc": 2, "simt": 1}, "tc", False),
    ({"tc": 0, "simt": 3}, "simt", True),
    ({"tc": 1, "simt": 3}, "simt", False)])
def test_join_route_check(joins, route, ok):
    """Each IVF path's join counts must show the kernel the rule gives
    its shapes, and only that one."""
    if ok:
        cs.require_join_route("path", joins, route)
        cs.require_route("path", dict(pair=0, persistent=1,
                                      persistent_sweeps=9), "persistent",
                         joins, route)
    else:
        with pytest.raises(AssertionError, match="route"):
            cs.require_join_route("path", joins, route)

