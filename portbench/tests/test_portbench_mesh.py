"""The mesh branch of a run (``mesh.py``) on the CPU: two ranks over
gloo at the tiny size, the harness's look for cards skipped.  A sound
run is correct with its ranks equal and each helper taking every embed
rank 0 took; a rank whose embedding differs, and the mesh's own fault
(the half-sweep's exchange left out, planted on every rank by
``calibrate``), are not correct; a helper killed in the window ends the run with an error and
no result.  The four-card cell ``higgs11m.mesh4`` is not in
BENCHMARK.json (its runs on four H100s spread too widely for
``embed_s``'s bound; PERF.md section 7): its files are in place, and
these tests add its entry to a copy of BENCHMARK.json, with two chips
where the mesh runs on the CPU."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import calibrate, faults, harness, mesh, tracing
from portbench.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "higgs11m.mesh4"
#: the cell's entry in BENCHMARK.json, and its per-layer readers'
ENTRY = {"name": CELL, "config": "higgs11m", "traffic": "mesh4", "chips": 4,
         "why": "the 11M table on one host's four H100s, sharded"}
READERS = ("knn_s", "knn.quantize_s", "knn.nndescent_s", "projection_s",
           "optimize_s", "host_rng_s", "device.idle_share")
COLLECTIVE = {"name": "mesh.collective_s", "unit": "s", "better": "lower",
              "source": "device_trace", "layer": "parallel",
              "moves": "embed_s", "workloads": [CELL]}
#: the tiny size, without the warm-up (each CPU embed on the mesh costs
#: seconds of gloo gathers)
OVER = {**tiny(CELL), "warmup_rows": 0}
SEED = 2 ** 33 + 21


def _checkout(top: Path, chips: int) -> Path:
    """A checkout whose BENCHMARK.json holds the cell on ``chips`` cards:
    its entry, ``embed_s`` and the per-layer readers' lists, and
    ``mesh.collective_s``."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    bench["workloads"].append({**ENTRY, "chips": chips})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("embed_s",) + READERS:
            m["workloads"].append(CELL)
    bench["per_layer"].append(COLLECTIVE)
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    (top / "portbench").symlink_to(ROOT / "portbench")
    return top


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The cell on two ranks, as the CPU runs it."""
    return _checkout(tmp_path_factory.mktemp("mesh_root"), 2)


def _run(root, log=None):
    return harness.run_cell(root, CELL, SEED, 0.0, False, 0.0, device="cpu",
                            overrides=OVER, log=log or (lambda m: None))


def test_sound_run_is_correct_and_its_ranks_agree(root):
    msgs = []
    out = _run(root, log=msgs.append)
    assert out["correct"], out["compared"]
    assert out["compared"]["rank_mismatch"] == [0, 0]
    assert out["device"]["count"] == 2
    assert list(out)[-1] == "compared"
    # the stop message: the helper took as many embeds as rank 0
    counts = [int(m.group(1)) for m in
              (re.search(r"rank \d embedding \w+ graph \w+ after (\d+) "
                         r"embeds", s) for s in msgs) if m]
    assert counts == [out["attempted"]] * 2


def test_a_rank_whose_embedding_differs_is_counted(root):
    # planted in this process only: rank 0's embedding alone is shifted
    with faults.planted("embedding"):
        out = _run(root)
    assert out["compared"]["rank_mismatch"] == [1, 0]
    assert not out["correct"]


def test_calibrate_on_the_mesh_catches_exchange_dropped(root):
    recs = {r["reading"]: r for r in calibrate.calibrate(
        root, CELL, [SEED], [], ["exchange_dropped"], device="cpu",
        overrides=OVER, emit=lambda rec: None)}
    sound, dropped = recs["sound"], recs["exchange_dropped"]
    assert sound["correct"] and sound["rank_mismatch"] == 0, sound
    assert not dropped["correct"], dropped
    # every rank keeps its own block: the ranks part, and most rows stay
    # where the optimizer started them
    assert dropped["rank_mismatch"] == 1
    assert dropped["embed_impurity"] > harness.Cell.load(
        root, CELL).limits["embed_impurity"]
    assert not recs["altered_embedding"]["correct"]


def test_a_helper_killed_in_the_window_ends_the_run(root):
    code = ("import json\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"out = harness.run_cell(Path({str(root)!r}), {CELL!r}, 11, 600.0,"
            f" False, 0.0, device='cpu', overrides={json.dumps(OVER)})\n"
            "print('RESULT', json.dumps(out))\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines, started = [], threading.Event()

    def read():
        for line in p.stderr:
            lines.append(line)
            if "the window starts" in line:
                started.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert started.wait(300), "".join(lines)
        pid = int(re.search(r"rank 1 pid (\d+)", "".join(lines)).group(1))
        time.sleep(1.0)
        t0 = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        out, _ = p.communicate(timeout=120)
        assert time.perf_counter() - t0 < 60
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    reader.join(10)
    assert p.returncode != 0
    assert "RESULT" not in out
    assert any("rank 1 ended" in s for s in lines), "".join(lines[-20:])


def test_rows_checksum_sees_one_bit():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = x.copy()
    assert mesh.digest(x) == mesh.digest(y)
    y[2, 3] = np.nextafter(y[2, 3], np.float32(100))
    assert mesh.digest(x) != mesh.digest(y)
    assert mesh.digest(x) != mesh.digest(x.reshape(4, 3))
    assert mesh.digest(x) != mesh.digest(x.astype(np.float64))


def test_peak_is_the_fullest_rank_and_mismatch_counts_helpers():
    assert mesh.largest_peak([3, 9, 5, 7]) == 9
    assert mesh.largest_peak([None, None]) is None
    sums = [("a", "g", 2), ("a", "g", 2), ("b", "g", 2), ("a", "h", 2)]
    assert mesh.mismatches(sums) == 2


def test_collective_reader_takes_the_union_of_nccl_kernels():
    read = harness.load_file(ROOT / "portbench", "metrics",
                             "mesh.collective_s").read
    trace = tracing.Trace(
        device=[("ncclDevKernel_AllGather_RING_LL", 10, 20),
                ("ncclDevKernel_AllReduce_Sum_f32", 15, 40),
                ("sweeps_kernel", 0, 100)],
        host=[], window_s=30e-9, t0_ns=0, t1_ns=30)
    run = harness.Run(config={}, mix={}, n=0, infos=[], window_s=0.0,
                      setup_s=0.0, peak_bytes=None, reference={},
                      trace=trace)
    assert abs(read(run) - 20e-9) < 1e-15
    trace.device = trace.device[2:]
    assert read(run) is None


def test_four_card_cell_resolves(tmp_path):
    root = _checkout(tmp_path, 4)
    bench = harness.load_json(root / "BENCHMARK.json")
    assert harness.chips_of(root, CELL) == 4
    cell = harness.Cell.load(root, CELL)
    hier = harness.Cell.load(ROOT, "higgs11m.hier")
    assert cell.config == hier.config
    assert cell.limits == {**hier.limits, "rank_mismatch": 0}
    per = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert per == set(READERS) | {"mesh.collective_s"}
    assert not any("roofline" in m for m in per)
    e2e = {m["name"] for m in harness.metrics_of(bench, CELL, False)}
    assert e2e == {"embed_s", "peak_gib", "setup_s"}
    for m in per | e2e:
        assert callable(harness.load_file(cell.base, "metrics", m).read)
