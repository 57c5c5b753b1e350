"""BENCHMARK.json against the benchmark's contract, and every file a
cell needs found by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    assert all(".." not in w and not w.startswith("/") for w in cmd)


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_all_names()),
                         ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_names_and_units_legal(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in ("why", "layer", "source"):
        if key in entry and group != "end_to_end":
            assert LINE.match(entry[key]), (key, entry[key])
    if group == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    if any("roofline" in m["name"] for m in BENCH["per_layer"]):
        for m in BENCH["per_layer"]:
            if "roofline" in m["name"]:
                assert m["unit"] == "%" and m["name"].split(".")[0].endswith(
                    "_roofline")


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = harness.metrics_of(BENCH, w["name"], False)
        per = harness.metrics_of(BENCH, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per


def test_configs_used_and_files_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / "portbench" / "data" /
                f"{cfg['generator']}.py").is_file()
    for w in BENCH["workloads"]:
        cell = harness.Cell.load(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert cell.limits
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = harness.load_file(ROOT / "portbench", "metrics", m["name"])
        assert callable(mod.read)


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_a_cell_is_added_by_new_files_and_entries(tmp_path):
    """A configuration, a mix, a metric and limits added as new files
    plus entries in BENCHMARK.json; no file that is there is edited,
    and the harness runs the new cell and reports the new metric."""
    from portbench.tests.conftest import tiny
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "portbench"
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "portbench/configs/higgs11m.json").read_text())
    cfg.update(name="dummy", embed=dict(cfg["embed"], layer=0))
    (base / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (base / "traffic" / "dummymix.json").write_text(json.dumps(
        {"name": "dummymix", "why": "a test", "params": {"n_sub": 12}}))
    (base / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return 41.0 + run.embeds\n")
    limits = json.loads((base / "limits" / "higgs11m.hier.json").read_text())
    (base / "limits" / "dummy.dummymix.json").write_text(json.dumps(limits))
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="portbench/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy.dummymix", "config": "dummy",
                               "traffic": "dummymix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_metric", "unit": "s",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["dummy.dummymix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    out = harness.run_cell(tmp_path, "dummy.dummymix", 5, 0.0, False, 0.0,
                           device="cpu", overrides=tiny("higgs11m"))
    assert out["metrics"]["dummy_metric"]["value"] == 42.0
    assert "setup_s" in out["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_missing_or_nonfinite_reading_is_not_correct():
    limits = {"knn_miss": 0.1, "proj_miss": 0.0}
    assert harness.is_correct(harness.compared(
        {"knn_miss": 0.05, "proj_miss": 0.0}, limits))
    assert not harness.is_correct(harness.compared({"knn_miss": 0.05},
                                                   limits))
    comp = harness.compared({"knn_miss": float("nan"), "proj_miss": 0.0},
                            limits)
    assert comp["knn_miss"] == [None, 0.1]
    assert not harness.is_correct(comp)
