"""The port's Higgs harness (``annembed_tpu_torch.examples.higgs``)
against the JAX package's (examples/higgs.py), on the CPU.

* the same flags with the same defaults (the port adds ``--device``),
  and the same ``parse_schedule``;
* its result line has the keys of the JAX package's 11M record
  (artifacts/higgs11m_r5.json), top level, first step and quality,
  on 5,000 synthetic rows with ``brute_force_limit`` lowered so both
  graphs go through the IVF build;
* the same command again loads the projection and the embedding from
  the caches, runs neither optimize step and gives equal quality fields;
* ``--csv`` reads a csv whose first column is the label.
"""

import argparse
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import annembed_tpu_torch as ta
from annembed_tpu_torch.examples import higgs

ROOT = Path(__file__).resolve().parent.parent
R5 = json.loads((ROOT / "artifacts" / "higgs11m_r5.json").read_text())


class _Parsed(Exception):
    pass


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_higgs_harness", ROOT / "examples" / "higgs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flags_and_defaults_match_the_jax_harness(monkeypatch):
    """The JAX harness's namespace with no arguments (its parser is built
    inside ``main``; parsing is stopped before any work)."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(argparse.ArgumentParser.parse_known_args(
            self, [], namespace)[0])
    jax_mod = _jax_harness()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        jax_mod.main()
    monkeypatch.undo()
    want = vars(got.value.args[0])
    mine = vars(higgs._parser().parse_args([]))
    assert mine.pop("device") == "cuda"
    assert mine == want
    for spec, batch, n_sub in (("auto", 60, 120), ("auto", 40, 60),
                               ("30x60,30x120", 60, 120), ("none", 1, 1),
                               ("", 1, 1)):
        assert higgs.parse_schedule(spec, batch, n_sub) == \
            jax_mod.parse_schedule(spec, batch, n_sub)


def _run(monkeypatch, capsys, argv):
    """``main(argv)`` with both graphs above a lowered brute_force_limit;
    returns (result record, the ``port:`` stderr record)."""
    monkeypatch.setattr(ta, "KnnParams", functools.partial(
        ta.KnnParams, brute_force_limit=1000))
    assert higgs.main(argv) == 0
    out, err = capsys.readouterr()
    port = next(json.loads(line[len("port: "):])
                for line in err.splitlines() if line.startswith("port: "))
    return json.loads(out.strip().splitlines()[-1]), port


def test_result_keys_match_r5_and_the_rerun_resumes(tmp_path, monkeypatch,
                                                    capsys):
    argv = ["--synthetic", "5000", "--device", "cpu", "--batch", "4",
            "--n-sub", "12", "--gather-reuse", "8", "--quality",
            "--quality-fraction", "0.5", "--json", "--out", "none",
            "--data-cache", str(tmp_path / "x.npy"),
            "--graph-cache", str(tmp_path / "proj"),
            "--embed-cache", str(tmp_path / "emb")]
    rec, port = _run(monkeypatch, capsys, argv)
    assert set(rec) == set(R5)
    assert set(rec["first_step"]) == set(R5["first_step"])
    assert set(rec["quality"]) == set(R5["quality"])
    assert rec["gather_reuse"] == rec["first_step"]["gather_reuse"] == 8
    assert rec["n"] == 5000 and rec["recall@6"] > 0.9
    assert set(port["checkpoints"]) == {"graph_save_s", "embedding_save_s"}
    assert "large_graph/ivf_join" in port["graph_build_phases"]
    again, port2 = _run(monkeypatch, capsys, argv)
    assert set(port2["checkpoints"]) == {"graph_load_s", "embedding_load_s"}
    assert "first_step" not in again and "optimize_time" not in again
    assert again["quality"] == rec["quality"]
    assert again["recall@6"] == rec["recall@6"]


def test_csv_rows_drop_the_label_column(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 28)).astype(np.float32)
    rows = np.column_stack([rng.integers(0, 2, 400), x])
    src = tmp_path / "HIGGS.csv"
    np.savetxt(src, rows, delimiter=",", fmt="%.6e")
    rec, _ = _run(monkeypatch, capsys, [
        "--csv", str(src), "--device", "cpu", "--batch", "2",
        "--n-sub", "6", "--fraction", "0.2", "--recall-sample", "100",
        "--out", str(tmp_path / "e.csv")])
    assert rec["n"] == 400 and "quality" not in rec
    assert np.loadtxt(tmp_path / "e.csv", delimiter=",").shape == (400, 2)
