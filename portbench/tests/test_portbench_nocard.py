"""A run without a card, or without the program beside the benchmark,
fails and prints no result: it never falls back to the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["-m", "portbench.run", "--workload", "mnist70k.dense", "--seed",
        "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_benchmark_alone_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    p = _run(tmp_path, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "No module named 'annembed_tpu_torch'" in p.stderr
