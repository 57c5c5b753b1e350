"""Port scaffolding: parameter parity with the JAX package, and the
port's isolation from jax."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import annembed_tpu.params as jp
import annembed_tpu_torch.params as tp
from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["EmbedderParams", "DiffusionParams",
                                  "KnnParams"])
def test_params_fields_and_defaults_match(name):
    jf = [(f.name, f.default, repr(f.default_factory))
          for f in dataclasses.fields(getattr(jp, name))]
    tf = [(f.name, f.default, repr(f.default_factory))
          for f in dataclasses.fields(getattr(tp, name))]
    assert tf == jf, f"{name}: field names/defaults must equal the JAX ones"


def test_constants_match():
    assert tp.PROBA_MIN == jp.PROBA_MIN
    assert tp.FULL_SVD_SIZE_LIMIT == jp.FULL_SVD_SIZE_LIMIT


def test_port_imports_without_jax():
    """Importing the port, every module of it, with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import annembed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]"
        " or m.startswith('jax.') or m.startswith('annembed_tpu.')"
        " or m == 'annembed_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_synthetic_higgs_matches_example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from higgs import synthetic_higgs as ref
    finally:
        sys.path.remove(str(ROOT / "examples"))
    np.testing.assert_array_equal(synthetic_higgs(500, seed=7),
                                  ref(500, seed=7))
    z = zscore(synthetic_higgs(500))
    assert z.dtype == np.float32
    np.testing.assert_allclose(z.mean(0), 0.0, atol=1e-5)
