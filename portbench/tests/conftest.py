"""Shared fixtures of the benchmark's own tests (not collected by the
repository's ``pytest tests/``)."""

from __future__ import annotations

import pytest

#: each configuration cut to a size a CPU test run holds, on its own
#: path: the Higgs cells keep the IVF build by a low brute_force_limit,
#: the MNIST cells their exact graph
TINY = {"higgs11m": {"rows": 3000, "warmup_rows": 1200,
                     "check": {"rows": 800, "recall_rows": 300},
                     "knn_params": {"brute_force_limit": 1000},
                     "embed": {"batch": 20}},
        "mnist70k": {"rows": 2000, "warmup_rows": 600,
                     "check": {"rows": 800, "recall_rows": 300},
                     "embed": {"batch": 30}}}


def tiny(cell: str) -> dict:
    """The tiny overrides of ``cell``'s configuration."""
    return TINY[cell.split(".")[0]]


@pytest.fixture
def card():
    """Skips the test without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
