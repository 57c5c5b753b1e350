#!/usr/bin/env python3
"""Bit-reproducibility and first-call time of the k-means update on the
card, three ways, each in a fresh process.

    python3 tools/torch_kmeans_repro.py

On 500,000 ``synthetic_higgs`` rows (seed 7, z-scored), ``kmeans_fit``
with 2,828 cells and 10 iterations three times (seconds each, the first
call paying the process's set-up), then whether two more calls give the
same centroids bit for bit, for the segment sums of
``knn/kmeans.py::_segment_sum`` (``segment_reduce`` of the rows sorted
by cell, the port's), a plain CUDA ``index_add_`` (atomics), and
``index_add_`` under ``torch.use_deterministic_algorithms``.  Needs
CUDA.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
VARIANTS = ("segment", "index_add", "deterministic")


def _index_add(x, cells, k):
    return torch.zeros((k, x.shape[1]), device=x.device).index_add_(0, cells,
                                                                    x)


def _deterministic(x, cells, k):
    torch.use_deterministic_algorithms(True)
    try:
        return _index_add(x, cells, k)
    finally:
        torch.use_deterministic_algorithms(False)


def run(variant: str) -> None:
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    from annembed_tpu_torch.knn import kmeans as km
    x = torch.from_numpy(zscore(synthetic_higgs(500_000, seed=7))).cuda()
    if variant == "index_add":
        km._segment_sum = _index_add
    elif variant == "deterministic":
        km._segment_sum = _deterministic
    torch.cuda.synchronize()
    for i in range(3):
        t0 = time.perf_counter()
        km.kmeans_fit(x, 2828, n_iter=10, seed=0)
        torch.cuda.synchronize()
        print(f"{variant}: call {i} {time.perf_counter() - t0:.3f} s",
              flush=True)
    a = km.kmeans_fit(x, 2828, n_iter=10, seed=0)[0]
    b = km.kmeans_fit(x, 2828, n_iter=10, seed=0)[0]
    print(f"{variant}: bit-equal across calls: {torch.equal(a, b)}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kmeans_repro: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return 0
    for v in VARIANTS:
        subprocess.run([sys.executable, __file__, v], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
