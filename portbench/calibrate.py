"""The readings that the limits of the check are set from, at a cell's
own size: for each seed, the program's sound embed, each planted fault
that needs an embed of its own (``unchanged``, ``half``,
``kicks_dropped``, ``sweeps_skipped``), the faults that alter an answer
where it is produced (``graph``, ``projection``, ``embedding``, applied
to the sound embed's outputs as the program would have returned them),
and the controls: the reference's own search at a lower precision put
in the program's place for the graph and the projection, and the
program's dense optimizer with its state held in bfloat16
(``bf16_sweeps``, see ``faults.py``) for the embedding.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \
        [--controls tf32 bfloat16 fp8] \
        [--faults unchanged half kicks_dropped sweeps_skipped bf16_sweeps]

One JSON line a seed and reading on standard output.  Not part of a
benchmark run: the benchmark's runs never plant a fault or run a
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import faults, harness
from .reference.judge import Reference


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def altered(kind: str, judged: tuple) -> tuple:
    """The sound embed's outputs with the answer ``kind`` altered as
    ``faults.planted(kind)`` alters it where it is produced."""
    y, (ids, dists), proj, full = judged
    if kind == "graph":
        ids = faults.wrong_neighbour(ids, y.shape[0])
    elif kind == "projection":
        sample_ids, p_idx, p_dist = proj
        proj = (sample_ids, faults.next_sampled(p_idx, sample_ids.shape[0]),
                p_dist)
    elif kind == "embedding":
        y = faults.shifted(torch.from_numpy(y)).numpy()
    return y, (ids, dists), proj, full


def reading_name(kind: str) -> str:
    return f"control_{kind}" if kind in faults.CONTROLS else kind


def calibrate(root: Path, name: str, seeds, controls, embed_faults,
              device: str = "cuda", overrides=None, emit=None):
    """Every reading of every seed, as a list of dicts."""
    import annembed_tpu_torch as at
    emit = emit or (lambda rec: print(json.dumps(rec), flush=True))
    out = []
    warmed = False
    for seed in seeds:
        cell, x_host, labels, kw = harness.prepare(root, name, seed, device,
                                                   overrides)
        rows = harness.check_rows(x_host.shape[0],
                                  cell.config["check"]["rows"], seed)
        capture = harness.Capture()
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            try:
                if warmed:
                    cell.config["warmup_rows"] = 0
                kw = harness.set_up(cell, x_host, kw, tmp, _log)
                warmed = True
                judged = {}
                for kind in ("sound", *embed_faults):
                    capture.clear()
                    t0 = time.perf_counter()
                    if kind == "sound":
                        y, info = at.embed(x_host, **kw)
                    else:
                        with faults.planted(kind):
                            y, info = at.embed(x_host, **kw)
                    judged[reading_name(kind)] = harness.outputs(
                        y, info, capture, rows)
                    _log(f"calibrate {name} seed {seed}: {kind} embed "
                         f"{time.perf_counter() - t0:.3f} s")
                    del y, info
                    capture.clear()
                    harness.free_device(device)
            finally:
                capture.close()
        t0 = time.perf_counter()
        ref = Reference(cell.judged_config(), x_host, labels, rows, device)
        _log(f"calibrate {name} seed {seed}: exact search "
             f"{time.perf_counter() - t0:.3f} s")
        sound = judged["sound"]
        cases = [(k, judged[k]) for k in judged]
        cases += [(f"altered_{k}", altered(k, sound))
                  for k in ("graph", "projection", "embedding")
                  if k != "projection" or sound[2] is not None]
        for kind, j in cases:
            t0 = time.perf_counter()
            rec = {"workload": name, "seed": seed, "reading": kind,
                   **harness.readings_of(ref, *j)}
            rec["seconds"] = time.perf_counter() - t0
            out.append(rec)
            emit(rec)
        for precision in controls:
            t0 = time.perf_counter()
            y, graph, proj, full = sound
            graph = ref.control_graph(precision)
            if proj is not None:
                proj = (proj[0], *ref.control_projection(proj[0], precision))
            rec = {"workload": name, "seed": seed,
                   "reading": f"control_{precision}",
                   **harness.readings_of(ref, y, graph, proj, full)}
            rec["seconds"] = time.perf_counter() - t0
            out.append(rec)
            emit(rec)
        ref.close()
        del ref, judged, sound, cases, x_host
        harness.free_device(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=["tf32"])
    p.add_argument("--faults", nargs="*",
                   default=["unchanged", "half", "kicks_dropped",
                            "sweeps_skipped", "bf16_sweeps"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    calibrate(Path.cwd(), args.workload, args.seeds, args.controls,
              args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
