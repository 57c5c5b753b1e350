"""The readings that the limits of the check are set from, at a cell's
own size: for each seed, the program's sound embed, each planted fault
that needs an embed of its own (``unchanged``, ``half``,
``kicks_dropped``, ``sweeps_skipped``), the faults that alter an answer
where it is produced (``graph``, ``projection``, ``embedding``, applied
to the sound embed's outputs as the program would have returned them),
and the controls: the reference's own search at a lower precision put
in the program's place for the graph and the projection, and the
program's dense optimizer with its state held in bfloat16
(``bf16_sweeps``, see ``faults.py``) for the embedding.  A cell on
more than one card runs on a mesh (``mesh.spmd``): every fault is
planted on every rank, and each embed also reads ``rank_mismatch``.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \
        [--controls tf32 bfloat16 fp8] \
        [--faults unchanged half kicks_dropped sweeps_skipped bf16_sweeps
                  graph projection embedding exchange_dropped]

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

from . import faults, harness, mesh
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
    """Every reading of every seed, as a list of dicts.  A cell on more
    than one card runs on a mesh of that many ranks (``mesh.spmd``), each
    fault planted on every rank, and reads ``rank_mismatch`` of each
    embed."""
    import annembed_tpu_torch as at
    emit = emit or (lambda rec: print(json.dumps(rec), flush=True))
    world = harness.chips_of(root, name)
    if world > 1:
        return mesh.spmd(_on_ranks, root, world,
                         dict(name=name, seeds=list(seeds),
                              controls=list(controls),
                              embed_faults=list(embed_faults), device=device,
                              overrides=overrides),
                         device, _log, emit=emit)
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
        out += _judge(cell, seed, x_host, labels, rows, judged, {}, controls,
                      device, emit)
        del judged, x_host
        harness.free_device(device)
    return out


def _on_ranks(rank, root: Path, name: str, seeds, controls, embed_faults,
              device: str, overrides, log, emit=None) -> list:
    """``calibrate`` on one rank of a mesh: every rank makes each embed,
    with the same fault planted; rank 0 judges them."""
    out = []
    for i, seed in enumerate(seeds):
        cell, x_host, labels, kw = rank.prepare(root, name, seed, overrides)
        w = min(int(cell.config["warmup_rows"]), x_host.shape[0])
        if i == 0 and w > 0:
            rank.embed(x_host[:w], kw)
        rows = harness.check_rows(x_host.shape[0],
                                  cell.config["check"]["rows"], seed)
        capture = harness.Capture() if rank.rank == 0 else None
        judged, mismatch = {}, {}
        try:
            for kind in ("sound", *embed_faults):
                t0 = time.perf_counter()
                (y, info), _ = rank.embed(x_host, kw,
                                          None if kind == "sound" else kind)
                m = mesh.mismatches(rank.sums(y, info))
                if capture:
                    judged[reading_name(kind)] = harness.outputs(
                        y, info, capture, rows)
                    mismatch[reading_name(kind)] = {"rank_mismatch": m}
                    capture.clear()
                    log(f"calibrate {name} seed {seed}: {kind} embed "
                        f"{time.perf_counter() - t0:.3f} s")
                del y, info
                harness.free_device(device)
        finally:
            if capture:
                capture.close()
        if capture:
            out += _judge(cell, seed, x_host, labels, rows, judged, mismatch,
                          controls, device, emit)
    return out


def _judge(cell, seed: int, x_host, labels, rows, judged: dict,
           mismatch: dict, controls, device: str, emit) -> list:
    """The reference's readings of one seed's embeds (``judged``, with
    ``mismatch``'s readings beside them), the answers altered where they
    are produced, and the controls."""
    name = cell.name
    t0 = time.perf_counter()
    ref = Reference(cell.judged_config(), x_host, labels, rows, device)
    _log(f"calibrate {name} seed {seed}: exact search "
         f"{time.perf_counter() - t0:.3f} s")
    sound = judged["sound"]
    cases = [(k, judged[k]) for k in judged]
    cases += [(f"altered_{k}", altered(k, sound))
              for k in ("graph", "projection", "embedding")
              if k != "projection" or sound[2] is not None]
    out = []

    def record(kind, readings, extra):
        rec = {"workload": name, "seed": seed, "reading": kind, **readings,
               **extra}
        rec["seconds"] = time.perf_counter() - t0
        rec["correct"] = harness.is_correct(harness.compared(rec,
                                                             cell.limits))
        out.append(rec)
        emit(rec)

    for kind, j in cases:
        t0 = time.perf_counter()
        record(kind, harness.readings_of(ref, *j), mismatch.get(kind, {}))
    for precision in controls:
        t0 = time.perf_counter()
        y, graph, proj, full = sound
        graph = ref.control_graph(precision)
        if proj is not None:
            proj = (proj[0], *ref.control_projection(proj[0], precision))
        record(f"control_{precision}",
               harness.readings_of(ref, y, graph, proj, full),
               mismatch.get("sound", {}))
    ref.close()
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
