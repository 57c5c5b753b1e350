"""A run of a cell whose ``chips`` is above 1: the port's torchrun-style
entry, ``embed(x, mesh=make_mesh(W))``, on W ranks of one host.

Every rank runs the same task, in step (``spmd``).  The process that
``portbench.run`` starts is rank 0, on ``cuda:0``.  It starts W - 1
helper ranks, fresh interpreters running this module (never ``fork``),
on ``cuda:1..W-1``; they inherit the kernel caches' environment, and
rank 0 builds the program's kernels before any rank can load one.  Every
rank joins one NCCL group (the default group, over which
``make_mesh(W)`` runs the program) and one gloo group on the CPU for the
harness's own messages, both with a timeout of ``TIMEOUT_S``, makes the
rows from the seed on its own card and checks over gloo that they are
byte-equal to every other rank's.  Every rank runs the warm-up, the
window's embeds and the traced embed; after each embed of the window
rank 0 alone decides whether the window goes on, and tells the others.

What rank 0 reads: its own clock (``setup_s`` from its process start,
the window over the embeds it completed), the largest of the ranks'
peaks (each logged), its own trace and ``info`` (the per-layer readers)
and its own returned graph, projection and embedding, which the
reference judges on ``cuda:0`` once the helpers have exited.
``rank_mismatch`` counts the helpers whose last embedding (its float32
bytes) or returned graph differs from rank 0's.  A helper that ends
before the task does ends the run: rank 0 stops the others and exits 1.
Each helper ends itself if rank 0 goes.

    python3 -m portbench.mesh '<json>'    (a helper; started by spmd)
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import hashlib
import importlib
import inspect
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import faults, harness, tracing
from .reference.judge import Reference

#: seconds a rank waits for the others in a collective or at the start
TIMEOUT_S = 600
#: seconds rank 0 waits for a helper to end after the task
EXIT_S = 120
#: where ``python3 -m portbench.mesh`` finds the benchmark
_HOME = Path(__file__).resolve().parents[1]


def digest(*arrays) -> str:
    """A checksum of the arrays' dtypes, shapes and bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def largest_peak(peaks: list) -> Optional[int]:
    """The fullest card's peak; None where no rank read one (the CPU)."""
    known = [p for p in peaks if p is not None]
    return max(known) if known else None


def mismatches(sums: list) -> int:
    """Helper ranks whose (embedding, graph) checksums differ from rank
    0's; ``sums`` is in rank order."""
    return sum(s[:2] != sums[0][:2] for s in sums[1:])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _is_card(device: str) -> bool:
    return torch.device(device).type == "cuda"


class Rank:
    """One rank of the mesh: its card, its two groups, its embeds."""

    def __init__(self, rank: int, world: int, device: str, port: int):
        from annembed_tpu_torch.parallel.sharded import make_mesh
        self.rank, self.world = rank, world
        self.device = f"cuda:{rank}" if device == "cuda" else device
        self.threads = torch.get_num_threads()
        self.embeds = 0
        kw, backend = {}, "gloo"
        if _is_card(self.device):
            torch.cuda.set_device(rank)
            backend = "nccl"
            if "device_id" in inspect.signature(
                    dist.init_process_group).parameters:
                # eager communicator set-up: a failing NCCL init raises here
                kw["device_id"] = torch.device(self.device)
        else:
            # the CPU ranks share the host's cores, each on one thread,
            # so that they also round alike
            torch.set_num_threads(1)
        td = datetime.timedelta(seconds=TIMEOUT_S)
        dist.init_process_group(backend, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, timeout=td, **kw)
        self.control = dist.new_group(backend="gloo", timeout=td)
        self.mesh = make_mesh(world)

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, over gloo."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def decided(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        box = [flag]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def prepare(self, root: Path, name: str, seed: int,
                overrides: Optional[dict]):
        """``harness.prepare`` on this rank's card, the rows checked
        byte-equal over the ranks, ``embed``'s arguments on the mesh."""
        cell, x, labels, kw = harness.prepare(root, name, seed, self.device,
                                              overrides)
        sums = self.gather(digest(x))
        if len(set(sums)) != 1:
            raise RuntimeError(f"the ranks' rows differ (checksums in rank "
                               f"order: {sums})")
        kw["mesh"] = self.mesh
        return cell, x, labels, kw

    def embed(self, x, kw: dict, fault: Optional[str] = None,
              trace: bool = False):
        """One ``embed`` with ``fault`` planted; returns ((embedding,
        info), trace or None)."""
        import annembed_tpu_torch as at
        rec = None
        with faults.planted(fault) if fault else contextlib.nullcontext():
            if trace:
                out, rec = tracing.capture(lambda: at.embed(x, **kw))
            else:
                out = at.embed(x, **kw)
        self.embeds += 1
        return out, rec

    def reset_peak(self) -> None:
        gc.collect()
        if _is_card(self.device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peaks(self) -> list:
        """Every rank's peak since ``reset_peak``, in rank order."""
        return self.gather(torch.cuda.max_memory_allocated()
                           if _is_card(self.device) else None)

    def sums(self, y, info: dict) -> list:
        """Every rank's (embedding checksum, graph checksum, embeds so
        far), in rank order."""
        g = info["kgraph"]
        return self.gather((digest(y), digest(g.indices, g.dists),
                            self.embeds))

    def leave(self) -> list:
        """Every rank's forbidden modules, in rank order; then the groups
        are left."""
        found = self.gather(harness.forbidden_modules())
        self.mesh = self.control = None
        dist.destroy_process_group()
        torch.set_num_threads(self.threads)
        return found


def _build_kernels() -> None:
    """Every CUDA source of the program built (found in the checkout's
    build cache after the first run), before any rank loads one."""
    from annembed_tpu_torch.ops import _build
    _build.build_libraries(sorted(p.stem for p in _build.CSRC.glob("*.cu")))


def _ended(procs: list) -> str:
    """The helpers that have ended, with their exit codes; "" if none."""
    return ", ".join(f"rank {r} ended (code {p.returncode})"
                     for r, p in enumerate(procs, 1) if p.poll() is not None)


def _stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spmd(task: Callable, root: Path, world: int, args: dict,
         device: str = "cuda", log=None, **local):
    """``task(rank, root, log=log, **args)`` on every rank of a mesh of
    ``world`` ranks, in step: this process is rank 0 (which also gets
    ``local``), the others helpers it starts (their ``log`` is stderr).
    ``task`` is a module-level function and ``args`` JSON.  Returns rank
    0's value once every helper has left the groups and ended."""
    log = log or harness.stderr_log
    for k, v in harness.CACHE_ENV.items():
        os.environ.setdefault(k, str(root / v))
    port = _free_port()
    spec = dict(task=f"{task.__module__}:{task.__qualname__}", world=world,
                port=port, root=str(root), device=device, args=args)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.mesh",
         json.dumps({**spec, "rank": r})], cwd=_HOME, stdout=2)
        for r in range(1, world)]
    log(f"portbench: {world} ranks, rank 0 pid {os.getpid()}, "
        + ", ".join(f"rank {r} pid {p.pid}" for r, p in enumerate(procs, 1)))
    done = threading.Event()

    def watch():
        while not done.wait(0.2):
            ended = _ended(procs)
            if ended:
                _stop(procs)
                log(f"portbench: {ended} before the task did; ending the "
                    f"run")
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    rank = None
    try:
        if _is_card(device):
            _build_kernels()
        rank = Rank(0, world, device, port)
        out = task(rank, root, log=log, **args, **local)
        done.set()
        found = rank.leave()
    except BaseException:
        done.set()
        ended = _ended(procs)
        if ended:
            log(f"portbench: {ended} before the task did")
        _stop(procs)
        # an NCCL group whose peers were stopped may not come down; the
        # process ends with the failure
        if rank is not None and rank.control is not None \
                and dist.get_backend() == "gloo":
            with contextlib.suppress(Exception):
                dist.destroy_process_group()
            torch.set_num_threads(rank.threads)
        raise
    for r, p in enumerate(procs, 1):
        try:
            code = p.wait(timeout=EXIT_S)
        except subprocess.TimeoutExpired:
            log(f"portbench: rank {r} did not end in {EXIT_S} s; killed")
            p.kill()
            code = p.wait()
        if code != 0:
            raise RuntimeError(f"rank {r} ended with code {code}")
    helpers = {r: f for r, f in enumerate(found) if f and r > 0}
    if helpers:
        raise harness.ForbiddenModules(
            "; ".join(f"rank {r}: {f}" for r, f in helpers.items()))
    return out


def _spans_line(info: dict) -> str:
    """One embed's pipeline stages and host draws, in seconds, for the
    log: the spans whose parent is ``pipeline``, in order, then the
    summed ``ivf_quantize`` and ``rng.*`` spans."""
    sp = info.get("spans") or []
    top = [i for i, s in enumerate(sp) if s[0] == "pipeline"]
    parts = [f"{s[0]} {(s[3] - s[2]) * 1e-9:.3f}" for s in sp
             if top and s[1] == top[0]]
    for label, pick in (("ivf_quantize", lambda n: n == "ivf_quantize"),
                        ("rng.*", lambda n: n.startswith("rng."))):
        t = sum(s[3] - s[2] for s in sp if pick(s[0])) * 1e-9
        parts.append(f"{label} {t:.3f}")
    return ", ".join(parts)


def _window(rank: Rank, root: Path, name: str, seed: int, seconds: float,
            trace: bool, overrides: Optional[dict], log,
            t_start: float = 0.0) -> Optional[dict]:
    """A run's steps on one rank: the rows, the warm-up, the window, the
    traced embed, the ranks compared.  Rank 0 returns what the judge and
    the metrics need; the helpers None."""
    root0 = rank.rank == 0
    cell, x_host, labels, kw = rank.prepare(root, name, seed, overrides)
    if cell.mix.get("graph_cache"):
        raise ValueError(f"{name}: a mesh cell takes no graph cache")
    capture = harness.Capture() if root0 else None
    try:
        w = min(int(cell.config["warmup_rows"]), x_host.shape[0])
        if w > 0:
            t0 = time.perf_counter()
            rank.embed(x_host[:w], kw)
            if root0:
                log(f"portbench: warm-up on {w} rows "
                    f"{time.perf_counter() - t0:.3f} s")
        rank.reset_peak()

        # the window: whole embeds back to back on every rank, until
        # rank 0 has seen ``seconds`` pass
        infos, ends, last = [], [], None
        t_win = time.perf_counter()
        setup_s = t_win - t_start
        if root0:
            log("portbench: the window starts")
        while True:
            last = None
            if capture:
                capture.clear()
            last, _ = rank.embed(x_host, kw)
            ends.append(time.perf_counter() - t_win)
            infos.append(harness._lean(last[1]))
            if root0:
                log(f"portbench: embed {len(ends)} "
                    f"{ends[-1] - (ends[-2] if len(ends) > 1 else 0.0):.3f}"
                    f" s: {_spans_line(last[1])}")
            if not rank.decided(ends[-1] < seconds):
                break
        window_s = time.perf_counter() - t_win
        peaks = rank.peaks()
        trace_rec = traced_info = None
        if trace:
            # every rank takes part in the collectives; rank 0 traces
            last = None
            if capture:
                capture.clear()
            t0 = time.perf_counter()
            last, trace_rec = rank.embed(x_host, kw, trace=root0)
            traced_info = harness._lean(last[1])
            if root0:
                log(f"portbench: traced embed "
                    f"{time.perf_counter() - t0:.3f} s, "
                    f"{len(trace_rec.device)} device activities")
        sums = rank.sums(*last)
        if not root0:
            return None
        for r, p in enumerate(peaks):
            log(f"portbench: rank {r} peak {p} bytes")
        for r, s in enumerate(sums):
            log(f"portbench: rank {r} embedding {s[0]} graph {s[1]} "
                f"after {s[2]} embeds")
        walls = [round(b - a, 3) for a, b in zip([0.0] + ends, ends)]
        log(f"portbench: window {window_s:.3f} s, {len(infos)} embeds "
            f"{walls[:8]}, setup {setup_s:.3f} s")
        rows = harness.check_rows(x_host.shape[0],
                                  cell.config["check"]["rows"], seed)
        return dict(cell=cell, x_host=x_host, labels=labels, rows=rows,
                    judged=harness.outputs(*last, capture, rows),
                    run=dict(config=cell.config, mix=cell.mix,
                             n=x_host.shape[0], infos=infos,
                             window_s=window_s, setup_s=setup_s,
                             peak_bytes=largest_peak(peaks),
                             traced_info=traced_info, trace=trace_rec),
                    mismatch=mismatches(sums))
    finally:
        if capture:
            capture.close()


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, log=None) -> dict:
    """``harness.run_cell`` on a mesh of the cell's ``chips`` ranks."""
    log = log or harness.stderr_log
    world = harness.chips_of(root, name)
    got = spmd(_window, root, world,
               dict(name=name, seed=seed, seconds=seconds, trace=trace,
                    overrides=overrides),
               device, log, t_start=t_start)

    # outside the window, the helpers gone: the reference judges rank
    # 0's last embed
    t0 = time.perf_counter()
    cell, judged = got["cell"], got.pop("judged")
    harness.free_device(device)
    ref = Reference(cell.judged_config(), got["x_host"], got["labels"],
                    got["rows"], device)
    log(f"portbench: reference's exact search "
        f"{time.perf_counter() - t0:.3f} s")
    readings = harness.readings_of(ref, *judged)
    readings["rank_mismatch"] = got["mismatch"]
    ref.close()
    log(f"portbench: reference {time.perf_counter() - t0:.3f} s")
    run = harness.Run(reference=readings, **got["run"])
    return harness.result(cell, run, device, world)


def _helper(spec: dict) -> None:
    """A helper rank: the groups, then the task."""
    parent = os.getppid()

    def watch_parent():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch_parent, daemon=True).start()
    module, name = spec["task"].split(":")
    task = getattr(importlib.import_module(module), name)
    rank = Rank(spec["rank"], spec["world"], spec["device"], spec["port"])
    task(rank, Path(spec["root"]), log=harness.stderr_log,
         **spec["args"])
    rank.leave()


if __name__ == "__main__":
    _helper(json.loads(sys.argv[1]))
