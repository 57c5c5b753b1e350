"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration and a traffic mix.  Everything else is found by name:

* the configuration's file (its ``file`` in BENCHMARK.json): the table's
  shape, its generator (``data/<generator>.py``), the arguments of
  ``annembed_tpu_torch.embed`` and the sizes of the check;
* the mix, ``traffic/<traffic>.json``: what the window does on top of
  the configuration (optimizer, graph cache) and the set-up it needs;
* the limits of the check, ``limits/<cell>.json``;
* each metric, ``metrics/<name>.py``: a ``read(run)`` that returns the
  metric's value from the run's record, or None where it finds nothing.

A run: the rows are made on the device from the seed and copied to the
host once; a warm-up at a small size goes through every library and
kernel of the cell's path; the mix's set-up runs; then whole embeds run
back to back until ``seconds`` have passed, none cut off (the window
covers every embed it started).  With ``trace`` one more embed runs under
the profiler.  Then, outside the window and with the program's state
freed, the plain reference (``reference/exact.py``) judges the last
embed: its graph, its projection and its embedding.

A cell whose ``chips`` is above 1 runs on a mesh of that many ranks
instead (``mesh.py``): the same steps, every rank in step.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import tracing
from .reference.judge import Reference

#: the benchmark's folder in a checkout; its files are found by name
FOLDER = "portbench"
#: top-level module names a run must never have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "annembed_tpu")
#: the program's kernel caches, at fixed paths inside the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
             "TRITON_CACHE_DIR": "build/portbench/triton",
             "CUDA_CACHE_PATH": "build/portbench/nv"}


@dataclasses.dataclass
class Run:
    """What a metric's ``read`` sees."""

    config: dict
    mix: dict
    n: int
    #: ``info`` of each embed of the window (the graph left out)
    infos: list
    window_s: float
    setup_s: float
    peak_bytes: Optional[int]
    #: the reference's readings of the judged embed
    reference: dict
    #: the embed run under the profiler and its trace (traced runs)
    traced_info: Optional[dict] = None
    trace: Optional[tracing.Trace] = None

    @property
    def embeds(self) -> int:
        return len(self.infos)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_file(base: Path, kind: str, name: str):
    """The module ``<base>/<kind>/<name>.py``: a metric's reader
    (``metrics``) or a configuration's generator (``data``)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ForbiddenModules(RuntimeError):
    """A rank of the run loaded a module a run must not load."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one a run must not load,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def chips_of(root: Path, name: str) -> int:
    """The cards the cell ``name`` asks for in BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    return int(by_name(bench["workloads"], name, "workload")["chips"])


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports in a run with or without trace."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def merged(base: dict, *over: dict) -> dict:
    out = dict(base)
    for o in over:
        out.update(o or {})
    return out


@dataclasses.dataclass
class Cell:
    """A cell resolved from BENCHMARK.json and its files."""

    name: str
    base: Path
    bench: dict
    config: dict
    mix: dict
    limits: dict

    @staticmethod
    def load(root: Path, name: str, overrides: Optional[dict] = None):
        bench = load_json(root / "BENCHMARK.json")
        w = by_name(bench["workloads"], name, "workload")
        entry = by_name(bench["configs"], w["config"], "configuration")
        config = load_json(root / entry["file"])
        base = root / FOLDER
        mix = load_json(base / "traffic" / f"{w['traffic']}.json")
        limits = load_json(base / "limits" / f"{name}.json")
        for key, val in (overrides or {}).items():
            if isinstance(val, dict) and isinstance(config.get(key), dict):
                config[key] = merged(config[key], val)
            else:
                config[key] = val
        return Cell(name, base, bench, config, mix, limits)

    def judged_config(self) -> dict:
        """The configuration as the window runs it: its ``embed`` and
        ``params`` with the mix's on top (what the reference judges
        against)."""
        c, m = dict(self.config), self.mix
        for key in ("embed", "params"):
            c[key] = merged(c.get(key, {}), m.get(key))
        return c

    def embed_kwargs(self, seed: int, device: str) -> dict:
        """``embed``'s arguments for this cell."""
        from annembed_tpu_torch import EmbedderParams, KnnParams
        c, m = self.config, self.mix
        kw = merged(c["embed"], m.get("embed"))
        kw["knn_params"] = KnnParams(**merged(c["knn_params"],
                                              m.get("knn_params")))
        kw["params"] = EmbedderParams(**merged(c.get("params", {}),
                                               m.get("params")))
        kw.update(seed=seed % 2_000_000_000, return_graph=True,
                  device=device)
        return kw


class Capture:
    """Keeps the hierarchy's projection that an embed hands to its
    optimizer (built, or loaded from the graph cache), so that the
    reference can judge it; ``clear`` drops it before the next embed."""

    def __init__(self):
        from annembed_tpu_torch.optim.embedder import Embedder
        self.cls = Embedder
        self.orig = Embedder.__dict__["from_hkgraph"]
        self.proj = None

        def from_hkgraph(proj, params, mesh=None):
            self.proj = proj
            return self.orig.__func__(proj, params, mesh=mesh)

        Embedder.from_hkgraph = staticmethod(from_hkgraph)

    def clear(self):
        self.proj = None

    def close(self):
        self.cls.from_hkgraph = self.orig
        self.proj = None


def _lean(info: dict) -> dict:
    return {k: v for k, v in info.items() if k not in ("kgraph",)}


def check_rows(n: int, count: int, seed: int) -> torch.Tensor:
    """``count`` distinct row ids drawn from the seed, in draw order."""
    g = torch.Generator().manual_seed(seed ^ 0x5EED5)
    return torch.randperm(n, generator=g)[:min(count, n)]


def compared(readings: dict, limits: dict) -> dict:
    """Each compared number beside its limit: {name: [value, limit]};
    a number the reference could not read, or read as not finite, is
    None."""
    out = {}
    for k, lim in limits.items():
        v = readings.get(k)
        out[k] = [v if v is not None and math.isfinite(v) else None, lim]
    return out


def is_correct(comp: dict) -> bool:
    return all(v is not None and v <= lim for v, lim in comp.values())


def prepare(root: Path, name: str, seed: int, device: str,
            overrides: Optional[dict] = None):
    """The cell, its rows made from the seed (host float32, as users
    pass them; the source clusters on the host) and ``embed``'s
    arguments."""
    for k, v in CACHE_ENV.items():
        os.environ.setdefault(k, str(root / v))
    cell = Cell.load(root, name, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cell.config
    x, labels = load_file(cell.base, "data", c["generator"]).make(
        c["rows"], c["columns"], seed, device)
    x_host = x.cpu().numpy()
    del x
    return cell, x_host, labels.cpu(), cell.embed_kwargs(seed, device)


def set_up(cell: Cell, x_host: np.ndarray, kw: dict, tmpdir: str,
           log) -> dict:
    """The warm-up, once through every library and kernel of the cell's
    path at a small size, then the mix's own set-up.  Returns the
    window's ``embed`` arguments."""
    import annembed_tpu_torch as at
    mix = cell.mix
    w = min(int(cell.config["warmup_rows"]), x_host.shape[0])
    if w > 0:
        t0 = time.perf_counter()
        warm = dict(kw)
        if mix.get("graph_cache"):
            warm.update(graph_cache=os.path.join(tmpdir, "warm.npz"),
                        graph_cache_eager=True)
            at.embed(x_host[:w], **merged(warm, mix.get("setup_embed")))
        at.embed(x_host[:w], **warm)
        log(f"portbench: warm-up on {w} rows "
            f"{time.perf_counter() - t0:.3f} s")
    kw = dict(kw)
    if mix.get("graph_cache"):
        # the port builds the graph and writes it; the window loads it
        kw["graph_cache"] = os.path.join(tmpdir, "graph.npz")
        t0 = time.perf_counter()
        at.embed(x_host, **merged(kw, {"graph_cache_eager": True},
                                  mix.get("setup_embed")))
        log(f"portbench: graph cache written "
            f"{time.perf_counter() - t0:.3f} s")
    return kw


def outputs(y_host: np.ndarray, info: dict, capture: Capture,
            rows: torch.Tensor) -> tuple:
    """What the reference judges of one embed, on the host: the
    embedding, the returned graph at the check rows, at layer 1 the
    sample and the projection at the check rows, and the whole returned
    graph (the embedding's forces are worked out from it)."""
    g = info["kgraph"]
    r = rows.to(g.indices.device)
    graph = (g.indices[r].long().cpu(), g.dists[r].cpu())
    proj = None
    if capture.proj is not None:
        p = capture.proj
        proj = (p.sample_ids.cpu(), p.proj_small_idx[r].cpu(),
                p.proj_dist[r].cpu())
    return y_host, graph, proj, (g.indices.cpu(), g.dists.cpu())


def free_device(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def readings_of(ref: Reference, y_host, graph, proj, full) -> dict:
    out = ref.graph(*graph)
    if proj is not None:
        out.update(ref.projection(*proj))
    out.update(ref.embedding(y_host))
    out.update(ref.rest(y_host, *full))
    return out


def stderr_log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, log=None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, and
    ``compared`` last).  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock.  A cell on more than one card runs on a
    mesh (``mesh.run_cell``)."""
    log = log or stderr_log
    if chips_of(root, name) > 1:
        from . import mesh
        return mesh.run_cell(root, name, seed, seconds, trace, t_start,
                             device, overrides, log)
    cell, x_host, labels, kw = prepare(root, name, seed, device, overrides)
    import annembed_tpu_torch as at
    n = x_host.shape[0]
    capture = Capture()
    tmp = tempfile.TemporaryDirectory(prefix="portbench_")
    try:
        kw = set_up(cell, x_host, kw, tmp.name, log)
        capture.clear()
        free_device(device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        # the window: whole embeds back to back
        infos, ends, last = [], [], None
        t_win = time.perf_counter()
        setup_s = t_win - t_start
        while True:
            # the previous embed's outputs are dropped before the next
            # call, so that the peak is what one call holds
            last = None
            capture.clear()
            y, info = at.embed(x_host, **kw)
            last, y, info = (y, info), None, None
            infos.append(_lean(last[1]))
            ends.append(time.perf_counter() - t_win)
            if ends[-1] >= seconds:
                break
        window_s = time.perf_counter() - t_win
        peak = torch.cuda.max_memory_allocated() if device == "cuda" \
            else None
        walls = [round(b - a, 3) for a, b in zip([0.0] + ends, ends)]
        log(f"portbench: window {window_s:.3f} s, {len(infos)} embeds "
            f"{walls[:8]}, setup {setup_s:.3f} s")
        opt = [round(i.get("optimize_time", 0.0), 3) for i in infos]
        loads = [round(i["checkpoints"]["graph_load_s"], 3) for i in infos
                 if "graph_load_s" in i.get("checkpoints", {})]
        log(f"portbench: optimize {opt[:8]}"
            + (f", graph load {loads[:8]}" if loads else ""))
        trace_rec = traced_info = None
        if trace:
            last = None
            capture.clear()
            t0 = time.perf_counter()
            last, trace_rec = tracing.capture(lambda: at.embed(x_host, **kw))
            traced_info = _lean(last[1])
            log(f"portbench: traced embed {time.perf_counter() - t0:.3f} s, "
                f"{len(trace_rec.device)} device activities")

        # outside the window: the reference judges the last embed
        t0 = time.perf_counter()
        rows = check_rows(n, cell.config["check"]["rows"], seed)
        judged = outputs(*last, capture, rows)
        last = None
        capture.close()
        free_device(device)
        ref = Reference(cell.judged_config(), x_host, labels, rows, device)
        log(f"portbench: reference's exact search "
            f"{time.perf_counter() - t0:.3f} s")
        readings = readings_of(ref, *judged)
        ref.close()
        log(f"portbench: reference {time.perf_counter() - t0:.3f} s")
    finally:
        capture.close()
        tmp.cleanup()

    run = Run(config=cell.config, mix=cell.mix, n=n, infos=infos,
              window_s=window_s, setup_s=setup_s, peak_bytes=peak,
              reference=readings, traced_info=traced_info, trace=trace_rec)
    return result(cell, run, device, 1)


def result(cell: Cell, run: Run, device: str, count: int) -> dict:
    """The result's fields of a run on ``count`` cards: each metric of
    the cell read from ``run``, the readings beside their limits."""
    trace = run.trace is not None
    metrics = {}
    for m in metrics_of(cell.bench, cell.name, trace):
        v = load_file(cell.base, "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    comp = compared(run.reference, cell.limits)
    correct = is_correct(comp)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": count, "memory_peak_bytes": run.peak_bytes}
    dev.update(tracing.device_summary(run.trace))
    out = {"correct": correct, "attempted": run.embeds + trace,
           "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = run.trace.breakdown()
    out["compared"] = comp
    return out
