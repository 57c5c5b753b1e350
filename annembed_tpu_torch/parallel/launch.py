"""Rank launcher of the port's 1-D ``data`` mesh: one process per device.

``run_on_ranks(fn, n_devices, args)`` spawns ``n_devices`` processes
with ``torch.multiprocessing`` (start method ``spawn``, never ``fork``:
CUDA may be live in the caller).  Each rank initializes the process
group over ``tcp://127.0.0.1:<free port>`` (NCCL and ``cuda:<rank>`` on
the card, gloo and one thread each on the CPU), calls ``fn(mesh,
*args)`` and saves what it returns; the caller gets every rank's return
value in rank order.  A rank that raises ends the others, and the caller
gets the error.

Large inputs reach the ranks as files, not through ``/dev/shm`` (a
container's can be 64 MB): ``save_rows`` writes an ``.npy`` that every
rank memory-maps with ``load_rows``.
"""

from __future__ import annotations

import datetime
import inspect
import os
import socket
import tempfile
from typing import Any, Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharded import make_mesh

#: collective timeout: ranks wait for each other at most this long
TIMEOUT_S = 1800


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_devices(n_devices: int, device) -> torch.device:
    """The ranks' device type, checked: ``cuda`` needs ``n_devices``
    cards, and nothing falls back to the CPU or to fewer cards."""
    dev = torch.device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} < 1")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"n_devices={n_devices} but only "
                             f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def save_rows(x: np.ndarray, directory: str) -> str:
    """Write float32 rows for the ranks to memory-map; returns the path."""
    path = os.path.join(directory, "rows.npy")
    np.save(path, np.ascontiguousarray(x, dtype=np.float32))
    return path


def load_rows(path: str) -> np.ndarray:
    """The rows ``save_rows`` wrote, memory-mapped (copy on write: the
    file is never changed)."""
    return np.load(path, mmap_mode="c")


def _rank_main(rank: int, world: int, port: int, dev_type: str,
               fn: Callable, args: Sequence, out_dir: str) -> None:
    kwargs = {}
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            # eager communicator set-up: a failing NCCL init raises here
            kwargs["device_id"] = torch.device("cuda", rank)
    else:
        backend = "gloo"
        # the CPU ranks share the host's cores: one thread each, or their
        # intra-op pools oversubscribe the cores many times over
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)
    try:
        mesh = make_mesh(world)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn: Callable, n_devices: int, args: Sequence = (),
                 device="cuda") -> List[Any]:
    """Call ``fn(mesh, *args)`` on ``n_devices`` spawned ranks (on
    ``cuda:0..n_devices-1``, or the CPU under gloo); returns the ranks'
    return values in rank order, loaded on the CPU.  ``fn`` and ``args``
    must pickle (``fn`` by its import path).  The caller's cached CUDA
    memory is released first: rank 0 shares ``cuda:0`` with it."""
    dev = check_devices(n_devices, device)
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="annembed_ranks_") as out_dir:
        mp.start_processes(_rank_main,
                           args=(n_devices, _free_port(), dev.type, fn,
                                 tuple(args), out_dir),
                           nprocs=n_devices, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n_devices)]
