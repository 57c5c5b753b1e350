"""Device selection and float32 matmul precision for the port.

The distance panels (knn/distances.py) form d^2 = |q|^2 + |x|^2 - 2 q.x;
at low d the cancellation in that expansion corrupts near-neighbour
ordering unless the cross term runs in full f32 (the JAX package runs it
at Precision.HIGHEST for d <= 32, annembed_tpu/knn/distances.py:88-104).
TF32 keeps ~10 mantissa bits, so it stays off for every matmul the port
issues.
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The given device, checked.  Never picks the CPU on its own: a
    request for ``cuda`` with no card present raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    disable_tf32()
    return dev
