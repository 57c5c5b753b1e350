"""MNIST IDX-format reader.

Port of annembed_tpu/io/mnist_io.py (reference src/utils/mnistio.rs):
the ubyte IDX files with magic 2051 (images, :68) / 2049 (labels, :133),
big-endian header, gzipped or not, and the train/test loader pairs
(:150, :167).  Host-side numpy: the rows go to the device through
``embed``.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

IMAGE_MAGIC = 2051
LABEL_MAGIC = 2049


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_image_file(path) -> np.ndarray:
    """(n, rows, cols) uint8 images."""
    with _open(os.fspath(path)) as f:
        magic, n, r, c = struct.unpack(">IIII", f.read(16))
        if magic != IMAGE_MAGIC:
            raise ValueError(f"bad image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * r * c), dtype=np.uint8)
    return data.reshape(n, r, c)


def read_label_file(path) -> np.ndarray:
    """(n,) uint8 labels."""
    with _open(os.fspath(path)) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != LABEL_MAGIC:
            raise ValueError(f"bad label magic {magic} in {path}")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    return data


def _find(dirpath: Path, stem: str) -> Path:
    for cand in (dirpath / stem, dirpath / (stem + ".gz")):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"{stem}[.gz] not found in {dirpath}")


def load_mnist_train_data(dirpath) -> Tuple[np.ndarray, np.ndarray]:
    d = Path(dirpath)
    return (read_image_file(_find(d, "train-images-idx3-ubyte")),
            read_label_file(_find(d, "train-labels-idx1-ubyte")))


def load_mnist_test_data(dirpath) -> Tuple[np.ndarray, np.ndarray]:
    d = Path(dirpath)
    return (read_image_file(_find(d, "t10k-images-idx3-ubyte")),
            read_label_file(_find(d, "t10k-labels-idx1-ubyte")))


def load_mnist_full(dirpath) -> Tuple[np.ndarray, np.ndarray]:
    """Train + test images flattened to float32 rows (by the header's
    dimensions) and their labels, as the reference's benchmark programs
    use them (examples/mnist_digits.rs)."""
    xi, yi = load_mnist_train_data(dirpath)
    xt, yt = load_mnist_test_data(dirpath)
    xall = np.concatenate([xi, xt])
    return (xall.reshape(len(xall), -1).astype(np.float32),
            np.concatenate([yi, yt]))
