"""``device.idle_unspanned``, read in the cells that report ``reembed_s``."""

from pathlib import Path

from portbench.harness import load_file

read = load_file(Path(__file__).resolve().parent.parent, "metrics",
                 "device.idle_unspanned").read
