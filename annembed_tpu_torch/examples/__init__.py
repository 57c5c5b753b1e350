"""Runnable harnesses of the port:
``python -m annembed_tpu_torch.examples.<name>``."""
