"""Multi-device path of the port: a 1-D ``data`` mesh of one process per
device on ``torch.distributed`` (port of annembed_tpu/parallel)."""
