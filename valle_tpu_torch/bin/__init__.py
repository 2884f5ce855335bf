"""Command-line entry points of the port, run as ``python -m
valle_tpu_torch.bin.<name>`` (no console scripts)."""
