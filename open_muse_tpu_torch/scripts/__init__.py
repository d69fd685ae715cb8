"""Command-line entry points run as ``python -m open_muse_tpu_torch.scripts.<name>``."""
