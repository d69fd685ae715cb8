"""Runnable examples: ``python -m open_muse_tpu_torch.examples.quickstart`` and
``python -m open_muse_tpu_torch.examples.serving``."""
