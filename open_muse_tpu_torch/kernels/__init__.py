"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper takes the plain version for tensors on the CPU, and for CUDA
tensors launches its kernel or raises: there is no fallback.  Each wrapper
counts its launches in a plain integer attribute, ``wrapper.launches``.  The
forward wrappers are ``torch.autograd.Function``s whose backward is the
matching backward wrapper, so one Function runs the plain versions on the CPU
and the kernels on the card in both directions.
"""

from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version route)."""
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def require_cuda(name: str, dtypes, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    of one of ``dtypes`` on one device."""
    device = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """The fp32 staging of the plain versions; float64 stays float64 so that
    ``gradcheck`` can run through them."""
    return t if t.dtype == torch.float64 else t.float()


from .attn_sublayer import (attn_sublayer_cross, attn_sublayer_cross_bwd,  # noqa: E402
                            attn_sublayer_self, attn_sublayer_self_bwd)
from .fused_sample import fused_categorical, fused_categorical_cfg  # noqa: E402
from .glu_matmul import glu_down_matmul, glu_down_matmul_bwd  # noqa: E402
from .vq_argmin import vq_argmin  # noqa: E402

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts", "glu_down_matmul",
           "glu_down_matmul_bwd", "attn_sublayer_self", "attn_sublayer_self_bwd",
           "attn_sublayer_cross", "attn_sublayer_cross_bwd", "fused_categorical_cfg",
           "fused_categorical", "vq_argmin"]

WRAPPERS = (attn_sublayer_self, attn_sublayer_cross, glu_down_matmul,
            fused_categorical_cfg, attn_sublayer_self_bwd, attn_sublayer_cross_bwd,
            glu_down_matmul_bwd, fused_categorical, vq_argmin)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
