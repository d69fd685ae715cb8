"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper takes the plain version for tensors on the CPU, and for CUDA
tensors launches its kernel or raises: there is no fallback.  Each wrapper
counts its launches in a plain integer attribute, ``wrapper.launches``;
``flash_attention_two_pass`` counts apart the launches of
``flash_attention`` that take its two-pass variant (more keys than the
one-pass kernel holds).  The forward wrappers are
``torch.autograd.Function``s whose backward is the matching backward
wrapper, so one Function runs the plain versions on the CPU and the kernels
on the card in both directions.  The fused norms and
``flash_attention`` have no backward kernel, as their TPU kernels have none:
their Functions launch the kernel forward and take the gradient of the plain
version, recomputed from the saved inputs (``plain_vjp``).  Under CUDA
autocast every Function casts its inputs to bf16, the one type the kernels
take.
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


def plain_vjp(plain, inputs, grads, needs):
    """The backward of a kernel without a backward kernel: recompute
    ``plain(*inputs)`` under autograd and return the gradients of the inputs
    flagged in ``needs`` (None for the others) given the outputs' ``grads``
    (None for an output without a gradient)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wrt = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wrt else ())
    return tuple(next(got, None) if n else None for n in needs)


class LaunchCounter:
    """A launch count kept beside the wrappers' own, for a kernel variant
    counted apart: it has a wrapper's ``__name__`` and ``launches``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """The fp32 staging of the plain versions; float64 stays float64 so that
    ``gradcheck`` can run through them."""
    return t if t.dtype == torch.float64 else t.float()


from .attn_sublayer import (attn_sublayer_cross, attn_sublayer_cross_bwd,  # noqa: E402
                            attn_sublayer_self, attn_sublayer_self_bwd)
from .flash_attention import flash_attention, flash_attention_two_pass  # noqa: E402
from .fused_norm import fused_residual_layernorm, fused_residual_rmsnorm  # noqa: E402
from .fused_sample import fused_categorical, fused_categorical_cfg  # noqa: E402
from .glu_matmul import glu_down_matmul, glu_down_matmul_bwd  # noqa: E402
from .vq_argmin import vq_argmin  # noqa: E402

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts", "glu_down_matmul",
           "glu_down_matmul_bwd", "attn_sublayer_self", "attn_sublayer_self_bwd",
           "attn_sublayer_cross", "attn_sublayer_cross_bwd", "fused_categorical_cfg",
           "fused_categorical", "vq_argmin", "fused_residual_rmsnorm", "fused_residual_layernorm",
           "flash_attention", "flash_attention_two_pass", "LaunchCounter"]

WRAPPERS = (attn_sublayer_self, attn_sublayer_cross, glu_down_matmul,
            fused_categorical_cfg, attn_sublayer_self_bwd, attn_sublayer_cross_bwd,
            glu_down_matmul_bwd, fused_categorical, vq_argmin, fused_residual_rmsnorm,
            fused_residual_layernorm, flash_attention, flash_attention_two_pass)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    flash_attention.by_head_dim.clear()
