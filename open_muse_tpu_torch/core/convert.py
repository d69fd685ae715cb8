"""JAX parameter tree -> the port's torch ``state_dict``.

The port keeps the open-muse torch key names, which are the names the JAX
package's loader maps (``open_muse_tpu/core/convert.py``).  The mapping is
driven by the port model, so it is never ambiguous: every ``state_dict`` key
maps to one flax path (``name.N`` -> ``name_N``, then the leaf name), and the
module that owns the key says how the array turns:

  nn.Linear           kernel (I, O)         -> weight (O, I)
  nn.Conv2d           kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  nn.ConvTranspose2d  kernel (kh, kw, I, O) -> weight (I, O, kh, kw), spatially
                      flipped: flax's ConvTranspose correlates where torch's
                      convolves, so the flip keeps the two forwards equal;
                      one built in flax with ``transpose_kernel=True``
                      (marked ``flax_transpose_kernel`` in the port) holds
                      (kh, kw, O, I), the transposed convolution's forward
                      kernel, which flax flips itself: -> (I, O, kh, kw),
                      not flipped
  norms / embeddings  scale / embedding     -> weight (unchanged)
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["flax_key_candidates", "jax_params_to_state_dict"]

_INDEX_RE = re.compile(r"\.(\d+)(?=\.|$)")
_LEAF_CANDIDATES = {
    "weight": ("kernel", "scale", "embedding", "weight"),
    "bias": ("bias",),
    "gamma": ("gamma",),
    "beta": ("beta",),
}


def flax_key_candidates(torch_key: str) -> List[str]:
    """'down_blocks.0.res_blocks.1.norm.norm.weight' ->
    ['down_blocks_0.res_blocks_1.norm.norm.kernel', '...scale', ...]."""
    parts = _INDEX_RE.sub(lambda m: "_" + m.group(1), torch_key).split(".")
    base, leaf = parts[:-1], parts[-1]
    return [".".join(base + [cand]) for cand in _LEAF_CANDIDATES.get(leaf, (leaf,))]


def _to_torch_layout(value: np.ndarray, module: nn.Module, leaf: str) -> np.ndarray:
    if leaf == "weight" and isinstance(module, nn.ConvTranspose2d):
        if getattr(module, "flax_transpose_kernel", False):
            return value.transpose(3, 2, 0, 1)
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if leaf == "weight" and isinstance(module, nn.Conv2d):
        return value.transpose(3, 2, 0, 1)
    if leaf == "weight" and isinstance(module, nn.Linear):
        return value.T
    return value


def jax_params_to_state_dict(flat_params: Mapping[str, np.ndarray], model: nn.Module
                             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Map a flattened JAX param tree onto ``model``'s state_dict keys.

    Returns (state_dict, unused flax keys).  Raises when a port key has no
    flax leaf or a leaf's shape does not fit.  ``model._flax_key(key)`` may
    rename a torch key first (or return None to skip a buffer)."""
    rename = getattr(model, "_flax_key", lambda key: key)
    modules = dict(model.named_modules())
    state, used = {}, set()
    for key, ref in model.state_dict().items():
        mapped = rename(key)
        if mapped is None:
            continue
        flax_key = next((k for k in flax_key_candidates(mapped) if k in flat_params), None)
        if flax_key is None:
            raise KeyError(f"no JAX leaf for port key {key!r} (as {mapped!r})")
        owner, _, leaf = key.rpartition(".")
        value = _to_torch_layout(np.asarray(flat_params[flax_key]), modules[owner], leaf)
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX {flax_key} gives {value.shape}, port wants "
                             f"{tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value)).to(ref.dtype)
        used.add(flax_key)
    return state, sorted(set(flat_params) - used)
