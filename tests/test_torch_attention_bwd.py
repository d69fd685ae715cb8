"""The attention backward's plain version against JAX on the CPU, in fp32.

``kernels.attn_sublayer._attention_bwd`` is what the sublayer backwards'
attention kernels compute (the CUDA kernels are held against it on the card
in tests/test_torch_cuda.py).  Here it is held against ``jax.vjp`` of the JAX
package's XLA attention oracle ``_xla_attention`` at the kernels' edges: 1,
77, 288 (the one-block kernel's most) and 1024 queries against 1, 77, 288
(past its 256) and 1024 keys (the long route's), on the same numpy inputs.
At 1024 tokens the JAX package's own backward stays on XLA's VJP, so that
VJP is the reference there.
"""

import functools

import numpy as np
import pytest
import jax
import torch

from open_muse_tpu.ops.pallas import attn_sublayer as A
from open_muse_tpu_torch.kernels import attn_sublayer as TA

HEADS = 2  # of 64
ROWS = (1, 77, 288, 1024)
SHAPES = [(queries, keys) for queries in ROWS for keys in ROWS]


def _inputs(queries, keys):
    rs = np.random.RandomState(queries * 1000 + keys)
    width = 64 * HEADS
    q, dattn = (rs.randn(1, queries, width).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(1, keys, width).astype(np.float32) for _ in range(2))
    return q, k, v, dattn


@functools.lru_cache(maxsize=None)
def _references():
    """(out, dq, dk, dv) of every shape: the forward and jax.vjp of
    ``_xla_attention``, all in one compiled call (run eagerly, each of their
    ops would compile on its own, shape by shape)."""
    def one(q, k, v, dattn):
        out, vjp = jax.vjp(lambda q_, k_, v_: A._xla_attention(q_, k_, v_, HEADS), q, k, v)
        return (out, *vjp(dattn))

    refs = jax.jit(lambda sets: [one(*s) for s in sets])([_inputs(*shape) for shape in SHAPES])
    return {shape: [np.array(t) for t in ref] for shape, ref in zip(SHAPES, refs)}


@pytest.mark.parametrize("queries,keys", SHAPES)
def test_attention_bwd_plain_matches_jax_vjp(queries, keys):
    """out, dq, dk and dv, rel and abs 1e-4 (fp32 on both sides)."""
    got = TA._attention_bwd(*(torch.from_numpy(t) for t in _inputs(queries, keys)), HEADS)
    for name, mine, want in zip(("out", "dq", "dk", "dv"), got, _references()[queries, keys]):
        torch.testing.assert_close(mine, torch.from_numpy(want), rtol=1e-4, atol=1e-4, msg=name)
