"""The port's ``models/uvit_blocks.py`` against the JAX package's, class by
class, on the CPU in fp32.

Each JAX block is initialised, its parameters replaced by numpy-seeded
noise and carried into the port block by ``jax_params_to_state_dict`` (no
JAX leaf left unused); the same numpy inputs go through both.  Tolerance:
rel 1e-4 of the output's largest magnitude (fp32 on both sides, differing
in summation order), with and without the port's kernel wrappers (their
plain versions here).  ``UpsampleBlock`` holds the transposed convolution
whose kernel the converter flips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from open_muse_tpu.core.convert import flatten_dict
from open_muse_tpu.models import uvit_blocks as J
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.models import uvit_blocks as P

REL = 1e-4


def _params(jax_module, args, seed):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *args))["params"]
    rs = np.random.RandomState(seed)
    flat = {}
    for key, leaf in flatten_dict(shapes).items():
        name = key.rsplit(".", 1)[-1]
        noise = rs.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            noise /= np.sqrt(max(1, int(np.prod(leaf.shape[:-1]))))
        elif name == "scale":
            noise = 1.0 + 0.1 * noise
        else:
            noise *= 0.1
        flat[key] = noise
    return flat


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _pair(jax_module, port_module, args, seed):
    flat = _params(jax_module, args, seed)
    state, unused = jax_params_to_state_dict(flat, port_module)
    assert not unused, unused
    port_module.load_state_dict(state)
    return lambda *a: jax_module.apply({"params": _unflatten(flat)}, *a), port_module.eval()


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * scale)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_attention_block_2d_and_norm_match_jax(use_kernels):
    x, ehs = _x(0, 2, 4, 4, 64), _x(1, 2, 5, 48)
    ref_fn, port = _pair(J.AttentionBlock2D(64, 4, 48), P.AttentionBlock2D(64, 4, 48),
                         (jnp.asarray(x), jnp.asarray(ehs)), 2)
    with torch.no_grad():
        _close(port(*_t(x, ehs), use_kernels=use_kernels), ref_fn(jnp.asarray(x), jnp.asarray(ehs)))
    ref_fn, port = _pair(J.Norm2D(64, "rmsnorm"), P.Norm2D(64, "rmsnorm"), (jnp.asarray(x),), 3)
    with torch.no_grad():
        _close(port(*_t(x), use_kernels=use_kernels), ref_fn(jnp.asarray(x)))


def test_res_block_with_skip_and_cond_matches_jax():
    x, skip, cond = _x(2, 1, 8, 8, 32), _x(3, 1, 8, 8, 32), _x(4, 1, 24)
    ref_fn, port = _pair(J.ResBlock(32, skip_channels=32, cond_embed_dim=24),
                         P.ResBlock(32, skip_channels=32, cond_embed_dim=24),
                         tuple(map(jnp.asarray, (x, skip, cond))), 5)
    with torch.no_grad():
        _close(port(*_t(x, skip, cond)), ref_fn(*map(jnp.asarray, (x, skip, cond))))


def test_down_and_up_blocks_match_jax():
    """The stride-2 conv, the res / attention stack with AdaLN and text
    states, then the up block's first skip and its ConvTranspose."""
    x, ehs, cond = _x(5, 2, 8, 8, 32), _x(6, 2, 5, 40), _x(7, 2, 16)
    kw = dict(num_res_blocks=2, num_heads=4, has_attention=True, encoder_hidden_size=40,
              cond_embed_dim=16)
    jargs = (jnp.asarray(x), None, jnp.asarray(cond), jnp.asarray(ehs))
    ref_fn, down = _pair(J.DownsampleBlock(32, 64, **kw), P.DownsampleBlock(32, 64, **kw),
                         jargs, 8)
    ref_y, ref_states = ref_fn(*jargs)
    with torch.no_grad():
        y, states = down(torch.from_numpy(x), None, torch.from_numpy(cond), torch.from_numpy(ehs))
    _close(y, ref_y)
    assert len(states) == len(ref_states) == 2
    _close(states[0], ref_states[0])

    skip = _x(9, 2, 4, 4, 64)
    up_args = (ref_y, (jnp.asarray(skip),), jnp.asarray(cond), jnp.asarray(ehs))
    ref_fn, up = _pair(J.UpsampleBlock(64, 32, skip_channels=64, **kw),
                       P.UpsampleBlock(64, 32, skip_channels=64, **kw), up_args, 10)
    with torch.no_grad():
        got = up(torch.from_numpy(np.asarray(ref_y)), (torch.from_numpy(skip),),
                 torch.from_numpy(cond), torch.from_numpy(ehs))
    _close(got, ref_fn(*up_args))
    assert got.shape == (2, 8, 8, 32)


def test_vanilla_blocks_match_jax():
    x = _x(11, 1, 16, 16, 32)
    ref_fn, res = _pair(J.ResnetBlockVanilla(32, 64, use_conv_shortcut=True),
                        P.ResnetBlockVanilla(32, 64, use_conv_shortcut=True), (jnp.asarray(x),), 12)
    with torch.no_grad():
        _close(res(torch.from_numpy(x)), ref_fn(jnp.asarray(x)))
    ref_fn, down = _pair(J.DownsampleBlockVanilla(32, 64, num_res_blocks=2),
                         P.DownsampleBlockVanilla(32, 64, num_res_blocks=2), (jnp.asarray(x),), 13)
    ref_y, ref_states = ref_fn(jnp.asarray(x))
    with torch.no_grad():
        y, states = down(torch.from_numpy(x))
    _close(y, ref_y)
    assert len(states) == len(ref_states) == 3
    skips = (_x(15, 1, 8, 8, 64), np.asarray(ref_states[-1]))  # popped last first
    up_args = (ref_y, tuple(map(jnp.asarray, skips)))
    ref_fn, up = _pair(J.UpsampleBlockVanilla(64, 64, skip_channels=64, num_res_blocks=2),
                       P.UpsampleBlockVanilla(64, 64, skip_channels=64, num_res_blocks=2),
                       up_args, 14)
    with torch.no_grad():
        got = up(torch.from_numpy(np.asarray(ref_y)), tuple(map(torch.from_numpy, skips)))
    _close(got, ref_fn(*up_args))
    assert got.shape == (1, 16, 16, 64)
