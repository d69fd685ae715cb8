"""The port's optimizers against the JAX package's, on the CPU in fp32.

``8bit_adamw`` (``quant8``), ``bf16_adamw`` and ``lion`` next to
``get_optimizer`` of the JAX package: the blockwise quantiser on the same
arrays, then three updates of a tiny MaskGiTUViT_v2's parameters (JAX
weights carried across) from the same seeded gradients, handed to each side
in its own layout, with global-norm clipping that binds, with and without
gradient accumulation (``optax.MultiSteps``), and a resume from
``state_dict`` that must continue bit for bit.  Feeding both sides the same
gradients holds the optimizers alone: no forward's summation order enters.
"""

import copy
import functools
import io

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.core.convert import flatten_dict
from open_muse_tpu.training import lr_schedules as jlr
from open_muse_tpu.training import quant8 as jq8
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.training import lr_schedules as tlr
from open_muse_tpu_torch.training import quant8 as tq8
from open_muse_tpu_torch.training.optimizers import flax_param_name, get_optimizer, global_norm

from test_torch_models import uvit_pair

LR, WARMUP, CLIP = 1e-3, 1, 1.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from torch's intra-op threads, and the
    parallel test workers share the cores: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
NEW = ("8bit_adamw", "bf16_adamw", "lion")


def _arrays(seed, shape, signed):
    """Entries over 7 decades with both signs (or none), whole blocks of
    zeros, exact codebook values and exact block maxima."""
    rs = np.random.RandomState(seed)
    x = 10.0 ** rs.uniform(-7, 1, shape) * (rs.choice([-1.0, 1.0], shape) if signed else 1.0)
    flat = x.reshape(-1)
    flat[:256] = 0.0
    table = tq8.SIGNED_TABLE if signed else tq8.UNSIGNED_TABLE
    flat[300:300 + 64] = table[rs.randint(0, 256, 64)]
    return x.astype(np.float32)


def test_tables_equal_jax():
    np.testing.assert_array_equal(tq8.SIGNED_TABLE, np.asarray(jq8.SIGNED_TABLE))
    np.testing.assert_array_equal(tq8.UNSIGNED_TABLE, np.asarray(jq8.UNSIGNED_TABLE))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(1000,), (3, 300), (2, 5, 256), (300, 7)])
def test_quantize_blockwise_equals_jax(shape, signed):
    """Codes and absmax exactly JAX's (blocks along the last axis, padding,
    zero blocks, exact codebook values), and so the dequantised arrays."""
    x = _arrays(len(shape) + 7 * signed, shape, signed)
    jtable = jq8.SIGNED_TABLE if signed else jq8.UNSIGNED_TABLE
    ttable = torch.from_numpy(tq8.SIGNED_TABLE if signed else tq8.UNSIGNED_TABLE)
    want = jq8.quantize_blockwise(jnp.asarray(x), jtable)
    codes, absmax = tq8.quantize_blockwise(torch.from_numpy(x), ttable)
    assert codes.dtype == torch.uint8 and tuple(absmax.shape) == want.absmax.shape
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(want.absmax))
    np.testing.assert_array_equal(tq8.dequantize_blockwise(codes, absmax, ttable).numpy(),
                                  np.asarray(jq8.dequantize_blockwise(want, jtable)))


@functools.lru_cache(maxsize=None)
def _models():
    return uvit_pair(3, force_down_up_sample=True)


def _pair(name, accumulation_steps=1):
    """A tiny U-ViT (with its ConvTranspose, so one weight's JAX layout
    flips) in both packages with the same weights, and ``name`` in each."""
    jm, port = _models()
    port = copy.deepcopy(port)
    schedule = ("constant_with_warmup", LR, WARMUP)
    tx = jax_get_optimizer(name, jlr.get_scheduler(*schedule), weight_decay=0.01,
                           max_grad_norm=CLIP)
    if accumulation_steps > 1:
        tx = optax.MultiSteps(tx, accumulation_steps)
    optimizer = get_optimizer(name, port, tlr.get_scheduler(*schedule), weight_decay=0.01,
                              max_grad_norm=CLIP, accumulation_steps=accumulation_steps)
    return jm.params, tx, port, optimizer


def _grads(params, seed):
    """Seeded gradients over 5 decades, as a JAX tree; their global norm is
    far above CLIP, so the clip binds."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rs.standard_normal(p.shape) * 10.0 ** rs.uniform(-5, 0, p.shape))
        .astype(np.float32), params)


def _to_port(tree, port):
    state, unused = jax_params_to_state_dict(
        {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree)).items()}, port)
    assert not unused, unused
    return state


def _port_update(port, optimizer, grads):
    emit = optimizer.begin_step()
    for name, p in port.named_parameters():
        p.grad = grads[name].clone()
    optimizer.update(global_norm([p.grad for p in port.parameters()]), emit)
    optimizer.end_step(emit)


def _quant8_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, jq8.Quant8State))
        if isinstance(s, jq8.Quant8State))


def _assert_codes(port, optimizer, opt_state):
    """The port's codes and absmax (kept in the JAX layout) against JAX's, leaf
    by leaf: codes equal but at fp32 rounding boundaries, where they differ
    by one code in at most 0.1% of a leaf's elements; absmax to rtol 1e-5."""
    q8 = _quant8_state(opt_state)
    quantized = 0
    for key, tree in (("exp_avg", q8.mu), ("exp_avg_sq", q8.nu)):
        flat = flatten_dict(tree)
        for name, p in port.named_parameters():
            leaf = flat[flax_param_name(port, name)]
            state = optimizer.torch_optimizer.state[p]
            if not isinstance(leaf, jq8.Quantized8):
                assert f"{key}_codes" not in state, name
                continue
            quantized += 1
            codes = state[f"{key}_codes"].numpy().astype(np.int32)
            want = np.asarray(leaf.codes).astype(np.int32)
            assert codes.shape == want.shape, (name, codes.shape, want.shape)
            differ = codes != want
            assert np.abs(codes - want).max() <= 1 and differ.mean() <= 1e-3, (name, differ.sum())
            np.testing.assert_allclose(state[f"{key}_absmax"].numpy(), np.asarray(leaf.absmax),
                                       rtol=1e-5, err_msg=name)
    assert quantized >= 8


def _assert_params(port, params, name, accumulation_steps):
    """Every element within one update of JAX's (LR; lion 2 x LR: a sign
    flipped by fp32 noise), and at most 0.1% of them beyond 2e-6 (Adam's m /
    (sqrt(v) + eps) turns summation noise in an element whose moments lie at
    eps into a step of up to LR)."""
    want = _to_port(params, port)
    moved, total = 0, 0
    for n, p in port.named_parameters():
        diff = (p.detach() - want[n]).abs()
        assert float(diff.max()) <= (2 * LR if name == "lion" else LR), (n, float(diff.max()))
        moved += int((diff > 2e-6).sum())
        total += p.numel()
    assert moved <= 1e-3 * total, (name, accumulation_steps, moved, total)


@pytest.mark.parametrize("accumulation_steps", [1, 2])
@pytest.mark.parametrize("name", NEW)
def test_three_updates_match_jax(name, accumulation_steps):
    """Three updates (six calls under accumulation 2) from the same
    gradients, warmup over one update (the first at lr 0), weight decay 0.01
    on the decay mask, clipping at 1.0; the parameters after every call, and
    for 8bit_adamw the codes and absmax, against JAX's."""
    params, tx, port, optimizer = _pair(name, accumulation_steps)
    opt_state = jax.jit(tx.init)(params)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}

    @jax.jit
    def jax_update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for call in range(3 * accumulation_steps):
        grads = _grads(params, 50 + call)
        params, opt_state = jax_update(grads, opt_state, params)
        _port_update(port, optimizer, _to_port(grads, port))
        _assert_params(port, params, name, accumulation_steps)
        if name == "8bit_adamw" and optimizer.count:
            _assert_codes(port, optimizer, opt_state)
    assert optimizer.count == 3
    assert any(not torch.equal(p.detach(), start[n]) for n, p in port.named_parameters())


@pytest.mark.parametrize("name", NEW)
def test_resume_is_exact(name):
    """Two updates, ``state_dict`` through ``torch.save``, a fresh model and
    optimizer loaded from it, then one more update on each side: parameters
    and every state tensor bit-equal to the run that never stopped, and the
    state's dtypes kept (uint8 codes, the bf16 first moment)."""
    params, _, port, optimizer = _pair(name, accumulation_steps=2)
    again = copy.deepcopy(port)
    grads = [_to_port(_grads(params, 70 + i), port) for i in range(5)]
    for g in grads[:3]:
        _port_update(port, optimizer, g)
    buf = io.BytesIO()
    torch.save({"model": port.state_dict(), "optimizer": optimizer.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    again.load_state_dict(saved["model"])
    resumed = get_optimizer(name, again, tlr.get_scheduler("constant_with_warmup", LR, WARMUP),
                            weight_decay=0.01, max_grad_norm=CLIP, accumulation_steps=2)
    resumed.load_state_dict(saved["optimizer"])
    for g in grads[3:]:
        _port_update(port, optimizer, g)
        _port_update(again, resumed, g)
    assert resumed.count == optimizer.count == 2
    for (n, p), q in zip(port.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
        mine, theirs = optimizer.torch_optimizer.state[p], resumed.torch_optimizer.state[q]
        assert mine.keys() == theirs.keys(), n
        for key, value in mine.items():
            assert value.dtype == theirs[key].dtype and torch.equal(value, theirs[key]), (n, key)
    dtypes = {v.dtype for s in resumed.torch_optimizer.state.values() for v in s.values()}
    assert {"8bit_adamw": torch.uint8, "bf16_adamw": torch.bfloat16,
            "lion": torch.float32}[name] in dtypes


def test_state_bytes():
    """8bit_adamw keeps ~2 bytes a parameter of moments on the quantised
    leaves (a code each and an fp32 absmax a 256-block), against AdamW's 8."""
    _, _, port, optimizer = _pair("8bit_adamw")
    _port_update(port, optimizer, {n: torch.ones_like(p) for n, p in port.named_parameters()})
    quantized = [p for p in port.parameters() if p.numel() >= tq8.MIN_QUANT_SIZE]
    state_bytes = sum(v.numel() * v.element_size() for p in quantized
                      for k, v in optimizer.torch_optimizer.state[p].items() if k != "step")
    n = sum(p.numel() for p in quantized)
    assert 2.0 <= state_bytes / n <= 2.0 + 8 / tq8.BLOCK_SIZE + 0.2, state_bytes / n
    with pytest.raises(ValueError, match="not supported"):
        get_optimizer("sgd", port, LR)
