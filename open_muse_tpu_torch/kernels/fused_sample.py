"""Vocab crop + (CFG combine +) Gumbel-max sample + confidence in one pass
(csrc/fused_sample.cu).

Counterparts of ``open_muse_tpu/ops/pallas/fused_sample.py``
``fused_categorical_cfg`` and ``fused_categorical``.  Sampling matches JAX
only in distribution; with the same explicit ``gumbel`` noise the token ids
match exactly.

On the card the kernel draws its noise from a Philox4x32-10 stream: one
call per four columns, counter (col // 4, row0 + row, 0, 0), key the 64-bit
seed, word col % 4 the bits of column col; ``row0`` is 0 but where a rank
samples rows ``row0 ..`` of a larger batch (sharded serving), so that it
draws what the whole batch's call draws for them.  The kernel loads the seed from device
memory, an int64 ``seed=`` tensor, so that a captured CUDA graph replays
with each request's seed; a CPU ``generator=`` has one drawn on the host
(``draw_seed``) and copied over.  ``philox_gumbel_plain`` draws the same
noise in torch: the plain version's noise for ``seed=`` on the CPU.
"""

from __future__ import annotations

import torch

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["fused_categorical", "fused_categorical_plain", "fused_categorical_cfg",
           "fused_categorical_cfg_plain", "sample_gumbel", "draw_seed", "philox4x32_plain",
           "philox_gumbel_plain"]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def sample_gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Gumbel(0, 1) noise on the CPU from ``generator``, drawn as
    ``jax.random.gumbel`` does: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit seed for the in-kernel Philox stream, from a CPU generator."""
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator))


def _mulhilo(a: int, c):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values ``c`` (int64), without overflowing int64: ``a`` in two
    16-bit halves."""
    lo_part, hi_part = c * (a & 0xFFFF), c * (a >> 16)  # each < 2^48
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    return (hi_part + (lo_part >> 16)) >> 16, lo


def philox4x32_plain(counters, key: int):
    """Philox4x32-10 (Salmon et al., SC 2011; Random123's philox4x32 with 10
    rounds): counters (..., 4) of uint32 values carried in int64 and a 64-bit
    key -> (..., 4) output words, uint32 in int64."""
    c = [counters[..., i].to(torch.int64) & _MASK32 for i in range(4)]
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return torch.stack(c, dim=-1)


def philox_gumbel_plain(seed: int, rows: int, cols: int, device=None, row0: int = 0):
    """The Gumbel noise (rows, cols) fp32 of the kernel's Philox route for a
    seed from ``draw_seed``: column col of row r takes word col % 4 of the
    call on counter (col // 4, row0 + r, 0, 0); its top 24 bits give u in (0,
    1) as the TPU kernel does, then -log(-log(u))."""
    calls = -(-cols // 4)
    col, row = torch.meshgrid(torch.arange(calls, device=device),
                              torch.arange(row0, row0 + rows, device=device), indexing="xy")
    zero = torch.zeros_like(col)
    bits = philox4x32_plain(torch.stack([col, row, zero, zero], dim=-1), seed)
    bits = bits.reshape(rows, 4 * calls)[:, :cols]
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def fused_categorical_plain(logits, vocab_limit: int, gumbel):
    """crop -> fp32 -> argmax(x + gumbel), first index on ties -> (ids int32,
    exp(x[id] - logsumexp(x)))."""
    x = logits[..., :vocab_limit].float()
    ids = torch.argmax(x + gumbel[..., :vocab_limit], dim=-1)
    sel = torch.exp(torch.gather(x, -1, ids[..., None])[..., 0] - torch.logsumexp(x, -1))
    return ids.to(torch.int32), sel


def fused_categorical_cfg_plain(logits, guidance, vocab_limit: int, gumbel):
    """crop -> fp32 -> u + g (c - u) -> the CFG-free sampler."""
    b = logits.shape[0] // 2
    x = logits[..., :vocab_limit].float()
    return fused_categorical_plain(x[b:] + guidance * (x[:b] - x[b:]), vocab_limit, gumbel)


def _sample(wrapper, entry: str, plain, logits, b, vocab_limit, gumbel, generator, seed, row0,
            *guidance):
    """Shared by both wrappers: check the noise, then the plain version for
    CPU tensors or, for CUDA tensors, the kernel behind the C function
    ``entry`` (``guidance`` passed after ``vocab_limit``), counted in
    ``wrapper.launches``."""
    name = wrapper.__name__
    s, v_raw = logits.shape[1:]
    if not 0 < vocab_limit <= v_raw:
        raise ValueError(f"bad logits {tuple(logits.shape)} / vocab_limit {vocab_limit}")
    if sum(x is not None for x in (gumbel, generator, seed)) != 1:
        raise ValueError("pass exactly one of gumbel=, seed= and generator=")
    if gumbel is not None and (gumbel.shape[:2] != (b, s) or gumbel.shape[2] < vocab_limit):
        raise ValueError(f"gumbel {tuple(gumbel.shape)} does not cover ({b}, {s}, "
                         f"{vocab_limit})")
    if seed is not None and (seed.dtype != torch.int64 or seed.numel() != 1):
        raise ValueError(f"seed must hold one int64, got {seed.dtype} {tuple(seed.shape)}")
    if on_cpu(logits, gumbel, seed):
        if generator is not None:
            gumbel = sample_gumbel((b, s, vocab_limit), generator)
        elif seed is not None:
            gumbel = philox_gumbel_plain(int(seed.reshape(())), b * s, vocab_limit,
                                         row0=row0 * s)
            gumbel = gumbel.reshape(b, s, vocab_limit)
        return plain(logits, *guidance, vocab_limit, gumbel)
    require_cuda(name, (torch.bfloat16, torch.float32), logits)
    for noise in (gumbel, seed):
        if noise is not None and noise.device != logits.device:
            raise ValueError(f"{name}: noise on {noise.device}, logits on {logits.device}")
    if gumbel is not None:
        require_cuda(name, (torch.float32,), gumbel)
    if generator is not None:
        seed = torch.tensor([draw_seed(generator)], dtype=torch.int64).to(logits.device)
    ids = torch.empty((b, s), dtype=torch.int32, device=logits.device)
    sel = torch.empty((b, s), dtype=torch.float32, device=logits.device)
    check(getattr(library(), entry)(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16), b * s, v_raw, vocab_limit,
        *guidance, None if gumbel is None else gumbel.data_ptr(),
        0 if gumbel is None else gumbel.shape[2], None if seed is None else seed.data_ptr(),
        row0 * s, ids.data_ptr(), sel.data_ptr(), stream_handle(logits)), name)
    wrapper.launches += 1
    return ids, sel


def fused_categorical_cfg(logits, guidance: float, vocab_limit: int, gumbel=None,
                          generator: torch.Generator | None = None, seed=None,
                          row0: int = 0):
    """logits (2B, S, V_raw), cond rows first -> (ids (B, S) int32,
    sel (B, S) fp32).  Noise is one of ``gumbel`` (B, S, >= vocab_limit)
    fp32, the Philox stream of ``seed`` (an int64 tensor of one element on
    the logits' device), or the stream of a seed drawn from the CPU
    ``generator`` (on the CPU: ``sample_gumbel`` from it, as before).
    ``row0``: the batch row these logits' first image is in the stream
    (a rank's share of a sharded batch), read with ``seed`` alone."""
    if logits.shape[0] % 2:
        raise ValueError(f"CFG logits {tuple(logits.shape)} need cond and uncond halves")
    return _sample(fused_categorical_cfg, "muse_cfg_sample", fused_categorical_cfg_plain, logits,
                   logits.shape[0] // 2, vocab_limit, gumbel, generator, seed, row0,
                   float(guidance))


fused_categorical_cfg.launches = 0


def fused_categorical(logits, vocab_limit: int, gumbel=None,
                      generator: torch.Generator | None = None, seed=None, row0: int = 0):
    """The CFG-free sampler: logits (B, S, V_raw) -> (ids (B, S) int32,
    sel (B, S) fp32) over the first ``vocab_limit`` columns.  Noise as for
    ``fused_categorical_cfg``."""
    return _sample(fused_categorical, "muse_sample", fused_categorical_plain, logits,
                   logits.shape[0], vocab_limit, gumbel, generator, seed, row0)


fused_categorical.launches = 0
