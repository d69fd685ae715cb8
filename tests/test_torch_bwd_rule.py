"""The sublayer backwards' attention route (``csrc/attn_sublayer.cu``), read
from the C source: every (S, L) takes exactly one route, the one-block
kernel up to 288 queries and 256 keys and the long route's rows and columns
kernels above, and the wrapper's scratch for the long route is what its C
launcher indexes.  CPU only: the rule lives in C (``bwd_one_block`` reads it
from the built library on the card); the CUDA tests run both routes."""

import itertools
import math
import re
from pathlib import Path

import pytest

from open_muse_tpu_torch.kernels import attn_sublayer as A

CSRC = (Path(__file__).resolve().parent.parent / "open_muse_tpu_torch" / "csrc"
        / "attn_sublayer.cu").read_text()


def _namespace(name):
    """The body of ``namespace name { ... }  // namespace name``."""
    start = CSRC.index(f"namespace {name} {{")
    return CSRC[start:CSRC.index(f"}}  // namespace {name}", start)]


def _constant(body, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


BWD, LNG = _namespace("bwd"), _namespace("lng")
MAX_ROWS, MAX_KEYS = _constant(BWD, "kMaxRows"), _constant(BWD, "kMaxKeys")


def one_block(queries, keys):
    """``bwd::takes`` as the C source states it."""
    return queries <= MAX_ROWS and keys <= MAX_KEYS


def test_the_c_rule_is_the_one_read_here():
    """The launcher routes by ``bwd::takes`` alone, to ``bwd::launch`` or
    ``lng::launch``; ``muse_attn_bwd_one_block`` answers with the same test."""
    assert (MAX_ROWS, MAX_KEYS) == (288, 256)
    assert ("constexpr bool takes(int S, int L) { return S <= kMaxRows && L <= kMaxKeys; }"
            in BWD)
    assert ("err = bwd::takes(S, args.L) ? bwd::launch(bargs, B, stream) : "
            "lng::launch(bargs, B, stream);") in CSRC
    assert ('extern "C" int muse_attn_bwd_one_block(int S, int L) { return bwd::takes(S, L) '
            "? 1 : 0; }") in CSRC
    # the mma.sync kernels that took these shapes before are gone
    assert "attn_bwd_q_kernel" not in CSRC and "attn_bwd_kv_kernel" not in CSRC


def test_every_shape_takes_one_route():
    """Self (S = L) and cross (S queries over L text keys) on a grid up to
    1100: one route each, the long one exactly where the one-block kernel's
    capacity is passed."""
    routes = {"one_block": 0, "long": 0}
    for queries, keys in itertools.chain(((s, s) for s in range(1, 1101)),
                                         itertools.product(range(1, 1101, 7),
                                                           range(1, 1101, 3))):
        route = "one_block" if one_block(queries, keys) else "long"
        assert (route == "long") == (queries > 288 or keys > 256)
        routes[route] += 1
    assert all(routes.values())


@pytest.mark.parametrize("queries,keys,want", [
    (288, 256, "one_block"), (289, 256, "long"), (288, 257, "long"), (256, 256, "one_block"),
    (257, 257, "long"), (1024, 1024, "long"), (1024, 77, "long"), (1024, 1, "long"),
    (288, 77, "one_block"), (289, 77, "long"), (17, 288, "long"), (1, 1, "one_block")])
def test_route_at_the_boundaries(queries, keys, want):
    assert ("one_block" if one_block(queries, keys) else "long") == want


@pytest.mark.parametrize("batch,heads,queries", [(2, 16, 1024), (8, 16, 1024), (2, 8, 300),
                                                 (1, 16, 289), (3, 4, 17), (2, 16, 520)])
def test_long_route_scratch_is_what_the_launcher_indexes(batch, heads, queries):
    """The rows kernel writes query tile t of pair p at (p ceil(S / 64) + t)
    kStatFloats, kStatFloats = 3 x 64 (max c, 1 / sum, D of 64 rows), and the
    columns kernel reads one tile's kStatBytes in one bulk copy: the
    wrapper's (B, H, ceil(S / 64), 3, 64) fp32 holds every pair's tiles,
    each 16-byte aligned."""
    assert (_constant(LNG, "kStatRows"), A.STAT_ROWS) == (64, 64)
    assert "constexpr int kStatFloats = 3 * kStatRows;" in LNG and A.STATS == 3
    assert "constexpr int kStatBytes = kStatFloats * 4;" in LNG
    assert "float* st = stats + (int64_t(pair) * q_tiles + t) * kStatFloats;" in LNG
    assert "const float* src = stats + int64_t(pair) * q_tiles * kStatFloats;" in LNG
    assert "st[2 * kStatRows + row]" in LNG and "sm + 2 * kStatRows + q" in LNG
    shape = A.bwd_stats_shape(batch, heads, queries)
    tiles = -(-queries // 64)
    assert shape == (batch, heads, tiles, 3, 64)
    # one past the last float the kernels touch: the last pair's last tile
    end = ((batch * heads - 1) * tiles + tiles - 1) * 192 + 192
    assert math.prod(shape) == end
    assert (192 * 4) % 16 == 0  # each tile's statistics: one 16-byte aligned bulk copy
