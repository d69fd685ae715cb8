"""Kernel 5's variant rule as ``kernels/flash_attention.py`` mirrors it from
the C launcher (``csrc/flash_attention.cu``): every (Tk, D, B H, Tq) maps
to exactly one variant, and the boundaries the C header states hold.  CPU
only; the CUDA tests hold each variant against the plain version."""

import itertools
import re
from pathlib import Path

import pytest

from open_muse_tpu_torch.kernels.flash_attention import (HEAD_DIMS, MAX_CLUSTER,
                                                         ONE_PASS_MAX_KEYS, VARIANTS,
                                                         one_pass_chunks, one_pass_cluster,
                                                         takes_two_pass, variant)

CSRC = Path(__file__).resolve().parent.parent / "open_muse_tpu_torch" / "csrc" / "flash_attention.cu"


def test_every_shape_maps_to_one_variant():
    """Key counts 1 - 400 at every head dim, pair counts around the card's
    132 SMs and a cluster's edges, query rows around the 64-row tiles."""
    seen = set()
    for tk, d, bh, tq in itertools.product(range(1, 401), HEAD_DIMS,
                                           (1, 2, 16, 24, 32, 44, 45, 66, 67, 131, 132, 133, 2048),
                                           (1, 64, 65, 128, 129, 256, 257, 1024)):
        name = variant(tk, d, bh, tq)
        assert name in VARIANTS
        assert name.startswith("two_pass") == takes_two_pass(tk) == (tk > ONE_PASS_MAX_KEYS)
        seen.add(name)
    assert seen == set(VARIANTS)


@pytest.mark.parametrize("tk,chunks", [(1, 1), (32, 1), (33, 3), (77, 3), (96, 3), (97, 8),
                                       (256, 8), (257, 9), (288, 9)])
def test_wgmma_capacity_per_key_count(tk, chunks):
    assert one_pass_chunks(tk) == chunks


@pytest.mark.parametrize("tk,d,bh,tq,want", [
    (288, 64, 1024, 256, "one_pass_wgmma"), (289, 64, 1024, 256, "two_pass_wgmma"),
    (289, 48, 1024, 256, "two_pass_mma"), (1025, 16, 2, 1025, "two_pass_mma"),
    (80, 16, 8, 64, "one_pass_mma"), (81, 32, 8, 64, "one_pass_mma_split"),
    (288, 32, 4096, 256, "one_pass_mma_split"),
    # the pairs fill the card: persistent blocks at 48 and 64, any key count
    (1, 48, 132, 1, "one_pass_wgmma"), (77, 64, 192, 256, "one_pass_wgmma"),
    (257, 48, 1024, 257, "one_pass_wgmma"), (256, 64, 2048, 256, "one_pass_wgmma"),
    # four 64-row tiles over three warpgroups: clusters of 2 up to 66 pairs
    (256, 64, 66, 256, "one_pass_cluster"), (256, 64, 67, 256, "one_pass_wgmma"),
    # serving: v2's 256 tokens in clusters, its 77 text keys and v1's head
    # dim 48 on mma.sync
    (256, 64, 32, 256, "one_pass_cluster"), (257, 64, 32, 257, "one_pass_cluster"),
    (97, 64, 32, 256, "one_pass_cluster"), (96, 64, 32, 256, "one_pass_mma_split"),
    (77, 64, 24, 256, "one_pass_mma"), (77, 64, 32, 1024, "one_pass_mma"),
    (257, 48, 16, 257, "one_pass_mma_split"),
])
def test_rule_at_the_stated_boundaries(tk, d, bh, tq, want):
    assert variant(tk, d, bh, tq) == want


@pytest.mark.parametrize("bh,tq,tk,want", [
    (132, 256, 256, 1), (66, 256, 256, 2), (32, 256, 256, 2), (16, 257, 257, 3),
    (32, 257, 257, 3), (1, 1025, 256, 6), (1, 1025, 288, MAX_CLUSTER), (32, 1024, 77, 4),
    (2, 1, 256, 1)])
def test_cluster_size(bh, tq, tk, want):
    """Blocks a pair: no more than the card holds for every pair, nor than
    give each consumer warpgroup (3 up to 256 keys, 2 above) one row tile."""
    assert one_pass_cluster(bh, tq, tk) == want


def test_mirror_reads_the_c_constants():
    """The numbers the mirror hard-codes are the C launcher's (the key
    capacities in the attention header it shares with kernels 11 / 12)."""
    src = CSRC.read_text() + (CSRC.parent / "attn_sm90.cuh").read_text()
    assert re.search(r"constexpr int kMaxKeys = (\d+);", src).group(1) == str(ONE_PASS_MAX_KEYS)
    assert re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1) == str(MAX_CLUSTER)
    assert ("constexpr int chunks_for(int Tk) { return Tk <= 32 ? 1 : Tk <= 96 ? 3 : "
            "Tk <= 256 ? 8 : 9; }") in src
    assert "constexpr int consumers_for(int chunks) { return chunks <= 8 ? 3 : 2; }" in src
    assert "return cluster_for(pairs, Tq, Tk, sms) == 1 || (D == 64 && Tk > 96);" in src
    assert "if (Tk <= 80)\n    return launch_one_pass<D, 4, 1, 5>" in src
