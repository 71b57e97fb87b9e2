"""The PyTorch port's geometry core equals the JAX package's, exactly.

Phase plans, halo tiles, output extents, the host padding and the layer
geometry are integer arithmetic: every case must be equal, no tolerance."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import offsets as j_offsets
from repro.core import tiling as j_tiling
from repro.kernels.deconv2d.ops import halo_pad_geometry as j_halo_pad_geometry
from repro_torch.core import offsets as t_offsets
from repro_torch.core import tiling as t_tiling
from repro_torch.kernels.deconv2d.ops import halo_pad_geometry

KS = [(1, 1), (3, 1), (3, 2), (4, 1), (4, 2), (5, 2), (5, 3), (7, 1), (4, 3)]


def _tiles(s):
    return [s * m for m in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("k,s", KS)
def test_phase_plan_matches_reference(k, s):
    for p in range(k):
        a = j_offsets.make_phase_plan(k, s, p)
        b = t_offsets.make_phase_plan(k, s, p)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.left_halo, a.right_halo) == (b.left_halo, b.right_halo)
        np.testing.assert_array_equal(j_offsets.offset_table(k, s, p),
                                      t_offsets.offset_table(k, s, p))


@pytest.mark.parametrize("k,s", KS)
def test_halo_tile_and_extents_match_reference(k, s):
    for p in range(k):
        for t in _tiles(s):
            a = j_tiling.halo_tile(t, k, s, p)
            b = t_tiling.halo_tile(t, k, s, p)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.step, a.overlap, a.min_padded_extent(3)) == \
                (b.step, b.overlap, b.min_padded_extent(3))
            assert j_tiling.exact_input_extent(t, k, s, p) == \
                t_tiling.exact_input_extent(t, k, s, p)
        for i in range(1, 9):
            assert j_tiling.out_size(i, k, s, p) == t_tiling.out_size(i, k, s, p)


@pytest.mark.parametrize("k,s", KS)
def test_halo_pad_geometry_matches_reference(k, s):
    for p in range(k):
        jp = j_offsets.make_phase_plan(k, s, p)
        tp = t_offsets.make_phase_plan(k, s, p)
        for ih, iw in ((1, 1), (4, 5), (7, 7)):
            if t_tiling.out_size(min(ih, iw), k, s, p) < 1:
                continue
            for t in _tiles(s)[:3]:
                for n, t_n in ((1, 1), (5, 2), (64, 8)):
                    args = (n, ih, iw, 6, 5, None, t, t, 4, 4, t_n)
                    want = j_halo_pad_geometry(*args[:5], jp, *args[6:])
                    got = halo_pad_geometry(*args[:5], tp, *args[6:])
                    assert got == want


@pytest.mark.parametrize("k,s", KS)
def test_deconv_geometry_matches_reference(k, s):
    for p in range(k):
        for ih, iw in ((1, 1), (4, 6), (16, 16)):
            if t_tiling.out_size(min(ih, iw), k, s, p) < 1:
                continue
            a = j_tiling.DeconvGeometry(ih, iw, 8, 3, k, s, p)
            b = t_tiling.DeconvGeometry(ih, iw, 8, 3, k, s, p)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.out_h, a.out_w, a.macs, a.ops, a.halo_padding()) == \
                (b.out_h, b.out_w, b.macs, b.ops, b.halo_padding())


@pytest.mark.parametrize("k,s", KS)
def test_output_macs_count_the_products_that_reach_the_output(k, s):
    """A transposed conv of ones by ones (one channel each way) puts at
    every output pixel the number of products that land there; their sum
    times C_in x C_out is the work the layer needs, below ``macs`` by the
    contributions the padding crops."""
    for p in range(k):
        for ih, iw in ((1, 1), (4, 6), (7, 7)):
            g = t_tiling.DeconvGeometry(ih, iw, 8, 3, k, s, p)
            if min(g.out_h, g.out_w) < 1:
                continue
            hits = F.conv_transpose2d(torch.ones(1, 1, ih, iw, dtype=torch.float64),
                                      torch.ones(1, 1, k, k, dtype=torch.float64),
                                      stride=s, padding=p)
            assert g.output_macs == int(hits.sum()) * 8 * 3
            assert g.output_macs <= g.macs
            if p == 0:
                assert g.output_macs == g.macs


def test_kernel_smem_bytes_counts_padded_window_and_slab():
    """The shared-memory models.  fp32 ("tc"): per ring stage the staged
    windows of t_n images with a channel stride of t_ci + 4 words, plus
    the weight rows of the block's valid taps at a stride of 8 mod 16
    words; as many stages (2..4) as 100 KB holds; under a cluster split at
    least the partial tile.  bf16 (also "tc"): the same arrays in 2-byte
    elements, the window's channel stride t_ci + 8."""
    g = t_tiling.DeconvGeometry(8, 8, 512, 256, 4, 2, 1)
    ht = t_tiling.halo_tile(8, 4, 2, 1)
    # every 8x8 tile of the 16x16 output stages a 6x6 window and 2x2 taps
    # per phase, 16 in all; 64 channels in rows of 72 words
    assert t_tiling.staged_window(8, 16, 8, 4, 2, 1) == (ht.extent, 4)
    assert t_tiling.tc_weight_stride(64) == 72
    stage = 4 * (2 * 6 * 6 * 20 + 16 * 16 * 72)
    assert t_tiling.kernel_smem_bytes(g, 8, 8, 16, 64, t_n=2) == 2 * stage
    # t_ci = 8, t_co = 32 (rows of 40 words): four stages fit 100 KB
    stage = 4 * (2 * 6 * 6 * 12 + 16 * 8 * 40)
    assert t_tiling.kernel_smem_bytes(g, 8, 8, 8, 32, t_n=2) == 4 * stage
    # a 1x1 root stages one pixel and one tap of K*K per 1-pixel tile
    root = t_tiling.DeconvGeometry(1, 1, 100, 256, 7, 1, 0)
    assert t_tiling.staged_window(1, 7, 1, 7, 1, 0) == (1, 1)
    stage = 4 * (4 * 12 + 8 * 72)
    assert t_tiling.kernel_smem_bytes(root, 1, 1, 8, 64, t_n=4) == 4 * stage
    # under a split the partial tile (here 4 images x 64 channels) shares
    # the ring's memory; at 64 images x 128 channels it needs more
    assert t_tiling.kernel_smem_bytes(root, 1, 1, 8, 64, t_n=4, split=2) == \
        4 * stage
    assert 4 * 4 * (64 * 12 + 8 * 136) < 4 * 64 * 128 == \
        t_tiling.kernel_smem_bytes(root, 1, 1, 8, 128, t_n=64, split=2)
    # bf16 at the first tiles: rows of 24 elements, weight rows of 72, 2
    # bytes each: two stages now fit 100 KB (fp32's two did not)
    stage = 2 * (2 * 6 * 6 * 24 + 16 * 16 * 72)
    assert t_tiling.kernel_smem_bytes(g, 8, 8, 16, 64, 2, "tc", 1,
                                      "bfloat16") == 2 * stage <= 100 * 1024
    # the bf16 root at t_n 4: one pixel and one tap per image, four stages
    stage = 2 * (4 * 24 + 16 * 72)
    assert t_tiling.kernel_smem_bytes(root, 1, 1, 16, 64, 4, "tc", 1,
                                      "bfloat16") == 4 * stage


def test_block_threads_cover_every_phase():
    # fp32, S=2, wide: 4 phases x one m16 tile x two 32-channel warp tiles
    assert t_tiling.block_threads(2, 8, 8, 64, 1) == 32 * 4 * 1 * 2
    # 9 phases of 9 pixels (one m16 tile), 8 channels (one n8 tile)
    assert t_tiling.block_threads(3, 9, 9, 8, 1) == 32 * 9
    # thin tanh layer: 64 pixels per phase in two 32-row warp tiles, one
    # channel in an n8 tile
    assert t_tiling.block_threads(2, 16, 16, 1, 1) == 32 * 4 * 2
    assert t_tiling.tc_warp_tile(64, 1) == (2, 1)
    assert t_tiling.launch_threads(1, 1, 1, 8, 1) == 128
    # every dtype runs on the "tc" kernels (bf16 at the same warp grid);
    # the FMA kernel ("simt") is gone
    assert t_tiling.kernel_for("bfloat16") == "tc"
    for fn in (t_tiling.block_threads, t_tiling.launch_threads):
        with pytest.raises(ValueError, match="unknown kernel"):
            fn(2, 8, 8, 64, 1, "simt")
    with pytest.raises(ValueError, match="unknown kernel"):
        t_tiling.kernel_smem_bytes(
            t_tiling.DeconvGeometry(1, 1, 100, 256, 7, 1, 0), 1, 1, 16, 64,
            4, "simt")
