"""The pix2pix U-Net's cell: its files found by name, the yardstick's counts
against an independent count, the reference against its control and its
shapes, and a run of the harness on the CPU (the kernels' plain versions)
at a small size."""
import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchkit import harness, spec

CELL = "pix2pix.frames16"
SMALL = {"name": "unet-small", "family": "unet_skip", "system": "unet_serve",
         "dtype": "float32", "z_dim": 32 * 32 * 3, "in_hw": 32, "in_c": 3,
         "out_c": 3, "ngf": 16, "num_downs": 5, "eps": 1e-5, "slope": 0.2}


@pytest.fixture(scope="module")
def cell():
    return spec.find_cell(spec.load_benchmark(), CELL)


@pytest.fixture(scope="module")
def fam():
    return spec.load_module("configs", "unet_skip")


def test_the_cell_finds_its_files(cell):
    assert cell.chips == 1
    assert cell.config["family"] == "unet_skip"
    assert cell.config["system"] == "unet_serve"
    assert cell.traffic["buckets"] == [16] and cell.traffic["rows"] == {
        "kind": "fixed", "value": 16}
    assert cell.config["z_dim"] == 256 * 256 * 3
    assert spec.load_module("systems", "unet_serve").System
    per_layer = {m["name"] for m in cell.per_layer}
    assert per_layer == {"engine.copy_us_per_image", "layer.other_us_per_image",
                         "b1.us_per_image", "b1.roofline_share",
                         "device.idle_share", "mfu"}
    for read in spec.metric_readers(cell.end_to_end + cell.per_layer).values():
        assert callable(read)


def _macs_inside(in_hw, up, c_in, c_out):
    """Multiply-adds that land inside the map, counted by running the
    layer on ones: each output value sums the taps that reach it."""
    one = torch.ones(1, 1, in_hw, in_hw, dtype=torch.float64)
    k = torch.ones(1, 1, 4, 4, dtype=torch.float64)
    op = F.conv_transpose2d if up else F.conv2d
    return float(op(one, k, stride=2, padding=1).sum()) * c_in * c_out


def test_flops_per_image_by_an_independent_count(cell, fam):
    cfg = cell.config
    ch = [64, 128, 256, 512, 512, 512, 512, 512]
    total, hw, c_in = 0.0, 256, 3
    for c in ch:
        total += _macs_inside(hw, False, c_in, c)
        hw, c_in = hw // 2, c
    ups = [(512, 512), (1024, 512), (1024, 512), (1024, 512), (1024, 256),
           (512, 128), (256, 64), (128, 3)]
    for ci, co in ups:
        total += _macs_inside(hw, True, ci, co)
        hw *= 2
    assert abs(2 * total - 11.400e9) <= 1e6
    assert fam.flops_per_image(cfg) == 2 * total
    counts = fam.layer_counts(cfg, 16)
    assert len(counts) == 16
    assert sum(f for f, _ in counts) == 16 * 2 * total
    assert len(fam.norm_bytes(cfg, 16)) == 15
    # every launch's bytes at least its input and output, in float32
    assert all(b >= 4 * 16 * 2 * 3 for _, b in counts)


def test_reference_shapes_and_the_control(fam):
    """On a small configuration the control (TF32 inputs and weights) lies
    above the cell's limit, and a shape that does not fit reads inf."""
    limit = spec.load_config(spec.load_benchmark(),
                             "pix2pix-unet256")["limits"]["max_abs_err"]
    w = fam.make_weights(SMALL, 2**31 + 5, "cpu")
    z = np.random.default_rng(0).standard_normal(
        (2, SMALL["z_dim"])).astype(np.float32)
    y = fam.forward(SMALL, w, torch.from_numpy(z)).numpy()
    assert y.shape == (2, 32, 32, 3)
    assert fam.max_abs_err(SMALL, w, z, y, "cpu") == 0.0
    ctl = fam.control_images(SMALL, w, z, "cpu")
    assert fam.max_abs_err(SMALL, w, z, ctl, "cpu") > limit
    assert fam.max_abs_err(SMALL, w, z, y[:, :16], "cpu") == math.inf
    assert fam.max_abs_err(SMALL, w, z[:1], y, "cpu") == math.inf


def test_a_small_run_on_the_cpu_is_correct():
    small = {**SMALL, "limits": {"max_abs_err": 1e-4}}
    mix = {"loop": "closed", "clients": 1,
           "rows": {"kind": "fixed", "value": 3}, "buckets": [4],
           "max_batch": 4, "pool_rows": 12, "check_requests": 2}
    bench = spec.load_benchmark()
    c = spec.Cell("small.frames", 1, small, mix, bench["end_to_end"], [])
    seed = 2**31 + 17
    run = harness.execute(c, seed, 0.2, False, time.perf_counter(),
                          device="cpu")
    assert run.failed == 0 and run.images == 3 * run.attempted > 0
    assert run.counters["padded_images"] == run.attempted
    assert run.counters["input_bytes"] == 4 * small["z_dim"] * run.images
    err = harness.check(run, seed, device="cpu")
    assert err < 1e-5



def test_norm_bytes_by_hand(cell, fam):
    """Each norm launch reads its map once and writes every slot it fills:
    the image's space-to-depth once, h_1 and x_3 .. x_8 twice (the next
    conv's input and the skip), u_8 .. u_2 once; gamma and beta are read
    once a channel."""
    b = 16
    down = [(128, 64, 0), (64, 128, 1), (32, 256, 1), (16, 512, 1),
            (8, 512, 1), (4, 512, 1), (2, 512, 1)]
    up = [(2, 512), (4, 512), (8, 512), (16, 512), (32, 256), (64, 128),
          (128, 64)]
    want = [4.0 * 2 * b * 256 * 256 * 3]
    want += [4.0 * (3 * b * hw * hw * c + 2 * c * affine)
             for hw, c, affine in down]
    want += [4.0 * (2 * b * hw * hw * c + 2 * c) for hw, c in up]
    assert fam.norm_bytes(cell.config, b) == want
    assert abs(sum(fam.norm_bytes(cell.config, 1)) - 41.8e6) < 0.1e6
