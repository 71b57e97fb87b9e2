"""The pix2pix U-Net generator (`models.unet`) against its plain reference
(`models.unet_reference`), its norm kernel's plain version, its serving
engine, its refusals and its size.

CPU: a small U-Net (5 downs, ngf 8, 32 x 32) on seeded weights with
non-trivial gamma, beta and bias, every backend against the reference;
the encoder's space-to-depth rewrite against ``F.conv2d``; the norm
kernel's plain version against the reference's instance norm on a
near-constant channel, and its destinations' layouts; the engine at
buckets 1 and 4 image by image against the reference of that image
alone.  Card (marker ``cuda``; skips without one): the published widths
at bucket 2 through the engine, within the benchmark configuration's
limit.

Tolerances: 1e-5 on the CPU (float32 sums in other orders, through 13
normalisations that rescale by up to ~10 on these weights)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis.check.plan_drc import check_network_plan
from repro_torch.kernels.norm_act import Dest, norm_act_plain, space_to_depth
from repro_torch.models import unet
from repro_torch.models.dcnn import CELEBA_DCNN, make_fused_generator
from repro_torch.models.unet import (PIX2PIX_UNET256, UnetConfig, s2d_weight,
                                     unet_apply, unet_init, unet_param_count)
from repro_torch.models.unet_reference import instance_norm, unet_reference
from repro_torch.plan import NetworkPlan, build_network_plan
from repro_torch.serve import DcnnServeEngine, EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = UnetConfig(name="unet-small", in_hw=32, ngf=8, num_downs=5)
TOL = 1e-5


def _fired(report):
    return sorted({v.rule_id for v in report.violations})


def _params(cfg, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return unet_init(g, cfg, device, w_std=0.2, g_std=0.1, b_std=0.1)


def _images(n, cfg, seed=1):
    return np.random.RandomState(seed).randn(
        n, *cfg.input_shape).astype(np.float32)


def _ref(p, cfg, x):
    with torch.no_grad():
        return unet_reference(p, torch.as_tensor(x), cfg.num_downs,
                              cfg.eps, cfg.slope).cpu().numpy()


@pytest.mark.parametrize("backend", ["reverse_loop", "cuda", "cudnn"])
def test_unet_apply_matches_reference(backend):
    p, x = _params(SMALL), _images(3, SMALL)
    before = dict(unet.LAUNCHES)
    with torch.no_grad():
        y = unet_apply(p, SMALL, torch.from_numpy(x), backend).numpy()
    assert y.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(y, _ref(p, SMALL, x), rtol=0, atol=TOL)
    made = {k: unet.LAUNCHES[k] - v for k, v in before.items()}
    want = ({"b1_enc": 5, "b1_dec": 5, "norm": 9} if backend == "cuda"
            else {"b1_enc": 0, "b1_dec": 0, "norm": 0})
    assert made == want


@pytest.mark.parametrize("c", [3, 8])
def test_space_to_depth_conv_equals_strided_conv(c, rng):
    x = torch.from_numpy(rng.randn(2, 12, 12, c).astype(np.float32))
    w = torch.from_numpy(0.1 * rng.randn(4, 4, c, 5).astype(np.float32))
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                    padding=1).permute(0, 2, 3, 1)
    got = F.conv2d(space_to_depth(x).permute(0, 3, 1, 2),
                   s2d_weight(w).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # and the flipped kernel is B1's stride-1 transposed conv at padding 1
    with torch.no_grad():
        y = unet._conv_down(x, w, "reverse_loop")
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_norm_plain_version_on_a_near_constant_channel(rng):
    """Per image and channel over its own map: a channel of 100 + 1e-2
    noise keeps its variance, which E[x^2] - E[x]^2 in float32 loses."""
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    x[..., 1] = 100.0 + 1e-2 * x[..., 1]
    x[1, ..., 2] *= 50.0
    src = torch.from_numpy(x)
    g = torch.from_numpy(rng.rand(4).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    out = torch.zeros(2, 8, 8, 4)
    norm_act_plain(src, [Dest(out, slope=1.0)], g, b, 1e-5)
    want = instance_norm(src.permute(0, 3, 1, 2), g, b, 1e-5)
    want = want.permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-3)
    naive_var = (src ** 2).mean((1, 2)) - src.mean((1, 2)) ** 2
    true_var = src.double().var((1, 2), unbiased=False)
    assert abs(float(naive_var[0, 1]) / float(true_var[0, 1]) - 1) > 0.05
    # an image's statistics are its own
    out1 = torch.zeros(1, 8, 8, 4)
    norm_act_plain(src[1:], [Dest(out1, slope=1.0)], g, b, 1e-5)
    assert torch.equal(out1[0], out[1])


def test_norm_destinations_layouts(rng):
    x = torch.from_numpy(rng.randn(2, 4, 6, 3).astype(np.float32))
    cat = torch.zeros(3, 4 + 2, 6 + 2, 8)
    s2d = torch.zeros(2, 1 + 3 + 1, 1 + 4 + 1, 16)
    norm_act_plain(x, [Dest(s2d, pad=1, slope=0.2, s2d=True),
                       Dest(cat, pad=1, off=5, slope=0.0)])
    assert torch.equal(cat[:2, 1:5, 1:7, 5:8], torch.relu(x))
    assert not cat[:, :, :, :5].any() and not cat[2].any()
    assert not cat[:, 0].any() and not cat[:, 5].any()
    lrelu = torch.where(x > 0, x, 0.2 * x)
    for a in range(3):
        for b in range(4):
            for p in range(2):
                for q in range(2):
                    h, w = 2 * a + p - 1, 2 * b + q - 1
                    got = s2d[:, 1 + a, 1 + b, (p * 2 + q) * 3:(p * 2 + q + 1) * 3]
                    want = (lrelu[:, h, w] if 0 <= h < 4 and 0 <= w < 6
                            else torch.zeros(2, 3))
                    assert torch.equal(got, want)
    assert not s2d[..., 12:].any() and not s2d[:, 0].any()


def test_engine_images_do_not_depend_on_the_batch():
    """Buckets 1 and 4: 6 rows run as 4 and a padded 4, 3 rows as a padded
    4, 1 row alone, and every image equals the reference of that image
    alone (no padding row or batch mate enters its statistics)."""
    p, x = _params(SMALL, 3), _images(6, SMALL, 4)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=SMALL, backend="cuda", buckets=(1, 4), device="cpu",
        warmup=True), p)
    ys = [eng.generate(x), eng.generate(x[:3]), eng.generate(x[5:])]
    want = np.concatenate([_ref(p, SMALL, x[i:i + 1]) for i in range(6)])
    np.testing.assert_allclose(ys[0], want, rtol=0, atol=TOL)
    np.testing.assert_allclose(ys[1], want[:3], rtol=0, atol=TOL)
    np.testing.assert_allclose(ys[2], want[5:], rtol=0, atol=TOL)
    assert eng.stats["images"] == 10
    assert eng.stats["padded_images"] == 3
    assert eng.stats["input_bytes"] == 10 * 32 * 32 * 3 * 4
    assert eng.kind_launch_counts == {}     # counted at capture, on a card
    for b, plan in eng.plans.items():
        assert plan.batch == b and len(plan.layers) == 10
        check_network_plan(plan, buckets=eng.buckets).raise_if_failed()


def test_drc_refuses_an_edited_unet_plan():
    """The plan carries the U-Net's wiring (``feeds``) through its JSON
    document and hash; the DRC checks every edge it declares, and holds a
    plan without it to a chain."""
    plan = build_network_plan(SMALL, batch=2, autotune=False)
    assert plan.feeds == SMALL.feeds()
    assert _fired(check_network_plan(plan)) == []
    again = NetworkPlan.from_json(plan.to_json())
    assert again.feeds == plan.feeds
    assert again.stable_hash() == plan.stable_hash()
    assert "feeds" not in json.loads(build_network_plan(
        CELEBA_DCNN, batch=2, autotune=False).to_json())
    layers = list(plan.layers)
    g = layers[3].geometry
    layers[3] = dataclasses.replace(layers[3], geometry=dataclasses.replace(
        g, c_out=g.c_out + 8))
    for bad in (dataclasses.replace(plan, layers=tuple(layers)),
                dataclasses.replace(plan, feeds=None),
                dataclasses.replace(plan, feeds=plan.feeds[:-1]
                                    + (((8, False), (2, False)),))):
        assert _fired(check_network_plan(bad)) == ["drc.geometry_chain"]
    with pytest.raises(ValueError, match="wires"):
        dataclasses.replace(plan, feeds=None).validate_for(SMALL)


def test_refusals():
    p = _params(SMALL)
    with pytest.raises(ValueError, match="float16|bfloat16"):
        UnetConfig(dtype="bfloat16")
    for kw in (dict(precision="int8"), dict(backend="cuda_sparse")):
        with pytest.raises(ValueError, match="not supported"):
            DcnnServeEngine.from_config(EngineConfig(
                model=SMALL, device="cpu", **kw), p)
    from repro_torch.launch.mesh import make_test_mesh

    with pytest.raises(ValueError, match="mesh"):
        DcnnServeEngine.from_config(EngineConfig(
            model=SMALL, mesh=make_test_mesh(2, device="cpu")), p)
    x = torch.from_numpy(_images(1, SMALL))
    with pytest.raises(ValueError, match="cuda_sparse"):
        unet_apply(p, SMALL, x, "cuda_sparse")
    p["u1"]["w"].requires_grad_(True)
    with pytest.raises(ValueError, match="training"):
        unet_apply(p, SMALL, x, "reverse_loop")
    with pytest.raises(ValueError, match="does not train"):
        make_fused_generator(SMALL)


def test_published_size():
    """unet_256: 54,413,955 parameters, counted, never allocated; 16 B1
    launches, of which the encoder's read 2 x 2 space-to-depth maps."""
    cfg = PIX2PIX_UNET256
    assert unet_param_count(cfg) == 54_413_955
    geoms = cfg.geometries()
    assert len(geoms) == 16
    assert [g.in_h for g in geoms[:8]] == [129, 65, 33, 17, 9, 5, 3, 2]
    assert [g.c_in for g in geoms[:8]] == [12, 256, 512, 1024] + [2048] * 4
    assert [(g.in_h, g.c_in, g.c_out) for g in geoms[8:]] == [
        (1, 512, 512), (2, 1024, 512), (4, 1024, 512), (8, 1024, 512),
        (16, 1024, 256), (32, 512, 128), (64, 256, 64), (128, 128, 3)]
    assert geoms[-1].out_h == 256
    feeds = cfg.feeds()
    assert feeds[:9] == tuple(((i - 1, True),) for i in range(8)) + (
        ((7, False),),)
    # convT_7 reads conv_7's map (the skip x_8) and convT_8's; convT_1
    # conv_1's (x_2) and convT_2's
    assert feeds[9] == ((6, False), (8, False))
    assert feeds[15] == ((0, False), (14, False))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_widths_on_the_card(card):
    """The engine at bucket 2 on the card: 16 B1 and 15 norm launches a
    replay, within the benchmark configuration's limit of the reference."""
    limit = json.loads((ROOT / "bench" / "configs" /
                        "pix2pix-unet256.json").read_text())["limits"][
                            "max_abs_err"]
    cfg = PIX2PIX_UNET256
    p = _params(cfg, 7, card)
    x = _images(2, cfg, 8)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=cfg, backend="cuda", buckets=(2,), warmup=True), p)
    y = eng.generate(x)
    assert eng.kind_launch_counts[2] == {"b1_enc": 16, "b1_dec": 16,
                                         "norm": 30}
    eng.close()
    with torch.no_grad():
        want = unet_reference(p, torch.from_numpy(x).to(card), 8).cpu()
    assert float(np.abs(y - want.numpy()).max()) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,c,stats", [(16, 128, 64, True),
                                          (16, 128, 64, False),
                                          (3, 256, 3, False),
                                          (5, 2, 512, True),
                                          (2, 16, 20, True)])
def test_norm_kernel_matches_plain_version(card, n, hw, c, stats):
    """The kernel on a strided crop of a padded map (as B1 leaves it)
    against the plain version, both destinations; places no pixel reaches
    stay as they were.  Tolerance 1e-5 relative to the normalised scale
    (the kernel's merged shares against two passes, float32)."""
    g = torch.Generator().manual_seed(n * hw + c)
    big = torch.randn(n + 1, hw + 3, hw + 1, c + 8, generator=g) * 3 + 1
    src = big[:n, :hw, :hw, :c]
    gamma = beta = None
    if stats:
        gamma = torch.rand(c, generator=g) + 0.5
        beta = torch.randn(c, generator=g)

    def dests(dev):
        s2d = torch.full((n + 1, hw // 2 + 3, hw // 2 + 3, 4 * c + 8), 7.0,
                         device=dev)
        cat = torch.full((n, hw + 2, hw + 2, 2 * c), 7.0, device=dev)
        return [Dest(s2d, pad=1, off=4, slope=0.2, s2d=True),
                Dest(cat, pad=1, off=c, slope=0.0)]

    want = dests("cpu")
    norm_act_plain(src, want, gamma, beta, 1e-5)
    got = dests(card)
    from repro_torch.kernels.norm_act import kernel as nk

    before = nk.LAUNCHES
    nk.norm_act(big.to(card)[:n, :hw, :hw, :c], got,
                None if gamma is None else gamma.to(card),
                None if beta is None else beta.to(card), 1e-5)
    torch.cuda.synchronize()
    assert nk.LAUNCHES == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.t.cpu().numpy(), b.t.numpy(), rtol=0,
                                   atol=1e-5 * (1 if stats else 4))
