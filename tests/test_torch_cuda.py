"""Card-only checks of the CUDA deconv kernels (marker ``cuda``; they skip
without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in the CPU tests: fp32 1e-4, bf16 8e-2; the int8 kernel's
int8 outputs equal its plain version's bit for bit, f32 ones within 1e-6;
the fp32 and int8 kernels' repeated launches equal each other bit for
bit."""
import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import magnitude_prune, prune_tree
from repro_torch.kernels.autotune import hopper_tiles
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.kernels.deconv2d.ops import deconv2d, launch_args
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel
from repro_torch.kernels.deconv2d_sparse import (make_sparse_plan,
                                                 schedule_tensors)
from repro_torch.models import dcnn
from repro_torch.quant import quantized_generator_ref
from repro_torch.serve import DcnnServeEngine, EngineConfig

pytestmark = pytest.mark.cuda

CASES = [(7, 7, 8, 16, 4, 2, 1, 4), (1, 1, 100, 1024, 4, 1, 0, 4),
         (5, 3, 4, 7, 4, 2, 1, 6), (8, 8, 16, 8, 3, 3, 1, 9)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", CASES)
def test_kernel_matches_plain_version(card, geom, dtype, rng):
    ih, iw, ci, co, k, s, p, t = geom
    x = torch.from_numpy(rng.randn(3, ih, iw, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, k, ci, co) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wp, bp, kw, _ = launch_args(x.to(card, dtype), w.to(card, dtype),
                                    b.to(card, dtype), s, p, t, t, 8, 8, 2,
                                    "tanh")
    before = deconv_kernel.LAUNCHES
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    assert deconv_kernel.LAUNCHES == before + 1
    want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


def test_refused_launch_raises(card):
    x = torch.zeros(1, 4, 4, 8, device=card)
    w = torch.zeros(4, 4, 8, 64, device=card)
    with pytest.raises(RuntimeError, match="512 threads"):
        deconv2d(x, w, None, 1, 0, t_oh=32, t_ow=32, t_ci=8, t_co=64, t_n=1)


def test_engine_serves_on_the_card_through_the_kernel(card):
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(model="mnist",
                                                   max_batch=8), params)
    z = np.random.RandomState(0).randn(11, cfg.z_dim).astype(np.float32)
    y = eng.generate(z)
    assert sum(eng.launch_counts.values()) == \
        len(cfg.layers) * len(eng.plan_chunks(11))
    want = dcnn.generator_apply(eng.params, cfg, torch.from_numpy(z).to(card),
                                backend="reverse_loop").cpu().numpy()
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


def _int8_check(card, rng, batch, geom, tiles, act, out_scale, split=None):
    """The int8 kernel against its plain version (at the launch's cluster
    split) on random int8 data: int8 outputs bit for bit, f32 within 1e-6;
    two launches bit-identical.  Returns the split."""
    ih, iw, ci, co, k, s, p = geom
    x = torch.from_numpy(rng.randint(-127, 128, (batch, ih, iw, ci)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8))
    sc = torch.from_numpy((rng.rand(co) * 1e-4 / np.sqrt(ci)).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wpk, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x.to(card), w.to(card), sc.to(card), b.to(card), s, p, *tiles, act,
        out_scale)
    got_split = int8_kernel.launch_split_int8(xp, wpk, kw)
    assert split is None or got_split == split
    before = int8_kernel.LAUNCHES
    y = int8_kernel.deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
    y1 = int8_kernel.deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
    torch.cuda.synchronize()
    assert int8_kernel.LAUNCHES == before + 2
    assert torch.equal(y, y1)
    want = int8_kernel.deconv2d_int8_launch_plain(
        xp, int8_kernel.unpack_int8_weights(wpk), sp, bp, split=got_split,
        **kw)
    assert y.dtype == want.dtype
    if out_scale is None:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(y, want, rtol=0, atol=0)
    return got_split


@pytest.mark.parametrize("out_scale,act", [(0.02, "relu"), (None, "tanh")])
@pytest.mark.parametrize("geom", CASES)
def test_int8_kernel_matches_plain_version(card, geom, out_scale, act, rng):
    """The synthetic cases at 32-channel CI chunks, 8-channel tiles and a
    batch tile of 2, each at the split its grid gives."""
    ih, iw, ci, co, k, s, p, t = geom
    _int8_check(card, rng, 3, (ih, iw, ci, co, k, s, p), (t, t, 32, 8, 2),
                act, out_scale)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_int8_kernel_at_each_cluster_split(card, split, rng):
    """One 16x16 output tile and 64 channels: the grid is one block, so the
    split is the count of 32-channel CI chunks, up to 8."""
    _int8_check(card, rng, 1, (8, 8, 32 * split, 64, 4, 2, 1),
                (16, 16, 32, 64, 1), "relu", 0.05, split)


@pytest.mark.parametrize("cfg,layer", [(dcnn.MNIST_DCNN, 2),
                                       (dcnn.CELEBA_DCNN, 4)],
                         ids=["mnist_l2", "celeba_l4"])
@pytest.mark.parametrize("batch", [1, 8])
def test_int8_kernel_on_thin_tanh_layers(card, cfg, layer, batch, rng):
    """The 1- and 3-channel tanh layers at their int8 tiles, f32 out: zero
    weight rows pad the n8 column tile, stores masked to the real
    channels."""
    g = cfg.geometries()[layer]
    t = hopper_tiles(g, batch, "int8")
    assert t.t_co == g.c_out
    _int8_check(card, rng, batch, (g.in_h, g.in_w, g.c_in, g.c_out, g.kernel,
                                   g.stride, g.padding),
                tuple(t.as_kwargs().values()), "tanh", None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", CASES)
def test_sparse_kernel_matches_plain_version(card, geom, dtype, rng):
    """Pruned at 0.9 with the first half of the input channels zeroed by
    hand, so that whole slabs drop out of the schedule."""
    ih, iw, ci, co, k, s, p, t = geom
    x = torch.from_numpy(rng.randn(3, ih, iw, ci).astype(np.float32))
    w = magnitude_prune(torch.from_numpy(
        (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)), 0.9)[0]
    w[:, :, : ci // 2] = 0.0
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wp, bp, kw, _ = launch_args(x.to(card, dtype), w.to(card, dtype),
                                    b.to(card, dtype), s, p, t, t, 8, 8, 2,
                                    "tanh")
    sched = schedule_tensors(make_sparse_plan(w, s, p, 8, 8), card)
    before = sparse_kernel.LAUNCHES
    y = sparse_kernel.deconv2d_sparse_launch(xp, wp, bp, *sched, **kw)
    torch.cuda.synchronize()
    assert sparse_kernel.LAUNCHES == before + 1
    want = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["int8", "cuda_sparse"])
def test_int8_and_sparse_engines_launch_their_kernel(card, kind):
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    if kind == "int8":
        conf = EngineConfig(model="mnist", precision="int8", max_batch=8)
        mod = int8_kernel
    else:
        params = prune_tree(params, 0.9)
        conf = EngineConfig(model="mnist", backend="cuda_sparse", max_batch=8)
        mod = sparse_kernel
    eng = DcnnServeEngine.from_config(conf, params)
    z = np.random.RandomState(0).randn(11, cfg.z_dim).astype(np.float32)
    counts = {m: m.LAUNCHES for m in (deconv_kernel, int8_kernel,
                                      sparse_kernel)}
    y = eng.generate(z)
    want_launches = len(cfg.layers) * len(eng.plan_chunks(11))
    assert sum(eng.launch_counts.values()) == want_launches
    for m, n in counts.items():
        assert m.LAUNCHES - n == (want_launches if m is mod else 0)
    zt = torch.from_numpy(z).to(card)
    if kind == "int8":
        want = quantized_generator_ref(eng.params, cfg, eng.quant_cfg, zt)
        np.testing.assert_allclose(y, want.cpu().numpy(), rtol=0, atol=1e-6)
    else:
        want = dcnn.generator_apply(eng.params, cfg, zt,
                                    backend="reverse_loop")
        np.testing.assert_allclose(y, want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "zero_skip"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_tc_kernel_at_each_cluster_split(card, split, sparse, rng):
    """One 16x16 output tile and 64 channels: the grid is one block, so the
    split is the CI chunks' count (8 channels each), up to 8.  The fp32
    kernel against its plain version, zero-skip on hand-zeroed slabs, and
    two launches bit-identical."""
    ci = 8 * split if split > 1 else 8
    x = torch.from_numpy(rng.randn(1, 8, 8, ci).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(4, 4, ci, 64) * 0.1).astype(np.float32))
    if sparse:
        w[:, :, : ci // 2] = 0.0
        w[1] = 0.0
    w = w.to(card)
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(card)
    xp, wp, bp, kw, _ = launch_args(x, w, b, 2, 1, 16, 16, 8, 64, 1, "relu")
    assert deconv_kernel.launch_split(1, ci, 64, 16, 16, 16, 16, 8, 64,
                                      1) == split
    if sparse:
        sched = schedule_tensors(make_sparse_plan(w, 2, 1, 8, 64), card)
        run = lambda: sparse_kernel.deconv2d_sparse_launch(  # noqa: E731
            xp, wp, bp, *sched, **kw)
        want = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched,
                                                          **kw)
    else:
        run = lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)  # noqa: E731
        want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split,
                                                   **kw)
    y0, y1 = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)
    torch.testing.assert_close(y0, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg,layer", [(dcnn.MNIST_DCNN, 2),
                                       (dcnn.CELEBA_DCNN, 4)],
                         ids=["mnist_l2", "celeba_l4"])
@pytest.mark.parametrize("batch", [1, 8])
def test_tc_kernel_on_thin_tanh_layers(card, cfg, layer, batch, rng):
    """The 1- and 3-channel tanh layers at their fp32 tiles: zero-padded
    weight columns in shared memory, stores masked to the real channels."""
    g = cfg.geometries()[layer]
    t = hopper_tiles(g, batch)
    x = torch.from_numpy(rng.randn(batch, g.in_h, g.in_w, g.c_in)
                         .astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(4, 4, g.c_in, g.c_out) * 0.05)
                         .astype(np.float32)).to(card)
    xp, wp, bp, kw, _ = launch_args(x, w, None, g.stride, g.padding,
                                    *t.as_kwargs().values(), "tanh")
    assert wp.shape[3] == g.c_out
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
