"""Card-only checks of the CUDA deconv kernels (marker ``cuda``; they skip
without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in the CPU tests: fp32 1e-4, bf16 8e-2; the int8 kernel's
int8 outputs equal its plain version's bit for bit, f32 ones within 1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import magnitude_prune, prune_tree
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
                                    b.to(card, dtype), s, p, t, t, 4, 8, 2,
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


@pytest.mark.parametrize("out_scale,act", [(0.02, "relu"), (None, "tanh")])
@pytest.mark.parametrize("geom", CASES)
def test_int8_kernel_matches_plain_version(card, geom, out_scale, act, rng):
    ih, iw, ci, co, k, s, p, t = geom
    x = torch.from_numpy(rng.randint(-127, 128, (3, ih, iw, ci)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8))
    sc = torch.from_numpy((rng.rand(co) * 1e-4 / np.sqrt(ci)).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wp, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x.to(card), w.to(card), sc.to(card), b.to(card), s, p, t, t, 4, 8, 2,
        act, out_scale)
    before = int8_kernel.LAUNCHES
    y = int8_kernel.deconv2d_int8_launch(xp, wp, sp, bp, **kw)
    torch.cuda.synchronize()
    assert int8_kernel.LAUNCHES == before + 1
    want = int8_kernel.deconv2d_int8_launch_plain(xp, wp, sp, bp, **kw)
    assert y.dtype == want.dtype
    if out_scale is None:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(y, want, rtol=0, atol=0)


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
                                    b.to(card, dtype), s, p, t, t, 4, 8, 2,
                                    "tanh")
    sched = schedule_tensors(make_sparse_plan(w, s, p, 4, 8), card)
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
