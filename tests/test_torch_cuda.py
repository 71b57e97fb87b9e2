"""Card-only checks of the CUDA deconv kernel (marker ``cuda``; they skip
without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in the CPU tests: fp32 1e-4, bf16 8e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.kernels.deconv2d.ops import deconv2d, launch_args
from repro_torch.models import dcnn
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
