"""Card-only checks of the training path (marker ``cuda``; they skip
without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

The fused generator's forward is one B1 launch per layer and its backward
launches none; its values are the reverse loop's within 1e-4 (fp32) and
its grads are the reverse loop's autograd exactly (the backward
rematerialises the same formulation on the same params).  Whole steps on
"cuda" against the same steps on "reverse_loop": losses within rtol 1e-4;
after one critic and one generator step Adam's moments within 1e-5 of
each leaf's largest (what the grads set) and params within 2 * lr (a
first Adam step moves each by about lr whatever its grad's size); after
three sr steps params within 1e-5 and the first step's moments as
above."""
import numpy as np
import pytest
import torch

from repro_torch.core.deconv import fp32_exact
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.deconv2d import deconv2d
from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.models import dcnn
from repro_torch.optim import AdamW
from repro_torch.train import SupervisedTrainer, WganTrainer
from repro_torch.train.supervised import pair_source
from repro_torch.workloads import get

pytestmark = pytest.mark.cuda

TOL = 1e-4
LR = 1e-4
MOMENT_TOL = 1e-5


def _assert_moments_close(a, b):
    assert int(a.step) == int(b.step)
    for x, y in zip(tree_leaves((a.mu, a.nu)), tree_leaves((b.mu, b.nu))):
        assert float((x - y).abs().max()) <= MOMENT_TOL * float(
            y.abs().max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    fp32_exact(torch.device("cuda"))
    return torch.device("cuda")


def _gen_params(cfg, card, seed=0):
    return dcnn.generator_init(torch.Generator().manual_seed(seed), cfg, card)


def test_fused_generator_launches_b1_forward_only(card):
    cfg = dcnn.CELEBA_DCNN
    p = tree_map(lambda t: t.requires_grad_(), _gen_params(cfg, card))
    z = torch.randn(8, cfg.z_dim, device=card, requires_grad=True)
    apply = dcnn.make_fused_generator(cfg)
    before = deconv_kernel.LAUNCHES
    y = apply(p, z)
    torch.cuda.synchronize()
    assert deconv_kernel.LAUNCHES == before + len(cfg.layers)
    ct = torch.randn_like(y)
    grads = torch.autograd.grad(y, tree_leaves(p) + [z], ct)
    torch.cuda.synchronize()
    assert deconv_kernel.LAUNCHES == before + len(cfg.layers)
    want = dcnn.generator_apply(p, cfg, z, backend="reverse_loop")
    torch.testing.assert_close(y, want.detach(), rtol=TOL, atol=TOL)
    want_grads = torch.autograd.grad(want, tree_leaves(p) + [z], ct)
    for a, b in zip(grads, want_grads):
        assert torch.equal(a, b)


def test_kernel_op_refuses_to_build_a_graph_on_the_card(card):
    x = torch.randn(2, 4, 4, 8, device=card)
    w = torch.randn(4, 4, 8, 8, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="make_fused_generator"):
        deconv2d(x, w, None, 2, 1)
    with torch.no_grad():
        assert deconv2d(x, w, None, 2, 1).grad_fn is None


@pytest.mark.parametrize("net", ["mnist", "celeba"])
def test_an_update_reaches_the_next_fused_forward(card, net):
    """After an optimizer step the fused forward reads the new weights,
    also on the layers whose channels the kernel pads (CelebA's C_out 3
    head, MNIST's C_out 1)."""
    cfg = dcnn.CELEBA_DCNN if net == "celeba" else dcnn.MNIST_DCNN
    p = _gen_params(cfg, card)
    apply = dcnn.make_fused_generator(cfg)
    z = torch.randn(4, cfg.z_dim, device=card)
    y0 = apply(p, z)
    opt = AdamW(lr=1e-2)
    grads = tree_map(torch.randn_like, p)
    p1, _ = opt.update(grads, opt.init(p), p)
    y1 = apply(p1, z)
    want = dcnn.generator_apply(p1, cfg, z, backend="reverse_loop")
    torch.testing.assert_close(y1, want, rtol=TOL, atol=TOL)
    assert (y1 - y0).abs().max() > 1e-2


def test_wgan_steps_on_cuda_equal_reverse_loop(card):
    cfg = dcnn.MNIST_DCNN
    g = torch.Generator(device=card).manual_seed(3)
    real = torch.rand((13, 28, 28, 1), generator=g, device=card) * 2 - 1
    real = torch.cat([real, torch.zeros(3, 28, 28, 1, device=card)])
    z = torch.randn((16, cfg.z_dim), generator=g, device=card)
    eps = torch.rand((16, 1, 1, 1), generator=g, device=card)
    out = {}
    for backend in ("cuda", "reverse_loop"):
        t = WganTrainer(cfg, AdamW(lr=LR, b1=0.5, b2=0.9),
                        AdamW(lr=LR, b1=0.5, b2=0.9), backend=backend,
                        device=card)
        gp, dp, gs, ds = t.init_state(0)
        dp, ds, dmet = t.critic_update(dp, ds, gp, real, 13, z, eps)
        gp, gs, gmet = t.gen_update(gp, gs, dp, z)
        out[backend] = (gp, dp, ds, gs, {**dmet, **gmet})
    (gp, dp, ds, gs, met) = out["cuda"]
    (rgp, rdp, rds, rgs, rmet) = out["reverse_loop"]
    for k, v in met.items():
        np.testing.assert_allclose(float(v), float(rmet[k]), rtol=TOL)
    _assert_moments_close(ds, rds)
    _assert_moments_close(gs, rgs)
    for a, b in zip(tree_leaves((gp, dp)), tree_leaves((rgp, rdp))):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * LR)


def test_supervised_sr_on_cuda_equals_reverse_loop(card):
    lr, k = 1e-3, 3
    w = get("sr")
    src = pair_source(w, 0, 64)
    out, first = {}, {}
    for backend in ("cuda", "reverse_loop"):
        t = SupervisedTrainer(w.cfg, AdamW(lr=lr), backend=backend,
                              device=card)
        out[backend] = t.fit(src, k, 0, log_every=1)
        assert t.build_counts["step"] == {64: 1}
        p0, s0 = t.init_state(0)
        b = src.batch(0)
        first[backend] = t.step(p0, s0, b["x"], b["y"])[1]
    (p, hist), (rp, rhist) = out["cuda"], out["reverse_loop"]
    assert len(hist) == len(rhist) == k
    for h, r in zip(hist, rhist):
        np.testing.assert_allclose(h["loss"], r["loss"], rtol=TOL)
    for a, b in zip(tree_leaves(p), tree_leaves(rp)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    _assert_moments_close(first["cuda"], first["reverse_loop"])
