"""The port's generators against the JAX package's, at full width.

Params come from the JAX package's ``generator_init`` and cross as numpy
through ``generator_params_from_numpy``; latents are made with numpy.  The
JAX side runs ``generator_apply(backend="reverse_loop")``, its plain
reference (the Pallas kernels are not run).  Tolerance 1e-4 (fp32, the
same products summed in another order; images are tanh outputs in
[-1, 1])."""
import jax
import numpy as np
import pytest
import torch

from repro.models import dcnn as jdcnn
from repro_torch.models import dcnn
from repro_torch.plan import build_network_plan

TOL = 1e-4
NETS = {"mnist": (jdcnn.MNIST_DCNN, dcnn.MNIST_DCNN),
        "celeba": (jdcnn.CELEBA_DCNN, dcnn.CELEBA_DCNN)}


@pytest.fixture(scope="module")
def reference():
    """Per net: numpy params, latents, reference images and the
    reference's per-layer inputs (computed once per module)."""
    out = {}
    for name, (jcfg, _) in NETS.items():
        p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jcfg)
        pn = jax.tree_util.tree_map(np.asarray, p)
        z = np.random.RandomState(1).randn(2, jcfg.z_dim).astype(np.float32)
        img, inters = jdcnn.generator_apply(p, jcfg, z, backend="reverse_loop",
                                            return_intermediates=True)
        out[name] = (pn, z, np.asarray(img), [np.asarray(t) for t in inters])
    return out


@pytest.mark.parametrize("backend", dcnn.BACKENDS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_generator_matches_reference(net, backend, reference):
    pn, z, want, _ = reference[net]
    cfg = NETS[net][1]
    p = dcnn.generator_params_from_numpy(pn, cfg, "cpu")
    y = dcnn.generator_apply(p, cfg, torch.from_numpy(z), backend=backend)
    assert tuple(y.shape) == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_generator_plan_path_matches_reference(net, reference):
    pn, z, want, _ = reference[net]
    cfg = NETS[net][1]
    p = dcnn.generator_params_from_numpy(pn, cfg, "cpu")
    plan = build_network_plan(cfg, batch=2, backend="cuda")
    y = dcnn.generator_apply(p, cfg, torch.from_numpy(z), plan=plan)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)


def test_return_intermediates_match_reference(reference):
    pn, z, want, inters = reference["celeba"]
    cfg = dcnn.CELEBA_DCNN
    p = dcnn.generator_params_from_numpy(pn, cfg, "cpu")
    y, xs = dcnn.generator_apply(p, cfg, torch.from_numpy(z), backend="cuda",
                                 return_intermediates=True)
    assert len(xs) == len(cfg.layers) == len(inters)
    for got, ref in zip(xs, inters):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)


def test_tower_input_errors_match_reference():
    for jcfg, cfg in NETS.values():
        z = np.zeros((3, jcfg.z_dim), np.float32)
        assert tuple(dcnn.tower_input(cfg, torch.from_numpy(z)).shape) == \
            jdcnn.tower_input(jcfg, z).shape
        for bad in (np.zeros((3, jcfg.z_dim + 1), np.float32),
                    np.zeros((3, 2, 2, jcfg.z_dim), np.float32)):
            with pytest.raises(ValueError) as want:
                jdcnn.tower_input(jcfg, bad)
            with pytest.raises(ValueError) as got:
                dcnn.tower_input(cfg, torch.from_numpy(bad))
            assert str(got.value) == str(want.value)


def test_params_from_numpy_checks_shapes(reference):
    pn, _, _, _ = reference["mnist"]
    cfg = dcnn.MNIST_DCNN
    bad = {k: dict(v) for k, v in pn.items()}
    bad["l1"]["w"] = bad["l1"]["w"][:, :, :, :-1]
    with pytest.raises(ValueError, match="l1.w"):
        dcnn.generator_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="l0..l2"):
        dcnn.generator_params_from_numpy({"l0": pn["l0"]}, cfg, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        dcnn.generator_apply(dcnn.generator_params_from_numpy(pn, cfg, "cpu"),
                             cfg, torch.zeros(1, 100), backend="pallas")


def test_generator_init_is_seeded_lecun():
    cfg = dcnn.MNIST_DCNN
    a = dcnn.generator_init(torch.Generator().manual_seed(3), cfg, "cpu")
    b = dcnn.generator_init(torch.Generator().manual_seed(3), cfg, "cpu")
    for i, l in enumerate(cfg.layers):
        assert torch.equal(a[f"l{i}"]["w"], b[f"l{i}"]["w"])
        assert tuple(a[f"l{i}"]["w"].shape) == (l.kernel, l.kernel, l.c_in,
                                                 l.c_out)
        assert not a[f"l{i}"]["b"].any()
        std = float(a[f"l{i}"]["w"].std())
        assert abs(std * np.sqrt(l.c_in * l.kernel ** 2) - 1.0) < 0.1
