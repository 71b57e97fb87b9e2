"""bf16 towers on the port's serving engine against the JAX package's bf16
generator, on the CPU (``device="cpu"``: the "cuda" backends run the
kernels' plain versions).

The engine's host side is float32 for a bf16 tower: z is cast to bf16 on
the device and the bf16 images cast up to float32 (exactly), so results
are float32 arrays of bf16 values.  The JAX package returns bfloat16
arrays, which numpy holds only through ``ml_dtypes``.

Tolerance: 8e-2 against the reference's bf16 ``reverse_loop`` (bf16
rounding of every layer's output, 2^-8 relative, compounds over the
layers, and the packages sum the products in other orders), the bf16
tolerance of the kernel checks.  The largest error observed is printed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.sparsity import prune_tree as j_prune_tree
from repro.models import dcnn as jdcnn
from repro.plan import build_network_plan as j_build_network_plan
from repro_torch.kernels.autotune import hopper_tiles
from repro_torch.models import dcnn
from repro_torch.plan import NetworkPlan, build_network_plan
from repro_torch.serve import DcnnServeEngine, EngineConfig

BF16_TOL = 8e-2


def _narrow_celeba(mod):
    """CelebA's first two layers at 32 channels wide: 1x1 -> 4x4 -> 8x8."""
    L = mod.DeconvLayerCfg
    return mod.DcnnConfig(
        name="celeba-narrow-bf16", z_dim=100, img_hw=8, img_c=3,
        dtype="bfloat16",
        layers=(L(100, 32, 4, 1, 0, "relu"), L(32, 3, 4, 2, 1, "tanh")))


NETS = {
    "mnist": (dataclasses.replace(jdcnn.MNIST_DCNN, dtype="bfloat16"),
              dataclasses.replace(dcnn.MNIST_DCNN, dtype="bfloat16")),
    "celeba-narrow": (_narrow_celeba(jdcnn), _narrow_celeba(dcnn)),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    jc, tc = NETS[request.param]
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jc)
    z = np.random.RandomState(3).randn(7, 100).astype(np.float32)
    return request.param, jc, tc, p, z


def _port_params(p, tc):
    """The reference's bf16 params as numpy (ml_dtypes bf16 arrays) into
    the port, through `generator_params_from_numpy`."""
    return dcnn.generator_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), tc, "cpu")


def _is_bf16_valued(y):
    return np.array_equal(
        y, torch.from_numpy(y).to(torch.bfloat16).float().numpy())


def test_params_cross_as_bf16(net):
    _, jc, tc, p, _ = net
    tp = _port_params(p, tc)
    for i in range(len(tc.layers)):
        for n in ("w", "b"):
            t = tp[f"l{i}"][n]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(p[f"l{i}"][n]).astype(np.float32))


@pytest.mark.parametrize("backend", ["reverse_loop", "cuda", "cuda_sparse",
                                     "cudnn"])
def test_bf16_engine_matches_reference(net, backend):
    name, jc, tc, p, z = net
    if backend == "cuda_sparse":
        p = j_prune_tree(p, 0.5)
    want = np.asarray(jdcnn.generator_apply(p, jc, z, backend="reverse_loop"),
                      np.float32)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=tc, backend=backend, max_batch=4, device="cpu"),
        _port_params(p, tc))
    got = eng.generate(z)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _is_bf16_valued(got)
    err = float(np.abs(got - want).max())
    print(f"{name} bf16 {backend}: max |port - reference| = {err:.3e}")
    assert err <= BF16_TOL
    # the queue serves the same images, from inputs of any float dtype
    tickets = [eng.submit(z[:3].astype(np.float64)), eng.submit(z[3]),
               eng.submit(z[4:])]
    eng.drain()
    outs = [eng.collect(t) for t in tickets]
    assert [o.shape[0] for o in outs] == [3, 1, 3]
    np.testing.assert_array_equal(np.concatenate(outs), got)
    assert eng.generate(z[:0]).shape == (0,) + got.shape[1:]
    if backend in ("cuda", "cuda_sparse"):
        assert all(l.dtype == "bfloat16" for pl in eng.plans.values()
                   for l in pl.layers)


def test_bf16_plans_name_the_dtype_and_tiles_come_from_the_fma_kernel(net):
    """Plans record "bfloat16", and their tiles are the model's for the
    bf16 tensor-core kernel (the FMA kernel this test was named for is
    gone; the name stays so that the test's history does)."""
    _, _, tc, _, _ = net
    for b in (1, 4):
        plan = build_network_plan(tc, batch=b, backend="cuda", autotune=False)
        for l, g in zip(plan.layers, tc.geometries()):
            assert l.dtype == "bfloat16"
            assert l.tiles == hopper_tiles(g, batch=b, dtype="bfloat16")


def test_reference_pinned_bf16_plan_loads_verifies_and_serves(net):
    _, jc, tc, p, z = net
    ref = j_build_network_plan(jc, batch=4, backend="pallas", autotune=False)
    plan = NetworkPlan.from_json(ref.to_json())
    assert plan.stable_hash() == ref.stable_hash()
    assert [l.stable_hash() for l in plan.layers] == \
        [l.stable_hash() for l in ref.layers]
    assert all(l.dtype == "bfloat16" for l in plan.layers)
    plan.validate_for(tc)
    hop = plan.for_hopper()
    assert hop == build_network_plan(tc, batch=4, backend="cuda",
                                     autotune=False)
    assert NetworkPlan.from_json(hop.to_json()) == hop
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=tc, buckets=(4,), device="cpu"),
        _port_params(p, tc), plan=hop)
    got = eng.generate(z[:4])
    assert eng.plan_stats["builds"] == 0
    want = np.asarray(jdcnn.generator_apply(p, jc, z[:4],
                                            backend="reverse_loop"),
                      np.float32)
    assert float(np.abs(got - want).max()) <= BF16_TOL
