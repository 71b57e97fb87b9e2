"""The port's workload zoo (the super-resolution head ``sr`` and the
denoiser ``denoise``) against the JAX package's, on the CPU
(``device="cpu"``: the "cuda" backends run the kernels' plain versions).

Tolerances, each with its reason:
* registry, synthesizers, calibration batches, int8 layer outputs: equal
  (the same numpy draws; the same integer sums and rounding);
* calibrated activation scales: layer 0 equal, later layers rtol 1e-5
  (the fp32 chain they observe sums its products in another order);
* fp32 images against the reference's ``reverse_loop``: 1e-4 (the same
  products summed in another order);
* int8 images against the reference's ``quantized_generator_ref`` under
  the reference's ``QuantConfig``: 1e-6 (int8 activations bit-equal, so
  only the last layer's tanh can differ, by an ulp).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.workloads as jworkloads
import repro_torch.workloads as workloads
from repro.models import dcnn as jdcnn
from repro.quant import calibrate as j_calibrate
from repro.quant import quantize_params as j_quantize_params
from repro.quant import quantized_generator_ref as j_chain_ref
from repro.kernels.deconv2d import deconv2d_int8_ref as j_int8_ref
from repro_torch.core.tiling import DeconvGeometry
from repro_torch.data import digit_images
from repro_torch.kernels.autotune import hopper_tiles
from repro_torch.kernels.deconv2d import deconv2d_int8
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.models import dcnn
from repro_torch.quant import QuantConfig, calibrate
from repro_torch.serve import DcnnServeEngine, EngineConfig
from test_workloads import DAE_K5S2, SR_K5S2

FP32_TOL = 1e-4
INT8_TOL = 1e-6
ZOO = ("sr", "denoise")


def port_cfg(jc):
    """The port's `DcnnConfig` of a JAX package tower."""
    return dcnn.DcnnConfig(
        name=jc.name, z_dim=jc.z_dim, img_hw=jc.img_hw, img_c=jc.img_c,
        layers=tuple(dcnn.DeconvLayerCfg(**dataclasses.asdict(l))
                     for l in jc.layers), dtype=jc.dtype, in_hw=jc.in_hw)


def ref_params(jc, seed=0):
    """The JAX package's params of ``jc`` as numpy, and the port's."""
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(seed), jc)
    pn = jax.tree_util.tree_map(np.asarray, p)
    return p, pn, dcnn.generator_params_from_numpy(pn, port_cfg(jc), "cpu")


# ---------------------------------------------------------------------------
# registry resolution (typed, never a silent fallback): the JAX package's
# tests/test_workloads.py cases, on the port's registry
# ---------------------------------------------------------------------------
def test_builtin_names_and_aliases_match_reference():
    assert workloads.names() == jworkloads.names()
    assert set(workloads.names()) >= {"sr", "denoise", "mnist", "celeba"}
    sr = workloads.get("sr")
    assert workloads.get("sr-x2") is sr
    assert workloads.get("sr-espcn-x2") is sr
    assert sr.cfg is workloads.SR_X2
    assert workloads.get("dae").cfg is workloads.DAE_DENOISE
    assert workloads.get("mnist").kind == "generative"
    for name in jworkloads.names():
        j, t = jworkloads.get(name), workloads.get(name)
        assert (t.name, t.kind, t.aliases, t.description) == \
            (j.name, j.kind, j.aliases, j.description)
        assert t.cfg == port_cfg(j.cfg)
        for key in (j.name, j.cfg.name) + j.aliases:
            assert workloads.get(key) is t


def test_unknown_workload_is_typed_error():
    with pytest.raises(workloads.UnknownWorkloadError) as ei:
        workloads.get("sr-typo")
    assert isinstance(ei.value, ValueError)
    assert isinstance(ei.value, KeyError)
    assert "sr" in str(ei.value) and "mnist" in str(ei.value)
    with pytest.raises(workloads.UnknownWorkloadError):
        workloads.resolve_model("mnsit")
    with pytest.raises(workloads.WorkloadError):
        workloads.resolve_model(42)
    with pytest.raises(workloads.UnknownWorkloadError):
        DcnnServeEngine.from_config(
            EngineConfig(model="no-such-net", buckets=(2,), device="cpu"),
            params={})


def test_resolve_model_passthrough_and_names():
    sr_k5 = port_cfg(SR_K5S2)
    assert workloads.resolve_model("sr") is workloads.SR_X2
    assert workloads.resolve_model(sr_k5) is sr_k5
    assert workloads.workload_name_for(workloads.SR_X2) == "sr"
    assert workloads.workload_name_for(sr_k5) == "sr-k5s2-test"
    assert workloads.workload_for(sr_k5) is None


def test_register_collision_is_typed():
    sr_k5 = port_cfg(SR_K5S2)
    with pytest.raises(workloads.WorkloadError):
        workloads.register(workloads.Workload(
            name="sr-clone", cfg=sr_k5, kind="generative", aliases=("sr",)))
    assert "sr-clone" not in workloads.names()
    with pytest.raises(workloads.WorkloadError):
        workloads.Workload(name="bad", cfg=sr_k5, kind="supervised")
    with pytest.raises(workloads.WorkloadError):
        workloads.Workload(name="bad", cfg=sr_k5, kind="unsupervised")
    # re-registering the same workload is idempotent; a changed tower is not
    sr = workloads.get("sr")
    assert workloads.register(sr) is sr
    with pytest.raises(workloads.WorkloadError):
        workloads.register(dataclasses.replace(sr, cfg=sr_k5))
    with pytest.raises(workloads.WorkloadError, match="no .*pair"):
        workloads.get("mnist").training_pairs(0, 2)


# ---------------------------------------------------------------------------
# synthesizers and calibration batches: the reference's numpy draws
# ---------------------------------------------------------------------------
def test_digit_images_equal_reference():
    from repro.data.synthetic import digit_images as j_digits

    for seed, n, hw in ((0, 3, 28), (7, 2, 14)):
        a = digit_images(seed, n, hw)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, j_digits(seed, n, hw))


@pytest.mark.parametrize("name", ZOO)
def test_training_pairs_and_calibration_input_equal_reference(name):
    j, t = jworkloads.get(name), workloads.get(name)
    for seed, n in ((0, 4), (3, 2)):
        for got, want in zip(t.training_pairs(seed, n),
                             j.training_pairs(seed, n)):
            np.testing.assert_array_equal(got, np.asarray(want))
        cal = workloads.calibration_input(t.cfg, seed=seed, batch=n)
        assert cal.dtype == torch.float32 and cal.device.type == "cpu"
        np.testing.assert_array_equal(
            cal.numpy(), np.asarray(jworkloads.calibration_input(
                j.cfg, seed=seed, batch=n)))
        np.testing.assert_array_equal(t.calibration_batch(seed, n).numpy(),
                                      cal.numpy())
    # an unregistered image tower draws unit normals over its root
    got = workloads.calibration_input(port_cfg(SR_K5S2), seed=1, batch=4)
    assert got.shape == (4, 7, 7, 1)


@pytest.mark.parametrize("name", ZOO)
def test_self_calibration_equals_reference(name):
    """The port calibrates an image tower on the reference's batch, so its
    scales are the reference's."""
    j = jworkloads.get(name)
    p, _, tp = ref_params(j.cfg)
    t = workloads.get(name)
    want = j_calibrate(p, j.cfg, jworkloads.calibration_input(
        j.cfg, seed=0, batch=8))
    got = calibrate(tp, t.cfg, workloads.calibration_input(t.cfg, seed=0,
                                                           batch=8))
    assert got.layers[0] == QuantConfig.from_dict(
        dataclasses.asdict(want)).layers[0]
    for a, b in zip(got.layers, want.layers):
        np.testing.assert_allclose(a.x_scale, b.x_scale, rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(a.w_scale),
                                      np.asarray(b.w_scale))


# ---------------------------------------------------------------------------
# serving the towers: fp32 and zero-skip against the reference's
# reverse_loop; int8 against its int8 oracle
# ---------------------------------------------------------------------------
def _requests(jc, seed):
    """Image rows for ``jc``: the workload's own pair inputs where it is
    registered, else seeded normals."""
    w = workloads.workload_for(port_cfg(jc))
    if w is not None:
        return np.asarray(w.training_pairs(seed, 7)[0], np.float32)
    return np.random.RandomState(seed).randn(
        7, *jc.input_shape).astype(np.float32)


TOWERS = {"sr": jworkloads.SR_X2, "denoise": jworkloads.DAE_DENOISE,
          "sr-k5s2": SR_K5S2, "dae-k5s2": DAE_K5S2}


@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse", "cudnn"])
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_fp32_engine_matches_reference(tower, backend):
    jc = TOWERS[tower]
    p, pn, tp = ref_params(jc)
    model = workloads.get(tower).name if tower in ZOO else port_cfg(jc)
    if backend == "cuda_sparse":
        from repro.core.sparsity import prune_tree as j_prune

        p = j_prune(p, 0.5)
        tp = dcnn.generator_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), port_cfg(jc), "cpu")
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=model, backend=backend, max_batch=4,
                     device="cpu"), tp)
    x = _requests(jc, 1)
    tickets = [eng.submit(x[:3]), eng.submit(x[3:4]), eng.submit(x[4:])]
    got = np.concatenate([eng.collect(r) for r in tickets])
    want = np.asarray(jdcnn.generator_apply(p, jc, x, backend="reverse_loop"))
    assert got.shape == (7, jc.img_hw, jc.img_hw, jc.img_c)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_array_equal(eng.generate(x), got)
    if tower in ZOO:
        assert eng.workload == tower


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_int8_engine_matches_reference_oracle(tower):
    """C_in = 1 (the image roots) and thin middle layers: the engine packs
    each weight's input channels to a multiple of every int8 CI chunk."""
    jc = TOWERS[tower]
    p, _, tp = ref_params(jc)
    jw = jworkloads.workload_for(jc)
    x_cal = (jworkloads.calibration_input(jc, seed=0, batch=8)
             if jw is not None else
             jax.random.normal(jax.random.PRNGKey(3), (8,) + jc.input_shape))
    jq = j_calibrate(p, jc, x_cal)
    qcfg = QuantConfig.from_dict(dataclasses.asdict(jq))
    model = jw.name if jw is not None else port_cfg(jc)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=model, precision="int8", quant_cfg=qcfg,
                     max_batch=8, device="cpu"), tp)
    x = _requests(jc, 2)
    got = eng.generate(x)
    for i, l in enumerate(jc.layers):
        assert eng.params[f"l{i}"]["static"].w.cip % 32 == 0
    want = np.asarray(j_chain_ref(j_quantize_params(p, jc, jq), jc, jq, x))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=INT8_TOL, atol=INT8_TOL)


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_layer_with_one_input_channel(batch):
    """SR's first layer (C_in = 1, K = 5, stride 1, padding 2) through the
    int8 op at its plan's tiles, against the reference's int8 oracle, with
    the weight packed once at 32 input channels (`int8.packed_ci_width(1)`)
    as the engine packs it."""
    rng = np.random.RandomState(batch)
    x = rng.randint(-127, 128, (batch, 14, 14, 1)).astype(np.int8)
    w = rng.randint(-127, 128, (5, 5, 1, 32)).astype(np.int8)
    scale = np.full((32,), 3.0 / (127 * 127 * 5), np.float32)
    b = (rng.randn(32) * 0.1).astype(np.float32)
    assert int8_kernel.packed_ci_width(1) == 32
    g = DeconvGeometry(14, 14, 1, 32, 5, 1, 2)
    t = hopper_tiles(g, batch, "int8")
    assert t.t_ci == 32
    st = int8_kernel.prepare_int8_static(
        int8_kernel.pack_int8_weights(torch.from_numpy(w), 32, 32),
        torch.from_numpy(scale), torch.from_numpy(b), 32, 32)
    for out_scale, act in ((3.0 / 127, "relu"), (None, "tanh")):
        got = deconv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(scale), torch.from_numpy(b), 1,
                            2, activation=act, out_scale=out_scale,
                            static=st, **t.as_kwargs())
        want = np.asarray(j_int8_ref(x, w, scale, b, 1, 2, activation=act,
                                     out_scale=out_scale))
        assert got.shape == (batch, 14, 14, 32)
        if out_scale is None:
            np.testing.assert_allclose(got.numpy(), want, rtol=INT8_TOL,
                                       atol=INT8_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed_ci,t_ci", [(1, 32), (32, 64)])
def test_int8_weight_packed_off_the_ci_chunk_is_refused(packed_ci, t_ci):
    """A weight packed at input channels that the CI chunk does not divide
    is refused before any launch, not padded per call: the engine packs
    every layer at `int8.packed_ci_width`."""
    x = torch.zeros((1, 14, 14, 1), dtype=torch.int8)
    w = torch.ones((5, 5, 1, 32), dtype=torch.int8)
    pk = int8_kernel.pack_int8_weights(w, packed_ci, 32)
    with pytest.raises(ValueError, match=f"CI chunks of {t_ci}"):
        deconv2d_int8(x, pk, torch.ones(32), None, 1, 2, t_oh=2, t_ow=2,
                      t_ci=t_ci, t_co=8, t_n=1)
