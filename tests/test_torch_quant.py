"""The port's int8 path against the JAX package's plain references, on the
CPU: qmath, calibration, weight quantization, the int8 layer (whose CPU
path is the kernel's plain version) and the whole int8 chain.

Tolerances, each with its reason:
* quantization, weight scales, combined scales, int32 accumulators: bit
  for bit (the same arithmetic on the same float32 values);
* calibrated activation scales past layer 0: rtol 1e-5 (the fp32 chain
  they observe sums its products in another order);
* re-quantized int8 outputs against the reference's oracles: bit for bit.
  The port (and the CUDA kernel) round the epilogue's product and sum
  separately, as the reference's eager oracles do; under ``jax.jit`` XLA
  on the CPU fuses them into one FMA, and then a value within an ulp of a
  rounding tie can land 1 LSB apart (`test_epilogue_rounds_product_and_
  sum_separately`);
* f32 images of the chain: 1e-5 (tanh of the same f32 value, and the
  last layer's fused vs separate epilogue).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mmd import median_bandwidth as j_median_bandwidth
from repro.core.mmd import mmd as j_mmd
from repro.kernels.deconv2d.int8 import requant_epilogue as j_epilogue
from repro.kernels.deconv2d import deconv2d_int8_ref as j_int8_ref
from repro.models import dcnn as jdcnn
from repro.quant import calibrate as j_calibrate
from repro.quant import quantize_params as j_quantize_params
from repro.quant import quantize_symmetric as j_quantize
from repro.quant import quantized_generator_ref as j_chain_ref
from repro_torch.core.mmd import median_bandwidth, mmd
from repro_torch.kernels.deconv2d import deconv2d_int8, deconv2d_int8_ref
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.models import dcnn
from repro_torch.quant import (QuantConfig, calibrate, dequantize_symmetric,
                               fake_quant, mmd_degradation, observe_amax,
                               quantize_params, quantize_symmetric,
                               quantized_generator_apply,
                               quantized_generator_ref, symmetric_scale)
from repro_torch.workloads import calibration_input

# (ih, iw, ci, co, k, s, p): the paper's layer shapes, ragged and stride 3
LAYERS = [(1, 1, 12, 16, 7, 1, 0), (7, 7, 16, 8, 4, 2, 1),
          (5, 6, 3, 5, 3, 2, 0), (4, 4, 6, 5, 5, 3, 2), (4, 5, 9, 3, 4, 2, 1)]


@pytest.fixture(scope="module")
def mnist():
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jdcnn.MNIST_DCNN)
    pn = jax.tree_util.tree_map(np.asarray, p)
    z = np.random.RandomState(5).randn(3, 100).astype(np.float32)
    return p, pn, dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN,
                                                   "cpu"), z


def _port_qcfg(jq):
    return QuantConfig.from_dict(dataclasses.asdict(jq))


def _int8(rng, shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


def test_quantize_is_bit_equal_on_random_values(rng):
    x = (rng.randn(4096) * 3).astype(np.float32)
    for scale in (0.05, 0.013, np.float32(0.3), 1.0):
        want = np.asarray(j_quantize(jnp.asarray(x), scale))
        got = quantize_symmetric(torch.from_numpy(x), scale).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int8


def test_quantize_rounds_ties_to_even_like_the_reference():
    """Values exactly at .5 after scaling (a power-of-two scale keeps the
    quotient exact) round to even in both packages."""
    k = np.arange(-130, 130)
    x = ((k + 0.5) * 0.125).astype(np.float32)
    want = np.asarray(j_quantize(jnp.asarray(x), 0.125))
    got = quantize_symmetric(torch.from_numpy(x), 0.125).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[k == 0][0] == 0 and got[k == 1][0] == 2 and got[k == -2][0] == -2
    assert got.max() == 127 and got.min() == -127


def test_python_float_scale_is_rounded_to_float32_before_dividing():
    """Both packages divide by float32(scale): on values near a rounding
    tie that differs from dividing by the float64 scale."""
    scale = 0.1
    x = ((np.arange(-127, 127) + 0.5) * np.float32(scale)).astype(np.float32)
    x = np.concatenate([np.nextafter(x, np.inf), x, np.nextafter(x, -np.inf)])
    got = quantize_symmetric(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_quantize(jnp.asarray(x),
                                                             scale)))
    np.testing.assert_array_equal(got, quantize_symmetric(
        torch.from_numpy(x), np.float32(scale)).numpy())
    f64 = np.clip(np.round(x.astype(np.float64) / scale), -127, 127)
    assert (f64 != got).any()


def test_qmath_helpers(rng):
    x = torch.from_numpy(rng.randn(512).astype(np.float32))
    scale = symmetric_scale(float(x.abs().max()))
    q = quantize_symmetric(x, scale)
    assert int(q.abs().max()) <= 127
    assert float((dequantize_symmetric(q, scale) - x).abs().max()) <= \
        scale * 0.5 + 1e-7
    torch.testing.assert_close(fake_quant(x, scale),
                               dequantize_symmetric(q, scale), rtol=0, atol=0)


@pytest.mark.parametrize("strategy", ["minmax", "percentile", "mean_ksigma"])
def test_observers_match_reference(strategy, rng):
    from repro.quant import observe_amax as j_observe

    x = rng.standard_cauchy(5000).astype(np.float32)
    assert observe_amax(torch.from_numpy(x), strategy) == j_observe(x, strategy)


def test_calibrate_matches_reference(mnist):
    """On the same z: weight scales bit-equal, layer 0's input scale (z
    itself) bit-equal, later input scales within rtol 1e-5."""
    p, _, tp, z = mnist
    want = j_calibrate(p, jdcnn.MNIST_DCNN, jnp.asarray(z))
    got = calibrate(tp, dcnn.MNIST_DCNN, torch.from_numpy(z))
    assert (got.name, got.strategy) == (want.name, want.strategy)
    for g, w in zip(got.layers, want.layers):
        assert g.w_scale == w.w_scale
        assert g.x_scale == pytest.approx(w.x_scale, rel=1e-5)
    assert got.layers[0].x_scale == want.layers[0].x_scale
    assert _port_qcfg(want).to_dict() == dataclasses.asdict(want)
    assert QuantConfig.from_dict(got.to_dict()) == got


def test_quantize_params_is_bit_equal(mnist):
    p, _, tp, z = mnist
    jq = j_calibrate(p, jdcnn.MNIST_DCNN, jnp.asarray(z))
    want = j_quantize_params(p, jdcnn.MNIST_DCNN, jq)
    got = quantize_params(tp, dcnn.MNIST_DCNN, _port_qcfg(jq))
    for i in range(3):
        for key in ("w_q", "b", "scale"):
            g, w = got[f"l{i}"][key].numpy(), np.asarray(want[f"l{i}"][key])
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("geom", LAYERS)
def test_int32_accumulator_is_exact(geom, rng):
    """scale 1, bias 0, no activation, f32 out: the output is the int32
    accumulator (every sum below 2**24, so exact in f32)."""
    ih, iw, ci, co, k, s, p = geom
    x, w = _int8(rng, (2, ih, iw, ci)), _int8(rng, (k, k, ci, co))
    ones = np.ones(co, np.float32)
    want = np.asarray(j_int8_ref(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(ones), None, s, p))
    assert np.abs(want).max() < 2 ** 24
    tx, tw, to = (torch.from_numpy(a) for a in (x, w, ones))
    got = deconv2d_int8(tx, tw, to, None, s, p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        deconv2d_int8_ref(tx, tw, to, None, s, p).numpy(), want)


def test_int8_plain_version_accumulates_past_2_24_exactly(rng):
    """CelebA-like sums (4 taps x 1024 x 127**2 > 2**24): float64 keeps them
    exact where f32 would not."""
    x = np.full((1, 2, 2, 1024), 127, np.int8)
    w = np.full((4, 4, 1024, 2), 127, np.int8)
    w[..., 1] = -127
    got = deconv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                        torch.ones(2), None, 2, 1, t_ci=32)
    acc = got.double()
    assert acc.abs().max() > 2 ** 24
    want = deconv2d_int8_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.ones(2), None, 2, 1).double()
    torch.testing.assert_close(acc, want, rtol=0, atol=0)
    assert float(acc[0, 1, 1, 0]) == 4 * 1024 * 127 ** 2


@pytest.mark.parametrize("geom", LAYERS)
@pytest.mark.parametrize("out_scale,act", [(0.02, "relu"), (None, "tanh"),
                                           (0.05, None)])
def test_int8_layer_with_requant(geom, out_scale, act, rng):
    """The port's layer (the kernel's plain version on the CPU) equals its
    own integer oracle and the JAX oracle bit for bit on int8 outputs, and
    within 1e-6 on f32 ones (tanh)."""
    ih, iw, ci, co, k, s, p = geom
    x, w = _int8(rng, (3, ih, iw, ci)), _int8(rng, (k, k, ci, co))
    scale = (rng.rand(co) * 2e-4 + 1e-5).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    want = np.asarray(j_int8_ref(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(scale), jnp.asarray(b), s, p,
                                 activation=act, out_scale=out_scale))
    tx, tw, ts, tb = (torch.from_numpy(a) for a in (x, w, scale, b))
    got = deconv2d_int8(tx, tw, ts, tb, s, p, activation=act,
                        out_scale=out_scale, t_ci=4, t_co=4, t_n=2)
    own = deconv2d_int8_ref(tx, tw, ts, tb, s, p, activation=act,
                            out_scale=out_scale)
    np.testing.assert_array_equal(got.numpy(), own.numpy())
    assert got.dtype == (torch.int8 if out_scale else torch.float32)
    if out_scale is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_epilogue_rounds_product_and_sum_separately(rng):
    """The LSB rule at its source.  Each case puts the separately rounded
    ``fl(fl(acc*scale) + b)`` exactly on the tie 0.5 (out_scale 1, so the
    division is exact): the port rounds it to even, 0, as the CUDA kernel
    does, and so does the reference's epilogue run eagerly (its plain
    oracles run so).  Under ``jax.jit`` XLA on the CPU fuses the multiply
    and add into one FMA, which sees the product's rounding error and
    lands just above the tie on about half the cases: there the jitted
    reference is 1 LSB higher.  The share is printed."""
    acc = rng.randint(2 ** 16, 2 ** 20, size=20000).astype(np.int32)
    scale = (rng.rand(20000) * 1e-2 + 1e-3).astype(np.float32)
    prod = acc.astype(np.float32) * scale
    b = (np.float32(0.5) - prod).astype(np.float32)
    assert ((prod + b) == 0.5).all()
    got = int8_kernel.requant_epilogue(torch.from_numpy(acc),
                                       torch.from_numpy(scale),
                                       torch.from_numpy(b), "relu", 1.0)
    np.testing.assert_array_equal(got.numpy(), 0)
    args = (jnp.asarray(acc), jnp.asarray(scale), jnp.asarray(b))
    eager = np.asarray(j_epilogue(*args, "relu", 1.0))
    np.testing.assert_array_equal(eager, got.numpy())
    jitted = np.asarray(jax.jit(
        lambda a, s_, b_: j_epilogue(a, s_, b_, "relu", 1.0))(*args))
    d = np.abs(jitted.astype(int) - got.numpy().astype(int))
    print(f"jitted reference differs by 1 LSB on {int(d.sum())} of {d.size}")
    assert d.max() <= 1


def test_int8_launch_checks_shapes():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((4, 4, 8, 4), dtype=torch.int8)
    xp, wp, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x, w, torch.ones(4), None, 2, 1, 8, 8, 4, 4, 1, "relu", 0.1)
    with pytest.raises(ValueError, match="tile multiples"):
        int8_kernel.deconv2d_int8_launch(xp, wp, sp, bp, **{**kw, "t_ci": 3})


def test_int8_chain_matches_reference(mnist):
    """The whole chain on one QuantConfig: the port's chain equals its own
    oracle chain bit for bit, and the reference's images within 1e-5."""
    p, _, tp, z = mnist
    jq = j_calibrate(p, jdcnn.MNIST_DCNN, jnp.asarray(z))
    jqp = j_quantize_params(p, jdcnn.MNIST_DCNN, jq)
    want = np.asarray(j_chain_ref(jqp, jdcnn.MNIST_DCNN, jq, jnp.asarray(z)))
    qcfg = _port_qcfg(jq)
    qp = quantize_params(tp, dcnn.MNIST_DCNN, qcfg)
    got = quantized_generator_apply(qp, dcnn.MNIST_DCNN, qcfg,
                                    torch.from_numpy(z))
    own = quantized_generator_ref(qp, dcnn.MNIST_DCNN, qcfg,
                                  torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), own.numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="layers"):
        quantized_generator_apply(qp, dcnn.MNIST_DCNN, QuantConfig(
            name="x", strategy="minmax", layers=qcfg.layers[:2]),
            torch.from_numpy(z))


def test_mmd_matches_reference(rng):
    x = rng.randn(12, 20).astype(np.float32)
    y = (rng.randn(10, 20) + 0.3).astype(np.float32)
    want = float(j_mmd(jnp.asarray(x), jnp.asarray(y)))
    got = float(mmd(torch.from_numpy(x), torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-4)
    assert float(median_bandwidth(torch.from_numpy(x))) == pytest.approx(
        float(j_median_bandwidth(jnp.asarray(x))), rel=1e-5)


def test_mmd_degradation_reports_every_strategy(mnist):
    _, _, tp, _ = mnist
    rows = mmd_degradation(tp, dcnn.MNIST_DCNN, torch.Generator().manual_seed(0),
                           n=6, calib_n=6)
    assert [r["strategy"] for r in rows] == ["minmax", "percentile",
                                             "mean_ksigma"]
    for r in rows:
        assert 0.0 <= r["mmd_vs_fp32"] < 0.5
        assert 0.0 < r["max_abs_err"] < 0.2


def test_calibration_input_is_seeded_normal():
    a = calibration_input(dcnn.MNIST_DCNN, seed=3, batch=256)
    assert a.shape == (256, 100) and a.dtype == torch.float32
    torch.testing.assert_close(a, calibration_input(dcnn.MNIST_DCNN, seed=3,
                                                    batch=256))
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05
