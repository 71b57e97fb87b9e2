"""The port's deconv layer against the JAX package's plain references.

On the CPU `deconv2d` runs the kernel's plain version through the same host
padding, launch arguments and un-padding slice that the CUDA launch uses.
It is held against the JAX package's ``deconv2d_ref`` (XLA zero insertion),
``deconv2d_reverse_loop`` and ``deconv2d_algorithm1_numpy``; the Pallas
kernels themselves are not run.

Tolerances: fp32 1e-4 (the same products summed in another order; the JAX
kernel tests use the same bound), bf16 8e-2 (the output is rounded to
bf16, about three significant digits, from differently ordered sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.deconv import deconv2d_algorithm1_numpy as j_alg1
from repro.core.deconv import deconv2d_reverse_loop as j_reverse_loop
from repro.kernels.deconv2d.ref import deconv2d_ref as j_ref
from repro_torch.core.deconv import (deconv2d_algorithm1_numpy,
                                     deconv2d_reverse_loop,
                                     deconv2d_zero_insertion)
from repro_torch.kernels.deconv2d import deconv2d, deconv2d_launch
from repro_torch.kernels.deconv2d.kernel import deconv2d_launch_plain
from repro_torch.kernels.deconv2d.ops import launch_args

SWEEP = [
    # (ih, iw, ci, co, k, s, p, t_oh)
    (7, 7, 8, 16, 4, 2, 1, None),
    (7, 7, 8, 16, 4, 2, 1, 4),
    (1, 1, 4, 8, 7, 1, 0, None),
    (1, 1, 4, 8, 4, 1, 0, 2),
    (5, 6, 3, 5, 3, 2, 0, 4),
    (4, 4, 2, 3, 5, 3, 2, 6),
    (16, 16, 32, 64, 4, 2, 1, 8),
    (6, 5, 4, 4, 4, 1, 2, None),
    (8, 8, 16, 8, 3, 3, 1, 9),
]
ALG1_GEOMS = [
    # (ih, iw, ci, co, k, s, p, t): odd output with a ragged last tile,
    # non-square input and output, non-dividing tiles, stride 3
    (4, 4, 6, 5, 5, 2, 2, 4),
    (4, 6, 3, 4, 5, 2, 2, 4),
    (5, 3, 4, 7, 4, 2, 1, 6),
    (4, 5, 2, 3, 5, 3, 1, 6),
]
TILE_SETS = {
    "tile": {},
    "ci_chunks": {"t_ci": 2, "t_co": 2},
    "batch_tile": {"t_n": 2},
    "pad_output": {"grow": 2},
}
F32_TOL = 1e-4
BF16_TOL = 8e-2


def _inputs(rng, n, ih, iw, ci, co, k):
    x = rng.randn(n, ih, iw, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return x, w, b


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("geom", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deconv2d_matches_reference_oracle(geom, dtype, rng):
    ih, iw, ci, co, k, s, p, t = geom
    x, w, b = _inputs(rng, 2, ih, iw, ci, co, k)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = np.asarray(j_ref(jnp.asarray(x, jd), jnp.asarray(w, jd),
                            jnp.asarray(b, jd), s, p), np.float32)
    y = deconv2d(_t(x, td), _t(w, td), _t(b, td), s, p, t_oh=t, t_ow=t)
    assert tuple(y.shape) == want.shape
    assert y.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("geom", SWEEP)
def test_reverse_loop_and_cudnn_match_reference(geom, rng):
    ih, iw, ci, co, k, s, p, _ = geom
    x, w, b = _inputs(rng, 2, ih, iw, ci, co, k)
    want = np.asarray(j_reverse_loop(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), s, p))
    for fn in (deconv2d_reverse_loop, deconv2d_zero_insertion):
        y = fn(_t(x), _t(w), _t(b), s, p)
        np.testing.assert_allclose(y.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("tiles", sorted(TILE_SETS))
@pytest.mark.parametrize("geom", ALG1_GEOMS)
def test_deconv2d_matches_algorithm1(geom, tiles, rng):
    """Batch 5 through every tile set: plain tiles, several CI/CO chunks,
    a ragged batch tile (t_n=2) and tiles that pad OH/OW past the image."""
    ih, iw, ci, co, k, s, p, t = geom
    kw = dict(TILE_SETS[tiles])
    t_out = t * kw.pop("grow", 1)
    x, w, b = _inputs(rng, 5, ih, iw, ci, co, k)
    y = deconv2d(_t(x), _t(w), _t(b), s, p, t_oh=t_out, t_ow=t_out,
                 **kw).numpy()
    for n in range(x.shape[0]):
        want, _ = j_alg1(x[n], w, b, s, p)
        np.testing.assert_allclose(y[n], want.astype(np.float32),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_algorithm1_copy_matches_reference(rng):
    x, w, b = _inputs(rng, 1, 4, 5, 3, 4, 5)
    w[0, 1] = 0.0
    for zero_skip in (False, True):
        want, want_macs = j_alg1(x[0], w, b, 2, 2, t_oh=4, zero_skip=zero_skip)
        got, macs = deconv2d_algorithm1_numpy(x[0], w, b, 2, 2, t_oh=4,
                                              zero_skip=zero_skip)
        np.testing.assert_array_equal(got, want)
        assert macs == want_macs


def test_channel_tiling_and_fused_activation(rng):
    """CI accumulated over three chunks, CO over three tiles, then the
    fused tanh, against the oracle followed by tanh."""
    x, w, _ = _inputs(rng, 1, 6, 6, 24, 40, 4)
    want = np.tanh(np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w), None,
                                    2, 1)))
    y = deconv2d(_t(x), _t(w), None, 2, 1, t_ci=8, t_co=16,
                 activation="tanh")
    np.testing.assert_allclose(y.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_launch_rejects_what_the_kernel_does_not_take(rng):
    x, w, b = _inputs(rng, 2, 5, 5, 4, 6, 4)
    xp, wp, bp, kw, _ = launch_args(_t(x), _t(w), _t(b), 2, 1, 4, 4, 4, 6, 1,
                                    "relu")
    with pytest.raises(ValueError, match="under-padded"):
        deconv2d_launch_plain(xp[:, :-1], wp, bp, **kw)
    with pytest.raises(ValueError, match="stride-aligned"):
        deconv2d_launch_plain(xp, wp, bp, **{**kw, "t_oh": 3})
    with pytest.raises(ValueError, match="no kernel for device"):
        deconv2d_launch(xp.to("meta"), wp.to("meta"), bp.to("meta"), **kw)
    with pytest.raises(TypeError, match="stride and padding"):
        deconv2d(_t(x), _t(w), _t(b))
