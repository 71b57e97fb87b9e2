"""The port's copy of the paper's models (the DSE of Fig. 5, the kernel's
traffic and footprint models, Eq. 6) against the JAX package's: every
result equal (``==``, no tolerance: the same arithmetic in the same
order), on the paper's devices and every layer of the four towers."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import dse as jdse
from repro.core import metric as jmetric
from repro.core import tiling as jtiling
from repro.models import dcnn as jdcnn
from repro.workloads import zoo as jzoo
from repro_torch.core import dse, metric, tiling
from repro_torch.core.tiling import KERNEL_MAX_SMEM

DEVICES = {"pynq-z2": (jdse.PYNQ_Z2, dse.PYNQ_Z2),
           "tpu-v5e": (jdse.TPU_V5E, dse.TPU_V5E)}
TOWERS = {"mnist": jdcnn.MNIST_DCNN, "celeba": jdcnn.CELEBA_DCNN,
          "sr": jzoo.SR_X2, "denoise": jzoo.DAE_DENOISE}


def _geoms(cfg):
    """The tower's layers as (reference geometry, port geometry)."""
    out = []
    for g in cfg.geometries():
        f = dataclasses.astuple(g)
        out.append((jtiling.DeconvGeometry(*f), tiling.DeconvGeometry(*f)))
    return out


def _t(p):
    return dataclasses.astuple(p)


# (ih, iw, ci, co, k, s, p): the towers' shapes and odd ones (stride 3,
# K < S, ragged tiles)
SWEEP = [(1, 1, 100, 256, 7, 1, 0), (7, 7, 256, 128, 4, 2, 1),
         (14, 14, 1, 32, 5, 1, 2), (28, 28, 24, 8, 3, 1, 1),
         (4, 4, 2, 3, 5, 3, 2), (5, 6, 3, 5, 3, 2, 0), (13, 13, 8, 1, 5, 2, 2),
         (6, 5, 4, 4, 2, 3, 0)]


def test_devices_copied_and_h100_as_stated():
    for j, t in DEVICES.values():
        # the reference's fields equal; the port's two GPU rates unset
        for f in dataclasses.fields(j):
            assert getattr(j, f.name) == getattr(t, f.name)
        assert (t.tf32_peak_ops, t.bf16_peak_ops) == (0.0, 0.0)
    h = dse.H100_SXM
    assert (h.peak_ops, h.int8_peak_ops, h.bandwidth) == (67e12, 1979e12,
                                                          3.35e12)
    assert h.onchip_bytes == KERNEL_MAX_SMEM
    assert h.peak_for(1) == 1979e12 and h.peak_for(4) == 67e12
    assert (h.tf32_peak_ops, h.bf16_peak_ops) == (495e12, 989e12)


@pytest.mark.parametrize("device", sorted(DEVICES))
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_layer_dse_unified_and_per_layer_optimum_equal(tower, device):
    jdev, tdev = DEVICES[device]
    geoms = _geoms(TOWERS[tower])
    for jg, tg in geoms:
        for co_tile in (8, 128):
            assert ([_t(p) for p in dse.layer_dse(tg, tdev, co_tile)]
                    == [_t(p) for p in jdse.layer_dse(jg, jdev, co_tile)])
    jg_all = [j for j, _ in geoms]
    tg_all = [t for _, t in geoms]
    assert _outcome(dse.optimize_unified_tile, tg_all, tdev) == \
        _outcome(jdse.optimize_unified_tile, jg_all, jdev)
    assert _outcome(lambda *a: [_t(p) for p in dse.per_layer_optimum(*a)],
                    tg_all, tdev) == \
        _outcome(lambda *a: [_t(p) for p in jdse.per_layer_optimum(*a)],
                 jg_all, jdev)


def _outcome(fn, *args):
    """``fn(*args)``, or the type and message of what it raised (a layer
    with no legal tiling factor on a device must be refused alike)."""
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("device", sorted(DEVICES))
def test_tile_attainable_equal(device):
    jdev, tdev = DEVICES[device]
    for f in SWEEP:
        jg, tg = jtiling.DeconvGeometry(*f), tiling.DeconvGeometry(*f)
        s = f[5]
        for t, t_ci, t_co, t_n, db, ob in itertools.product(
                (s, 2 * s, 4 * s), (8, 128), (8, 128), (1, 4), (None, 1, 4),
                (None, 4)):
            kw = dict(t_n=t_n, batch=2 * t_n, dtype_bytes=db,
                      out_dtype_bytes=ob)
            assert _t(dse.tile_attainable(tg, t, t, t_ci, t_co, tdev, **kw)) \
                == _t(jdse.tile_attainable(jg, t, t, t_ci, t_co, jdev, **kw))


@pytest.mark.parametrize("geom", SWEEP, ids=str)
def test_traffic_and_footprint_models_equal(geom):
    jg, tg = jtiling.DeconvGeometry(*geom), tiling.DeconvGeometry(*geom)
    k, s, p = geom[4:]
    for t in (s, 2 * s, 3 * s, 8 * s):
        assert tiling.input_tile_extent(t, k, s) == \
            jtiling.input_tile_extent(t, k, s)
        for t_ci, t_co, db in itertools.product((1, 8, 128), (3, 64),
                                                (1, 2, 4)):
            args = (t, t, t_ci, t_co, db)
            assert _t(tiling.deconv_traffic(tg, *args)) == \
                _t(jtiling.deconv_traffic(jg, *args))
            assert _t(tiling.full_image_traffic(tg, *args)) == \
                _t(jtiling.full_image_traffic(jg, *args))
            for batch, t_n, ob in ((1, 1, None), (5, 2, 4), (64, 8, None)):
                assert _t(tiling.deconv_traffic_batched(
                    tg, batch, t_n, *args, out_dtype_bytes=ob)) == \
                    _t(jtiling.deconv_traffic_batched(
                        jg, batch, t_n, *args, out_dtype_bytes=ob))
                assert tiling.kernel_vmem_bytes(
                    tg, *args, t_n=t_n, out_dtype_bytes=ob) == \
                    jtiling.kernel_vmem_bytes(jg, *args, t_n=t_n,
                                              out_dtype_bytes=ob)
    for model, budget, co_tile, db in itertools.product(
            ("full_spatial", "eq5"), (64 << 10, 12 << 20), (8, 128), (1, 4)):
        assert tiling.legal_tile_factors(tg, budget, db, co_tile, model) == \
            jtiling.legal_tile_factors(jg, budget, db, co_tile, model)
        for t in range(s, tg.out_h + s, s):
            assert tiling.vmem_footprint(tg, t, co_tile, db, model) == \
                jtiling.vmem_footprint(jg, t, co_tile, db, model)
    oh = tg.out_h
    if (oh - k + 2 * p) % s == 0:
        assert tiling.in_size_for(oh, k, s, p) == \
            jtiling.in_size_for(oh, k, s, p) == geom[0]


def test_eq6_metric_equal():
    rng = np.random.default_rng(0)
    sp = np.linspace(0.0, 0.95, 12)
    t0, d0 = 1.7, 0.02
    tp = t0 * (1 - 0.8 * sp) + rng.uniform(0, 0.05, sp.size)
    dp = d0 * (1 + 6 * sp ** 3) + rng.uniform(0, 1e-3, sp.size)
    got = metric.quality_speed_metric(t0, d0, tp, dp)
    want = jmetric.quality_speed_metric(t0, d0, tp, dp)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    best, curve = metric.optimal_sparsity(sp, t0, d0, tp, dp)
    jbest, jcurve = jmetric.optimal_sparsity(sp, t0, d0, tp, dp)
    assert best == jbest and np.array_equal(curve, jcurve)
    assert 0.0 < best < 0.95      # an interior peak, as in the paper's Fig. 6
