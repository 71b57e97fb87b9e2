"""The fp32 tensor-core kernel's arithmetic and host side, on the CPU.

The kernel (``csrc/deconv2d_tc.cu``) runs only on the card; what it relies
on is checked here against the JAX package: its 3xTF32 products (a numpy
emulation at CelebA's reduction lengths), the cluster split of the CI
reduction (the plain version summing per-rank partials in rank order), the
packed zero-skip schedule (decoded back to the reference's tables), and the
tiles and shared memory the launcher gives it.

Tolerances: 3xTF32 within 1e-6 of float64 (|d| / (1 + |ref|), as
``chip_smoke.py`` scores); the split plain version within 1e-5 of the
unsplit one and 1e-4 of the JAX reference; schedules bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.deconv2d import deconv2d_ref as j_deconv2d_ref
from repro.kernels.deconv2d_sparse import make_sparse_plan as j_make_sparse_plan
from repro.models import dcnn as jdcnn
from repro_torch.core.offsets import make_phase_plan
from repro_torch.core.sparsity import magnitude_prune
from repro_torch.core.tiling import (KERNEL_MAX_SMEM, KERNEL_MAX_THREADS,
                                     DeconvGeometry, block_threads,
                                     halo_tile, kernel_smem_bytes,
                                     staged_window, tc_warp_tile)
from repro_torch.kernels.autotune import (MAX_SPLIT, SMS, ci_split,
                                          grid_blocks, hopper_tiles)
from repro_torch.kernels.autotune import BUCKET1_MIN_CTAS
from repro_torch.kernels.deconv2d.kernel import (deconv2d_launch_plain,
                                                 launch_split)
from repro_torch.kernels.deconv2d.ops import launch_args
from repro_torch.kernels.deconv2d_sparse import (make_sparse_plan,
                                                 pack_schedule,
                                                 schedule_tensors,
                                                 unpack_schedule)
from repro_torch.kernels.deconv2d_sparse.kernel import \
    deconv2d_sparse_launch_plain
from repro_torch.models import dcnn

BUCKETS = (1, 2, 4, 8, 16, 32, 64)
NETS = [dcnn.MNIST_DCNN, dcnn.CELEBA_DCNN]


def _tf32_cut(v):
    """What the tensor core reads of an f32 operand: sign, exponent and the
    top 10 mantissa bits (the kernel's hi is this cut)."""
    v = np.asarray(v, np.float32)
    return (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_round(v):
    """f32 rounded to TF32, to nearest with ties away from zero (one TF32
    product, as cvt.rna.tf32.f32 and the libraries' TF32 mode round)."""
    v = np.asarray(v, np.float32)
    return ((v.view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_sum(x, w, three, chunk=64):
    """x (M, K) @ w (K, N) as the kernel sums it: per 8-deep k-step the
    products of TF32 operands (exact in float64) added into an f32 partial,
    and each ``chunk``-deep partial (a CI chunk: 4 taps x 16 channels)
    added into the f32 accumulator; with ``three`` the 3xTF32 split hi =
    cut(v), lo = v - hi and lo*hi + hi*lo + hi*hi."""
    if three:
        xh, wh = _tf32_cut(x), _tf32_cut(w)
        terms = [(_tf32_cut(x - xh), wh), (xh, _tf32_cut(w - wh)), (xh, wh)]
    else:
        terms = [(_tf32_round(x), _tf32_round(w))]
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for c0 in range(0, x.shape[1], chunk):
        part = np.zeros_like(acc)
        for k0 in range(c0, c0 + chunk, 8):
            step = sum(a[:, k0:k0 + 8].astype(np.float64)
                       @ b[k0:k0 + 8].astype(np.float64) for a, b in terms)
            part = part + step.astype(np.float32)
        acc = acc + part
    return acc


@pytest.mark.parametrize("taps,c_in", [(4, 1024), (4, 256)],
                         ids=["celeba_l1", "celeba_l3"])
def test_3xtf32_products_keep_fp32_accuracy(taps, c_in):
    """At CelebA's layer 1 and 3 reduction lengths (4 taps per phase x
    C_in), on ReLU N(0, 1) activations and LeCun weights: the kernel's
    3xTF32 sums stay within 1e-6 of float64; one TF32 product per term
    misses the 1e-4 parity, which is why the kernel splits."""
    rng = np.random.default_rng(0)
    k = taps * c_in
    x = np.maximum(rng.standard_normal((128, k)), 0).astype(np.float32)
    w = (rng.standard_normal((k, 32)) / np.sqrt(16 * c_in)).astype(np.float32)
    ref = x.astype(np.float64) @ w.astype(np.float64)

    def err(y):
        return float((np.abs(y - ref) / (1 + np.abs(ref))).max())

    three, one = err(_mma_sum(x, w, True)), err(_mma_sum(x, w, False))
    print(f"K={k}: 3xTF32 {three:.2e}, one TF32 product {one:.2e}")
    assert three < 1e-6
    assert one > 1e-4


def _layer(rng, batch, geom, act="relu"):
    ih, iw, ci, co, k, s, p = geom
    x = torch.from_numpy(rng.standard_normal((batch, ih, iw, ci))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, ci, co))
                          / np.sqrt(ci * k * k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("split", [2, 4, 8])
def test_cluster_split_plain_version(split):
    """The plain version with the CI chunks split over ``split`` ranks
    (partials summed in rank order, then the bias) agrees with the unsplit
    plain version within 1e-5 and with the JAX reference within 1e-4, and
    is bit-identical across two runs."""
    geom = (6, 6, 64, 24, 4, 2, 1)
    x, w, b = _layer(np.random.default_rng(split), 2, geom)
    xp, wp, bp, kw, crop = launch_args(x, w, b, 2, 1, 4, 4, 8, 8, 1, "relu")
    one = deconv2d_launch_plain(xp, wp, bp, **kw)
    parts = deconv2d_launch_plain(xp, wp, bp, split=split, **kw)
    again = deconv2d_launch_plain(xp, wp, bp, split=split, **kw)
    assert torch.equal(parts, again)
    torch.testing.assert_close(parts, one, rtol=1e-5, atol=1e-5)
    want = np.maximum(np.asarray(j_deconv2d_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), 2, 1)), 0)
    np.testing.assert_allclose(parts[crop].numpy(), want, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="split"):
        deconv2d_launch_plain(xp, wp, bp, split=9, **kw)


def test_launch_split_fills_the_card_from_the_grid():
    """The launcher's split: doubled while blocks x split is under the SMs,
    at most 8 and at most one rank per CI chunk."""
    assert ci_split(200, 64) == 1
    assert ci_split(100, 64) == 2
    assert ci_split(40, 64) == 4
    assert ci_split(1, 64) == MAX_SPLIT == 8
    assert ci_split(1, 3) == 2
    # CelebA layer 1 at bucket 1: an 8x8 tile and 16 channels per block
    assert launch_split(1, 1024, 512, 8, 8, 8, 8, 32, 16, 1) == 8


@pytest.mark.parametrize("cfg", NETS, ids=["mnist", "celeba"])
def test_packed_schedule_decodes_to_the_reference_tables(cfg):
    """Every pruned layer of both nets at its fp32 tiles: packing the
    reference's (ci_idx, valid, tap_mask) and decoding it gives the tables
    back, which equal the JAX package's at the same tiles; the plain
    version on the packed schedule equals the dense plain version on the
    weights the tables keep."""
    rng = np.random.default_rng(3)
    for g, l in zip(cfg.geometries(), cfg.layers):
        t = hopper_tiles(g, 2)
        w = magnitude_prune(torch.from_numpy(
            rng.standard_normal((g.kernel, g.kernel, g.c_in, g.c_out))
            .astype(np.float32)), 0.9)[0]
        w[:, :, : g.c_in // 2] = 0.0
        tables = make_sparse_plan(w, g.stride, g.padding, t.t_ci, t.t_co)
        want = j_make_sparse_plan(jnp.asarray(w.numpy()), g.stride,
                                  g.padding, t.t_ci, t.t_co)
        for a, j in zip(tables, want):
            np.testing.assert_array_equal(a, np.asarray(j))
        count, ci, bits = pack_schedule(*tables)
        assert bits.shape[-1] == -(-g.kernel ** 2 // 32)
        for got, ref in zip(unpack_schedule(count, ci, bits, g.kernel),
                            tables):
            np.testing.assert_array_equal(got.numpy(), ref)
        # the plain version on the packed schedule, on a small batch
        x = torch.from_numpy(rng.standard_normal((1, g.in_h, g.in_w, g.c_in))
                             .astype(np.float32))
        xp, wp, bp, kw, _ = launch_args(x, w, None, g.stride, g.padding,
                                        *t.as_kwargs().values(),
                                        l.activation)
        sched = schedule_tensors(tables, "cpu")
        got = deconv2d_sparse_launch_plain(xp, wp, bp, *sched, **kw)
        ci_idx, valid, tap_mask = tables
        keep = np.zeros(wp.shape, bool)
        for co_t in range(ci_idx.shape[0]):
            for e in np.flatnonzero(valid[co_t]):
                c0 = ci_idx[co_t, e] * t.t_ci
                live = tap_mask[co_t, e].reshape(g.kernel, g.kernel) != 0
                keep[:, :, c0:c0 + t.t_ci,
                     co_t * t.t_co:(co_t + 1) * t.t_co] |= \
                    live[:, :, None, None]
        dense = deconv2d_launch_plain(xp, wp * torch.from_numpy(keep), bp,
                                      **kw)
        assert torch.equal(got, dense)


def _tc_takes(g, batch, t):
    """The checks the fp32 kernel's launch makes (csrc/deconv2d_tc.cu
    `setup`) on the launcher's padded extents at tiles ``t``."""
    s = g.stride
    ohp, owp = -(-g.out_h // t.t_oh) * t.t_oh, -(-g.out_w // t.t_ow) * t.t_ow
    cip = -(-g.c_in // t.t_ci) * t.t_ci
    blocks = grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n)
    split = ci_split(blocks, cip // t.t_ci)
    assert t.t_oh % s == 0 and t.t_ow % s == 0
    assert t.t_ci % 8 == 0 and t.t_co >= 1
    assert t.t_co % 8 == 0 or t.t_co == g.c_out < 8
    assert 1 <= split <= min(MAX_SPLIT, cip // t.t_ci)
    assert block_threads(s, t.t_oh, t.t_ow, t.t_co, t.t_n, k_size=g.kernel,
                         t_ci=t.t_ci) <= KERNEL_MAX_THREADS
    assert kernel_smem_bytes(g, t.t_oh, t.t_ow, t.t_ci, t.t_co, t.t_n,
                             split=split) <= KERNEL_MAX_SMEM
    # every halo window lies inside the host-padded input
    plan = make_phase_plan(g.kernel, s, g.padding)
    for t_out, n_out, size in ((t.t_oh, ohp, g.in_h), (t.t_ow, owp, g.in_w)):
        ht = halo_tile(t_out, g.kernel, s, g.padding)
        padded = plan.left_halo + size + max(
            0, (n_out // s - 1 + plan.delta_max) - (size - 1))
        assert ht.min_padded_extent(n_out // t_out) <= padded
    return blocks, split


@pytest.mark.parametrize("cfg", NETS, ids=["mnist", "celeba"])
def test_hopper_tiles_are_taken_by_the_tc_kernel(cfg):
    """fp32 tiles for every layer of both nets at buckets 1 .. 64 pass the
    kernel's launch checks; CelebA's wide layers at bucket 1 split their
    CI chunks over clusters and run in one wave of at least
    BUCKET1_MIN_CTAS blocks, at most one per SM (`autotune._bucket1_tiles`)."""
    for i, g in enumerate(cfg.geometries()):
        for batch in BUCKETS:
            t = hopper_tiles(g, batch)
            blocks, split = _tc_takes(g, batch, t)
            if cfg is dcnn.CELEBA_DCNN and i in (1, 2, 3) and batch == 1:
                assert split > 1
                assert BUCKET1_MIN_CTAS <= blocks * split <= SMS


def test_staged_window_is_the_largest_block_span():
    """`staged_window` against the kernel's per-block rule, tile by tile:
    a phase tap is valid when its rows meet the real input, and the block
    stages the rows its valid taps read."""
    for (size, k, s, p, t) in ((4, 4, 2, 1, 8), (8, 4, 2, 1, 4), (1, 7, 1, 0, 1),
                               (1, 4, 1, 0, 1), (5, 3, 2, 0, 4), (4, 5, 3, 2, 6),
                               (14, 4, 2, 1, 16)):
        plan = make_phase_plan(k, s, p)
        out = (size - 1) * s + k - 2 * p
        n_out = -(-out // t) * t
        step = t // s
        rows = taps = 0
        for j in range(n_out // t):
            o0 = j * step + plan.left_halo + plan.delta_min
            ds = [d - plan.delta_min for ph in range(s) for _, d in plan.taps[ph]
                  if plan.left_halo <= o0 + d - plan.delta_min + step - 1
                  and o0 + d - plan.delta_min < plan.left_halo + size]
            if ds:
                rows = max(rows, max(ds) + step - min(ds))
                taps = max(taps, len(ds))
        assert staged_window(size, n_out, t, k, s, p) == (rows, taps)
    # a root stages one input pixel and one tap per 1-pixel tile
    assert staged_window(1, 4, 1, 4, 1, 0) == (1, 1)


def test_warp_tiles_cover_phase_rows_and_channels():
    """(WM, WN): m16 row tiles and n8 column tiles of one warp, each one of
    the kernel's six instances."""
    assert tc_warp_tile(16, 64) == (1, 4)
    assert tc_warp_tile(32, 32) == (2, 4)
    assert tc_warp_tile(128, 16) == (2, 2)
    assert tc_warp_tile(1, 3) == (1, 1)
    for pix in (1, 9, 16, 31, 64, 256):
        for t_co in (1, 3, 8, 12, 16, 40, 64, 128):
            assert tc_warp_tile(pix, t_co) in {(m, n) for m in (1, 2)
                                               for n in (1, 2, 4)}


def test_generator_layers_through_the_split_plain_version():
    """The slice as a whole on the CPU: every layer of the MNIST generator
    (JAX params) through the plain version at its fp32 tiles and bucket-1
    cluster split matches the JAX reverse loop."""
    import jax

    p, _ = jdcnn.generator_init(jax.random.PRNGKey(5), jdcnn.MNIST_DCNN)
    tp = dcnn.generator_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), dcnn.MNIST_DCNN, "cpu")
    z = np.random.RandomState(6).randn(1, 100).astype(np.float32)
    want = np.asarray(jdcnn.generator_apply(p, jdcnn.MNIST_DCNN,
                                            jnp.asarray(z),
                                            backend="reverse_loop"))
    x = torch.from_numpy(z).reshape(1, 1, 1, 100)
    for i, (g, l) in enumerate(zip(dcnn.MNIST_DCNN.geometries(),
                                   dcnn.MNIST_DCNN.layers)):
        t = hopper_tiles(g, 1)
        xp, wp, bp, kw, crop = launch_args(
            x, tp[f"l{i}"]["w"], tp[f"l{i}"]["b"], g.stride, g.padding,
            *t.as_kwargs().values(), l.activation)
        split = launch_split(xp.shape[0], xp.shape[3], wp.shape[3],
                             kw["ohp"], kw["owp"], t.t_oh, t.t_ow, t.t_ci,
                             t.t_co, t.t_n)
        x = deconv2d_launch_plain(xp, wp, bp, split=split, **kw)[crop]
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-4, atol=1e-4)


def test_kernel_geometry_matches_reference_geometry():
    """The layers the tiles are fitted to are the reference's."""
    for jcfg, cfg in ((jdcnn.MNIST_DCNN, dcnn.MNIST_DCNN),
                      (jdcnn.CELEBA_DCNN, dcnn.CELEBA_DCNN)):
        for jg, g in zip(jcfg.geometries(), cfg.geometries()):
            assert DeconvGeometry(jg.in_h, jg.in_w, jg.c_in, jg.c_out,
                                  jg.kernel, jg.stride, jg.padding) == g
