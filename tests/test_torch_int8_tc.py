"""The int8 tensor-core kernel's arithmetic and host side, on the CPU.

The kernel (``csrc/deconv2d_tc.cu``, ``deconv2d_tc_int8_forward``) runs
only on the card; what it relies on is checked here: the packed weight
layout, a numpy transcription of its index arithmetic (block -> tile, the
block's valid taps and staged window with rows of t_ci + 16 bytes, the
m16n8k32 A/B/D fragment lanes, the split's rank-ordered int32 sum) against
the plain version's int32 accumulator, the tiles and guards its launcher
applies, and the int8 layer and chain through packed weights against the
JAX package's oracles.

Tolerances: integer sums and int8 outputs bit for bit; f32 outputs of the
last (tanh) layer within 1e-6, as the other int8 parity tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.deconv2d import deconv2d_int8_ref as j_int8_ref
from repro.models import dcnn as jdcnn
from repro.quant import calibrate as j_calibrate
from repro.quant import quantize_params as j_quantize_params
from repro.quant.infer import quantized_generator_ref as j_chain_ref
from repro_torch.core.tiling import (KERNEL_MAX_SMEM, halo_tile,
                                     int8_acc_bound, int8_row_stride,
                                     kernel_smem_bytes, staged_window,
                                     tc_columns, tc_warp_tile)
from repro_torch.kernels.autotune import (INT8_T_CI, MAX_SPLIT, SMS,
                                          ci_split, grid_blocks,
                                          hopper_tiles)
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.kernels.deconv2d.int8 import (PackedInt8Weights,
                                               deconv2d_int8,
                                               deconv2d_int8_launch,
                                               deconv2d_int8_launch_plain,
                                               int8_acc_plain,
                                               launch_args_int8,
                                               launch_split_int8,
                                               pack_int8_weights,
                                               packed_ci_width,
                                               packed_width,
                                               unpack_int8_weights)
from repro_torch.kernels.deconv2d.kernel import _tap_words
from repro_torch.models import dcnn
from repro_torch.quant import (QuantConfig, pack_quantized_params,
                               quantize_params, quantize_symmetric,
                               quantized_generator_apply,
                               quantized_generator_ref)

NETS = [dcnn.MNIST_DCNN, dcnn.CELEBA_DCNN]
MAX_STRIDE, MAX_TAPS = 4, 8   # the tap table's layout (csrc kMaxStride, kMaxTaps)


def _int8(rng, shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


# -- packing -----------------------------------------------------------------
@pytest.mark.parametrize("shape,cip,cop", [((4, 4, 100, 24), 128, 32),
                                           ((4, 4, 64, 3), 64, 3),
                                           ((7, 7, 16, 8), 128, 128)])
def test_pack_unpack_round_trip(shape, cip, cop, rng):
    """Packing zero-pads to (cip, cop) and lays the weight out (K, K, COp,
    CIp), contiguous; unpacking gives the padded reference layout back
    exactly, as a view."""
    w = torch.from_numpy(_int8(rng, shape))
    pk = pack_int8_weights(w, cip, cop)
    k, _, ci, co = shape
    assert pk.data.shape == (k, k, cop, cip) and pk.data.is_contiguous()
    assert (pk.shape, pk.cip, pk.cop) == (shape, cip, cop)
    assert torch.equal(pk.data[1, 2, 0, :ci], w[1, 2, :, 0])
    back = unpack_int8_weights(pk)
    assert back.data_ptr() == pk.data.data_ptr()
    assert torch.equal(back[:, :, :ci, :co], w)
    assert not back[:, :, ci:].any() and not back[:, :, :, co:].any()
    with pytest.raises(ValueError, match="cannot pack"):
        pack_int8_weights(w, ci - 1, cop)


def test_plain_version_on_unpacked_weights_equals_reference_layout(rng):
    """The plain version on the launcher's packed weight (unpacked) equals
    the plain version on the reference-layout weight padded the same way,
    here at a 128-channel packing wider than the launch's own padding."""
    x = torch.from_numpy(_int8(rng, (2, 5, 5, 40)))
    w = torch.from_numpy(_int8(rng, (4, 4, 40, 12)))
    sc = torch.from_numpy((rng.rand(12) * 1e-4).astype(np.float32))
    b = torch.from_numpy((rng.randn(12) * 0.1).astype(np.float32))
    pk = pack_int8_weights(w, 128, 128)
    outs = []
    for wt in (w, pk):
        xp, wpk, sp, bp, kw, crop = launch_args_int8(
            x, wt, sc, b, 2, 1, 4, 4, 32, 8, 1, "relu", 0.02)
        wp = torch.nn.functional.pad(
            w, (0, wpk.cop - 12, 0, wpk.cip - 40))
        ref = deconv2d_int8_launch_plain(xp, wp, sp, bp, **kw)
        got = deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
        assert torch.equal(got, ref)
        outs.append(got[crop])
    assert torch.equal(outs[0], outs[1])


# -- the kernel's index arithmetic, transcribed -------------------------------
def _block_taps(words, s, k, o0s, spans, pad_l, reals):
    """`block_taps` of csrc/deconv2d_tc.cu for one block: per dim the valid
    phase taps, their kernel bitmask, the staged span and its real rows,
    and the flat kernel tap of each weight slot."""
    tap_ok, kok, span, real, kof = [], [], [], [], []
    for dim in range(2):
        o0, sp_, n_real = o0s[dim], spans[dim], reals[dim]
        lo, hi, km, ok = 1 << 30, -(1 << 30), 0, {}
        for ph in range(s):
            for a in range(words[ph]):
                d = words[MAX_STRIDE + MAX_STRIDE * MAX_TAPS + ph * MAX_TAPS + a]
                v = o0 + d < pad_l + n_real and o0 + d + sp_ > pad_l
                ok[ph, a] = v
                if v:
                    km |= 1 << words[MAX_STRIDE + ph * MAX_TAPS + a]
                    lo, hi = min(lo, d), max(hi, d + sp_)
        if lo >= hi:
            lo = hi = 0
        r0 = min(max(pad_l - (o0 + lo), 0), hi - lo)
        r1 = max(min(pad_l + n_real - (o0 + lo), hi - lo), r0)
        tap_ok.append(ok)
        kok.append(km)
        span.append((lo, hi))
        real.append((r0, r1))
        kof.append([kk for kk in range(k) if (km >> kk) & 1])
    wtap = [kh * k + kw for kh in kof[0] for kw in kof[1]]
    return tap_ok, kok, span, real, wtap


def _popc(v):
    return bin(v).count("1")


def _u8(buf, addrs):
    """The 4 bytes at each lane's address: (32, 4) int8."""
    return buf[addrs[:, None] + np.arange(4)]


def _mma_m16n8k32(a, b):
    """mma.sync m16n8k32 s8.s8.s32 on per-lane fragments, by the PTX
    fragment layout: A row gid (a0, a2) / gid + 8 (a1, a3), k bytes
    4*tig (a0, a1) / 16 + 4*tig (a2, a3); B column gid, k bytes 4*tig (b0)
    / 16 + 4*tig (b1); D rows gid (d0, d1) / gid + 8 (d2, d3), columns
    2*tig + c % 2."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for q in range(4):
        A[gid, 4 * tig + q] = a[0][:, q]
        A[gid + 8, 4 * tig + q] = a[1][:, q]
        A[gid, 16 + 4 * tig + q] = a[2][:, q]
        A[gid + 8, 16 + 4 * tig + q] = a[3][:, q]
        B[4 * tig + q, gid] = b[0][:, q]
        B[16 + 4 * tig + q, gid] = b[1][:, q]
    D = A @ B
    return np.stack([D[gid, 2 * tig], D[gid, 2 * tig + 1],
                     D[gid + 8, 2 * tig], D[gid + 8, 2 * tig + 1]], 1)


def _banks(addrs):
    return len(set(((addrs // 4) % 32).tolist()))


def kernel_acc(xp, wpk, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci, t_co, t_n,
               split, banks=None):
    """The int32 sums ``(N, OHp, OWp, COp)`` the int8 kernel computes, by a
    line-by-line transcription of its index arithmetic on numpy buffers
    laid out as its shared memory.  ``banks`` (a dict) collects the fewest
    distinct banks one warp's A and B fragment loads hit."""
    x = xp.numpy()
    w = wpk.data.numpy()
    n, ihp, iwp, cip = x.shape
    k, s = plan.kernel_size, plan.stride
    cop = wpk.cop
    words = _tap_words(plan)
    th, tw = t_oh // s, t_ow // s
    base_h = halo_tile(t_oh, k, s, plan.padding).base
    base_w = halo_tile(t_ow, k, s, plan.padding).base
    pix = t_n * th * tw
    wm, wn = tc_warp_tile(pix, t_co)
    mgroups, ngroups = -(-(-(-pix // 16)) // wm), -(-(-(-t_co // 8)) // wn)
    cols, cs = tc_columns(t_co), int8_row_stride(t_ci)
    win_h, _ = staged_window(ih, ohp, t_oh, k, s, plan.padding)
    win_w, _ = staged_window(iw, owp, t_ow, k, s, plan.padding)
    tiles_h, tiles_w, tiles_co = ohp // t_oh, owp // t_ow, cop // t_co
    n_ci = cip // t_ci
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    y = np.zeros((n, ohp, owp, cop), np.int64)
    for by in range(n // t_n):
        for bx in range(tiles_h * tiles_w * tiles_co * split):
            rank, tile = bx % split, bx // split
            co_t, tile = tile % tiles_co, tile // tiles_co
            ow_t, oh_t = tile % tiles_w, tile // tiles_w
            n0, co0 = by * t_n, co_t * t_co
            h0, w0 = oh_t * th + base_h, ow_t * tw + base_w
            tap_ok, kok, span, real, wtap = _block_taps(
                words, s, k, (h0, w0), (th, tw), plan.left_halo, (ih, iw))
            (lo_h, hi_h), (lo_w, hi_w) = span
            eh, ew = hi_h - lo_h, hi_w - lo_w
            nw_ok = _popc(kok[1])
            it0 = rank * n_ci // split
            n_it = (rank + 1) * n_ci // split - it0
            acc = {}
            for it in range(n_it):
                c0 = (it0 + it) * t_ci
                # stage: input rows of t_ci bytes at stride cs, zero where
                # they lie outside the real input; weight rows per slot
                xs = np.zeros(t_n * win_h * win_w * cs, np.int8)
                ws = np.zeros(len(wtap) * cols * cs, np.int8)
                for r in range(t_n * eh * ew):
                    rest, lc = divmod(r, ew)
                    nn, lr = divmod(rest, eh)
                    if real[0][0] <= lr < real[0][1] and \
                            real[1][0] <= lc < real[1][1]:
                        d = ((nn * win_h + lr) * win_w + lc) * cs
                        xs[d:d + t_ci] = x[n0 + nn, h0 + lo_h + lr,
                                           w0 + lo_w + lc, c0:c0 + t_ci]
                for r in range(len(wtap) * t_co):
                    slot, co = divmod(r, t_co)
                    d = (slot * cols + co) * cs
                    ws[d:d + t_ci] = w[wtap[slot] // k, wtap[slot] % k,
                                       co0 + co, c0:c0 + t_ci]
                # mma per warp of each phase
                for phase in range(s * s):
                    ph, pw = divmod(phase, s)
                    for mg in range(mgroups):
                        aoff = {}
                        for i in range(wm):
                            for hf in range(2):
                                r = (mg * wm + i) * 16 + gid + 8 * hf
                                r = np.where(r >= pix, 0, r)
                                nn, rr, cc = r // (th * tw), (r // tw) % th, r % tw
                                aoff[i, hf] = ((nn * win_h + rr) * win_w
                                               + cc) * cs + 4 * tig
                        for ng in range(ngroups):
                            for a in range(words[ph]):
                                if not tap_ok[0][ph, a]:
                                    continue
                                kh = words[MAX_STRIDE + ph * MAX_TAPS + a]
                                dh = words[MAX_STRIDE + MAX_STRIDE * MAX_TAPS
                                           + ph * MAX_TAPS + a]
                                sh = _popc(kok[0] & ((1 << kh) - 1))
                                for bb in range(words[pw]):
                                    if not tap_ok[1][pw, bb]:
                                        continue
                                    kw = words[MAX_STRIDE + pw * MAX_TAPS + bb]
                                    dw = words[MAX_STRIDE + MAX_STRIDE
                                               * MAX_TAPS + pw * MAX_TAPS + bb]
                                    slot = sh * nw_ok + _popc(
                                        kok[1] & ((1 << kw) - 1))
                                    xt = ((dh - lo_h) * win_w + (dw - lo_w)) * cs
                                    wt = (slot * cols + ng * wn * 8 + gid) * cs \
                                        + 4 * tig
                                    for k0 in range(0, t_ci, 32):
                                        for i in range(wm):
                                            ad = [xt + aoff[i, 0] + k0,
                                                  xt + aoff[i, 1] + k0,
                                                  xt + aoff[i, 0] + k0 + 16,
                                                  xt + aoff[i, 1] + k0 + 16]
                                            af = [_u8(xs, q) for q in ad]
                                            if banks is not None:
                                                banks["a"] = min(
                                                    banks.get("a", 32),
                                                    _banks(ad[0]))
                                            for j in range(wn):
                                                bd = [wt + j * 8 * cs + k0,
                                                      wt + j * 8 * cs + k0 + 16]
                                                bf = [_u8(ws, q) for q in bd]
                                                if banks is not None:
                                                    banks["b"] = min(
                                                        banks.get("b", 32),
                                                        _banks(bd[0]),
                                                        _banks(bd[1]))
                                                key = (phase, mg, ng, i, j)
                                                acc[key] = acc.get(key, 0) + \
                                                    _mma_m16n8k32(af, bf)
            # the block's partial tile [phase][row][channel] (stores of
            # rows past pix and channels past t_co masked); under a split
            # the ranks' tiles are summed in rank order by the y += below
            for (phase, mg, ng, i, j), d in acc.items():
                ph, pw = divmod(phase, s)
                for hf in range(2):
                    r = (mg * wm + i) * 16 + gid + 8 * hf
                    for c in range(2):
                        col = (ng * wn + j) * 8 + 2 * tig + c
                        keep = (r < pix) & (col < t_co)
                        rk, ck = r[keep], col[keep]
                        nn, rr, cc = rk // (th * tw), (rk // tw) % th, rk % tw
                        y[n0 + nn, oh_t * t_oh + rr * s + ph,
                          ow_t * t_ow + cc * s + pw, co0 + ck] += \
                            d[keep, 2 * hf + c]
    assert np.abs(y).max() < 2 ** 31
    return torch.from_numpy(y.astype(np.int32))


# (ih, iw, ci, co, k, s, p, batch, t, t_ci, t_co, t_n)
TRANSCRIBED = {
    "s2k4": (4, 4, 64, 16, 4, 2, 1, 2, 8, 32, 16, 1),
    "s2k4_wide_tile": (8, 8, 64, 16, 4, 2, 1, 1, 16, 64, 8, 1),
    "root_ci100": (1, 1, 100, 24, 4, 1, 0, 3, 1, 64, 8, 2),
    "thin_co1": (5, 5, 32, 1, 4, 2, 1, 1, 4, 32, 1, 1),
    "thin_co3": (6, 6, 64, 3, 4, 2, 1, 2, 8, 32, 3, 2),
}


@pytest.mark.parametrize("case", sorted(TRANSCRIBED))
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_transcribed_kernel_equals_plain_int32_sums(case, split, rng):
    """The transcription of the kernel at ``split`` equals the plain
    version's int32 accumulator exactly: stride-2 K=4 layers, a 1x1 root
    with CI 100 padded to 128, thin C_out 1 and 3 layers.  A split takes
    at least one CI chunk per rank, so a case is widened to ``split``
    chunks where it has fewer (the root keeps its 28 padding channels)."""
    ih, iw, ci, co, k, s, p, batch, t, t_ci, t_co, t_n = TRANSCRIBED[case]
    ci = max(ci, split * t_ci - (28 if case == "root_ci100" else 0))
    x = torch.from_numpy(_int8(rng, (batch, ih, iw, ci)))
    w = torch.from_numpy(_int8(rng, (k, k, ci, co)))
    xp, wpk, _, _, kw, _ = launch_args_int8(
        x, w, torch.ones(co), None, s, p, t, t, t_ci, t_co, t_n, None, None)
    assert wpk.cip // t_ci >= split
    plan = kw["plan"]
    want = int8_acc_plain(xp, unpack_int8_weights(wpk), plan, kw["ohp"],
                          kw["owp"], t_ci)
    got = kernel_acc(xp, wpk, plan, kw["ih"], kw["iw"], kw["ohp"], kw["owp"],
                     t, t, t_ci, t_co, kw["t_n"], split)
    assert torch.equal(got, want)
    assert torch.equal(int8_acc_plain(xp, unpack_int8_weights(wpk), plan,
                                      kw["ohp"], kw["owp"], t_ci, split),
                       want)


@pytest.mark.parametrize("t_ci", INT8_T_CI)
def test_fragment_loads_hit_32_banks(t_ci, rng):
    """At the t_ci + 16-byte row stride, one warp's 32-bit loads of an A
    fragment whose 8 rows are consecutive pixels (a 16-wide tile at stride
    2: 8 pixels per phase row), and of every B fragment, fall in 32
    distinct banks."""
    x = torch.from_numpy(_int8(rng, (1, 8, 8, t_ci)))
    w = torch.from_numpy(_int8(rng, (4, 4, t_ci, 16)))
    xp, wpk, _, _, kw, _ = launch_args_int8(
        x, w, torch.ones(16), None, 2, 1, 16, 16, t_ci, 16, 1, None, None)
    banks = {}
    got = kernel_acc(xp, wpk, kw["plan"], kw["ih"], kw["iw"], kw["ohp"],
                     kw["owp"], 16, 16, t_ci, 16, 1, 1, banks)
    assert banks == {"a": 32, "b": 32}
    assert torch.equal(got, int8_acc_plain(xp, unpack_int8_weights(wpk),
                                           kw["plan"], kw["ohp"], kw["owp"],
                                           t_ci))


@pytest.mark.parametrize("split", [2, 4, 8])
def test_split_plain_version_is_bit_equal(split, rng):
    """The plain version summing per-rank int32 partials in rank order
    equals the unsplit one bit for bit, int8 and f32 outputs alike."""
    x = torch.from_numpy(_int8(rng, (2, 4, 4, 256)))
    w = torch.from_numpy(_int8(rng, (4, 4, 256, 24)))
    sc = torch.from_numpy((rng.rand(24) * 2e-5).astype(np.float32))
    b = torch.from_numpy((rng.randn(24) * 0.1).astype(np.float32))
    for act, out_scale in (("relu", 0.02), ("tanh", None)):
        xp, wpk, sp, bp, kw, _ = launch_args_int8(
            x, w, sc, b, 2, 1, 8, 8, 32, 8, 1, act, out_scale)
        wp = unpack_int8_weights(wpk)
        one = deconv2d_int8_launch_plain(xp, wp, sp, bp, **kw)
        parts = deconv2d_int8_launch_plain(xp, wp, sp, bp, split=split, **kw)
        assert torch.equal(parts, one)
    with pytest.raises(ValueError, match="split"):
        deconv2d_int8_launch_plain(xp, wp, sp, bp, split=9, **kw)


# -- tiles and guards ----------------------------------------------------------
@pytest.mark.parametrize("cfg", NETS, ids=["mnist", "celeba"])
def test_int8_tiles_are_taken_by_the_kernel(cfg):
    """Every layer of both nets at buckets 1 and 64, at the engine's packed
    widths: CI chunks of 32, 64 or 128 channels dividing the packed CIp,
    channel tiles dividing the packed COp, shared memory within a block's,
    the int32 guard holding, and the grid x split filling the 132 SMs
    wherever the chunks allow."""
    for g in cfg.geometries():
        for batch in (1, 64):
            t = hopper_tiles(g, batch, "int8")
            cip, cop = packed_ci_width(g.c_in), packed_width(g.c_out)
            assert t.t_ci % 32 == 0 and cip % t.t_ci == 0
            assert cop % t.t_co == 0
            blocks = grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n)
            split = ci_split(blocks, cip // t.t_ci)
            assert kernel_smem_bytes(g, t.t_oh, t.t_ow, t.t_ci, t.t_co, t.t_n,
                                     "tc", split, "int8") <= KERNEL_MAX_SMEM
            assert int8_acc_bound(g.kernel, g.stride, g.padding, cip) < 2 ** 31
            assert blocks * split >= SMS or \
                split == min(MAX_SPLIT, cip // t.t_ci)


def test_int8_smem_layout_counts_byte_rows():
    """The int8 kernel's shared memory: per ring stage the staged windows
    of t_n images and the valid taps' weight rows (`tc_columns` per tap,
    zero past t_co), every row t_ci + 16 bytes; as many stages (2..4) as
    100 KB holds; under a split at least the int32 partial tile."""
    from repro_torch.core.tiling import DeconvGeometry

    g = DeconvGeometry(8, 8, 512, 256, 4, 2, 1)
    # every 8x8 tile of the 16x16 output stages a 6x6 window and 4x4 taps
    assert staged_window(8, 16, 8, 4, 2, 1) == (6, 4)
    stage = 80 * (2 * 6 * 6 + 16 * 32)
    assert kernel_smem_bytes(g, 8, 8, 64, 32, 2, dtype="int8") == 2 * stage
    stage = 48 * (1 * 6 * 6 + 16 * 8)
    assert kernel_smem_bytes(g, 8, 8, 32, 8, 1, dtype="int8") == 4 * stage
    # a thin layer's 3 channels take one n8 tile of weight rows
    assert tc_columns(3) == 8 and int8_row_stride(128) == 144
    # a root at 64 images x 64 channels stages 64 pixels and one tap's 64
    # weight rows; under a split its 16 KB int32 partial tile fits the ring
    root = DeconvGeometry(1, 1, 100, 1024, 4, 1, 0)
    ring = 4 * 144 * (64 + 64)
    assert 4 * 64 * 64 < ring == kernel_smem_bytes(
        root, 1, 1, 128, 64, 64, split=2, dtype="int8")
    # at 256 output pixels x 128 channels the partial tile outgrows it
    assert kernel_smem_bytes(g, 16, 16, 32, 128, 4, split=2,
                             dtype="int8") == 4 * 4 * 4 * 64 * 128


def test_overflow_and_unpacked_weight_guards_raise(rng):
    """A layer whose taps x CIp x 127^2 reaches 2^31 is refused before any
    sum (K=7 at stride 1: 49 taps; 1024 channels: 8.1e8 fits, 4096: 3.2e9
    does not); a raw weight tensor is refused by the launch."""
    assert int8_acc_bound(7, 1, 0, 1024) < 2 ** 31 <= \
        int8_acc_bound(7, 1, 0, 4096)
    x = torch.zeros((1, 1, 1, 4096), dtype=torch.int8)
    w = torch.zeros((7, 7, 4096, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        deconv2d_int8(x, w, torch.ones(8), None, 1, 0, t_ci=128)
    x = torch.from_numpy(_int8(rng, (1, 4, 4, 32)))
    w = torch.from_numpy(_int8(rng, (4, 4, 32, 8)))
    xp, wpk, sp, bp, kw, _ = launch_args_int8(
        x, w, torch.ones(8), None, 2, 1, 8, 8, 32, 8, 1, "relu", 0.1)
    with pytest.raises(TypeError, match="PackedInt8Weights"):
        deconv2d_int8_launch(xp, unpack_int8_weights(wpk), sp, bp, **kw)
    assert isinstance(wpk, PackedInt8Weights)


def test_launch_split_of_int8_launches():
    """The launcher's split for int8 comes from the grid, as fp32's: CelebA
    layer 1 at bucket 1 splits its 1024 channels over a cluster of 8."""
    g = dcnn.CELEBA_DCNN.geometries()[1]
    t = hopper_tiles(g, 1, "int8")
    x = torch.zeros((1, g.in_h, g.in_w, g.c_in), dtype=torch.int8)
    pk = pack_int8_weights(torch.zeros((4, 4, g.c_in, g.c_out),
                                       dtype=torch.int8), 1024, 512)
    xp, wpk, _, _, kw, _ = launch_args_int8(
        x, pk, torch.ones(g.c_out), None, g.stride, g.padding,
        *t.as_kwargs().values(), "relu", 0.1)
    assert launch_split_int8(xp, wpk, kw) == 8


# -- the slice against the JAX package -------------------------------------------
@pytest.fixture(scope="module")
def mnist_q():
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(2), jdcnn.MNIST_DCNN)
    pn = jax.tree_util.tree_map(np.asarray, p)
    z = np.random.RandomState(7).randn(3, 100).astype(np.float32)
    jq = j_calibrate(p, jdcnn.MNIST_DCNN, jnp.asarray(z))
    jqp = j_quantize_params(p, jdcnn.MNIST_DCNN, jq)
    qcfg = QuantConfig.from_dict(dataclasses.asdict(jq))
    tp = dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN, "cpu")
    qp = quantize_params(tp, dcnn.MNIST_DCNN, qcfg)
    return jq, jqp, qcfg, qp, z


def test_int8_layers_through_packed_weights_match_reference(mnist_q):
    """Each MNIST layer through the packed path at its int8 tiles and
    bucket-1 split equals the JAX package's `deconv2d_int8_ref` on the same
    int8 input: int8 outputs bit for bit, the f32 tanh layer within 1e-6."""
    jq, jqp, qcfg, qp, z = mnist_q
    packed = pack_quantized_params(qp, dcnn.MNIST_DCNN)
    x = quantize_symmetric(torch.from_numpy(z).reshape(3, 1, 1, 100),
                           qcfg.layers[0].x_scale)
    for i, (g, l) in enumerate(zip(dcnn.MNIST_DCNN.geometries(),
                                   dcnn.MNIST_DCNN.layers)):
        lq = packed[f"l{i}"]
        t = hopper_tiles(g, 1, "int8")
        xp, wpk, sp, bp, kw, crop = launch_args_int8(
            x, lq["static"].w, lq["scale"], lq["b"], g.stride, g.padding,
            *t.as_kwargs().values(), l.activation, qcfg.out_scale(i))
        split = min(launch_split_int8(xp, wpk, kw), wpk.cip // t.t_ci)
        got = deconv2d_int8_launch_plain(xp, unpack_int8_weights(wpk), sp, bp,
                                         split=split, **kw)[crop]
        assert torch.equal(got, deconv2d_int8_launch(xp, wpk, sp, bp,
                                                     **kw)[crop])
        want = np.asarray(j_int8_ref(
            jnp.asarray(x.numpy()), jnp.asarray(jqp[f"l{i}"]["w_q"]),
            jnp.asarray(jqp[f"l{i}"]["scale"]), jnp.asarray(jqp[f"l{i}"]["b"]),
            g.stride, g.padding, activation=l.activation,
            out_scale=qcfg.out_scale(i)))
        if qcfg.out_scale(i) is None:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        else:
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
        x = got


def test_int8_chain_through_packed_weights_matches_reference(mnist_q):
    """The whole chain on the engine's packed tree equals the port's oracle
    chain bit for bit and the JAX package's `quantized_generator_ref`
    within 1e-6 (f32 tanh images; every int8 layer before them bit-equal,
    as the test above shows)."""
    jq, jqp, qcfg, qp, z = mnist_q
    packed = pack_quantized_params(qp, dcnn.MNIST_DCNN)
    assert all(isinstance(packed[f"l{i}"]["static"].w, PackedInt8Weights)
               for i in range(3))
    assert torch.equal(packed["l0"]["w_q"], qp["l0"]["w_q"])
    got = quantized_generator_apply(packed, dcnn.MNIST_DCNN, qcfg,
                                    torch.from_numpy(z))
    own = quantized_generator_ref(qp, dcnn.MNIST_DCNN, qcfg,
                                  torch.from_numpy(z))
    assert torch.equal(got, own)
    want = np.asarray(j_chain_ref(jqp, jdcnn.MNIST_DCNN, jq, jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_engine_packs_int8_weights_once():
    """The int8 engine holds every layer's weight packed at construction
    (the reference-layout ``w_q`` beside it); its dispatches reuse them."""
    from repro_torch.serve import DcnnServeEngine, EngineConfig

    params = dcnn.generator_init(torch.Generator().manual_seed(0),
                                 dcnn.MNIST_DCNN, "cpu")
    eng = DcnnServeEngine.from_config(
        EngineConfig(model="mnist", device="cpu", precision="int8",
                     max_batch=2), params)
    packs = {i: eng.params[f"l{i}"]["static"].w for i in range(3)}
    assert [(p.cip, p.cop) for p in packs.values()] == \
        [(128, 256), (256, 128), (128, 1)]
    eng.generate(np.zeros((3, 100), np.float32))
    assert all(eng.params[f"l{i}"]["static"].w is packs[i] for i in range(3))
    assert all(p.cip % max(INT8_T_CI) == 0 for p in packs.values())
