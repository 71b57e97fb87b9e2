"""The fp32 dense kernel's wgmma path (``csrc/deconv2d_tc.cu`` design step
9): its arithmetic and host side on the CPU, its launches on the card.

CPU: a numpy transcription of ``f32_wgmma_block`` (block -> tile, the
block's valid taps and per-phase tap lists, the input window and the
weight boxes of the CI-minor weights as their TMA tensor copies lay them
out in a 32- or 64-byte swizzle, the lo planes the producer writes,
the ldmatrix rows of each warp's 16 rows of A under the window's swizzle
in wgmma's register-A layout, A cut into hi and lo in registers, B read
through the
K-major descriptor (stride byte offset and swizzle decoded from its bits),
the three products per k8 step, the accumulator lanes, the fresh partial
per chunk, the split's rank-ordered sum) against the plain sums and
against the mma.sync path's 3xTF32 sums; the rule (`fp32_wgmma_tile`) on
both generators; the CI-minor pack and the split of each weight.

Card (marker ``cuda``; they skip without one): every layer of both
generators whose tiles take the path at buckets 1, 16, 32 and 64 against the
plain version, repeated launches bit for bit, `launch_info`'s path per
CelebA layer, and an engine's ``wgmma_launch_counts``.

Tolerances: the transcription and the mma.sync path's sums agree within
1e-12 (the same products in float64, summed in another order); both lie
within 1e-5 of the exact sums on unit-scale data (3xTF32 drops a_lo * b_lo
and the lo halves' 13 low bits: ~2^-21 of each product); the kernel within
1e-4 of its plain version on the card (the fp32 path's tolerance)."""
import numpy as np
import pytest
import torch

from repro_torch.core.deconv import phase_products
from repro_torch.core.tiling import (WG_ALIGN, WG_F32_STAGE_BUDGET,
                                     fp32_wgmma_tile, halo_tile,
                                     staged_window, tc_smem_layout)
from repro_torch.kernels.autotune import ci_split, grid_blocks, hopper_tiles
from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.kernels.deconv2d.kernel import (_tap_words,
                                                 deconv2d_launch_plain,
                                                 pack_ci_minor)
from repro_torch.kernels.deconv2d.ops import launch_args, takes_fp32_wgmma
from repro_torch.models import dcnn
from repro_torch.plan import build_network_plan

MAX_STRIDE, MAX_TAPS = 4, 8   # the tap table's layout (csrc kMaxStride, kMaxTaps)
NETS = {"mnist": dcnn.MNIST_DCNN, "celeba": dcnn.CELEBA_DCNN}
BUCKETS = (1, 16, 32, 64)


def _cut(v):
    """An f32 word with its 13 low bits cleared: what the tensor cores read
    of a TF32 operand, and the kernel's hi (split_tf32)."""
    v = np.asarray(v, np.float32)
    return (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    """split_tf32 and tf32_lo: hi = the cut, lo = v - hi in f32 (exact)."""
    v = np.asarray(v, np.float32)
    hi = _cut(v)
    return hi, (v - hi).astype(np.float32)


def _popc(v):
    return bin(v).count("1")


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


def _swizzle(addr, rowbytes):
    """The byte address ``addr`` under the 32- or 64-byte swizzle of a TMA
    box and of the descriptor's layout: bits 4.. XORed with bits 7.. (1 or
    2 bits)."""
    bits = {32: 1, 64: 2}[rowbytes]
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def _tma_box(smem, base, rows, rowbytes):
    """A TMA tensor copy of ``rows`` (t_ci words each: a weight box's
    output channels, or the input window's pixels) into ``smem`` (words,
    byte address / 4) at byte ``base``: row r's bytes at base + r *
    rowbytes, 16-byte pieces placed by the swizzle."""
    r, c = np.meshgrid(np.arange(rows.shape[0]), np.arange(rows.shape[1]),
                       indexing="ij")
    smem[_swizzle(base + r * rowbytes + 4 * c, rowbytes) // 4] = rows


def _wg_desc_k(addr, rowbytes):
    """The kernel's ``wg_desc_k``: start address >> 4 in bits 0..13, the
    leading byte offset (1, unused) in 16..29, the stride byte offset >> 4
    in 32..45, the layout (2: 64-byte swizzle, 3: 32) in 62..63."""
    layout = {64: 2, 32: 3}[rowbytes]
    return (((addr & 0x3FFFF) >> 4) | (1 << 16)
            | (((8 * rowbytes) >> 4) << 32) | (layout << 62))


def _wg_b(smem, desc, n):
    """B (8 x n) of one m64nNk8 TF32 wgmma as the hardware reads it through
    a K-major descriptor: output channel c's 8 words at start + (c % 8) *
    W + (c // 8) * SBO (W the swizzle's bytes, a row of the atom), then the
    swizzle of the address."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    w_ = {2: 64, 3: 32}[desc >> 62]
    k, c = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    addr = start + (c % 8) * w_ + (c // 8) * sbo + 4 * k
    return smem[_swizzle(addr, w_) // 4]


def _ldsm_words(buf, addrs):
    """``ldmatrix.sync.aligned.m8n8.x4.shared.b16`` on a buffer of 4-byte
    words: matrix m's eight 16-byte rows (4 words) start at the word
    addresses of lanes 8m..8m+7; lane l receives word l % 4 of row l / 4
    (two b16 halves) of each.  Returns 4 registers of (32,) words."""
    lane = np.arange(32)
    regs = []
    for m in range(4):
        rows = addrs[8 * m:8 * m + 8]
        assert all(4 * a % 16 == 0 for a in rows), "ldmatrix rows not 16-byte aligned"
        mat = np.stack([buf[a:a + 4] for a in rows])
        regs.append(mat[lane // 4, lane % 4])
    return regs


def _wgmma_a(regs):
    """A (64 x 8) of one m64nNk8 TF32 wgmma from registers: warp w gives
    rows 16w .. 16w + 15 in mma.sync m16n8k8's tf32 A layout (a0: row g,
    k t; a1: row g + 8, k t; a2: row g, k t + 4; a3: row g + 8, k t + 4;
    g = lane / 4, t = lane % 4)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((64, 8), np.float32)
    for w_, a in enumerate(regs):
        A[16 * w_ + g, t] = a[0]
        A[16 * w_ + g + 8, t] = a[1]
        A[16 * w_ + g, t + 4] = a[2]
        A[16 * w_ + g + 8, t + 4] = a[3]
    return A


def _wg_lanes(D):
    """The accumulator registers of D (64 x N): per warp w, per lane, d[4j
    + c] = D[16w + lane/4 + 8 (c / 2), 8j + 2 (lane % 4) + c % 2]."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    n = D.shape[1]
    return [np.stack([D[16 * w_ + gid + 8 * (c // 2), 8 * j + 2 * tig + c % 2]
                      for j in range(n // 8) for c in range(4)], 1)
            for w_ in range(4)]


def _three(ah, al, bh, bl):
    """a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, each operand as the tensor cores
    read it (cut), in float64 (exact products)."""
    f = lambda v: _cut(v).astype(np.float64)  # noqa: E731
    return f(al) @ f(bh) + f(ah) @ f(bl) + f(ah) @ f(bh)


def wgmma_sums(x, wt, bias, plan, dims, tiles, split):
    """The f32 sums (bias included) of the fp32 wgmma path, by a
    transcription of ``f32_wgmma_block`` on the CI-minor weights ``wt``
    (K, K, COp, CIp)."""
    n, ihp, iwp, cip, ih, iw, ohp, owp, cop = dims
    t_oh, t_ow, t_ci, t_co, t_n = tiles
    k, s = plan.kernel_size, plan.stride
    words = _tap_words(plan)
    th, tw = t_oh // s, t_ow // s
    consumers, wm, nn_ = fp32_wgmma_tile(s, t_oh, t_ow, t_co, t_n, k, t_ci)
    ngroups, mgroups = t_co // nn_, t_n * th * tw // 64
    rowbytes = 4 * t_ci
    box_bytes = rowbytes * nn_
    base_h = halo_tile(t_oh, k, s, plan.padding).base
    base_w = halo_tile(t_ow, k, s, plan.padding).base
    win_h, slots_h = staged_window(ih, ohp, t_oh, k, s, plan.padding)
    win_w, slots_w = staged_window(iw, owp, t_ow, k, s, plan.padding)
    x_region = -(-t_n * win_h * win_w * rowbytes // WG_ALIGN) * WG_ALIGN
    lo_off = slots_h * slots_w * ngroups * box_bytes
    tiles_h, tiles_w, tiles_co = ohp // t_oh, owp // t_ow, cop // t_co
    n_ci = cip // t_ci
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    lrow = (lane & 7) + ((lane >> 3) & 1) * 8
    y = np.zeros((n, ohp, owp, cop))
    for by in range(n // t_n):
        for bx in range(tiles_h * tiles_w * tiles_co * split):
            rank, tile = bx % split, bx // split
            co_t, tile = tile % tiles_co, tile // tiles_co
            ow_t, oh_t = tile % tiles_w, tile // tiles_w
            n0, co0 = by * t_n, co_t * t_co
            h0, w0 = oh_t * th + base_h, ow_t * tw + base_w
            tap_ok, kok, span, real, wtap = _block_taps(
                words, s, k, (h0, w0), (th, tw), plan.left_halo, (ih, iw))
            (lo_h, _), (lo_w, _) = span
            nw = _popc(kok[1])
            lists = []
            for phase in range(s * s):
                ph, pw = divmod(phase, s)
                taps = []
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
                        dw = words[MAX_STRIDE + MAX_STRIDE * MAX_TAPS
                                   + pw * MAX_TAPS + bb]
                        taps.append(((dh - lo_h) * win_w + (dw - lo_w),
                                     sh * nw + _popc(kok[1] & ((1 << kw) - 1))))
                lists.append(taps)
            it0 = rank * n_ci // split
            n_it = (rank + 1) * n_ci // split - it0
            acc = {}
            for it in range(n_it):
                c0 = (it0 + it) * t_ci
                # the stage: the window as one 4-D TMA box from the span's
                # first row and column (past the padded input: zeros), the
                # weight boxes, then the producer's lo planes
                smem = np.zeros((x_region + 2 * lo_off) // 4, np.float32)
                win = np.zeros((t_n, win_h, win_w, t_ci), np.float32)
                part_x = x[n0:n0 + t_n, h0 + lo_h:h0 + lo_h + win_h,
                           w0 + lo_w:w0 + lo_w + win_w, c0:c0 + t_ci]
                win[:, :part_x.shape[1], :part_x.shape[2]] = part_x
                _tma_box(smem, 0, win.reshape(-1, t_ci), rowbytes)
                for slot, t in enumerate(wtap):
                    for ng in range(ngroups):
                        col = co0 + ng * nn_
                        _tma_box(smem, x_region + (slot * ngroups + ng)
                                 * box_bytes, wt[t // k, t % k,
                                                 col:col + nn_, c0:c0 + t_ci],
                                 rowbytes)
                boxes = slice(x_region // 4, (x_region + len(wtap) * ngroups
                                              * box_bytes) // 4)
                hi = smem[boxes]
                smem[x_region // 4 + lo_off // 4:][:hi.size] = _split(hi)[1]
                for cw in range(consumers):
                    for i in range(wm):
                        ti = cw * wm + i
                        ng, r = ti % ngroups, ti // ngroups
                        mg, phase = r % mgroups, r // mgroups
                        part = None
                        for xoff, slot in lists[phase]:
                            for kk in range(t_ci // 8):
                                regs = []
                                for w_ in range(4):
                                    row = mg * 64 + w_ * 16 + lrow
                                    nn, rr, cc = (row // (th * tw),
                                                  (row // tw) % th, row % tw)
                                    apix = (nn * win_h + rr) * win_w + cc
                                    byte = ((apix + xoff) * rowbytes
                                            + 16 * (lane >> 4) + 32 * kk)
                                    regs.append(_ldsm_words(
                                        smem, _swizzle(byte, rowbytes) // 4))
                                a_hi, a_lo = _split(_wgmma_a(regs))
                                wt_ = (x_region + (slot * ngroups + ng)
                                       * box_bytes + 32 * kk)
                                b_hi = _wg_b(smem, _wg_desc_k(wt_, rowbytes),
                                             nn_)
                                b_lo = _wg_b(smem, _wg_desc_k(wt_ + lo_off,
                                                              rowbytes), nn_)
                                d = _three(a_hi, a_lo, b_hi, b_lo)
                                part = d if part is None else part + d
                        if part is not None:
                            acc[ti] = acc.get(ti, 0) + part
            for ti, D in acc.items():
                ng, r = ti % ngroups, ti // ngroups
                mg, phase = r % mgroups, r // mgroups
                ph, pw = divmod(phase, s)
                for w_, d in enumerate(_wg_lanes(D)):
                    for hf in range(2):
                        row = mg * 64 + w_ * 16 + gid + 8 * hf
                        nn, rr, cc = row // (th * tw), (row // tw) % th, \
                            row % tw
                        for j in range(nn_ // 8):
                            for c in range(2):
                                y[n0 + nn, oh_t * t_oh + rr * s + ph,
                                  ow_t * t_ow + cc * s + pw,
                                  co0 + ng * nn_ + 8 * j + 2 * tig + c] += \
                                    d[:, 4 * j + 2 * hf + c]
    return y + bias


def mma_sync_sums(x, w, bias, plan, ohp, owp, t_ci, split):
    """The mma.sync path's 3xTF32 sums, by output element: per CI chunk of
    each rank's range a fresh partial over the phase's taps in tap-table
    order and t_ci / 8 k8 steps of a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the
    operands cut as split_tf32 cuts them), added to the sums; the ranks'
    partials added in rank order, then the bias."""
    s = plan.stride
    n_ci = x.shape[3] // t_ci
    y = np.zeros((x.shape[0], ohp, owp, w.shape[3]))
    for r in range(split):
        acc = 0.0
        for it in range(r * n_ci // split, (r + 1) * n_ci // split):
            part = 0.0
            c0 = it * t_ci
            for kk in range(t_ci // 8):
                sl = slice(c0 + 8 * kk, c0 + 8 * kk + 8)
                xh, xl = _split(x[..., sl])
                wh, wl = _split(w[:, :, sl])
                f = lambda v: torch.from_numpy(  # noqa: E731
                    _cut(v).astype(np.float64))
                part = part + sum(
                    phase_products(f(a), f(b), plan, ohp // s, owp // s,
                                   torch.zeros(w.shape[3], dtype=torch.float64),
                                   torch.float64).numpy()
                    for a, b in ((xl, wh), (xh, wl), (xh, wh)))
            acc = acc + part
        y = y + acc
    return y + bias


def _case(rng, n, ih, ci, co, k, s, p, t, t_ci, t_co, t_n):
    """Unit-scale f32 data padded as the launcher pads it."""
    x = torch.from_numpy(rng.randn(n, ih, ih, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, k, ci, co) / np.sqrt(ci * k)).astype(
        np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    return launch_args(x, w, b, s, p, t, t, t_ci, t_co, t_n, None)


# (n, ih, ci, co, k, s, p, t, t_ci, t_co, t_n, split): two consumer
# warpgroups of two m64 tiles of 64 channels (t_ci 8, the 32-byte swizzle)
# at splits 1 and 2, four 4x4 phase tiles of one image each, a ragged
# input whose edge blocks drop taps, a 3x3 kernel (phases of 1 and 2 taps
# a dim), and a stride-1 2x2 kernel whose one phase is two tiles of 64
# channels, one a warpgroup (t_ci 16: two k8 steps, the 64-byte swizzle)
WG_CASES = [
    (1, 8, 32, 64, 4, 2, 1, 16, 8, 64, 1, 1),
    (1, 8, 32, 64, 4, 2, 1, 16, 8, 64, 1, 2),
    (4, 4, 32, 64, 4, 2, 1, 8, 8, 64, 4, 2),
    (1, 6, 16, 64, 4, 2, 1, 16, 8, 64, 1, 1),
    (1, 8, 64, 64, 3, 2, 1, 16, 8, 64, 1, 2),
    (1, 8, 32, 128, 2, 1, 0, 8, 16, 128, 1, 2),
]


@pytest.mark.parametrize("case", WG_CASES, ids=str)
def test_transcribed_wgmma_path_equals_plain_sums(case, rng):
    """The wgmma path's transcription (through the CI-minor pack, the TMA
    boxes' swizzle and the K-major descriptor) equals the mma.sync path's
    3xTF32 sums within 1e-12 and the exact sums within 1e-5, at splits 1
    and 2 (the path takes no wider split)."""
    n, ih, ci, co, k, s, p, t, t_ci, t_co, t_n, split = case
    xp, wp, bp, kw, _ = _case(rng, n, ih, ci, co, k, s, p, t, t_ci, t_co, t_n)
    plan = kw["plan"]
    assert fp32_wgmma_tile(s, t, t, t_co, t_n, k, t_ci, split) is not None
    assert split <= xp.shape[3] // t_ci
    x, w, bias = xp.numpy(), wp.numpy(), bp.numpy().reshape(-1)
    wt = pack_ci_minor(wp).numpy()
    got = wgmma_sums(x, wt, bias, plan,
                     (*xp.shape, kw["ih"], kw["iw"], kw["ohp"], kw["owp"],
                      wp.shape[3]), (t, t, t_ci, t_co, t_n), split)
    mma = mma_sync_sums(x, w, bias, plan, kw["ohp"], kw["owp"], t_ci, split)
    exact = phase_products(xp.double(), wp.double(), plan, kw["ohp"] // s,
                           kw["owp"] // s, bp.double().reshape(-1),
                           torch.float64).numpy()
    np.testing.assert_allclose(got, mma, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    assert np.abs(got - exact).max() > 0   # the split's rounding is there
    plain = deconv2d_launch_plain(xp, wp, bp, split=split, **kw).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)


def test_ci_minor_pack_and_the_split_of_each_weight(rng):
    """`pack_ci_minor` is the exact transpose (K, K, CIp, COp) -> (K, K,
    COp, CIp), contiguous and 16-byte aligned; the kernel's split of a
    weight, hi = its cut and lo = w - hi (the producer's lo plane), has hi
    + lo == w exactly and hi's 13 low bits zero."""
    w = torch.from_numpy(rng.randn(4, 4, 24, 40).astype(np.float32))
    wt = pack_ci_minor(w)
    assert wt.shape == (4, 4, 40, 24) and wt.is_contiguous()
    assert wt.data_ptr() % 16 == 0
    assert torch.equal(wt, w.permute(0, 1, 3, 2))
    v = wt.numpy()
    hi, lo = _split(v)
    assert np.array_equal(hi + lo, v)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(_cut(hi), hi)
    assert (lo != 0).any() and np.all(np.abs(lo) <= np.abs(v) * 2.0 ** -10)


# the rule on both generators, at the model's tiles: which layers take the
# wgmma path per bucket (layer indices)
WGMMA_LAYERS = {
    ("mnist", 1): (), ("mnist", 16): (), ("mnist", 64): (),
    ("celeba", 1): (), ("celeba", 16): (), ("celeba", 32): (3,),
    ("celeba", 64): (1, 2, 3),
}


def _launch_split(g, batch, t):
    """The cluster split of a launch at tiles ``t`` (`autotune.ci_split`)."""
    return ci_split(grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n),
                    -(-g.c_in // t.t_ci))


@pytest.mark.parametrize("net,batch", sorted(WGMMA_LAYERS), ids=str)
def test_rule_table_on_both_generators(net, batch):
    """`fp32_wgmma_tile` at the model's tiles and their cluster split:
    CelebA's wide stride-2 layers at bucket 64 and its 256->128 layer at
    32; never a 1x1 root (one-pixel phase tiles), a thin layer (C_out 1 or
    3), a 32-channel tile (MNIST's wide layer), a split of 4 or 8 (the
    small buckets' tiles) or a zero-skip launch; the plan's layers agree
    (`takes_fp32_wgmma`), and the shared memory of each taking layer is
    the path's layout within its ring."""
    cfg = NETS[net]
    plan = build_network_plan(cfg, batch=batch, autotune=False)
    got = []
    for i, (g, l) in enumerate(zip(cfg.geometries(), plan.layers)):
        t = hopper_tiles(g, batch)
        assert l.tiles == t
        split = _launch_split(g, batch, t)
        wg = fp32_wgmma_tile(g.stride, t.t_oh, t.t_ow, t.t_co, t.t_n,
                             g.kernel, t.t_ci, split)
        assert (wg is not None) == takes_fp32_wgmma(l)
        assert fp32_wgmma_tile(g.stride, t.t_oh, t.t_ow, t.t_co, t.t_n,
                               g.kernel, t.t_ci, split, sparse=True) is None
        if wg is not None:
            got.append(i)
            ohp = -(-g.out_h // t.t_oh) * t.t_oh
            owp = -(-g.out_w // t.t_ow) * t.t_ow
            stages, smem = tc_smem_layout(g.in_h, g.in_w, g.kernel, g.stride,
                                          g.padding, ohp, owp, t.t_oh, t.t_ow,
                                          t.t_ci, t.t_co, t.t_n, split)
            assert stages >= 2 and smem <= WG_F32_STAGE_BUDGET + WG_ALIGN
    assert tuple(got) == WGMMA_LAYERS[net, batch]


def test_rule_by_hand():
    """By hand: CelebA layer 2's 16x16 tile at t_co 64 takes the path at
    t_ci 8 (two warpgroups of two m64 tiles of 64 channels) and not at 16
    (2 x (10 x 10 pixels of 16 words + 16 taps x 64 x 16 x 2 words) > the
    ring); a stride-1 phase of 64 pixels by 128 channels is two tiles of
    64, one a warpgroup, and takes t_ci 16; 32-channel tiles, one-pixel
    phase tiles, t_ci 24 or 32, 128-pixel phase tiles at N 64 and a split
    of 4 do not."""
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 4, 8) == (2, 2, 64)
    x16 = -(-4 * 10 * 10 * 16 // 1024) * 1024
    assert 2 * (x16 + 8 * 16 * 64 * 16) > WG_F32_STAGE_BUDGET
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 4, 16) is None
    assert fp32_wgmma_tile(2, 16, 16, 32, 1, 4, 16) is None    # N 32
    assert fp32_wgmma_tile(2, 2, 2, 64, 64, 4, 8) is None     # 1-pixel phases
    assert fp32_wgmma_tile(1, 1, 1, 64, 64, 4, 8) is None     # a 1x1 root
    assert fp32_wgmma_tile(1, 8, 8, 128, 1, 2, 16) == (2, 1, 64)
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 4, 24) is None
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 3, 32) is None   # 128-byte rows
    assert fp32_wgmma_tile(2, 16, 16, 16, 1, 4, 8) is None
    assert fp32_wgmma_tile(2, 16, 16, 64, 2, 4, 8) is None    # four m64 tiles
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 4, 8, 2) == (2, 2, 64)
    assert fp32_wgmma_tile(2, 16, 16, 64, 1, 4, 8, 4) is None  # 4-way split


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _layers_on_the_path():
    """(net, layer, bucket) of every generator layer whose model tiles take
    the path at buckets 1, 16, 32 and 64."""
    out = []
    for net, cfg in NETS.items():
        for batch in BUCKETS:
            for i, g in enumerate(cfg.geometries()):
                t = hopper_tiles(g, batch)
                if fp32_wgmma_tile(g.stride, t.t_oh, t.t_ow, t.t_co,
                                   min(t.t_n, batch), g.kernel, t.t_ci,
                                   _launch_split(g, batch, t)) is not None:
                    out.append((net, i, batch))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("net,layer,batch", _layers_on_the_path(), ids=str)
def test_wgmma_layers_match_the_plain_version(card, net, layer, batch):
    """Each layer on the path against the plain version within 1e-4 (its
    error printed), and two launches on the same inputs bit for bit."""
    cfg = NETS[net]
    g, l = cfg.geometries()[layer], cfg.layers[layer]
    t = hopper_tiles(g, batch)
    gen = torch.Generator(device=card).manual_seed(layer)
    x = torch.randn((batch, g.in_h, g.in_w, g.c_in), generator=gen,
                    device=card)
    w = torch.randn((g.kernel, g.kernel, g.c_in, g.c_out), generator=gen,
                    device=card) / (g.c_in * g.kernel ** 2) ** 0.5
    b = 0.1 * torch.randn((g.c_out,), generator=gen, device=card)
    xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding,
                                    *t.as_kwargs().values(), l.activation)
    params = deconv_kernel.launch_params(xp, wp, [("b", bp, xp.dtype)], **kw)
    assert deconv_kernel.launch_info(params)["path"] == "wgmma"
    wt = pack_ci_minor(wp)
    before = deconv_kernel.WGMMA_LAUNCHES
    y0 = deconv_kernel.deconv2d_launch(xp, wp, bp, wt=wt, **kw)
    y1 = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)   # packed per call
    torch.cuda.synchronize()
    assert deconv_kernel.WGMMA_LAUNCHES == before + 2
    split = deconv_kernel.launch_split(xp.shape[0], xp.shape[3], wp.shape[3],
                                       kw["ohp"], kw["owp"], t.t_oh, t.t_ow,
                                       t.t_ci, t.t_co, kw["t_n"])
    want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split, **kw)
    err = float((y0 - want).abs().max())
    print(f"{net} l{layer} bucket {batch} {t.as_kwargs()} split {split}: "
          f"max_abs_err {err:.3e}")
    torch.testing.assert_close(y0, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(y0, y1)


@pytest.mark.cuda
def test_launch_info_names_the_path_per_celeba_layer(card):
    """At bucket 64: CelebA layers 1-3 (1024->512, 512->256, 256->128) on
    wgmma; the 1x1 root and the tanh layer on mma.sync."""
    cfg = dcnn.CELEBA_DCNN
    paths = []
    for g, l in zip(cfg.geometries(), cfg.layers):
        t = hopper_tiles(g, 64)
        x = torch.zeros((64, g.in_h, g.in_w, g.c_in), device=card)
        w = torch.zeros((g.kernel, g.kernel, g.c_in, g.c_out), device=card)
        xp, wp, bp, kw, _ = launch_args(x, w, None, g.stride, g.padding,
                                        *t.as_kwargs().values(), l.activation)
        paths.append(deconv_kernel.launch_info(deconv_kernel.launch_params(
            xp, wp, [("b", bp, xp.dtype)], **kw))["path"])
    assert paths == ["mma.sync", "wgmma", "wgmma", "wgmma", "mma.sync"]


@pytest.mark.cuda
@pytest.mark.parametrize("net,wide", [("celeba", 3), ("mnist", 0)])
def test_engine_counts_its_wgmma_launches(card, net, wide):
    """An engine at bucket 64: ``wgmma_launch_counts`` = the layers on the
    path x replays (CelebA's three wide layers; none of MNIST's, whose
    32-channel tiles keep mma.sync), beside ``launch_counts`` = all layers
    x replays, and its images within 1e-4 of the plain chain."""
    from repro_torch.serve import DcnnServeEngine, EngineConfig

    cfg = NETS[net]
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=cfg, buckets=(64,), warmup=True), params)
    eng.launch_counts.clear()
    eng.wgmma_launch_counts.clear()
    z = np.random.RandomState(1).randn(64, cfg.z_dim).astype(np.float32)
    replays = 3
    for _ in range(replays):
        y = eng.generate(z)
    assert eng.wgmma_launch_counts.get(64, 0) == wide * replays
    assert eng.launch_counts == {64: len(cfg.layers) * replays}
    want = dcnn.generator_apply(eng.params, cfg, torch.from_numpy(z).to(card),
                                backend="reverse_loop").cpu().numpy()
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
