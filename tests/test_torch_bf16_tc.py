"""The bf16 tensor-core kernels' arithmetic and host side, on the CPU.

The kernels (``csrc/deconv2d_tc.cu``, ``deconv2d_tc_bf16_kernel`` behind
``deconv2d_tc_forward`` and ``deconv2d_tc_sparse_forward``) run only on
the card; what they rely on is checked here: numpy transcriptions of the
dense kernel's index arithmetic on both of its paths against the plain
sums.  The wgmma path (`core.tiling.bf16_wgmma_tile`): block -> tile, the
block's valid taps and its per-phase tap lists, the staged window in rows
of t_ci + 8 elements, the weight boxes as the TMA tensor copy lays them
out (64- or 128-byte swizzle), the consumer warpgroups' m64 tiles, the
ldmatrix rows of each warp's 16 rows of A in wgmma's register-A layout,
B read through the shared-memory descriptor (MN-major, the stride byte
offset and the swizzle decoded from the descriptor's bits), the
accumulator lanes, the fresh partial per chunk, the split's rank-ordered
sum.  The mma.sync path (small and thin tiles): the same block, the
weight rows at the fp32 kernel's stride, ldmatrix and ldmatrix.trans,
the m16n8k16 fragment lanes.  Then the shared-memory layout against a
hand count (the TMA boxes included), the tiles the model picks, and the
plain versions of B1 and B3 under a cluster split against the JAX
package's bf16 reference.

Tolerances: the transcription runs on small integers (exact in bf16, their
products and sums exact in float64), so it equals the plain sums bit for
bit; the plain versions in bf16 are held within 8e-2 of the JAX package's
``deconv2d_ref`` in bf16, the bf16 tolerance of the kernel checks (both
round the output to bf16, about three significant digits, from
differently ordered f32 sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.deconv2d import deconv2d_ref as j_ref
from repro_torch.core.deconv import phase_products
from repro_torch.core.tiling import (KERNEL_MAX_SMEM, KERNEL_MAX_THREADS,
                                     WG_ALIGN, DeconvGeometry,
                                     bf16_row_stride, bf16_wgmma_tile,
                                     block_threads, halo_tile,
                                     kernel_smem_bytes, staged_window,
                                     tc_columns, tc_smem_layout,
                                     tc_warp_tile, tc_weight_stride)
from repro_torch.kernels.autotune import (BF16_T_CI, MAX_SPLIT, SMS,
                                          ci_split, grid_blocks, hopper_tiles)
from repro_torch.kernels.deconv2d.kernel import (_tap_words,
                                                 deconv2d_launch_plain)
from repro_torch.kernels.deconv2d.ops import launch_args
from repro_torch.kernels.deconv2d_sparse import (
    deconv2d_sparse_launch_plain, make_sparse_plan, schedule_tensors)
from repro_torch.models import dcnn
from test_torch_int8_tc import MAX_STRIDE, MAX_TAPS, _block_taps, _popc

BF16_TOL = 8e-2
NETS = [dcnn.MNIST_DCNN, dcnn.CELEBA_DCNN]


def _ints(rng, shape, lo=-6, hi=7):
    """Small integers as bf16 (exact), so every sum below is exact."""
    return torch.from_numpy(rng.randint(lo, hi, size=shape)
                            .astype(np.float32)).to(torch.bfloat16)


def _ldsm(buf, addrs, n, trans, groups=None):
    """``ldmatrix.sync.aligned.m8n8.x{n}[.trans].shared.b16`` on a numpy
    buffer of 2-byte elements: matrix m's eight 16-byte rows start at the
    element addresses of lanes 8m..8m+7.  Returns n registers, each (32,
    2): the low and high halves each lane receives, (l/4, 2*(l%4) + h) of
    the matrix as stored, or (2*(l%4) + h, l/4) with ``trans``.
    ``groups`` (a list) collects the distinct 16-byte bank groups (of 8)
    that each matrix's rows fall in."""
    lane = np.arange(32)
    regs = []
    for m in range(n):
        rows = addrs[8 * m:8 * m + 8]
        assert all(2 * a % 16 == 0 for a in rows), "ldmatrix rows not 16-byte aligned"
        mat = np.stack([buf[a:a + 8] for a in rows])
        if groups is not None:
            groups.append(len({(2 * a // 16) % 8 for a in rows}))
        if trans:
            regs.append(np.stack([mat[2 * (lane % 4) + h, lane // 4]
                                  for h in range(2)], 1))
        else:
            regs.append(np.stack([mat[lane // 4, 2 * (lane % 4) + h]
                                  for h in range(2)], 1))
    return regs


def _mma_m16n8k16(a, b):
    """mma.sync m16n8k16 bf16.bf16.f32 on per-lane fragments, by the PTX
    fragment layout: A row gid (a0, a2) / gid + 8 (a1, a3), k 2*tig + h
    (a0, a1) / 8 + 2*tig + h (a2, a3); B column gid, k 2*tig + h (b0) / 8 +
    2*tig + h (b1); D rows gid (d0, d1) / gid + 8 (d2, d3), columns 2*tig +
    c % 2."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for h in range(2):
        A[gid, 2 * tig + h] = a[0][:, h]
        A[gid + 8, 2 * tig + h] = a[1][:, h]
        A[gid, 8 + 2 * tig + h] = a[2][:, h]
        A[gid + 8, 8 + 2 * tig + h] = a[3][:, h]
        B[2 * tig + h, gid] = b[0][:, h]
        B[8 + 2 * tig + h, gid] = b[1][:, h]
    D = A @ B
    return np.stack([D[gid, 2 * tig], D[gid, 2 * tig + 1],
                     D[gid + 8, 2 * tig], D[gid + 8, 2 * tig + 1]], 1)


def _swizzle(addr, rowbytes):
    """The byte address ``addr`` in shared memory under the 64- or 128-byte
    swizzle of a TMA box (and of the wgmma descriptor's layout): bits 4..
    of the address XORed with bits 7.. (3 bits at 128, 2 at 64)."""
    bits = 3 if rowbytes == 128 else 2
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def _tma_box(smem, base, rows, rowbytes):
    """A 2-D TMA tensor copy of ``rows`` (t_ci, N) into ``smem`` (2-byte
    elements, byte address / 2) at byte ``base`` (a swizzle atom's
    multiple): row r's bytes at base + r * rowbytes, 16-byte pieces placed
    by the swizzle."""
    r, c = np.meshgrid(np.arange(rows.shape[0]), np.arange(rows.shape[1]),
                       indexing="ij")
    smem[_swizzle(base + r * rowbytes + 2 * c, rowbytes) // 2] = rows


def _wg_desc(addr, rowbytes):
    """The kernel's ``wg_desc``: start address >> 4 in bits 0..13, the
    leading byte offset (1, unused) in 16..29, the stride byte offset >> 4
    in 32..45, the layout (1: 128-byte swizzle, 2: 64-byte) in 62..63."""
    layout = 1 if rowbytes == 128 else 2
    return (((addr & 0x3FFFF) >> 4) | (1 << 16)
            | (((8 * rowbytes) >> 4) << 32) | (layout << 62))


def _wg_b(smem, desc, n):
    """B (16 x n) of one m64nNk16 wgmma as the hardware reads it through
    the descriptor: the MN-major canonical layout ((T, W, m), (8, k)) :
    ((1, T, LBO), (W*T, SBO)) in elements (T = 8 a 16-byte piece, W = 8 at
    the 128-byte swizzle, 4 at 64), then the swizzle of the address."""
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    w_ = {1: 8, 2: 4}[desc >> 62]
    k, c = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    addr = (start + 2 * (c % 8 + 8 * ((c // 8) % w_)) + (c // (8 * w_)) * lbo
            + (k % 8) * 2 * 8 * w_ + (k // 8) * sbo)
    return smem[_swizzle(addr, 16 * w_) // 2]


def _wgmma_a(regs):
    """A (64 x 16) of one m64nNk16 wgmma from registers: warp w of the
    warpgroup gives rows 16w .. 16w + 15 in the layout of mma.sync
    m16n8k16's A (``regs[w]``: its four ldmatrix x4 registers)."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    A = np.zeros((64, 16))
    for w_, a in enumerate(regs):
        for h in range(2):
            A[16 * w_ + gid, 2 * tig + h] = a[0][:, h]
            A[16 * w_ + gid + 8, 2 * tig + h] = a[1][:, h]
            A[16 * w_ + gid, 8 + 2 * tig + h] = a[2][:, h]
            A[16 * w_ + gid + 8, 8 + 2 * tig + h] = a[3][:, h]
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


def wgmma_sums(x, w, bias, plan, words, dims, tiles, split):
    """The f32 sums (bias included) of the dense kernel's wgmma path, by a
    transcription of ``bf16_wgmma_block``: per block the tap lists, the
    stages as the producer fills them (bulk-copied window rows, TMA weight
    boxes), per consumer warpgroup and m64 tile the tap groups of k16
    wgmmas (the first of a chunk overwriting the fresh partial), the
    partial added per chunk, the accumulator lanes stored (split 1) or
    summed over the ranks in order, then the bias."""
    n, ihp, iwp, cip, ih, iw, ohp, owp, cop = dims
    t_oh, t_ow, t_ci, t_co, t_n = tiles
    k, s = plan.kernel_size, plan.stride
    th, tw = t_oh // s, t_ow // s
    pix = t_n * th * tw
    consumers, wm, nn_ = bf16_wgmma_tile(s, pix, t_co, k, t_ci)
    ngroups, mgroups = t_co // nn_, pix // 64
    rowbytes, box_bytes = 2 * nn_, t_ci * nn_ * 2
    base_h = halo_tile(t_oh, k, s, plan.padding).base
    base_w = halo_tile(t_ow, k, s, plan.padding).base
    cs = bf16_row_stride(t_ci)
    win_h, _ = staged_window(ih, ohp, t_oh, k, s, plan.padding)
    win_w, _ = staged_window(iw, owp, t_ow, k, s, plan.padding)
    atom = WG_ALIGN // 2
    x_region = 2 * (-(-t_n * win_h * win_w * cs // atom) * atom)
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
            (lo_h, hi_h), (lo_w, hi_w) = span
            nw = _popc(kok[1])
            # the per-phase tap lists: window offset, (weight slot, tap)
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
                        taps.append((((dh - lo_h) * win_w + (dw - lo_w)) * cs,
                                     sh * nw + _popc(kok[1] & ((1 << kw) - 1))))
                lists.append(taps)
            it0 = rank * n_ci // split
            n_it = (rank + 1) * n_ci // split - it0
            acc = {}
            for it in range(n_it):
                c0 = (it0 + it) * t_ci
                xs = np.zeros(t_n * win_h * win_w * cs)
                for nn in range(t_n):
                    for lr in range(real[0][0], real[0][1]):
                        for lc in range(real[1][0], real[1][1]):
                            d = ((nn * win_h + lr) * win_w + lc) * cs
                            xs[d:d + t_ci] = x[n0 + nn, h0 + lo_h + lr,
                                               w0 + lo_w + lc, c0:c0 + t_ci]
                smem = np.zeros((x_region + len(wtap) * ngroups
                                 * box_bytes) // 2)
                for slot, t in enumerate(wtap):
                    for ng in range(ngroups):
                        col = co0 + ng * nn_
                        _tma_box(smem, x_region + (slot * ngroups + ng)
                                 * box_bytes, w[t // k, t % k, c0:c0 + t_ci,
                                                col:col + nn_], rowbytes)
                for cw in range(consumers):
                    for i in range(wm):
                        ti = cw * wm + i
                        ng, r = ti % ngroups, ti // ngroups
                        mg, phase = r % mgroups, r // mgroups
                        part = None
                        for xoff, slot in lists[phase]:
                            for kk in range(t_ci // 16):
                                regs = []
                                for w_ in range(4):
                                    row = mg * 64 + w_ * 16 + lrow
                                    nn, rr, cc = (row // (th * tw),
                                                  (row // tw) % th, row % tw)
                                    aoff = (((nn * win_h + rr) * win_w + cc)
                                            * cs + 8 * (lane >> 4))
                                    regs.append(_ldsm(xs, aoff + xoff + 16 * kk,
                                                      4, False))
                                wt = (x_region + (slot * ngroups + ng)
                                      * box_bytes + 32 * nn_ * kk)
                                d = _wgmma_a(regs) @ _wg_b(
                                    smem, _wg_desc(wt, rowbytes), nn_)
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


def kernel_sums(xp, wp, bp, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci, t_co,
                t_n, split, groups=None):
    """The f32 sums ``(N, OHp, OWp, COp)``, bias included, that the dense
    bf16 kernel computes before its activation, by a line-by-line
    transcription of its index arithmetic on numpy buffers laid out as its
    shared memory (float64 here: exact on small integers): `wgmma_sums`
    where the tile takes the wgmma path, else the mma.sync path's below.
    ``groups`` (a dict) collects the fewest distinct bank groups of one
    ldmatrix phase of A and of B (mma.sync)."""
    x = xp.double().numpy()
    w = wp.double().numpy()
    bias = bp.double().numpy()
    n, ihp, iwp, cip = x.shape
    k, s = plan.kernel_size, plan.stride
    cop = w.shape[3]
    words = _tap_words(plan)
    th, tw = t_oh // s, t_ow // s
    if bf16_wgmma_tile(s, t_n * th * tw, t_co, k, t_ci) is not None:
        return wgmma_sums(x, w, bias, plan, words,
                          (n, ihp, iwp, cip, ih, iw, ohp, owp, cop),
                          (t_oh, t_ow, t_ci, t_co, t_n), split)
    base_h = halo_tile(t_oh, k, s, plan.padding).base
    base_w = halo_tile(t_ow, k, s, plan.padding).base
    pix = t_n * th * tw
    wm, wn = tc_warp_tile(pix, t_co)
    mgroups, ngroups = -(-(-(-pix // 16)) // wm), -(-(-(-t_co // 8)) // wn)
    cs, wst = bf16_row_stride(t_ci), tc_weight_stride(t_co)
    assert ngroups * wn * 8 == tc_columns(t_co) <= wst
    win_h, _ = staged_window(ih, ohp, t_oh, k, s, plan.padding)
    win_w, _ = staged_window(iw, owp, t_ow, k, s, plan.padding)
    tiles_h, tiles_w, tiles_co = ohp // t_oh, owp // t_ow, cop // t_co
    n_ci = cip // t_ci
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    lrow = (lane & 7) + ((lane >> 3) & 1) * 8
    seen = {"a": [], "b": []}
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
            (lo_h, hi_h), (lo_w, hi_w) = span
            eh, ew = hi_h - lo_h, hi_w - lo_w
            nw_ok = _popc(kok[1])
            it0 = rank * n_ci // split
            n_it = (rank + 1) * n_ci // split - it0
            acc = {}
            for it in range(n_it):
                c0 = (it0 + it) * t_ci
                # stage: input rows of t_ci elements at stride cs, zero where
                # they lie outside the real input; per valid tap t_ci weight
                # rows of t_co at stride wst, zero past t_co
                xs = np.zeros(t_n * win_h * win_w * cs)
                ws = np.zeros(len(wtap) * t_ci * wst)
                for r in range(t_n * eh * ew):
                    rest, lc = divmod(r, ew)
                    nn, lr = divmod(rest, eh)
                    if real[0][0] <= lr < real[0][1] and \
                            real[1][0] <= lc < real[1][1]:
                        d = ((nn * win_h + lr) * win_w + lc) * cs
                        xs[d:d + t_ci] = x[n0 + nn, h0 + lo_h + lr,
                                           w0 + lo_w + lc, c0:c0 + t_ci]
                for r in range(len(wtap) * t_ci):
                    slot, ci = divmod(r, t_ci)
                    ws[r * wst:r * wst + t_co] = w[wtap[slot] // k,
                                                   wtap[slot] % k, c0 + ci,
                                                   co0:co0 + t_co]
                for phase in range(s * s):
                    ph, pw = divmod(phase, s)
                    for mg in range(mgroups):
                        aoff = []
                        for i in range(wm):
                            r = (mg * wm + i) * 16 + lrow
                            r = np.where(r >= pix, 0, r)
                            nn, rr, cc = r // (th * tw), (r // tw) % th, r % tw
                            aoff.append(((nn * win_h + rr) * win_w + cc) * cs
                                        + 8 * (lane >> 4))
                        for ng in range(ngroups):
                            boff = lrow * wst + (ng * wn + (lane >> 4 if wn > 1
                                                            else 0)) * 8
                            part = {}
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
                                    wt = slot * t_ci * wst + boff
                                    for k0 in range(0, t_ci, 16):
                                        af = [_ldsm(xs, xt + aoff[i] + k0, 4,
                                                    False, seen["a"])
                                              for i in range(wm)]
                                        bf = []
                                        if wn == 1:
                                            bf.append(_ldsm(ws, wt + k0 * wst,
                                                            2, True, seen["b"]))
                                        for pr in range(wn // 2):
                                            q = _ldsm(ws, wt + k0 * wst + 16 * pr,
                                                      4, True, seen["b"])
                                            bf += [q[:2], q[2:]]
                                        for i in range(wm):
                                            for j in range(wn):
                                                key = (i, j)
                                                part[key] = part.get(key, 0) + \
                                                    _mma_m16n8k16(af[i], bf[j])
                            # the chunk's partial into the accumulators
                            for (i, j), d in part.items():
                                key = (phase, mg, ng, i, j)
                                acc[key] = acc.get(key, 0) + d
            # the block's tile: bias once (split 1: the accumulators' start;
            # under a split after the rank-ordered sum, the y += below)
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
    y += bias
    if groups is not None:
        groups["a"] = min(seen["a"])
        groups["b"] = min(seen["b"])
    return y


# (ih, iw, ci, co, k, s, p, batch, t, t_ci, t_co, t_n)
TRANSCRIBED = {
    "s2k4_co32": (4, 4, 32, 32, 4, 2, 1, 2, 8, 16, 32, 1),
    "s2k4_wide_tile": (8, 8, 32, 16, 4, 2, 1, 1, 16, 32, 16, 1),
    "s2k4_co8_batch_tile": (4, 4, 32, 8, 4, 2, 1, 2, 8, 16, 8, 2),
    "root_ci100": (1, 1, 100, 24, 4, 1, 0, 3, 1, 64, 8, 2),
    "thin_co1": (5, 5, 16, 1, 4, 2, 1, 1, 4, 16, 1, 1),
    "thin_co3": (6, 6, 32, 3, 4, 2, 1, 2, 8, 16, 3, 2),
    # the wgmma path, one case per instance (WM, WN): (2, 4), (2, 8) on a
    # stride-2 K=4 layer, (1, 8), (1, 4) on a 1x1 root; a 128-pixel phase
    # tile (four m64 tiles a warpgroup) keeps the mma.sync path
    "wgmma_2x4": (4, 4, 32, 32, 4, 2, 1, 4, 8, 16, 32, 4),
    "wgmma_2x8": (8, 8, 32, 64, 4, 2, 1, 1, 16, 32, 64, 1),
    "pix128_mma": (4, 4, 32, 32, 4, 2, 1, 8, 8, 32, 32, 8),
    "wgmma_root_1x8": (1, 1, 40, 64, 4, 1, 0, 64, 1, 16, 64, 64),
    "wgmma_root_1x4": (1, 1, 24, 32, 4, 1, 0, 64, 1, 16, 32, 64),
}


@pytest.mark.parametrize("case", sorted(TRANSCRIBED))
@pytest.mark.parametrize("split", [1, 2, 4])
def test_transcribed_kernel_equals_plain_sums(case, split, rng):
    """The transcription of the bf16 kernel at ``split`` equals the plain
    sums exactly: CelebA-like stride-2 K=4 layers at one, two and four n8
    tiles per warp (ldmatrix x2.trans and x4.trans), a 1x1 root with CI
    100 padded to 128, and the thin C_out 1 and 3 heads.  A split takes at
    least one CI chunk per rank, so a case is widened to ``split`` chunks
    where it has fewer."""
    ih, iw, ci, co, k, s, p, batch, t, t_ci, t_co, t_n = TRANSCRIBED[case]
    ci = max(ci, split * t_ci - (28 if case == "root_ci100" else 0))
    x = _ints(rng, (batch, ih, iw, ci))
    w = _ints(rng, (k, k, ci, co))
    b = _ints(rng, (co,))
    xp, wp, bp, kw, _ = launch_args(x, w, b, s, p, t, t, t_ci, t_co, t_n,
                                    None)
    assert xp.dtype == torch.bfloat16 and xp.shape[3] // t_ci >= split
    plan = kw["plan"]
    want = phase_products(xp, wp, plan, kw["ohp"] // s, kw["owp"] // s, bp,
                          torch.float64).numpy()
    got = kernel_sums(xp, wp, bp, plan, kw["ih"], kw["iw"], kw["ohp"],
                      kw["owp"], t, t, t_ci, t_co, kw["t_n"], split)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_ci", BF16_T_CI)
def test_ldmatrix_phases_hit_8_bank_groups(t_ci, rng):
    """At rows of t_ci + 8 elements, each ldmatrix phase of an A fragment
    whose 8 rows are consecutive pixels (a 16-wide tile at stride 2: 8
    pixels per phase row), and of every B fragment (8 k-rows of the weight
    at 8 mod 16 elements), falls in 8 distinct 16-byte bank groups."""
    x = _ints(rng, (1, 8, 8, t_ci))
    w = _ints(rng, (4, 4, t_ci, 16))
    b = _ints(rng, (16,))
    xp, wp, bp, kw, _ = launch_args(x, w, b, 2, 1, 16, 16, t_ci, 16, 1, None)
    groups = {}
    got = kernel_sums(xp, wp, bp, kw["plan"], kw["ih"], kw["iw"], kw["ohp"],
                      kw["owp"], 16, 16, t_ci, 16, 1, 1, groups)
    assert groups == {"a": 8, "b": 8}
    np.testing.assert_array_equal(
        got, phase_products(xp, wp, kw["plan"], kw["ohp"] // 2,
                            kw["owp"] // 2, bp, torch.float64).numpy())


def test_bf16_smem_layout_counts_2_byte_rows():
    """By hand: an 8x8 tile of a 4x4 -> 8x8 stride-2 layer at t_ci = 32,
    t_co = 32 stages a 6x6 window (rows of 40 elements) and 16 taps x 32
    weight rows of 40 elements (32 columns + 8), 2 bytes each; two stages
    fit 100 KB; under a split the partial tile (4 phases x 16 pixels x 32
    channels, 4 bytes each) is smaller than the ring."""
    g = DeconvGeometry(4, 4, 1024, 512, 4, 2, 1)
    assert bf16_row_stride(32) == 40 and tc_weight_stride(32) == 40
    stage = 2 * (6 * 6 * 40 + 16 * 32 * 40)
    assert tc_smem_layout(4, 4, 4, 2, 1, 8, 8, 8, 8, 32, 32, 1, 1,
                          "bfloat16") == (2, 2 * stage)
    assert kernel_smem_bytes(g, 8, 8, 32, 32, 1, "tc", 8, "bfloat16") == \
        2 * stage > 4 * 4 * 16 * 32
    # half the fp32 bytes less the channel strides' difference: fp32 rows
    # are t_ci + 4 words, weight rows the same element count in words
    fp32 = 4 * (6 * 6 * 36 + 16 * 32 * 40)
    assert tc_smem_layout(4, 4, 4, 2, 1, 8, 8, 8, 8, 32, 32, 1, 1,
                          "float32")[1] == 2 * fp32
    # a thin C_out 3 head: a 10x10 window per image, weight rows of 8
    # elements (one n8 tile), four stages; a 1x1 root at t_n 4: one pixel
    # and one tap per image, four stages
    assert tc_smem_layout(32, 32, 4, 2, 1, 64, 64, 16, 16, 16, 3, 2, 1,
                          "bfloat16") == \
        (4, 4 * 2 * (2 * 10 * 10 * 24 + 16 * 16 * 8))
    assert tc_smem_layout(1, 1, 4, 1, 0, 4, 4, 1, 1, 16, 64, 4, 1,
                          "bfloat16") == (4, 4 * 2 * (4 * 24 + 16 * 72))


def test_bf16_wgmma_smem_layout_counts_the_tma_boxes():
    """By hand, the wgmma path: CelebA layer 1's 8x8 tile of 4 images at
    t_ci = 32, t_co = 32 (two consumer warpgroups of two m64 tiles, N =
    32) stages a 6x6 window per image in rows of 40 elements, padded to a
    1024-byte swizzle atom, then 16 taps' boxes of 32 k-rows by 32
    channels, unpadded; four stages fit the path's 200 KB; the block adds
    1024 bytes to align its ring, and launches 384 threads."""
    g = DeconvGeometry(4, 4, 1024, 512, 4, 2, 1)
    x = 4 * 6 * 6 * 40 * 2                       # 11520 bytes
    x_padded = -(-x // 1024) * 1024              # 12288
    boxes = 16 * 32 * 32 * 2                     # 32768
    stage = x_padded + boxes
    assert bf16_wgmma_tile(2, 64, 32, 4, 32) == (2, 2, 32)
    assert tc_smem_layout(4, 4, 4, 2, 1, 8, 8, 8, 8, 32, 32, 4, 1,
                          "bfloat16") == (4, 4 * stage + 1024)
    assert kernel_smem_bytes(g, 8, 8, 32, 32, 4, "tc", 1, "bfloat16") == \
        4 * stage + 1024 == 181248
    assert block_threads(2, 8, 8, 32, 4, dtype="bfloat16", k_size=4,
                         t_ci=32) == 384
    # t_co 64 at t_ci 32: two m64 tiles of 64 channels a warpgroup (128
    # floats a thread), 4 KB boxes, two stages; under a split the partial
    # tile (4 phases x 64 pixels x 64 channels of 4 bytes) is smaller than
    # the ring
    assert bf16_wgmma_tile(2, 64, 64, 4, 32) == (2, 2, 64)
    big = -(-4 * 6 * 6 * 40 * 2 // 1024) * 1024 + 16 * 32 * 64 * 2
    assert tc_smem_layout(4, 4, 4, 2, 1, 8, 8, 8, 8, 32, 64, 4, 2,
                          "bfloat16") == (2, 2 * big + 1024)
    assert 2 * big > 4 * 4 * 64 * 64
    # a phase tile of 16 pixels, or thin channels, keeps the mma.sync path
    assert bf16_wgmma_tile(2, 16, 32, 4, 32) is None
    assert bf16_wgmma_tile(2, 64, 8, 4, 32) is None
    assert bf16_wgmma_tile(2, 64, 64, 4, 64) is None   # 128 floats, t_ci 64
    assert bf16_wgmma_tile(2, 128, 32, 4, 32) is None  # four m64 tiles
    assert block_threads(2, 8, 8, 32, 1, dtype="bfloat16", k_size=4,
                         t_ci=32) == 32 * 4 * 1 * 1


@pytest.mark.parametrize("cfg", NETS, ids=["mnist", "celeba"])
def test_bf16_tiles_are_taken_by_the_tc_kernel(cfg):
    """Every layer of both generators at buckets 1, 4 and 64: CI chunks of
    16, 32 or 64 channels, channel tiles of a multiple of 8 (C_out itself
    below 8), at most 512 threads, shared memory within a block's (split
    included), and at bucket 64 enough blocks, split included, for the
    card's 132 SMs."""
    for g in cfg.geometries():
        for batch in (1, 4, 64):
            t = hopper_tiles(g, batch, "bfloat16")
            assert t.t_ci in BF16_T_CI and t.t_ci <= -(-g.c_in // 16) * 16
            assert t.t_co % 8 == 0 or t.t_co == g.c_out < 8
            assert t.t_oh % g.stride == 0 and 1 <= t.t_n <= batch
            blocks = grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n)
            split = ci_split(blocks, -(-g.c_in // t.t_ci))
            assert 1 <= split <= MAX_SPLIT
            assert block_threads(g.stride, t.t_oh, t.t_ow, t.t_co, t.t_n,
                                 dtype="bfloat16", k_size=g.kernel,
                                 t_ci=t.t_ci) <= KERNEL_MAX_THREADS
            assert kernel_smem_bytes(g, t.t_oh, t.t_ow, t.t_ci, t.t_co,
                                     t.t_n, "tc", split, "bfloat16") \
                <= KERNEL_MAX_SMEM
            if batch == 64:
                assert blocks * split >= SMS


# (ih, iw, ci, co, k, s, p, t, t_ci, t_co, t_n, split)
SPLIT_CASES = [
    (4, 4, 128, 24, 4, 2, 1, 8, 16, 8, 1, 8),
    (8, 8, 64, 16, 4, 2, 1, 16, 16, 16, 1, 4),
    (6, 6, 64, 3, 4, 2, 1, 8, 32, 3, 2, 2),
    (1, 1, 100, 32, 4, 1, 0, 1, 16, 32, 2, 4),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_bf16_plain_versions_under_a_split_match_the_reference(case, rng):
    """B1's and B3's plain versions in bf16 at a cluster split (partials
    over contiguous CI-chunk ranges, added in rank order, then the bias)
    against the JAX package's bf16 ``deconv2d_ref``, within 8e-2; B3 on
    weights with whole slabs zeroed (its schedule skips them)."""
    ih, iw, ci, co, k, s, p, t, t_ci, t_co, t_n, split = case
    x = rng.randn(2, ih, iw, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(ci * k * k)).astype(np.float32)
    w[:, :, :t_ci] = 0.0
    b = (rng.randn(co) * 0.1).astype(np.float32)
    bf = torch.bfloat16
    xt, wt, bt = (torch.from_numpy(v).to(bf) for v in (x, w, b))
    want = np.asarray(j_ref(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16),
                            jnp.asarray(b, jnp.bfloat16), s, p), np.float32)
    xp, wp, bp, kw, crop = launch_args(xt, wt, bt, s, p, t, t, t_ci, t_co,
                                       t_n, "relu")
    sched = schedule_tensors(make_sparse_plan(wt, s, p, t_ci, t_co), "cpu")
    assert int(sched.count.sum()) < (xp.shape[3] // t_ci) * (wp.shape[3]
                                                             // t_co)
    for name, y in (
            ("B1", deconv2d_launch_plain(xp, wp, bp, split=split, **kw)),
            ("B3", deconv2d_sparse_launch_plain(xp, wp, bp, *sched,
                                                split=split, **kw))):
        assert y.dtype == bf
        got = y[crop].float().numpy()
        err = float(np.abs(got - np.maximum(want, 0.0)).max())
        print(f"{name} bf16 {case} split {split}: max |plain - reference| "
              f"= {err:.3e}")
        assert err <= BF16_TOL
