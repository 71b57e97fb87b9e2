// Halo-tiled, phase-decomposed transposed convolution on Hopper's tensor
// cores (sm_90a): the fp32 dense and zero-skip kernels, instances of one
// template, the bf16 dense and zero-skip kernels, instances of a sibling
// template, and the int8 kernel, all built on the same staging and split.
//
// Replaces three Pallas TPU kernels of the JAX package, each computing the
// same function on the same host-padded inputs:
//
//  * dense (`deconv2d_tc_forward`): `_deconv2d_kernel`,
//    src/repro/kernels/deconv2d/kernel.py (launched by `deconv2d_pallas_call`)
//
//      y = act(conv_transpose(x, w) + b)   x (N, IHp, IWp, CIp), w (K, K, CIp, COp),
//                                          b (COp), y (N, OHp, OWp, COp), NHWC,
//                                          f32 or bf16 (sums in f32)
//
//  * zero-skip (`deconv2d_tc_sparse_forward`): `_sparse_kernel`,
//    src/repro/kernels/deconv2d_sparse/kernel.py.  The dense function on
//    pruned weights, walking a packed schedule: per CO tile t, count[t]
//    entries, entry l naming CI tile ci[t*len + l] and its tap bits
//    bits[(t*len + l)*nbw + j] (bit kh*K + kw of the flat tap index set
//    where the slab is not all zero).  Tap bits are ANDed with the block's
//    valid taps; a dead tap stages nothing and costs no product.
//
//  * int8 (`deconv2d_tc_int8_forward`): `_deconv2d_int8_kernel`,
//    src/repro/kernels/deconv2d/int8.py (launched by `deconv2d_int8_pallas_call`).
//    x int8 (N, IHp, IWp, CIp); w int8 packed CI-minor, (K, K, COp, CIp);
//    the products go into an int32 accumulator that starts at 0 (the bias
//    lives in the epilogue), then the requant epilogue
//      v = act(float(acc) * scale[c] + b[c])     (f32, each step rounded)
//      y = clip(rint(v / out_scale), -127, 127)  int8, or y = v in f32 (last layer)
//    written with __fmul_rn/__fadd_rn/__fdiv_rn so that nvcc does not
//    contract it into an FMA: it rounds exactly as the plain torch version
//    (a separate multiply, add and true division) and the two agree bit for
//    bit on every int8 output.
//
// What bounds the kernels on an H100: tensor-core throughput on the wide
// CelebA layers (1024->512, 512->256, 256->128 channels: ~134M MACs per
// image each, a 4x4 kernel reused over every output pixel), device-memory
// bytes on the 1x1 roots (each weight read once and used by one pixel per
// image) and on the thin tanh layers (1 or 3 output channels), and at
// batch 1 the handful of blocks a layer's output makes.
//
// The design:
//  1. Implicit GEMM per output phase.  A block owns one (t_n, t_oh, t_ow,
//     t_co) output tile.  For each of its S*S phases the GEMM rows are the
//     phase's output pixels (t_n * t_oh/S * t_ow/S), the columns t_co
//     output channels, and the reduction runs over the phase's taps that
//     read real input in this block times the CI chunk.  A warp owns WM
//     m16 row tiles by WN n8 column tiles of one phase.  A fragments are
//     gathered from the staged input window at the tap's (dh, dw) offset
//     (from the host's tap table); B fragments from the staged weight rows.
//     Products are mma.sync m16n8k8 TF32 in the 3xTF32 split: hi = v cut
//     to TF32, lo = v - hi, and acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
//     three mma per fragment pair into f32.  One TF32 product keeps ~3
//     decimal digits, which fails the 1e-4 parity at CelebA's reduction
//     lengths (4 x 1024 terms); the split keeps the error near fp32's.
//     The mma sums of one CI chunk go to a fresh partial that is then added
//     to the accumulators, which start at the bias: the tensor cores round
//     each mma's sum toward zero, and one chain of 1536 mma into one
//     accumulator drifted by 3.6e-5 on CelebA's widest layer.
//     Dense fp32 takes wgmma where a block's phase tiles are whole m64
//     tiles (step 9): A, gathered per tap, comes from registers there, and
//     only B, the weights, has to be K-major; elsewhere, and for zero-skip,
//     fp32 stays on mma.sync.
//  2. Asynchronous staging.  A ring of 2..4 stages of (input window, weight
//     rows), filled by the copy engine: one cp.async.bulk per staged row (a
//     pixel's t_ci channels, a tap's and channel's t_co weights), counted
//     on the stage's mbarrier; thin layers' weight rows (C_out 1 or 3, not
//     whole 16-byte pieces) go by 4-byte cp.async.ca.  Window pixels outside
//     the real input are zero-filled in shared memory instead of copied.
//     Chunk c+stages-1 is in flight while chunk c runs its mma: one barrier
//     per chunk.  Per-thread 16-byte cp.async, the first design, spent more
//     issue slots on address arithmetic than the mma took (CelebA's wide
//     layers at batch 64 ran 1.0 ms); bulk copies of whole rows cost one
//     instruction per row.  The input window's channel stride is t_ci + 4
//     words, so the eight rows of an A fragment hit different banks where
//     they are consecutive pixels; a weight row is padded to 8 mod 16
//     words, so the four k-rows of a B fragment do.  A block stages only
//     the input rows and the weight taps that its valid taps read: a 1x1
//     root stages one input pixel and one tap of K*K.
//  3. Cluster split of the CI reduction.  Where a layer's grid would not
//     fill the 132 SMs (batch 1 above all), `split` blocks of one
//     thread-block cluster share an output tile, rank r walking the r-th
//     contiguous range of the CI chunks (zero-skip: of the CO tile's
//     entries).  Each leaves its partial tile in its own shared memory;
//     after cluster.sync() rank r sums slice r of the tile over ranks
//     0..split-1 in rank order through distributed shared memory, adds the
//     bias once, applies the activation and stores; a last cluster.sync()
//     keeps every block's memory alive until its readers are done.  One
//     launch per layer, no atomics: repeated launches give bit-identical
//     outputs.
//  4. Zero-skip without per-slab barriers: the packed schedule is built on
//     the host once per plan; each entry's tap bits are read when its chunk
//     is issued (and kept per stage in shared memory for the mma loop), the
//     block's valid taps are two bitmasks in registers, and a dead tap's
//     rows are neither copied nor counted on the stage's mbarrier.
//  5. Thin layers: the n8 column tile is padded with zero weight columns in
//     shared memory (zeroed once per launch) and the stores are masked to
//     the real channels, so C_out 1 or 3 writes no padding channel.
//  6. int8 (its own kernel on the same steps 1-3 and 5): products are
//     mma.sync m16n8k32 s8 x s8 -> s32, one per fragment pair, summed into
//     int32 accumulators over the whole CI reduction (integer sums are
//     exact: no split of the operands, no fresh partial per chunk, and the
//     cluster's rank-ordered sum is the plain version's in any order).  The
//     B operand wants 4 consecutive CI bytes per output channel, so the
//     weight comes packed CI-minor, (K, K, COp, CIp), once per engine; a
//     staged row (an input pixel's or a (tap, channel)'s t_ci bytes, t_ci a
//     multiple of 32) is one bulk copy of whole 16-byte pieces, thin layers
//     included, at a stride of t_ci + 16 bytes: the 8 rows x 4 words of an A
//     (consecutive pixels) or B fragment then fall in 32 distinct banks.
//     The largest sum on the served nets, 4 taps x 1024 x 127^2 ~ 6.6e7, is
//     far below 2^31; the launch refuses a layer whose taps x CIp x 127^2
//     could reach it.
//  7. bf16 (its own template on steps 1-5, dense and zero-skip, the same
//     function as the reference's bf16 kernels: bf16 operands, f32 sums):
//     products are mma.sync m16n8k16 bf16 x bf16 -> f32, one per fragment
//     pair and 16-channel k-step.  A bf16 product is exact in f32, so there
//     is no operand split (3xTF32 takes six mma per 16 channels); the fresh
//     partial per CI chunk stays, since the tensor cores still round each
//     mma's sum toward zero.  Staged rows are bf16, half fp32's bytes: an
//     input pixel's t_ci channels at a stride of t_ci + 8 elements, a (tap,
//     channel)'s t_co weights at fp32's stride in elements (8 mod 16 of
//     them).  Fragments come by ldmatrix: A (pixels x CI, two channels of a
//     pixel per register, as the int8 kernel's bytes) with one x4 per m16
//     tile, each lane addressing one 16-byte pixel row at the tap's
//     offset, so the per-tap gather costs nothing; B (CI x CO, two
//     consecutive channels of one output channel per register) with x4.trans
//     (x2 for one n8 tile) from the weight rows in the reference layout, so
//     the weights need no packing.  At those strides the 8 rows of every
//     ldmatrix phase (consecutive pixels, or k-rows) fall in distinct bank
//     groups.  Thin layers' weight rows (C_out 1 or 3: 2 or 6 bytes, which
//     neither cp.async nor a bulk copy takes) are staged by plain loads,
//     four in flight per thread, into the zero-padded columns.  The
//     epilogue adds the bias in f32, applies the activation in f32, rounds
//     once to bf16 and stores neighbouring channels as one bf16x2 word.
//  8. bf16 on wgmma (the kWg path of the same template, `Geometry::wg`):
//     where every phase tile is whole 64-pixel m64 tiles and t_co is 32,
//     64 or 128.  On mma.sync each warp issued its own fragment loads and
//     products in series and the same threads issued the copies; at
//     CelebA's wide layers the block was issue-bound (more stages did not
//     help).  Here a producer warpgroup only copies and one or two consumer
//     warpgroups only multiply, with setmaxnreg moving registers from the
//     first to the others.  A consumer warpgroup owns one or two m64 tiles
//     (a phase's 64 pixels by N = min(t_co, 64) channels) and issues, per
//     valid tap, one group of wgmma.mma_async m64nNk16 (f32 sums, bf16
//     in): A from registers, each warp's 16 rows gathered by the same
//     per-tap ldmatrix x4 as step 7 (mma.sync's A fragment is wgmma's
//     register-A layout), B from shared memory through a matrix
//     descriptor, MN-major (the transpose bit), so the weights stay in the
//     reference layout.  The next tap's fragments load while one group is
//     in flight (two buffers; one where the sums take 128 floats a
//     thread).  The first wgmma of a chunk does not accumulate: the fresh
//     partial of step 1, added to the bias-initialised sums after the
//     chunk.  The producer stages the window's real rows by cp.async.bulk
//     at the t_ci + 8 stride ldmatrix needs (rows outside the real input
//     are zeroed once for every stage) and each live weight slot's boxes
//     (t_ci k-rows by N channels of the (K*K*CIp, COp) weights, 64- or
//     128-byte swizzle, the descriptor's) by TMA tensor copies, counted on
//     the stage's full barrier; consumers release a stage on its empty
//     barrier.  The tensor map is encoded on the host (through the
//     runtime's driver entry point) once per weight and passed as a
//     __grid_constant__ parameter.  The cluster split and its rank-ordered
//     sum are step 3's.  Phase tiles under 64 pixels (bucket 1 on the
//     first layers) and thin layers keep the mma.sync path.
//  9. Dense fp32 on wgmma (the kWg path of the fp32 template, `Geometry::wg`
//     for D_F32 with P_SPARSE 0): step 8's block, m64 tiles and tap lists,
//     on 3xTF32 wgmma.mma_async m64nNk8.  TF32 wgmma takes A from registers
//     in mma.sync m16n8k8's A layout, which the per-tap ldmatrix x4 gives
//     on fp32 rows as on bf16 ones (a word is two b16 halves: lane l gets
//     word l % 4 of row l / 4).  B it reads K-major only (no transpose
//     bit), so the weights come packed CI-minor, (K, K, COp, CIp), once
//     per engine (as B2's), and a weight box is N output channels by t_ci
//     input channels.  t_ci is 8 or 16: a row of 32 or 64 bytes, staged in
//     that swizzle.  The split: per k8 step a consumer warp cuts its A
//     words as step 1 does (hi = a with its 13 low bits cleared, lo = a -
//     hi, in registers) and issues a_lo*b_hi, a_hi*b_lo, a_hi*b_hi, step
//     1's three products in step 1's order.  B's hi plane is the box as
//     TMA wrote it: the tensor cores read a raw f32 word as TF32 by
//     ignoring its 13 low bits, which is step 1's cut; the lo plane (v
//     minus v so cut, exact in f32) is written beside it once the box has
//     landed, so each weight comes from L2 once a block (the split done in
//     device memory would double those bytes).  A and B both round toward
//     zero at the cut, as on mma.sync.  The producer warpgroup's warp 0
//     only copies, up to `stages` chunks ahead: the block's input window
//     as one 4-D TMA box (t_n images by win_h x win_w pixels by t_ci
//     channels of the host-padded input; rows past it read zeros) and the
//     weight boxes; warps 1-3 write each chunk's lo planes as its copies
//     land, fence them for the async proxy wgmma reads through, and arrive
//     on the stage's ready barrier, which the consumers wait on.  A
//     consumer warpgroup runs its tiles one after another, each tap's
//     group of t_ci / 8 x 3 wgmma while the next tap's fragments load (two
//     buffers); the fresh partial per chunk is step 1's.  The ring may
//     take the whole of shared memory (one block per SM at these
//     registers).  On the H100 the first design copied the window row by
//     row (one bulk copy a pixel, 32 bytes each) and that alone took most
//     of a layer's time; as one box it is cheap, and the consumers bound
//     the kernel: a group's time is its latency, about the same at N 32 and
//     64 (so N 64, t_ci 8 wins where it fits).  Alternating two tiles' or
//     two chunks' groups in flight, or pipelining the groups across tiles,
//     ran 25-45 % slower than one tile's chain at a time.  A 1x1 root
//     keeps mma.sync: its phase tiles are one pixel an image, one valid tap
//     a block, and it reads each weight once.
//
// Plain C interface (loaded with ctypes): each `*_forward` launches on the
// given stream, does not synchronise and allocates nothing.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStride = 4;
constexpr int kMaxTaps = 8;
constexpr int kMaxK = kMaxStride * kMaxTaps;  // the largest kernel size
constexpr int kTapWords = kMaxStride + 2 * kMaxStride * kMaxTaps;
constexpr int kMaxThreads = 512;   // with __launch_bounds__: up to 128 registers
constexpr int kStaticSmem = 4096;  // bound on the kernel's static shared tables
constexpr int kMaxDynamicSmem = 232448 - kStaticSmem;
constexpr int kMaxSplit = 8;       // blocks of one cluster (the portable limit)
constexpr int kMaxStages = 4;
constexpr int kStageBudget = 100 * 1024;  // bytes the ring may take (2 stages at least)
constexpr int kMaxBitWords = kMaxK * kMaxK / 32;
// the bf16 wgmma path: a producer warpgroup and at most two consumer
// warpgroups; registers per thread at the launch bound, and the split
// setmaxnreg makes of them (128 x 56 + 256 x 224 = 384 x 168)
constexpr int kWgThreads = 384;
constexpr int kWgRegs = (65536 / kWgThreads) & ~7;
constexpr int kWgProducerRegs = 56;
constexpr int kWgConsumerRegs = 224;
constexpr int kWgStageBudget = 200 * 1024;  // the wgmma path's ring (2 stages at least)
constexpr int kWgAlign = 1024;             // a 128-byte-swizzle atom: 8 rows of 128 bytes
constexpr int kWgTaps = 64;                // valid taps over a block's phases (its tap lists)
// the fp32 wgmma path's ring: all of a block's shared memory but the
// alignment (a block takes a whole SM's registers)
constexpr int kWgF32StageBudget = kMaxDynamicSmem - kWgAlign;

// Layout of the int32 parameter array the host passes (kept in step with
// repro_torch/kernels/deconv2d/kernel.py::_TC_PARAM_FIELDS).
enum Param {
  P_N, P_IHP, P_IWP, P_CIP, P_K, P_COP, P_OHP, P_OWP, P_S,
  P_TN, P_TOH, P_TOW, P_TCI, P_TCO, P_TIH, P_TIW, P_BASE_H, P_BASE_W,
  P_ACT, P_IH, P_IW, P_PAD_L, P_THREADS, P_SPLIT, P_DTYPE, P_SPARSE, P_TAPS
};

// P_DTYPE: the staged type, and so the instance and shared layout (the
// codes of repro_torch/kernels/deconv2d/kernel.py::_DTYPE_CODE).  P_SPARSE:
// 1 for a zero-skip launch, whose fp32 instance has no wgmma path.
enum Dtype { D_F32 = 0, D_BF16 = 1, D_INT8 = 2 };

// Argument errors are reported as negative codes, CUDA errors as positive.
enum ArgError {
  E_ARGS = -1, E_THREADS = -2, E_SMEM = -3, E_REGTILE = -4, E_ALIGN = -5, E_REGS = -6, E_TMAP = -7
};

struct Geometry {
  int n, ihp, iwp, cip, k, cop, ohp, owp, s;
  int t_n, t_oh, t_ow, t_ci, t_co, base_h, base_w;
  int act;
  int ih, iw, pad_l;  // the unpadded input extent and the left halo padding
  int tiles_h, tiles_w, tiles_co;
  int split;
  // derived: rows of a phase, warp grid, staged window, weight rows, ring
  int pix, wm, wn, mgroups, ngroups;
  int win_h, win_w, slots;  // most rows staged per dim; most valid taps
  // strides and sizes in elements of the staged type (f32 words; bf16
  // halves; int8 bytes): fp32 and bf16 cs = input pixel row, ws = weight
  // row (t_co wide); int8 cs = either row (t_ci wide), ws = weight rows
  // per slot
  int cs, ws;
  int x_elems, stage_elems, stages;
  bool w_vec4;              // fp32 and bf16 weight rows staged as whole 16-byte pieces
  // the int8 kernel's layout (else fp32); last, so that the fp32 kernels'
  // fields keep their offsets and compiled code
  bool int8;
  // the wgmma path (design steps 8 and 9): consumer warpgroups, m64 tiles
  // a warpgroup, the wgmma's N and the tile's 64-or-fewer-channel groups
  bool wg;
  int wg_consumers, wg_wm, wg_n, wg_ngroups, wg_mgroups;
};

struct TapTable {
  int words[kTapWords];  // counts[S] | tap k[S][kMaxTaps] | local row[S][kMaxTaps]
};

// The packed zero-skip schedule (device int32 arrays); unused by the dense
// instance.
struct Schedule {
  const int* count;
  const int* ci;
  const unsigned* bits;
  int len, nbw;
};

// v = hi + lo: hi is v cut to TF32 (sign, exponent, 10 mantissa bits), lo
// = v - hi is exact in f32 and the tensor core reads its top 10 mantissa
// bits.  The cut costs one LOP3 where cvt.rna.tf32.f32 expands to five
// instructions on sm_90a, and the split's error (below 2^-21 of v) is far
// under the f32 accumulation's.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, int8 operands into int32 (exact: no saturation below 2^31).
// a: rows lane/4 and lane/4 + 8, k bytes 4*(lane%4) and +16; b: column
// lane/4, the same k bytes; d: rows lane/4 (+8), columns 2*(lane%4) (+1).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, bf16 operands into f32 (each product exact).  a: rows
// lane/4 and lane/4 + 8, k elements 2*(lane%4) (+1) and 8 + 2*(lane%4)
// (+1); b: column lane/4, the same k elements; d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix of 8x8 matrices of 16-bit elements from shared memory: lanes
// 8i..8i+7 give the addresses of matrix i's eight 16-byte rows (x2: lanes
// 0..15 only).  Lane l receives register i = elements (l/4, 2*(l%4)) and
// (l/4, 2*(l%4) + 1) of matrix i as stored; with .trans (2*(l%4), l/4) and
// (2*(l%4) + 1, l/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r0)[2], uint32_t (&r1)[2],
                                              unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0[0]), "=r"(r0[1]), "=r"(r1[0]), "=r"(r1[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ float bf16_float(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}

// lo and hi rounded to the nearest bf16 (ties to even), packed with lo in
// the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0) cp_async_wait<0>();
  else if (pending == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) whose completion is counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive once on `bar`, announcing `bytes` of copies that complete on it.
__device__ __forceinline__ void mbar_arrive_expect(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// The bf16 wgmma path's primitives (design step 8)

// Wait for `bar`'s phase `parity`, trapping after 2^32 clocks (about two
// seconds): a count or parity gone wrong fails the launch, it does not
// hang the card.
__device__ __forceinline__ void mbar_wait_bounded(void* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One 2-D TMA tensor copy: the box of `map` at (col, row), into shared
// memory at `dst` in the map's swizzle, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// One 4-D TMA tensor copy: the box of `map` at (c0, c1, c2, c3), innermost
// first, into shared memory at `dst` in the map's swizzle, counted on
// `bar`; coordinates past the tensor read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// The byte offset `a` of a region laid out in rows of `rowbytes` (32 or 64)
// bytes as a TMA copy in that many bytes' swizzle places it (the region
// aligned to 1024 bytes): bits 4.. XORed with bits 7.. (1 or 2 bits), so
// that 8 consecutive rows' 16-byte pieces fall in distinct bank groups.
__device__ __forceinline__ unsigned swizzled(unsigned a, int rowbytes) {
  return a ^ (((a >> 7) & (unsigned)((rowbytes >> 4) - 1)) << 4);
}

// The shared-memory matrix descriptor of a B operand (16 k-rows of one
// staged box): MN-major, the output channels contiguous, `rowbytes` (64 or
// 128) bytes a k-row in that many bytes' swizzle, so that 8 k-rows make
// one swizzle atom and the stride byte offset between the two 8-row
// groups is 8 * rowbytes.  The leading byte offset (between 64-channel
// atoms along N) is unused: a box is one atom wide.
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, int rowbytes) {
  const uint64_t layout = rowbytes == 128 ? 1 : 2;  // 128-byte or 64-byte swizzle
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * rowbytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers of `d` to this point of the program: reads of a wgmma
// accumulator after its wait_group are not moved above it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a * B + (scale_d ? d : 0) over one k16 step, bf16 operands, f32 sums:
// a is the warp's 16 rows of the warpgroup's 64 in registers (the layout of
// mma.sync m16n8k16's A, which ldmatrix x4 gives), B (16 x N) from shared
// memory through `desc`, MN-major (the transpose bit).  d holds, per n8
// column tile j, rows lane/4 and lane/4 + 8 of the warp's 16 at columns
// 8j + 2*(lane%4) (+1), as d[4j..4j+3].
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The shared-memory matrix descriptor of a B operand on the fp32 wgmma path
// (design step 9): K-major, each output channel's k8 step 32 contiguous
// bytes of a `rowbytes` (32 or 64) byte row in that many bytes' swizzle,
// 8 rows a swizzle atom, so that the stride byte offset between 8-row
// groups is 8 * rowbytes; the leading byte offset is unused (one
// instruction's 32 bytes never cross an atom).  A k8 step inside a wider
// row starts 32 bytes further on.
__device__ __forceinline__ uint64_t wg_desc_k(unsigned addr, int rowbytes) {
  const uint64_t layout = rowbytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * rowbytes) >> 4) << 32) | (layout << 62);
}

// d = a * B + (scale_d ? d : 0) over one k8 step, TF32 operands, f32 sums:
// a is the warp's 16 rows of the warpgroup's 64 in registers (the layout
// of mma.sync m16n8k8's tf32 A: rows lane/4 (a0, a2) and lane/4 + 8 (a1,
// a3), k words lane%4 (a0, a1) and lane%4 + 4 (a2, a3)), B (8 x N) from
// shared memory through `desc`, K-major; d as for wgmma_bf16.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// v - (v with its 13 low bits cleared): the lo half of split_tf32, exact in
// f32, for a B word whose hi half the tensor cores take from v itself
__device__ __forceinline__ float tf32_lo(float v) {
  return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

// n / d and n % d for a divisor fixed per block, with a multiply-high
// (Granlund and Montgomery's round-up method, for n < 2^31).
struct FastDiv {
  unsigned mul, shift;
  __device__ __forceinline__ void init(int divisor) {
    const unsigned d = divisor > 0 ? divisor : 1;
    shift = 32 - __clz(d - 1);
    mul = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return tanhf(v);
  return v;
}

// Tap validity, uniform over a block, run by one thread: the int8 kernel's
// copy of the block the fp32 kernel keeps inline (called from there, this
// function changed the fp32 kernel's compiled code and cost it 1-2 % at
// bucket 1).  A tap whose rows (or columns) in this tile's window all lie in the
// host padding adds exactly zero, so its weights are not staged and its
// products are skipped, and only the window span that valid taps read is
// staged.  Per dim (0: rows, 1: cols) it writes which phase taps are valid
// (tap_ok), their kernel indices as a bitmask (kok), the staged span [lo,
// hi) (span) and its rows of real input [lo, hi), window-local (real); and
// the flat kernel tap (kh * K + kw) of each staged weight slot (wtap).
__device__ __forceinline__ void block_taps(const Geometry& g, const int* s_taps, int h0, int w0,
                                           unsigned char (*s_tap_ok)[kMaxStride * kMaxTaps],
                                           unsigned* s_kok, int* s_span, int* s_real,
                                           short* s_wtap) {
  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  unsigned char kof[2][kMaxK];
  for (int dim = 0; dim < 2; ++dim) {
    const int o0 = dim == 0 ? h0 : w0;
    const int span = dim == 0 ? th : tw;
    const int lo_real = g.pad_l;
    const int hi_real = g.pad_l + (dim == 0 ? g.ih : g.iw);
    int lo = 1 << 30, hi = -(1 << 30);
    unsigned kok = 0;
    for (int ph_ = 0; ph_ < s; ++ph_) {
      for (int a = 0; a < s_taps[ph_]; ++a) {
        const int d = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph_ * kMaxTaps + a];
        const bool ok = o0 + d < hi_real && o0 + d + span > lo_real;
        s_tap_ok[dim][ph_ * kMaxTaps + a] = ok;
        if (ok) {
          kok |= 1u << s_taps[kMaxStride + ph_ * kMaxTaps + a];
          lo = min(lo, d);
          hi = max(hi, d + span);
        }
      }
    }
    if (lo >= hi) lo = hi = 0;
    s_span[2 * dim] = lo;
    s_span[2 * dim + 1] = hi;
    // window-local rows lo + r read padded row o0 + lo + r
    s_real[2 * dim] = min(max(lo_real - (o0 + lo), 0), hi - lo);
    s_real[2 * dim + 1] = max(min(hi_real - (o0 + lo), hi - lo), s_real[2 * dim]);
    s_kok[dim] = kok;
    int n = 0;
    for (int k = 0; k < g.k; ++k) {
      if ((kok >> k) & 1u) kof[dim][n++] = (unsigned char)k;
    }
    if (dim == 1) {
      const int nh = __popc(s_kok[0]);
      for (int sh = 0; sh < nh; ++sh) {
        for (int sw = 0; sw < n; ++sw) s_wtap[sh * n + sw] = (short)(kof[0][sh] * g.k + kof[1][sw]);
      }
    }
  }
}

template <int WM, int WN>
__device__ __forceinline__ void f32_wgmma_block(const float* __restrict__ b,
                                                float* __restrict__ y, const Geometry& g,
                                                const TapTable& taps, const CUtensorMap* tmap,
                                                const CUtensorMap* xmap);

// The fp32 wgmma path's tensor maps (the weights', the input's), passed in
// the kernel's parameter space; the mma.sync instances take an empty struct
// in their place, so that their parameters stay what steps 1-5 pass.  (With
// the two maps in every instance's parameters, the profiler mirror's card
// test, tests/test_torch_obs_cuda.py, saw a dispatch's input copy start
// before its host range in 4 of 6 runs on the H100; without, in none of 6.)
struct TensorMaps {
  CUtensorMap w, x;
};
struct NoMaps {};
template <bool kWg>
using MapsOf = std::conditional_t<kWg, TensorMaps, NoMaps>;

// The fp32 dense and zero-skip kernels: two paths of one template.  kWg
// (design step 9, dense only): a producer warpgroup and 3xTF32 wgmma
// consumer warpgroups, where every phase tile is whole m64 tiles of 64
// channels (`Geometry::wg`, tiling.py's `fp32_wgmma_tile`); w is then
// packed CI-minor and reached through `maps.w`, x through `maps.x`.  Else
// (design steps 1-5): warps of mma.sync m16n8k8 over the block's phases.
template <bool kSparse, bool kWg, int WM, int WN>
__global__ void __launch_bounds__(kWg ? kWgThreads : kMaxThreads, 1) deconv2d_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ y, Geometry g, TapTable taps, Schedule sched,
    const __grid_constant__ MapsOf<kWg> maps) {
  if constexpr (kWg) {
    f32_wgmma_block<WM, WN>(b, y, g, taps, &maps.w, &maps.x);
  } else {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_taps[kTapWords];
  // per dim (0: rows, 1: cols): which phase taps read any real input for
  // this block, those taps' kernel indices as a bitmask, the staged window
  // span [lo, hi) and its rows of real input [lo, hi) (window-local)
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned s_kok[2];
  __shared__ int s_span[4];
  __shared__ int s_real[4];
  // the flat kernel tap (kh * K + kw) of each staged weight slot
  __shared__ short s_wtap[kMaxK * kMaxK];
  // zero-skip: per stage, the entry's CI tile (-1: none) and its tap bits
  __shared__ int s_ent[kMaxStages][1 + kMaxBitWords];
  // per stage: completes when the stage's bulk copies have landed
  __shared__ __align__(8) unsigned long long s_bar[kMaxStages];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTapWords; i += blockDim.x) s_taps[i] = taps.words[i];

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.pix;

  // block -> (output tile, rank in the cluster)
  const int split = g.split;
  const int rank = blockIdx.x % split;
  int tile = blockIdx.x / split;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;

  // the weight rows' padding columns stay zero: the copies never write them
  for (int st = 0; st < g.stages; ++st) {
    float* ws = smem + st * g.stage_elems + g.x_elems;
    const int pad = g.ws - g.t_co;
    for (int e = tid; e < g.slots * g.t_ci * pad; e += blockDim.x)
      ws[(e / pad) * g.ws + g.t_co + e % pad] = 0.0f;
  }
  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) mbar_init(&s_bar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tap validity, uniform over the block: a tap whose rows (or columns) in
  // this tile's window all lie in the host padding adds exactly zero, so
  // its weights are not staged and its products are skipped, and only the
  // window span that valid taps read is staged.
  if (tid == 0) {
    unsigned char kof[2][kMaxK];
    for (int dim = 0; dim < 2; ++dim) {
      const int o0 = dim == 0 ? h0 : w0;
      const int span = dim == 0 ? th : tw;
      const int lo_real = g.pad_l;
      const int hi_real = g.pad_l + (dim == 0 ? g.ih : g.iw);
      int lo = 1 << 30, hi = -(1 << 30);
      unsigned kok = 0;
      for (int ph_ = 0; ph_ < s; ++ph_) {
        for (int a = 0; a < s_taps[ph_]; ++a) {
          const int d = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph_ * kMaxTaps + a];
          const bool ok = o0 + d < hi_real && o0 + d + span > lo_real;
          s_tap_ok[dim][ph_ * kMaxTaps + a] = ok;
          if (ok) {
            kok |= 1u << s_taps[kMaxStride + ph_ * kMaxTaps + a];
            lo = min(lo, d);
            hi = max(hi, d + span);
          }
        }
      }
      if (lo >= hi) lo = hi = 0;
      s_span[2 * dim] = lo;
      s_span[2 * dim + 1] = hi;
      // window-local rows lo + r read padded row o0 + lo + r
      s_real[2 * dim] = min(max(lo_real - (o0 + lo), 0), hi - lo);
      s_real[2 * dim + 1] = max(min(hi_real - (o0 + lo), hi - lo), s_real[2 * dim]);
      s_kok[dim] = kok;
      int n = 0;
      for (int k = 0; k < g.k; ++k) {
        if ((kok >> k) & 1u) kof[dim][n++] = (unsigned char)k;
      }
      if (dim == 1) {
        const int nh = __popc(s_kok[0]);
        for (int sh = 0; sh < nh; ++sh) {
          for (int sw = 0; sw < n; ++sw) s_wtap[sh * n + sw] = (short)(kof[0][sh] * g.k + kof[1][sw]);
        }
      }
    }
  }
  __syncthreads();

  const unsigned kok_h = s_kok[0], kok_w = s_kok[1];
  const int nw_ok = __popc(kok_w);
  const int n_slots = __popc(kok_h) * nw_ok;
  const int lo_h = s_span[0], eh = s_span[1] - s_span[0];
  const int lo_w = s_span[2], ew = s_span[3] - s_span[2];
  const int cs = g.cs, wst = g.ws;
  FastDiv div_ew, div_eh, div_ci;
  div_ew.init(ew);
  div_eh.init(eh);
  div_ci.init(g.t_ci);
  // bytes one chunk's input rows bring: the real rows of the span
  const int x_bytes =
      g.t_n * (s_real[1] - s_real[0]) * (s_real[3] - s_real[2]) * g.t_ci * 4;

  // warp -> (phase, row group, column group); warps past the last phase
  // only stage
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int per_phase = g.mgroups * g.ngroups;
  const int phase = warp / per_phase;
  const bool computes = phase < s * s;
  const int q = warp - phase * per_phase;
  const int mg = q / g.ngroups, ng = q - (q / g.ngroups) * g.ngroups;
  const int ph = computes ? phase / s : 0, pw = computes ? phase % s : 0;

  // the input-window offsets of this lane's A rows (rows past the phase's
  // pixels read pixel 0 and are never stored)
  int aoff[WM][2];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      int r = (mg * WM + i) * 16 + gid + 8 * hf;
      if (r >= pix) r = 0;
      const int nn = r / (th * tw);
      const int rr = (r / tw) % th;
      const int cc = r % tw;
      aoff[i][hf] = ((nn * g.win_h + rr) * g.win_w + cc) * cs;
    }
  }
  // accumulators, from the bias unless a cluster split adds it after the sum
  float acc[WM][WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    const int col = (ng * WN + j) * 8 + 2 * tig;
    const float b0 = (split == 1 && col < g.t_co) ? b[co0 + col] : 0.0f;
    const float b1 = (split == 1 && col + 1 < g.t_co) ? b[co0 + col + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      acc[i][j][0] = b0;
      acc[i][j][1] = b1;
      acc[i][j][2] = b0;
      acc[i][j][3] = b1;
    }
  }

  // this rank's range of chunks (dense) or of the CO tile's entries
  const int n_ci = g.cip / g.t_ci;
  const int total = kSparse ? sched.count[co_t] : n_ci;
  const int it0 = rank * total / split;
  const int n_it = (rank + 1) * total / split - it0;

  // Issue chunk `it` into stage `st`: input rows and (wide) weight rows as
  // bulk copies counted on the stage's mbarrier, thin weight rows as 4-byte
  // cp.async in a commit group (an empty group past the end, so that the
  // wait counts stay uniform).
  auto issue = [&](int it, int st) {
    if (it < n_it) {
      int ci_t = it0 + it;
      const unsigned* bits = nullptr;
      if constexpr (kSparse) {
        const int e = co_t * sched.len + it0 + it;
        ci_t = sched.ci[e];
        bits = sched.bits + (size_t)e * sched.nbw;
        if (ci_t < 0 || ci_t >= n_ci) ci_t = -1;
      }
      auto live = [&](int t) {
        if constexpr (kSparse) return ((__ldg(bits + (t >> 5)) >> (t & 31)) & 1u) != 0;
        return true;
      };
      if (tid == 0) {
        int bytes = 0;
        if (ci_t >= 0) {
          int n_live = n_slots;
          if constexpr (kSparse) {
            n_live = 0;
            for (int sl = 0; sl < n_slots; ++sl) n_live += live(s_wtap[sl]);
            s_ent[st][0] = ci_t;
            for (int j = 0; j < sched.nbw; ++j) s_ent[st][1 + j] = (int)bits[j];
          }
          bytes = x_bytes + (g.w_vec4 ? n_live * g.t_ci * g.t_co * 4 : 0);
        } else if constexpr (kSparse) {
          s_ent[st][0] = -1;
        }
        mbar_arrive_expect(&s_bar[st], bytes);
      }
      if (ci_t >= 0) {
        const int c0 = ci_t * g.t_ci;
        float* xs = smem + st * g.stage_elems;
        float* ws = xs + g.x_elems;
        // input window: one bulk copy per pixel row of t_ci channels; rows
        // outside the real input are zero-filled in place
        const int nx = g.t_n * eh * ew;
        for (int r = tid; r < nx; r += blockDim.x) {
          const int rest = div_ew.div(r);
          const int lc = r - rest * ew;
          const int nn = div_eh.div(rest);
          const int lr = rest - nn * eh;
          float* dst = xs + ((nn * g.win_h + lr) * g.win_w + lc) * cs;
          if (lr >= s_real[0] && lr < s_real[1] && lc >= s_real[2] && lc < s_real[3]) {
            const int gh = h0 + lo_h + lr, gw = w0 + lo_w + lc;
            bulk_copy(dst,
                      x + ((((size_t)(n0 + nn) * g.ihp + gh) * g.iwp + gw) * g.cip) + c0,
                      g.t_ci * 4, &s_bar[st]);
          } else {
            for (int j = 0; j < g.t_ci; j += 4)
              *reinterpret_cast<float4*>(dst + j) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
        // weight rows of the block's valid (zero-skip: and live) taps
        const int nw = n_slots * g.t_ci;
        if (g.w_vec4) {
          for (int r = tid; r < nw; r += blockDim.x) {
            const int slot = div_ci.div(r);
            const int ci = r - slot * g.t_ci;
            const int t = s_wtap[slot];
            if (!live(t)) continue;
            bulk_copy(ws + r * wst, w + ((size_t)t * g.cip + c0 + ci) * g.cop + co0,
                      g.t_co * 4, &s_bar[st]);
          }
        } else {
          for (int e = tid; e < nw * g.t_co; e += blockDim.x) {
            const int r = e / g.t_co;
            const int c = e - r * g.t_co;
            const int slot = div_ci.div(r);
            const int ci = r - slot * g.t_ci;
            const int t = s_wtap[slot];
            if (!live(t)) continue;
            cp_async4(ws + r * wst + c, w + ((size_t)t * g.cip + c0 + ci) * g.cop + co0 + c);
          }
        }
      }
    }
    cp_async_commit();
  };

  // The mma loop of one staged chunk: the phase's valid (and live) taps,
  // t_ci / 8 k-steps each, summed in a fresh partial that is then added
  // to the accumulators.  The tensor cores round each mma's sum toward
  // zero, so a long chain of mma into one accumulator drifts; a partial
  // per chunk keeps the chain short and the chunks are added with
  // round-to-nearest.
  auto compute = [&](int st) {
    if constexpr (kSparse) {
      if (s_ent[st][0] < 0) return;
    }
    const float* xs = smem + st * g.stage_elems;
    const float* ws = xs + g.x_elems;
    float part[WM][WN][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.0f;
      }
    }
    const int n_taps_h = s_taps[ph], n_taps_w = s_taps[pw];
    for (int a = 0; a < n_taps_h; ++a) {
      if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
      const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
      const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      const int sh = __popc(kok_h & ((1u << kh) - 1u));
      for (int bb = 0; bb < n_taps_w; ++bb) {
        if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
        const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
        if constexpr (kSparse) {
          const int t = kh * g.k + kw;
          if (!(((unsigned)s_ent[st][1 + (t >> 5)] >> (t & 31)) & 1u)) continue;
        }
        const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
        const int slot = sh * nw_ok + __popc(kok_w & ((1u << kw) - 1u));
        const float* xt = xs + ((dh - lo_h) * g.win_w + (dw - lo_w)) * cs + tig;
        const float* wt = ws + slot * g.t_ci * wst + tig * wst + ng * WN * 8 + gid;
        for (int k0 = 0; k0 < g.t_ci; k0 += 8) {
          uint32_t ah[WM][4], al[WM][4], bh[WN][2], bl[WN][2];
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            split_tf32(xt[aoff[i][0] + k0], ah[i][0], al[i][0]);
            split_tf32(xt[aoff[i][1] + k0], ah[i][1], al[i][1]);
            split_tf32(xt[aoff[i][0] + k0 + 4], ah[i][2], al[i][2]);
            split_tf32(xt[aoff[i][1] + k0 + 4], ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            split_tf32(wt[k0 * wst + j * 8], bh[j][0], bl[j][0]);
            split_tf32(wt[(k0 + 4) * wst + j * 8], bh[j][1], bl[j][1]);
          }
          // the three products of a tile depend on each other through its
          // accumulator: issue each round over all WM x WN tiles, so that
          // WM * WN independent mma sit between two dependent ones
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) mma_tf32(part[i][j], al[i], bh[j]);
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
      }
    }
  };

  const int ns = g.stages;
  for (int st = 0; st < ns - 1; ++st) issue(st, st);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ns;
    cp_async_wait_pending(ns - 2);         // this thread's 4-byte copies of chunk `it`
    mbar_wait(&s_bar[st], (it / ns) & 1);  // the chunk's bulk copies
    __syncthreads();                       // all of it; stage (it-1) % ns is free
    issue(it + ns - 1, (it + ns - 1) % ns);
    if (computes) compute(st);
  }
  cp_async_wait<0>();

  // output pixel of row r of this warp's phase -> y row pointer
  auto out_row = [&](int r, int ph_, int pw_) {
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    const int oh = oh_t * g.t_oh + rr * s + ph_;
    const int ow = ow_t * g.t_ow + cc * s + pw_;
    return y + (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0;
  };

  if (split == 1) {
    if (!computes) return;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
        float* row = out_row(r, ph, pw);
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          if (col < g.t_co) row[col] = activate(acc[i][j][2 * hf], g.act);
          if (col + 1 < g.t_co) row[col + 1] = activate(acc[i][j][2 * hf + 1], g.act);
        }
      }
    }
    return;
  }

  // Cluster split: the partial tile, [phase][row][channel], in this block's
  // shared memory (the ring is drained), then the rank-ordered sum of
  // slice `rank` through distributed shared memory.
  __syncthreads();
  float* part = smem;
  if (computes) {
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
        float* prow = part + (phase * pix + r) * g.t_co;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          if (col < g.t_co) prow[col] = acc[i][j][2 * hf];
          if (col + 1 < g.t_co) prow[col + 1] = acc[i][j][2 * hf + 1];
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_el = s * s * pix * g.t_co;
  const int e_end = (rank + 1) * n_el / split;
  for (int e = rank * n_el / split + tid; e < e_end; e += blockDim.x) {
    float v = 0.0f;
    for (int qr = 0; qr < split; ++qr) v += cluster.map_shared_rank(part, qr)[e];
    const int col = e % g.t_co;
    const int rest = e / g.t_co;
    const int r = rest % pix;
    const int phs = rest / pix;
    out_row(r, phs / s, phs % s)[col] = activate(v + b[co0 + col], g.act);
  }
  cluster.sync();
  }
}

// The int8 kernel (design step 6): the fp32 kernel's block, warp grid,
// tap table, ring and cluster split, on int8 bytes and s8 mma.
template <bool kRequant, int WM, int WN>
__global__ void __launch_bounds__(kMaxThreads) deconv2d_tc_int8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ b, void* __restrict__ y, Geometry g, TapTable taps,
    float out_scale) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  __shared__ int s_taps[kTapWords];
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned s_kok[2];
  __shared__ int s_span[4];
  __shared__ int s_real[4];
  __shared__ short s_wtap[kMaxK * kMaxK];
  __shared__ __align__(8) unsigned long long s_bar[kMaxStages];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTapWords; i += blockDim.x) s_taps[i] = taps.words[i];

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.pix;

  // block -> (output tile, rank in the cluster)
  const int split = g.split;
  const int rank = blockIdx.x % split;
  int tile = blockIdx.x / split;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;
  // a staged row (input pixel or (tap, channel) weight) is t_ci bytes at a
  // stride of cs bytes; a slot holds g.ws weight rows, those past t_co zero
  const int cs = g.cs, cols = g.ws;

  // the padding weight rows stay zero: the copies never write them
  const int pieces = g.t_ci / 16;
  for (int st = 0; st < g.stages; ++st) {
    unsigned char* ws = smem_i8 + st * g.stage_elems + g.x_elems;
    const int pad = cols - g.t_co;
    for (int e = tid; e < g.slots * pad * pieces; e += blockDim.x) {
      const int r = e / pieces;
      *reinterpret_cast<int4*>(ws + ((r / pad) * cols + g.t_co + r % pad) * cs +
                               16 * (e - r * pieces)) = make_int4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) mbar_init(&s_bar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) block_taps(g, s_taps, h0, w0, s_tap_ok, s_kok, s_span, s_real, s_wtap);
  __syncthreads();

  const unsigned kok_h = s_kok[0], kok_w = s_kok[1];
  const int nw_ok = __popc(kok_w);
  const int n_slots = __popc(kok_h) * nw_ok;
  const int lo_h = s_span[0], eh = s_span[1] - s_span[0];
  const int lo_w = s_span[2], ew = s_span[3] - s_span[2];
  FastDiv div_ew, div_eh, div_co;
  div_ew.init(ew);
  div_eh.init(eh);
  div_co.init(g.t_co);
  // bytes one chunk brings: the real rows of the span and the valid taps'
  // weight rows
  const int chunk_bytes =
      (g.t_n * (s_real[1] - s_real[0]) * (s_real[3] - s_real[2]) + n_slots * g.t_co) * g.t_ci;

  // warp -> (phase, row group, column group); warps past the last phase
  // only stage
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int per_phase = g.mgroups * g.ngroups;
  const int phase = warp / per_phase;
  const bool computes = phase < s * s;
  const int q = warp - phase * per_phase;
  const int mg = q / g.ngroups, ng = q - (q / g.ngroups) * g.ngroups;
  const int ph = computes ? phase / s : 0, pw = computes ? phase % s : 0;

  // the input-window byte offsets of this lane's A words (rows past the
  // phase's pixels read pixel 0 and are never stored)
  int aoff[WM][2];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      int r = (mg * WM + i) * 16 + gid + 8 * hf;
      if (r >= pix) r = 0;
      const int nn = r / (th * tw);
      const int rr = (r / tw) % th;
      const int cc = r % tw;
      aoff[i][hf] = ((nn * g.win_h + rr) * g.win_w + cc) * cs + 4 * tig;
    }
  }
  int acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
    }
  }

  // this rank's range of CI chunks
  const int n_ci = g.cip / g.t_ci;
  const int it0 = rank * n_ci / split;
  const int n_it = (rank + 1) * n_ci / split - it0;

  // Issue chunk `it` into stage `st`: every staged row one bulk copy counted
  // on the stage's mbarrier; input rows outside the real input zero-filled.
  auto issue = [&](int it, int st) {
    if (it >= n_it) return;
    if (tid == 0) mbar_arrive_expect(&s_bar[st], chunk_bytes);
    const int c0 = (it0 + it) * g.t_ci;
    unsigned char* xs = smem_i8 + st * g.stage_elems;
    unsigned char* ws = xs + g.x_elems;
    const int nx = g.t_n * eh * ew;
    for (int r = tid; r < nx; r += blockDim.x) {
      const int rest = div_ew.div(r);
      const int lc = r - rest * ew;
      const int nn = div_eh.div(rest);
      const int lr = rest - nn * eh;
      unsigned char* dst = xs + ((nn * g.win_h + lr) * g.win_w + lc) * cs;
      if (lr >= s_real[0] && lr < s_real[1] && lc >= s_real[2] && lc < s_real[3]) {
        const int gh = h0 + lo_h + lr, gw = w0 + lo_w + lc;
        bulk_copy(dst, x + ((((size_t)(n0 + nn) * g.ihp + gh) * g.iwp + gw) * g.cip) + c0,
                  g.t_ci, &s_bar[st]);
      } else {
        for (int j = 0; j < g.t_ci; j += 16)
          *reinterpret_cast<int4*>(dst + j) = make_int4(0, 0, 0, 0);
      }
    }
    // weight rows of the block's valid taps: (tap, channel) -> t_ci bytes
    for (int r = tid; r < n_slots * g.t_co; r += blockDim.x) {
      const int slot = div_co.div(r);
      const int co = r - slot * g.t_co;
      bulk_copy(ws + (slot * cols + co) * cs,
                w + ((size_t)s_wtap[slot] * g.cop + co0 + co) * g.cip + c0, g.t_ci,
                &s_bar[st]);
    }
  };

  // The mma loop of one staged chunk: the phase's valid taps, t_ci / 32
  // k-steps each, straight into the int32 accumulators.
  auto compute = [&](int st) {
    const unsigned char* xs = smem_i8 + st * g.stage_elems;
    const unsigned char* ws = xs + g.x_elems;
    const int n_taps_h = s_taps[ph], n_taps_w = s_taps[pw];
    for (int a = 0; a < n_taps_h; ++a) {
      if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
      const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
      const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      const int sh = __popc(kok_h & ((1u << kh) - 1u));
      for (int bb = 0; bb < n_taps_w; ++bb) {
        if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
        const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
        const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
        const int slot = sh * nw_ok + __popc(kok_w & ((1u << kw) - 1u));
        const unsigned char* xt = xs + ((dh - lo_h) * g.win_w + (dw - lo_w)) * cs;
        const unsigned char* wt = ws + (slot * cols + ng * WN * 8 + gid) * cs + 4 * tig;
        for (int k0 = 0; k0 < g.t_ci; k0 += 32) {
          uint32_t af[WM][4], bf[WN][2];
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            af[i][0] = lds32(xt + aoff[i][0] + k0);
            af[i][1] = lds32(xt + aoff[i][1] + k0);
            af[i][2] = lds32(xt + aoff[i][0] + k0 + 16);
            af[i][3] = lds32(xt + aoff[i][1] + k0 + 16);
          }
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            bf[j][0] = lds32(wt + j * 8 * cs + k0);
            bf[j][1] = lds32(wt + j * 8 * cs + k0 + 16);
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) mma_s8(acc[i][j], af[i], bf[j]);
          }
        }
      }
    }
  };

  const int ns = g.stages;
  for (int st = 0; st < ns - 1; ++st) issue(st, st);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ns;
    mbar_wait(&s_bar[st], (it / ns) & 1);  // the chunk's bulk copies
    __syncthreads();                       // and its zero fill; stage (it-1) % ns is free
    issue(it + ns - 1, (it + ns - 1) % ns);
    if (computes) compute(st);
  }

  // the requant epilogue of the sum at row r (of phase (ph_, pw_)) and
  // tile channel col: one disjoint write per element
  auto store = [&](int r, int ph_, int pw_, int col, int v) {
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    const int oh = oh_t * g.t_oh + rr * s + ph_;
    const int ow = ow_t * g.t_ow + cc * s + pw_;
    const size_t o = (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0 + col;
    // no contraction: the same roundings as the plain version
    float f = __fadd_rn(__fmul_rn(__int2float_rn(v), scale[co0 + col]), b[co0 + col]);
    f = activate(f, g.act);
    if constexpr (kRequant) {
      // round half to even, saturate at +-127
      static_cast<int8_t*>(y)[o] =
          (int8_t)fminf(fmaxf(rintf(__fdiv_rn(f, out_scale)), -127.0f), 127.0f);
    } else {
      static_cast<float*>(y)[o] = f;
    }
  };

  if (split == 1) {
    if (!computes) return;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          if (col < g.t_co) store(r, ph, pw, col, acc[i][j][2 * hf]);
          if (col + 1 < g.t_co) store(r, ph, pw, col + 1, acc[i][j][2 * hf + 1]);
        }
      }
    }
    return;
  }

  // Cluster split: the int32 partial tile, [phase][row][channel], in this
  // block's shared memory (the ring is drained), then slice `rank` summed
  // over the ranks in rank order through distributed shared memory.
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem_i8);
  if (computes) {
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
        int* prow = part + (phase * pix + r) * g.t_co;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          if (col < g.t_co) prow[col] = acc[i][j][2 * hf];
          if (col + 1 < g.t_co) prow[col + 1] = acc[i][j][2 * hf + 1];
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_el = s * s * pix * g.t_co;
  const int e_end = (rank + 1) * n_el / split;
  for (int e = rank * n_el / split + tid; e < e_end; e += blockDim.x) {
    int v = 0;
    for (int qr = 0; qr < split; ++qr) v += cluster.map_shared_rank(part, qr)[e];
    const int col = e % g.t_co;
    const int rest = e / g.t_co;
    const int phs = rest / pix;
    store(rest % pix, phs / s, phs % s, col, v);
  }
  cluster.sync();
}

// One tap's wgmma group of a consumer warpgroup: its t_ci / 16 k-steps'
// A fragments by ldmatrix into `fr` (one k16 step's x4 each; KS of them,
// which bounds t_ci at 16 * KS), then one wgmma a step on the tap's box at
// `wt`, committed as one group.  The caller alternates two fragment
// buffers, so the next tap's loads run while this group is in flight
// (wait_group 1 retires the one before).  A dead zero-skip tap issues
// nothing, and waits for the groups in flight, so that the buffer it
// would have filled is free.
template <int N, int KS>
__device__ __forceinline__ void wg_tap(float (&part)[N / 2], uint32_t (&fr)[KS][4], bool& fresh,
                                       unsigned xt, unsigned wt, int ksteps, bool live) {
  if (!live) {
    wg_wait<0>();
    return;
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (k < ksteps) ldsm_x4(fr[k], xt + 32u * (unsigned)k);
  }
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (k < ksteps) {
      wgmma_bf16<N>(part, fr[k], wg_desc(wt + (unsigned)(32 * N * k), 2 * N), fresh ? 0 : 1);
      fresh = false;
    }
  }
  wg_commit();
  wg_wait<1>();
}

// The bf16 kernels' wgmma path (design step 8): warpgroup 0 produces, the
// consumer warpgroups multiply.  Per CI chunk the producer waits for the
// stage to be released, then issues the window's real input rows as bulk
// copies (the rows outside the real input were zeroed once for every
// stage) and each live weight slot's boxes as TMA tensor copies, all
// counted on the stage's full barrier.  A consumer warpgroup owns WM m64
// tiles of the block, each one phase's 64 pixels by N output channels;
// per tap and k16 step its four warps gather their 16 rows by ldmatrix at
// the tap's window offset and issue one wgmma on the staged box, one group
// left in flight while the next fragments load.  The chunk's products go
// to a fresh partial (the first wgmma of the chunk does not accumulate)
// that is then added to the bias-initialised sums, as in design step 1.
template <bool kSparse, int WM, int WN>
__device__ __forceinline__ void bf16_wgmma_block(const uint16_t* __restrict__ x,
                                                 const uint16_t* __restrict__ b,
                                                 uint16_t* __restrict__ y, const Geometry& g,
                                                 const TapTable& taps, const Schedule& sched,
                                                 const CUtensorMap* tmap) {
  constexpr int N = WN * 8;
  // k16 steps a fragment buffer holds: a warpgroup whose sums take 128
  // floats a thread has room for one buffer of two (t_ci <= 32)
  constexpr int KS = WM * N > 64 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  __shared__ int s_taps[kTapWords];
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned s_kok[2];
  __shared__ int s_span[4];
  __shared__ int s_real[4];
  __shared__ short s_wtap[kMaxK * kMaxK];
  // zero-skip: per stage, the entry's CI tile (-1: none) and its tap bits
  __shared__ int s_ent[kMaxStages][1 + kMaxBitWords];
  // per stage: full when its copies have landed, empty when every
  // consumer warp is done with it
  __shared__ __align__(8) unsigned long long s_full[kMaxStages];
  __shared__ __align__(8) unsigned long long s_empty[kMaxStages];
  // per phase p, its valid taps s_pl_n[p] .. s_pl_n[p + 1] - 1: the tap's
  // input-window offset in elements and (weight slot | flat tap << 8)
  __shared__ int s_pl_n[kMaxStride * kMaxStride + 1];
  __shared__ int s_pl_x[kWgTaps];
  __shared__ int s_pl_st[kWgTaps];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTapWords; i += blockDim.x) s_taps[i] = taps.words[i];

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.pix;
  const int split = g.split;
  const int rank = blockIdx.x % split;
  int tile = blockIdx.x / split;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;
  // the ring starts at a swizzle atom (the host adds kWgAlign bytes); a
  // stage is the input window, then each weight slot's boxes
  const unsigned raw = smem_addr(smem_wg);
  const unsigned base = (raw + kWgAlign - 1) & ~(unsigned)(kWgAlign - 1);
  unsigned char* ring = smem_wg + (base - raw);
  const int stage_bytes = 2 * g.stage_elems;
  const int x_region = 2 * g.x_elems;
  const int box_bytes = g.t_ci * N * 2;

  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(&s_full[st], 1);
      mbar_init(&s_empty[st], 4 * g.wg_consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    block_taps(g, s_taps, h0, w0, s_tap_ok, s_kok, s_span, s_real, s_wtap);
    const unsigned kh_ok = s_kok[0], kw_ok = s_kok[1];
    const int nw = __popc(kw_ok);
    int n = 0;
    for (int p = 0; p < s * s; ++p) {
      const int ph = p / s, pw = p % s;
      s_pl_n[p] = n;
      for (int a = 0; a < s_taps[ph]; ++a) {
        if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
        const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
        const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
        const int sh = __popc(kh_ok & ((1u << kh) - 1u));
        for (int bb = 0; bb < s_taps[pw]; ++bb) {
          if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
          const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
          const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
          s_pl_x[n] = ((dh - s_span[0]) * g.win_w + (dw - s_span[2])) * g.cs;
          s_pl_st[n] = (sh * nw + __popc(kw_ok & ((1u << kw) - 1u))) | ((kh * g.k + kw) << 8);
          ++n;
        }
      }
    }
    s_pl_n[s * s] = n;
  }
  __syncthreads();

  const int lo_h = s_span[0], eh = s_span[1] - s_span[0];
  const int lo_w = s_span[2], ew = s_span[3] - s_span[2];
  const int cs = g.cs;
  // window rows outside the real input are zero in every stage: the copies
  // never write them
  const int nwin = g.t_n * eh * ew;
  for (int e = tid; e < g.stages * nwin; e += blockDim.x) {
    const int st = e / nwin;
    int r = e - st * nwin;
    const int lc = r % ew;
    r /= ew;
    const int lr = r % eh, nn = r / eh;
    if (lr >= s_real[0] && lr < s_real[1] && lc >= s_real[2] && lc < s_real[3]) continue;
    uint16_t* dst = reinterpret_cast<uint16_t*>(ring + st * stage_bytes) +
                    ((nn * g.win_h + lr) * g.win_w + lc) * cs;
    for (int j = 0; j < g.t_ci; j += 8) *reinterpret_cast<int4*>(dst + j) = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const unsigned kok_h = s_kok[0], kok_w = s_kok[1];
  const int nw_ok = __popc(kok_w);
  const int n_slots = __popc(kok_h) * nw_ok;
  // this rank's range of chunks (dense) or of the CO tile's entries
  const int n_ci = g.cip / g.t_ci;
  const int total = kSparse ? sched.count[co_t] : n_ci;
  const int it0 = rank * total / split;
  const int n_it = (rank + 1) * total / split - it0;
  const int ns = g.stages;

  if (tid < 128) {
    // ---- the producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs) : "memory");
    const int real_h = s_real[1] - s_real[0], real_w = s_real[3] - s_real[2];
    const int nx = g.t_n * real_h * real_w;
    const int x_bytes = nx * g.t_ci * 2;
    const int nboxes = n_slots * g.wg_ngroups;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ns;
      mbar_wait_bounded(&s_empty[st], ((it / ns) & 1) ^ 1);  // round 0 passes at once
      int ci_t = it0 + it;
      const unsigned* bits = nullptr;
      if constexpr (kSparse) {
        const int e = co_t * sched.len + it0 + it;
        ci_t = sched.ci[e];
        bits = sched.bits + (size_t)e * sched.nbw;
        if (ci_t < 0 || ci_t >= n_ci) ci_t = -1;
      }
      auto live = [&](int t) {
        if constexpr (kSparse) return ((__ldg(bits + (t >> 5)) >> (t & 31)) & 1u) != 0;
        return true;
      };
      if (tid == 0) {
        int bytes = 0;
        if (ci_t >= 0) {
          int n_live = n_slots;
          if constexpr (kSparse) {
            n_live = 0;
            for (int sl = 0; sl < n_slots; ++sl) n_live += live(s_wtap[sl]);
            s_ent[st][0] = ci_t;
            for (int j = 0; j < sched.nbw; ++j) s_ent[st][1 + j] = (int)bits[j];
          }
          bytes = x_bytes + n_live * g.wg_ngroups * box_bytes;
        } else if constexpr (kSparse) {
          s_ent[st][0] = -1;
        }
        mbar_arrive_expect(&s_full[st], bytes);
      }
      if (ci_t < 0) continue;
      const int c0 = ci_t * g.t_ci;
      unsigned char* xs = ring + st * stage_bytes;
      for (int r = tid; r < nx; r += 128) {
        const int lc = s_real[2] + r % real_w;
        const int rest = r / real_w;
        const int lr = s_real[0] + rest % real_h;
        const int nn = rest / real_h;
        uint16_t* dst =
            reinterpret_cast<uint16_t*>(xs) + ((nn * g.win_h + lr) * g.win_w + lc) * cs;
        const int gh = h0 + lo_h + lr, gw = w0 + lo_w + lc;
        bulk_copy(dst, x + ((((size_t)(n0 + nn) * g.ihp + gh) * g.iwp + gw) * g.cip) + c0,
                  g.t_ci * 2, &s_full[st]);
      }
      // weight boxes of the block's valid (zero-skip: and live) taps; a
      // dead tap's box is not issued
      for (int k = tid; k < nboxes; k += 128) {
        const int slot = k / g.wg_ngroups, ngr = k - slot * g.wg_ngroups;
        const int t = s_wtap[slot];
        if (!live(t)) continue;
        tma_load_2d(xs + x_region + k * box_bytes, tmap, co0 + ngr * N, t * g.cip + c0,
                    &s_full[st]);
      }
    }
    if (split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // ---- the consumer warpgroups ----
  // (the memory clobbers keep the sums' bias loads after the increase)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs) : "memory");
  const int ctid = tid - 128;
  const int cw = ctid >> 7;
  const int lane = tid & 31, wwg = (ctid >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  // the A rows this lane addresses for ldmatrix (as the mma.sync path's),
  // per m64 tile: row 16 * wwg + (lane % 8) + 8 * (lane / 8 % 2) of the
  // tile, channels 8 * (lane / 16) on
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  int t_ph[WM], t_mg[WM], t_ng[WM], aoff[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int ti = cw * WM + i;
    t_ng[i] = ti % g.wg_ngroups;
    const int r = ti / g.wg_ngroups;
    t_mg[i] = r % g.wg_mgroups;
    t_ph[i] = r / g.wg_mgroups;
    const int row = t_mg[i] * 64 + wwg * 16 + lrow;
    const int nn = row / (th * tw);
    const int rr = (row / tw) % th;
    const int cc = row % tw;
    aoff[i] = ((nn * g.win_h + rr) * g.win_w + cc) * cs + 8 * (lane >> 4);
  }
  const int ksteps = g.t_ci / 16;
  float acc[WM][N / 2], part[WM][N / 2];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int col = t_ng[i] * N + 8 * j + 2 * tig;
      const float b0 = split == 1 ? bf16_float(b[co0 + col]) : 0.0f;
      const float b1 = split == 1 ? bf16_float(b[co0 + col + 1]) : 0.0f;
      acc[i][4 * j] = b0;
      acc[i][4 * j + 1] = b1;
      acc[i][4 * j + 2] = b0;
      acc[i][4 * j + 3] = b1;
    }
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % ns;
    mbar_wait_bounded(&s_full[st], (it / ns) & 1);
    bool skip = false;
    if constexpr (kSparse) skip = s_ent[st][0] < 0;
    if (!skip) {
      const unsigned xs = base + (unsigned)(st * stage_bytes);
      const unsigned ws = xs + (unsigned)x_region;
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int e0 = s_pl_n[t_ph[i]], e1 = s_pl_n[t_ph[i] + 1];
        const unsigned xa = xs + 2u * (unsigned)aoff[i];
        const unsigned wb = ws + (unsigned)(t_ng[i] * box_bytes);
        bool fresh = true;  // the next wgmma starts the chunk's partial
        uint32_t fa[KS][4];
        auto live = [&](int e) {
          if constexpr (kSparse) {
            const int t = s_pl_st[e] >> 8;
            return (((unsigned)s_ent[st][1 + (t >> 5)] >> (t & 31)) & 1u) != 0;
          }
          return true;
        };
        auto box = [&](int e) {
          return wb + (unsigned)((s_pl_st[e] & 255) * g.wg_ngroups * box_bytes);
        };
        if constexpr (WM * N <= 64) {
          uint32_t fb[KS][4];
          for (int e = e0; e < e1; e += 2) {
            wg_tap<N, KS>(part[i], fa, fresh, xa + 2u * (unsigned)s_pl_x[e], box(e), ksteps,
                          live(e));
            if (e + 1 < e1)
              wg_tap<N, KS>(part[i], fb, fresh, xa + 2u * (unsigned)s_pl_x[e + 1], box(e + 1),
                            ksteps, live(e + 1));
          }
        } else {
          // sums of 128 floats a thread leave room for one fragment buffer:
          // each tap's group is retired before the next tap's loads
          for (int e = e0; e < e1; ++e) {
            wg_tap<N, KS>(part[i], fa, fresh, xa + 2u * (unsigned)s_pl_x[e], box(e), ksteps,
                          live(e));
            wg_wait<0>();
          }
        }
        wg_wait<0>();
        fence_regs(part[i]);
        if (!fresh) {
#pragma unroll
          for (int c = 0; c < N / 2; ++c) acc[i][c] += part[i][c];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s_empty[st]);
  }

  // output pixel of row r of a phase -> y row pointer
  auto out_row = [&](int r, int ph_, int pw_) {
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    const int oh = oh_t * g.t_oh + rr * s + ph_;
    const int ow = ow_t * g.t_ow + cc * s + pw_;
    return y + (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0;
  };

  if (split == 1) {
    // neighbouring channels leave as one bf16x2 word (t_co and COp even)
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = t_mg[i] * 64 + wwg * 16 + gid + 8 * hf;
        uint16_t* row = out_row(r, t_ph[i] / s, t_ph[i] % s);
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = t_ng[i] * N + 8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16x2(activate(acc[i][4 * j + 2 * hf], g.act),
                          activate(acc[i][4 * j + 2 * hf + 1], g.act));
        }
      }
    }
    return;
  }

  // Cluster split: every consumer is done with the ring (the producer's
  // copies have all landed), then the f32 partial tile, [phase][row]
  // [channel], in this block's ring, then the rank-ordered sum of slice
  // `rank` through distributed shared memory, as the mma.sync path's.
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * g.wg_consumers) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* partt = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = t_mg[i] * 64 + wwg * 16 + gid + 8 * hf;
      float* prow = partt + (t_ph[i] * pix + r) * g.t_co;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int col = t_ng[i] * N + 8 * j + 2 * tig;
        prow[col] = acc[i][4 * j + 2 * hf];
        prow[col + 1] = acc[i][4 * j + 2 * hf + 1];
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_el = s * s * pix * g.t_co;
  const int e_end = (rank + 1) * n_el / split;
  for (int e = rank * n_el / split + ctid; e < e_end; e += 128 * g.wg_consumers) {
    float v = 0.0f;
    for (int qr = 0; qr < split; ++qr) v += cluster.map_shared_rank(partt, qr)[e];
    const int col = e % g.t_co;
    const int rest = e / g.t_co;
    const int r = rest % pix;
    const int phs = rest / pix;
    out_row(r, phs / s, phs % s)[col] =
        (uint16_t)(pack_bf16x2(activate(v + bf16_float(b[co0 + col]), g.act), 0.0f) & 0xffffu);
  }
  cluster.sync();
}

// One tap's k8 steps on the fp32 wgmma path (design step 9): per step the
// warp's 16 rows of A by ldmatrix x4 from the window at `xs` (the byte
// offset `xt` of this lane's row at the tap, 32 bytes a step, under the
// window's swizzle), cut into hi and lo in registers as split_tf32 cuts
// them, then a_lo*b_hi, a_hi*b_lo and a_hi*b_hi on the tap's box at `wt`
// (its lo plane `lo` bytes on; a step 32 bytes along each K-major row of
// `rowbytes`), committed as one group.  As wg_tap: the caller alternates
// two fragment buffers, and one group stays in flight.
template <int N, int KS>
__device__ __forceinline__ void wg_tap_tf32(float (&part)[N / 2], uint32_t (&fh)[KS][4],
                                            uint32_t (&fl)[KS][4], bool& fresh, unsigned xs,
                                            unsigned xt, unsigned wt, unsigned lo, int rowbytes,
                                            int ksteps) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (k < ksteps) {
      uint32_t r[4];
      ldsm_x4(r, xs + swizzled(xt + 32u * (unsigned)k, rowbytes));
#pragma unroll
      for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(r[c]), fh[k][c], fl[k][c]);
    }
  }
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (k < ksteps) {
      const uint64_t bh = wg_desc_k(wt + 32u * (unsigned)k, rowbytes);
      const uint64_t bl = wg_desc_k(wt + lo + 32u * (unsigned)k, rowbytes);
      wgmma_tf32<N>(part, fl[k], bh, fresh ? 0 : 1);
      fresh = false;
      wgmma_tf32<N>(part, fh[k], bl, 1);
      wgmma_tf32<N>(part, fh[k], bh, 1);
    }
  }
  wg_commit();
  wg_wait<1>();
}

// The fp32 dense kernel's wgmma path (design step 9): bf16_wgmma_block's
// block on f32 and 3xTF32 wgmma.  Per CI chunk the producer's warp 0 waits
// for the stage to be released, then issues the block's input window as
// one 4-D TMA tensor copy (t_n images by win_h x win_w pixels by t_ci
// channels of the host-padded input, from the span's first row and column;
// rows past the input read zeros) and each weight slot's boxes (N output
// channels by t_ci input channels of the CI-minor weights) as 2-D ones,
// counted on the stage's full barrier; warps 1-3 wait for them, write the
// boxes' lo plane and arrive on the stage's ready barrier.  A consumer
// warpgroup owns WM m64 tiles of the block and, per tap, issues
// wg_tap_tf32's groups on the ready stage, then adds the chunk's fresh
// partial to the bias-initialised sums and releases the stage.
template <int WM, int WN>
__device__ __forceinline__ void f32_wgmma_block(const float* __restrict__ b,
                                                float* __restrict__ y, const Geometry& g,
                                                const TapTable& taps, const CUtensorMap* tmap,
                                                const CUtensorMap* xmap) {
  constexpr int N = WN * 8;
  // k8 steps a fragment buffer holds (hi and lo, 8 registers a step): a
  // warpgroup whose sums take 128 floats a thread takes t_ci 8
  constexpr int KS = WM * N > 64 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  __shared__ int s_taps[kTapWords];
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned s_kok[2];
  __shared__ int s_span[4];
  __shared__ int s_real[4];
  __shared__ short s_wtap[kMaxK * kMaxK];
  // per stage: full when its copies have landed, ready when its lo plane
  // is written, empty when every consumer warp is done with it
  __shared__ __align__(8) unsigned long long s_full[kMaxStages];
  __shared__ __align__(8) unsigned long long s_ready[kMaxStages];
  __shared__ __align__(8) unsigned long long s_empty[kMaxStages];
  // per phase p, its valid taps s_pl_n[p] .. s_pl_n[p + 1] - 1: the tap's
  // input-window offset in pixels and (weight slot | flat tap << 8)
  __shared__ int s_pl_n[kMaxStride * kMaxStride + 1];
  __shared__ int s_pl_x[kWgTaps];
  __shared__ int s_pl_st[kWgTaps];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTapWords; i += blockDim.x) s_taps[i] = taps.words[i];

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.pix;
  const int split = g.split;
  const int rank = blockIdx.x % split;
  int tile = blockIdx.x / split;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;
  // the ring starts at a swizzle atom (the host adds kWgAlign bytes); a
  // stage is the input window (a pixel's t_ci channels a swizzled row),
  // each weight slot's boxes, then their lo planes in the same order
  const unsigned raw = smem_addr(smem_wg);
  const unsigned base = (raw + kWgAlign - 1) & ~(unsigned)(kWgAlign - 1);
  unsigned char* ring = smem_wg + (base - raw);
  const int stage_bytes = 4 * g.stage_elems;
  const int x_region = 4 * g.x_elems;
  const int rowbytes = 4 * g.t_ci;
  const int box_bytes = rowbytes * N;
  const int lo_off = g.slots * g.wg_ngroups * box_bytes;

  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(&s_full[st], 1);
      mbar_init(&s_ready[st], 3);
      mbar_init(&s_empty[st], 4 * g.wg_consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    block_taps(g, s_taps, h0, w0, s_tap_ok, s_kok, s_span, s_real, s_wtap);
    const unsigned kh_ok = s_kok[0], kw_ok = s_kok[1];
    const int nw = __popc(kw_ok);
    int n = 0;
    for (int p = 0; p < s * s; ++p) {
      const int ph = p / s, pw = p % s;
      s_pl_n[p] = n;
      for (int a = 0; a < s_taps[ph]; ++a) {
        if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
        const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
        const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
        const int sh = __popc(kh_ok & ((1u << kh) - 1u));
        for (int bb = 0; bb < s_taps[pw]; ++bb) {
          if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
          const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
          const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
          s_pl_x[n] = (dh - s_span[0]) * g.win_w + (dw - s_span[2]);
          s_pl_st[n] = (sh * nw + __popc(kw_ok & ((1u << kw) - 1u))) | ((kh * g.k + kw) << 8);
          ++n;
        }
      }
    }
    s_pl_n[s * s] = n;
  }
  __syncthreads();

  const int n_slots = __popc(s_kok[0]) * __popc(s_kok[1]);
  // this rank's range of chunks
  const int n_ci = g.cip / g.t_ci;
  const int it0 = rank * n_ci / split;
  const int n_it = (rank + 1) * n_ci / split - it0;
  const int ns = g.stages;

  if (tid < 128) {
    // ---- the producer warpgroup: warp 0 copies, warps 1-3 write lo ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs) : "memory");
    const int nboxes = n_slots * g.wg_ngroups;
    if (tid < 32) {
      // the copies, up to `stages` chunks ahead of the consumers
      const int bytes = g.t_n * g.win_h * g.win_w * rowbytes + nboxes * box_bytes;
      const int wh0 = h0 + s_span[0], ww0 = w0 + s_span[2];
      for (int it = 0; it < n_it; ++it) {
        const int st = it % ns;
        mbar_wait_bounded(&s_empty[st], ((it / ns) & 1) ^ 1);  // round 0 passes at once
        const int c0 = (it0 + it) * g.t_ci;
        unsigned char* xs = ring + st * stage_bytes;
        if (tid == 0) {
          mbar_arrive_expect(&s_full[st], bytes);
          tma_load_4d(xs, xmap, c0, ww0, wh0, n0, &s_full[st]);
        }
        __syncwarp();
        // the boxes of the block's valid taps: the CI-minor weights as
        // rows (tap, output channel) of CIp channels
        for (int k = tid; k < nboxes; k += 32) {
          const int slot = k / g.wg_ngroups, ngr = k - slot * g.wg_ngroups;
          tma_load_2d(xs + x_region + k * box_bytes, tmap, c0,
                      s_wtap[slot] * g.cop + co0 + ngr * N, &s_full[st]);
        }
      }
    } else {
      // each chunk's lo plane, once its copies have landed: v - (v cut to
      // TF32) per staged weight, fenced for the async proxy, then the
      // stage is ready
      const int nvec = nboxes * box_bytes / 16;
      for (int j = 0; j < n_it; ++j) {
        const int st = j % ns;
        mbar_wait_bounded(&s_full[st], (j / ns) & 1);
        const float4* hi = reinterpret_cast<const float4*>(ring + st * stage_bytes + x_region);
        float4* lo = reinterpret_cast<float4*>(ring + st * stage_bytes + x_region + lo_off);
#pragma unroll 4
        for (int v = tid - 32; v < nvec; v += 96) {
          const float4 a = hi[v];
          lo[v] = make_float4(tf32_lo(a.x), tf32_lo(a.y), tf32_lo(a.z), tf32_lo(a.w));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&s_ready[st]);
      }
    }
    if (split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // ---- the consumer warpgroups ----
  // (the memory clobbers keep the sums' bias loads after the increase)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs) : "memory");
  const int ctid = tid - 128;
  const int cw = ctid >> 7;
  const int lane = tid & 31, wwg = (ctid >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  // the A rows this lane addresses for ldmatrix, per m64 tile: row 16 *
  // wwg + (lane % 8) + 8 * (lane / 8 % 2) of the tile, words 4 * (lane /
  // 16) on (a word is two b16 halves to ldmatrix): its window pixel and
  // the byte in that pixel's row
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lbyte = 16 * (lane >> 4);
  int t_ph[WM], t_mg[WM], t_ng[WM], apix[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int ti = cw * WM + i;
    t_ng[i] = ti % g.wg_ngroups;
    const int r = ti / g.wg_ngroups;
    t_mg[i] = r % g.wg_mgroups;
    t_ph[i] = r / g.wg_mgroups;
    const int row = t_mg[i] * 64 + wwg * 16 + lrow;
    const int nn = row / (th * tw);
    const int rr = (row / tw) % th;
    const int cc = row % tw;
    apix[i] = (nn * g.win_h + rr) * g.win_w + cc;
  }
  const int ksteps = g.t_ci / 8;
  float acc[WM][N / 2], part[WM][N / 2];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int col = t_ng[i] * N + 8 * j + 2 * tig;
      const float b0 = split == 1 ? b[co0 + col] : 0.0f;
      const float b1 = split == 1 ? b[co0 + col + 1] : 0.0f;
      acc[i][4 * j] = b0;
      acc[i][4 * j + 1] = b1;
      acc[i][4 * j + 2] = b0;
      acc[i][4 * j + 3] = b1;
    }
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % ns;
    mbar_wait_bounded(&s_ready[st], (it / ns) & 1);
    const unsigned xs = base + (unsigned)(st * stage_bytes);
    const unsigned ws = xs + (unsigned)x_region;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      const int e0 = s_pl_n[t_ph[i]], e1 = s_pl_n[t_ph[i] + 1];
      const unsigned wb = ws + (unsigned)(t_ng[i] * box_bytes);
      bool fresh = true;  // the next wgmma starts the chunk's partial
      uint32_t fah[KS][4], fal[KS][4], fbh[KS][4], fbl[KS][4];
      auto xrow = [&](int e) { return (unsigned)((apix[i] + s_pl_x[e]) * rowbytes + lbyte); };
      auto box = [&](int e) {
        return wb + (unsigned)((s_pl_st[e] & 255) * g.wg_ngroups * box_bytes);
      };
      for (int e = e0; e < e1; e += 2) {
        wg_tap_tf32<N, KS>(part[i], fah, fal, fresh, xs, xrow(e), box(e), (unsigned)lo_off,
                           rowbytes, ksteps);
        if (e + 1 < e1)
          wg_tap_tf32<N, KS>(part[i], fbh, fbl, fresh, xs, xrow(e + 1), box(e + 1),
                             (unsigned)lo_off, rowbytes, ksteps);
      }
      wg_wait<0>();
      fence_regs(part[i]);
      if (!fresh) {
#pragma unroll
        for (int c = 0; c < N / 2; ++c) acc[i][c] += part[i][c];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s_empty[st]);
  }

  // output pixel of row r of a phase -> y row pointer
  auto out_row = [&](int r, int ph_, int pw_) {
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    const int oh = oh_t * g.t_oh + rr * s + ph_;
    const int ow = ow_t * g.t_ow + cc * s + pw_;
    return y + (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0;
  };

  if (split == 1) {
    // neighbouring channels leave as one 8-byte store (t_co and COp even)
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = t_mg[i] * 64 + wwg * 16 + gid + 8 * hf;
        float* row = out_row(r, t_ph[i] / s, t_ph[i] % s);
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = t_ng[i] * N + 8 * j + 2 * tig;
          *reinterpret_cast<float2*>(row + col) =
              make_float2(activate(acc[i][4 * j + 2 * hf], g.act),
                          activate(acc[i][4 * j + 2 * hf + 1], g.act));
        }
      }
    }
    return;
  }

  // Cluster split: every consumer is done with the ring (the producer's
  // copies have all landed), then the partial tile, [phase][row][channel],
  // in this block's ring, then the rank-ordered sum of slice `rank`
  // through distributed shared memory, as the mma.sync path's.
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * g.wg_consumers) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* partt = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = t_mg[i] * 64 + wwg * 16 + gid + 8 * hf;
      float* prow = partt + (t_ph[i] * pix + r) * g.t_co;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int col = t_ng[i] * N + 8 * j + 2 * tig;
        prow[col] = acc[i][4 * j + 2 * hf];
        prow[col + 1] = acc[i][4 * j + 2 * hf + 1];
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_el = s * s * pix * g.t_co;
  const int e_end = (rank + 1) * n_el / split;
  for (int e = rank * n_el / split + ctid; e < e_end; e += 128 * g.wg_consumers) {
    float v = 0.0f;
    for (int qr = 0; qr < split; ++qr) v += cluster.map_shared_rank(partt, qr)[e];
    const int col = e % g.t_co;
    const int rest = e / g.t_co;
    const int r = rest % pix;
    const int phs = rest / pix;
    out_row(r, phs / s, phs % s)[col] = activate(v + b[co0 + col], g.act);
  }
  cluster.sync();
}

// The bf16 dense and zero-skip kernels: two paths of one template.  kWg
// (design step 8): a producer warpgroup and wgmma consumer warpgroups,
// where every phase tile is whole m64 tiles and t_co 32, 64 or 128
// (`Geometry::wg`, tiling.py's `bf16_wgmma_tile`).  Else (design step 7):
// the fp32 kernel's block, warp grid, tap table, ring, zero-skip walk and
// cluster split, on bf16 rows, ldmatrix fragments and bf16 mma.sync.
template <bool kSparse, bool kWg, int WM, int WN>
__global__ void __launch_bounds__(kWg ? kWgThreads : kMaxThreads, 1) deconv2d_tc_bf16_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    const uint16_t* __restrict__ b, uint16_t* __restrict__ y, Geometry g, TapTable taps,
    Schedule sched, const __grid_constant__ CUtensorMap tmap) {
  if constexpr (kWg) {
    bf16_wgmma_block<kSparse, WM, WN>(x, b, y, g, taps, sched, &tmap);
  } else {
  extern __shared__ __align__(16) uint16_t smem_bf[];
  __shared__ int s_taps[kTapWords];
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned s_kok[2];
  __shared__ int s_span[4];
  __shared__ int s_real[4];
  __shared__ short s_wtap[kMaxK * kMaxK];
  // zero-skip: per stage, the entry's CI tile (-1: none) and its tap bits
  __shared__ int s_ent[kMaxStages][1 + kMaxBitWords];
  __shared__ __align__(8) unsigned long long s_bar[kMaxStages];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTapWords; i += blockDim.x) s_taps[i] = taps.words[i];

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.pix;

  // block -> (output tile, rank in the cluster)
  const int split = g.split;
  const int rank = blockIdx.x % split;
  int tile = blockIdx.x / split;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;

  // the weight rows' padding columns stay zero: the copies never write them
  for (int st = 0; st < g.stages; ++st) {
    uint16_t* ws = smem_bf + st * g.stage_elems + g.x_elems;
    const int pad = g.ws - g.t_co;
    for (int e = tid; e < g.slots * g.t_ci * pad; e += blockDim.x)
      ws[(e / pad) * g.ws + g.t_co + e % pad] = 0;
  }
  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) mbar_init(&s_bar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) block_taps(g, s_taps, h0, w0, s_tap_ok, s_kok, s_span, s_real, s_wtap);
  __syncthreads();

  const unsigned kok_h = s_kok[0], kok_w = s_kok[1];
  const int nw_ok = __popc(kok_w);
  const int n_slots = __popc(kok_h) * nw_ok;
  const int lo_h = s_span[0], eh = s_span[1] - s_span[0];
  const int lo_w = s_span[2], ew = s_span[3] - s_span[2];
  const int cs = g.cs, wst = g.ws;
  FastDiv div_ew, div_eh, div_ci;
  div_ew.init(ew);
  div_eh.init(eh);
  div_ci.init(g.t_ci);
  // bytes one chunk's input rows bring: the real rows of the span
  const int x_bytes =
      g.t_n * (s_real[1] - s_real[0]) * (s_real[3] - s_real[2]) * g.t_ci * 2;

  // warp -> (phase, row group, column group); warps past the last phase
  // only stage
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int per_phase = g.mgroups * g.ngroups;
  const int phase = warp / per_phase;
  const bool computes = phase < s * s;
  const int q = warp - phase * per_phase;
  const int mg = q / g.ngroups, ng = q - (q / g.ngroups) * g.ngroups;
  const int ph = computes ? phase / s : 0, pw = computes ? phase % s : 0;

  // The rows this lane addresses for ldmatrix, in elements.  A, per m16
  // tile: row (lane % 8) + 8 * (lane / 8 % 2), channels 8 * (lane / 16) on,
  // in the input window (rows past the phase's pixels read pixel 0 and are
  // never stored).  B, per pair of n8 tiles: k-row (lane % 8) + 8 * (lane /
  // 8 % 2) of the chunk, the n8 tile lane / 16 of the pair (one tile: x2,
  // lanes 0..15).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  int aoff[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    int r = (mg * WM + i) * 16 + lrow;
    if (r >= pix) r = 0;
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    aoff[i] = ((nn * g.win_h + rr) * g.win_w + cc) * cs + 8 * (lane >> 4);
  }
  const int boff = lrow * wst + (ng * WN + (WN > 1 ? lane >> 4 : 0)) * 8;
  // accumulators, from the bias unless a cluster split adds it after the sum
  float acc[WM][WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    const int col = (ng * WN + j) * 8 + 2 * tig;
    const float b0 = (split == 1 && col < g.t_co) ? bf16_float(b[co0 + col]) : 0.0f;
    const float b1 = (split == 1 && col + 1 < g.t_co) ? bf16_float(b[co0 + col + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      acc[i][j][0] = b0;
      acc[i][j][1] = b1;
      acc[i][j][2] = b0;
      acc[i][j][3] = b1;
    }
  }

  // this rank's range of chunks (dense) or of the CO tile's entries
  const int n_ci = g.cip / g.t_ci;
  const int total = kSparse ? sched.count[co_t] : n_ci;
  const int it0 = rank * total / split;
  const int n_it = (rank + 1) * total / split - it0;

  // Issue chunk `it` into stage `st`: input rows and (wide) weight rows as
  // bulk copies counted on the stage's mbarrier; thin weight rows by plain
  // loads and stores, which the barrier before the chunk's mma orders.
  auto issue = [&](int it, int st) {
    if (it >= n_it) return;
    int ci_t = it0 + it;
    const unsigned* bits = nullptr;
    if constexpr (kSparse) {
      const int e = co_t * sched.len + it0 + it;
      ci_t = sched.ci[e];
      bits = sched.bits + (size_t)e * sched.nbw;
      if (ci_t < 0 || ci_t >= n_ci) ci_t = -1;
    }
    auto live = [&](int t) {
      if constexpr (kSparse) return ((__ldg(bits + (t >> 5)) >> (t & 31)) & 1u) != 0;
      return true;
    };
    if (tid == 0) {
      int bytes = 0;
      if (ci_t >= 0) {
        int n_live = n_slots;
        if constexpr (kSparse) {
          n_live = 0;
          for (int sl = 0; sl < n_slots; ++sl) n_live += live(s_wtap[sl]);
          s_ent[st][0] = ci_t;
          for (int j = 0; j < sched.nbw; ++j) s_ent[st][1 + j] = (int)bits[j];
        }
        bytes = x_bytes + (g.w_vec4 ? n_live * g.t_ci * g.t_co * 2 : 0);
      } else if constexpr (kSparse) {
        s_ent[st][0] = -1;
      }
      mbar_arrive_expect(&s_bar[st], bytes);
    }
    if (ci_t < 0) return;
    const int c0 = ci_t * g.t_ci;
    uint16_t* xs = smem_bf + st * g.stage_elems;
    uint16_t* ws = xs + g.x_elems;
    // input window: one bulk copy per pixel row of t_ci channels; rows
    // outside the real input are zero-filled in place
    const int nx = g.t_n * eh * ew;
    for (int r = tid; r < nx; r += blockDim.x) {
      const int rest = div_ew.div(r);
      const int lc = r - rest * ew;
      const int nn = div_eh.div(rest);
      const int lr = rest - nn * eh;
      uint16_t* dst = xs + ((nn * g.win_h + lr) * g.win_w + lc) * cs;
      if (lr >= s_real[0] && lr < s_real[1] && lc >= s_real[2] && lc < s_real[3]) {
        const int gh = h0 + lo_h + lr, gw = w0 + lo_w + lc;
        bulk_copy(dst, x + ((((size_t)(n0 + nn) * g.ihp + gh) * g.iwp + gw) * g.cip) + c0,
                  g.t_ci * 2, &s_bar[st]);
      } else {
        for (int j = 0; j < g.t_ci; j += 8)
          *reinterpret_cast<int4*>(dst + j) = make_int4(0, 0, 0, 0);
      }
    }
    // weight rows of the block's valid (zero-skip: and live) taps
    const int nw = n_slots * g.t_ci;
    if (g.w_vec4) {
      for (int r = tid; r < nw; r += blockDim.x) {
        const int slot = div_ci.div(r);
        const int ci = r - slot * g.t_ci;
        const int t = s_wtap[slot];
        if (!live(t)) continue;
        bulk_copy(ws + r * wst, w + ((size_t)t * g.cip + c0 + ci) * g.cop + co0, g.t_co * 2,
                  &s_bar[st]);
      }
    } else {
      const int ne = nw * g.t_co;
      for (int e0 = tid; e0 < ne; e0 += 4 * blockDim.x) {
        uint16_t v[4];
        int dst[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * blockDim.x;
          dst[u] = -1;
          if (e >= ne) continue;
          const int r = e / g.t_co;
          const int c = e - r * g.t_co;
          const int slot = div_ci.div(r);
          const int ci = r - slot * g.t_ci;
          const int t = s_wtap[slot];
          if (!live(t)) continue;
          v[u] = __ldg(w + ((size_t)t * g.cip + c0 + ci) * g.cop + co0 + c);
          dst[u] = r * wst + c;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (dst[u] >= 0) ws[dst[u]] = v[u];
        }
      }
    }
  };

  // The mma loop of one staged chunk: the phase's valid (and live) taps,
  // t_ci / 16 k-steps each, summed in a fresh partial that is then added
  // to the accumulators (see the fp32 kernel's).
  const unsigned smem_base = smem_addr(smem_bf);
  auto compute = [&](int st) {
    if constexpr (kSparse) {
      if (s_ent[st][0] < 0) return;
    }
    const unsigned xs = smem_base + 2u * (unsigned)(st * g.stage_elems);
    const unsigned ws = xs + 2u * (unsigned)g.x_elems;
    float part[WM][WN][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.0f;
      }
    }
    const int n_taps_h = s_taps[ph], n_taps_w = s_taps[pw];
    for (int a = 0; a < n_taps_h; ++a) {
      if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
      const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
      const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      const int sh = __popc(kok_h & ((1u << kh) - 1u));
      for (int bb = 0; bb < n_taps_w; ++bb) {
        if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
        const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
        if constexpr (kSparse) {
          const int t = kh * g.k + kw;
          if (!(((unsigned)s_ent[st][1 + (t >> 5)] >> (t & 31)) & 1u)) continue;
        }
        const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
        const int slot = sh * nw_ok + __popc(kok_w & ((1u << kw) - 1u));
        const unsigned xt = xs + 2u * (unsigned)(((dh - lo_h) * g.win_w + (dw - lo_w)) * cs);
        const unsigned wt = ws + 2u * (unsigned)(slot * g.t_ci * wst + boff);
        for (int k0 = 0; k0 < g.t_ci; k0 += 16) {
          uint32_t af[WM][4], bf[WN][2];
#pragma unroll
          for (int i = 0; i < WM; ++i) ldsm_x4(af[i], xt + 2u * (unsigned)(aoff[i] + k0));
          if constexpr (WN == 1) {
            ldsm_x2_trans(bf[0], wt + 2u * (unsigned)(k0 * wst));
          } else {
#pragma unroll
            for (int pr = 0; pr < WN / 2; ++pr)
              ldsm_x4_trans(bf[2 * pr], bf[2 * pr + 1], wt + 2u * (unsigned)(k0 * wst + 16 * pr));
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) mma_bf16(part[i][j], af[i], bf[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
      }
    }
  };

  const int ns = g.stages;
  for (int st = 0; st < ns - 1; ++st) issue(st, st);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ns;
    mbar_wait(&s_bar[st], (it / ns) & 1);  // the chunk's bulk copies
    __syncthreads();                       // and its plain stores; stage (it-1) % ns is free
    issue(it + ns - 1, (it + ns - 1) % ns);
    if (computes) compute(st);
  }

  // output pixel of row r of this warp's phase -> y row pointer
  auto out_row = [&](int r, int ph_, int pw_) {
    const int nn = r / (th * tw);
    const int rr = (r / tw) % th;
    const int cc = r % tw;
    const int oh = oh_t * g.t_oh + rr * s + ph_;
    const int ow = ow_t * g.t_ow + cc * s + pw_;
    return y + (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0;
  };

  if (split == 1) {
    if (!computes) return;
    // neighbouring channels leave as one bf16x2 word where both are real
    // and the word is 4-byte aligned
    const bool pairs = g.cop % 2 == 0 && g.t_co % 2 == 0;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
        uint16_t* row = out_row(r, ph, pw);
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          const uint32_t v = pack_bf16x2(activate(acc[i][j][2 * hf], g.act),
                                         activate(acc[i][j][2 * hf + 1], g.act));
          if (pairs && col + 1 < g.t_co) {
            *reinterpret_cast<uint32_t*>(row + col) = v;
          } else {
            if (col < g.t_co) row[col] = (uint16_t)(v & 0xffffu);
            if (col + 1 < g.t_co) row[col + 1] = (uint16_t)(v >> 16);
          }
        }
      }
    }
    return;
  }

  // Cluster split: the f32 partial tile, [phase][row][channel], in this
  // block's shared memory (the ring is drained), then the rank-ordered sum
  // of slice `rank` through distributed shared memory.
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_bf);
  if (computes) {
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (mg * WM + i) * 16 + gid + 8 * hf;
        if (r >= pix) continue;
        float* prow = part + (phase * pix + r) * g.t_co;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int col = (ng * WN + j) * 8 + 2 * tig;
          if (col < g.t_co) prow[col] = acc[i][j][2 * hf];
          if (col + 1 < g.t_co) prow[col + 1] = acc[i][j][2 * hf + 1];
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_el = s * s * pix * g.t_co;
  const int e_end = (rank + 1) * n_el / split;
  for (int e = rank * n_el / split + tid; e < e_end; e += blockDim.x) {
    float v = 0.0f;
    for (int qr = 0; qr < split; ++qr) v += cluster.map_shared_rank(part, qr)[e];
    const int col = e % g.t_co;
    const int rest = e / g.t_co;
    const int r = rest % pix;
    const int phs = rest / pix;
    out_row(r, phs / s, phs % s)[col] =
        (uint16_t)(pack_bf16x2(activate(v + bf16_float(b[co0 + col]), g.act), 0.0f) & 0xffffu);
  }
  cluster.sync();
  }
}

struct Launch {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  Schedule sched;
};

// Launches `kern` over the geometry's grid, in clusters of g.split blocks,
// after raising its opt-in shared-memory limit once per device (`allowed`:
// a bit per device, one variable per kernel instance).
template <class... P, class... A>
int launch_clusters(void (*kern)(P...), std::atomic<unsigned>& allowed, const Geometry& g,
                    int threads, size_t smem, cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned bit = 1u << (dev & 31);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles_h * g.tiles_w * g.tiles_co * g.split, g.n / g.t_n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Refuses a wgmma instance (E_REGS) not compiled at kWgRegs a thread:
// setmaxnreg moves registers between the warpgroups of a block that holds
// kWgRegs a thread, and an instance compiled at fewer would wait forever
// for them.  `regs` caches the count, one variable per instance.
template <class K>
int check_wg_regs(K kern, std::atomic<int>& regs) {
  if (regs.load() < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    regs.store(fa.numRegs);
  }
  return regs.load() == kWgRegs ? 0 : E_REGS;
}

template <bool kSparse, bool kWg, int WM, int WN>
int launch(const Launch& a, const Geometry& g, const TapTable& taps, int threads, size_t smem,
           cudaStream_t stream, const CUtensorMap& tmap, const CUtensorMap& xmap) {
  static std::atomic<unsigned> allowed{0};
  auto kern = deconv2d_tc_kernel<kSparse, kWg, WM, WN>;
  if constexpr (kWg) {
    static std::atomic<int> regs{-1};
    if (const int e = check_wg_regs(kern, regs)) return e;
  }
  MapsOf<kWg> maps;
  if constexpr (kWg) maps = TensorMaps{tmap, xmap};
  return launch_clusters(kern, allowed, g, threads, smem, stream, a.x, a.w, a.b, a.y, g, taps,
                         a.sched, maps);
}

template <bool kSparse>
int dispatch(const Launch& a, const Geometry& g, const TapTable& taps, int threads, size_t smem,
             cudaStream_t stream, const CUtensorMap& tmap, const CUtensorMap& xmap) {
  if constexpr (!kSparse) {
    if (g.wg) {
#define DECONV_TC_WG_CASE(WM_, WN_)           \
  if (g.wg_wm == WM_ && g.wg_n == 8 * (WN_)) \
    return launch<false, true, WM_, WN_>(a, g, taps, threads, smem, stream, tmap, xmap);
      DECONV_TC_WG_CASE(1, 8)
      DECONV_TC_WG_CASE(2, 8)
#undef DECONV_TC_WG_CASE
      return E_REGTILE;
    }
  }
#define DECONV_TC_CASE(WM_, WN_) \
  if (g.wm == WM_ && g.wn == WN_)  \
    return launch<kSparse, false, WM_, WN_>(a, g, taps, threads, smem, stream, tmap, xmap);
  DECONV_TC_CASE(2, 4)
  DECONV_TC_CASE(2, 2)
  DECONV_TC_CASE(2, 1)
  DECONV_TC_CASE(1, 4)
  DECONV_TC_CASE(1, 2)
  DECONV_TC_CASE(1, 1)
#undef DECONV_TC_CASE
  return E_REGTILE;
}

struct LaunchBf16 {
  const uint16_t* x;
  const uint16_t* w;
  const uint16_t* b;
  uint16_t* y;
  Schedule sched;
};

template <bool kSparse, bool kWg, int WM, int WN>
int launch_bf16(const LaunchBf16& a, const Geometry& g, const TapTable& taps, int threads,
                size_t smem, cudaStream_t stream, const CUtensorMap& tmap) {
  static std::atomic<unsigned> allowed{0};
  auto kern = deconv2d_tc_bf16_kernel<kSparse, kWg, WM, WN>;
  if constexpr (kWg) {
    static std::atomic<int> regs{-1};
    if (const int e = check_wg_regs(kern, regs)) return e;
  }
  return launch_clusters(kern, allowed, g, threads, smem, stream, a.x, a.w, a.b, a.y, g, taps,
                         a.sched, tmap);
}

template <bool kSparse>
int dispatch_bf16(const LaunchBf16& a, const Geometry& g, const TapTable& taps, int threads,
                  size_t smem, cudaStream_t stream, const CUtensorMap& tmap) {
  if (g.wg) {
#define DECONV_TC_WG_CASE(WM_, WN_)              \
  if (g.wg_wm == WM_ && g.wg_n == 8 * (WN_))     \
    return launch_bf16<kSparse, true, WM_, WN_>(a, g, taps, threads, smem, stream, tmap);
    DECONV_TC_WG_CASE(1, 4)
    DECONV_TC_WG_CASE(1, 8)
    DECONV_TC_WG_CASE(2, 4)
    DECONV_TC_WG_CASE(2, 8)
#undef DECONV_TC_WG_CASE
    return E_REGTILE;
  }
#define DECONV_TC_BF16_CASE(WM_, WN_) \
  if (g.wm == WM_ && g.wn == WN_)     \
    return launch_bf16<kSparse, false, WM_, WN_>(a, g, taps, threads, smem, stream, tmap);
  DECONV_TC_BF16_CASE(2, 4)
  DECONV_TC_BF16_CASE(2, 2)
  DECONV_TC_BF16_CASE(2, 1)
  DECONV_TC_BF16_CASE(1, 4)
  DECONV_TC_BF16_CASE(1, 2)
  DECONV_TC_BF16_CASE(1, 1)
#undef DECONV_TC_BF16_CASE
  return E_REGTILE;
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library needs no link against the driver library.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  static int err = 0;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) err = (int)e;
    else if (q != cudaDriverEntryPointSuccess || p == nullptr) err = E_TMAP;
    else fn = reinterpret_cast<EncodeTiled>(p);
  });
  *out = fn;
  return err;
}

// The wgmma paths' weight map.  bf16 (design step 8): the weights (K, K,
// CIp, COp) as K*K*CIp rows of COp channels, a box t_ci rows by N channels
// in N*2 bytes' swizzle.  fp32 (step 9): the CI-minor weights (K, K, COp,
// CIp) as K*K*COp rows of CIp channels, a box N rows by t_ci channels in
// t_ci*4 bytes' swizzle.  Both are the B descriptor's layouts.  Encoded on
// the host once per weight (pointer and shape: the map is a function of
// them alone) and kept, so that a static weight's launches, and a graph
// that captured one, pass the same map by value.
int weight_map(const void* w, const Geometry& g, bool f32, CUtensorMap* out) {
  struct Key {
    const void* w;
    int rows, cols, box_rows, box_cols, f32;
  };
  constexpr int kKept = 64;
  static std::mutex mu;
  static Key keys[kKept];
  static CUtensorMap maps[kKept];
  static int kept = 0, next = 0;
  Key k;
  std::memset(&k, 0, sizeof k);
  k.w = w;
  k.f32 = f32;
  k.rows = g.k * g.k * (f32 ? g.cop : g.cip);
  k.cols = f32 ? g.cip : g.cop;
  k.box_rows = f32 ? g.wg_n : g.t_ci;
  k.box_cols = f32 ? g.t_ci : g.wg_n;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < kept; ++i) {
    if (std::memcmp(&keys[i], &k, sizeof k) == 0) {
      *out = maps[i];
      return 0;
    }
  }
  EncodeTiled encode;
  if (const int e = encode_tiled(&encode)) return e;
  const int elem = f32 ? 4 : 2;
  const int rowbytes = k.box_cols * elem;
  const cuuint64_t dims[2] = {(cuuint64_t)k.cols, (cuuint64_t)k.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k.cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)k.box_cols, (cuuint32_t)k.box_rows};
  const cuuint32_t elems[2] = {1, 1};
  CUtensorMap m;
  if (encode(&m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(w), dims, strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
             rowbytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
             : rowbytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return E_TMAP;
  const int i = kept < kKept ? kept++ : next++ % kKept;
  keys[i] = k;
  maps[i] = m;
  *out = m;
  return 0;
}

// The fp32 wgmma path's input map (design step 9): the host-padded input
// (N, IHp, IWp, CIp) as a 4-D tensor, a box of t_n images by win_h x
// win_w pixels by t_ci channels, a pixel's channels a row of t_ci * 4
// bytes in that many bytes' swizzle.  Encoded per input pointer and shape
// and kept as weight_map keeps its maps (a serving graph's input buffer
// is static, so its launches find theirs).
int input_map(const void* x, const Geometry& g, CUtensorMap* out) {
  struct Key {
    const void* x;
    int n, ihp, iwp, cip, t_ci, win_w, win_h, t_n;
  };
  constexpr int kKept = 64;
  static std::mutex mu;
  static Key keys[kKept];
  static CUtensorMap maps[kKept];
  static int kept = 0, next = 0;
  Key k;
  std::memset(&k, 0, sizeof k);
  k.x = x;
  k.n = g.n;
  k.ihp = g.ihp;
  k.iwp = g.iwp;
  k.cip = g.cip;
  k.t_ci = g.t_ci;
  k.win_w = g.win_w;
  k.win_h = g.win_h;
  k.t_n = g.t_n;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < kept; ++i) {
    if (std::memcmp(&keys[i], &k, sizeof k) == 0) {
      *out = maps[i];
      return 0;
    }
  }
  EncodeTiled encode;
  if (const int e = encode_tiled(&encode)) return e;
  const int rowbytes = 4 * g.t_ci;
  const cuuint64_t dims[4] = {(cuuint64_t)g.cip, (cuuint64_t)g.iwp, (cuuint64_t)g.ihp,
                              (cuuint64_t)g.n};
  const cuuint64_t strides[3] = {(cuuint64_t)g.cip * 4, (cuuint64_t)g.iwp * g.cip * 4,
                                 (cuuint64_t)g.ihp * g.iwp * g.cip * 4};
  const cuuint32_t box[4] = {(cuuint32_t)g.t_ci, (cuuint32_t)g.win_w, (cuuint32_t)g.win_h,
                             (cuuint32_t)g.t_n};
  const cuuint32_t elems[4] = {1, 1, 1, 1};
  CUtensorMap m;
  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
             elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
             rowbytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
             : rowbytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return E_TMAP;
  const int i = kept < kKept ? kept++ : next++ % kKept;
  keys[i] = k;
  maps[i] = m;
  *out = m;
  return 0;
}

struct LaunchInt8 {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* b;
  void* y;
  float out_scale;
};

template <bool kRequant, int WM, int WN>
int launch_int8(const LaunchInt8& a, const Geometry& g, const TapTable& taps, int threads,
                size_t smem, cudaStream_t stream) {
  static std::atomic<unsigned> allowed{0};
  return launch_clusters(deconv2d_tc_int8_kernel<kRequant, WM, WN>, allowed, g, threads, smem,
                         stream, a.x, a.w, a.scale, a.b, a.y, g, taps, a.out_scale);
}

template <bool kRequant>
int dispatch_int8(const LaunchInt8& a, const Geometry& g, const TapTable& taps, int threads,
                  size_t smem, cudaStream_t stream) {
#define DECONV_TC_INT8_CASE(WM_, WN_) \
  if (g.wm == WM_ && g.wn == WN_)     \
    return launch_int8<kRequant, WM_, WN_>(a, g, taps, threads, smem, stream);
  DECONV_TC_INT8_CASE(2, 4)
  DECONV_TC_INT8_CASE(2, 2)
  DECONV_TC_INT8_CASE(2, 1)
  DECONV_TC_INT8_CASE(1, 4)
  DECONV_TC_INT8_CASE(1, 2)
  DECONV_TC_INT8_CASE(1, 1)
#undef DECONV_TC_INT8_CASE
  return E_REGTILE;
}

// Per dim: the most input rows any block stages and the most kernel taps
// that read real input in any block (repro_torch/core/tiling.py's
// `staged_window`, which sizes the host's shared-memory model).
void window(const int* words, int s, int in_size, int pad_l, int tiles, int step, int base,
            int* rows, int* ntaps) {
  *rows = *ntaps = 0;
  for (int j = 0; j < tiles; ++j) {
    const int o0 = j * step + base;
    int lo = 1 << 30, hi = -(1 << 30), n = 0;
    for (int ph = 0; ph < s; ++ph) {
      for (int a = 0; a < words[ph]; ++a) {
        const int d = words[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
        if (o0 + d < pad_l + in_size && o0 + d + step > pad_l) {
          lo = d < lo ? d : lo;
          hi = d + step > hi ? d + step : hi;
          ++n;
        }
      }
    }
    if (n) {
      *rows = hi - lo > *rows ? hi - lo : *rows;
      *ntaps = n > *ntaps ? n : *ntaps;
    }
  }
}

// Reads and checks the parameter array and derives the launch's layout;
// 0 or an ArgError.
int setup(const int* p, Geometry* gp, TapTable* taps, int* threads, long long* smem) {
  Geometry& g = *gp;
  g.n = p[P_N]; g.ihp = p[P_IHP]; g.iwp = p[P_IWP]; g.cip = p[P_CIP]; g.k = p[P_K];
  g.cop = p[P_COP]; g.ohp = p[P_OHP]; g.owp = p[P_OWP]; g.s = p[P_S];
  g.t_n = p[P_TN]; g.t_oh = p[P_TOH]; g.t_ow = p[P_TOW]; g.t_ci = p[P_TCI]; g.t_co = p[P_TCO];
  g.base_h = p[P_BASE_H]; g.base_w = p[P_BASE_W];
  g.act = p[P_ACT];
  g.ih = p[P_IH]; g.iw = p[P_IW]; g.pad_l = p[P_PAD_L];
  g.split = p[P_SPLIT];
  const int dtype = p[P_DTYPE];
  if (dtype != D_F32 && dtype != D_BF16 && dtype != D_INT8) return E_ARGS;
  if (p[P_SPARSE] != 0 && p[P_SPARSE] != 1) return E_ARGS;
  g.int8 = dtype == D_INT8;
  const bool bf16 = dtype == D_BF16;
  const bool f32 = dtype == D_F32;
  if (g.ih < 1 || g.iw < 1 || g.pad_l < 0 || g.pad_l + g.ih > g.ihp || g.pad_l + g.iw > g.iwp)
    return E_ARGS;
  if (g.s < 1 || g.s > kMaxStride || g.k < 1 || g.k > kMaxK || g.t_n < 1 || g.t_ci < 8 ||
      g.t_ci % (g.int8 ? 32 : bf16 ? 16 : 8) || g.t_co < 1 || g.t_oh < g.s || g.t_ow < g.s ||
      g.t_oh % g.s || g.t_ow % g.s || g.n % g.t_n || g.cip % g.t_ci || g.cop % g.t_co || g.ohp % g.t_oh ||
      g.owp % g.t_ow || g.act < 0 || g.act > 2)
    return E_ARGS;
  g.tiles_h = g.ohp / g.t_oh;
  g.tiles_w = g.owp / g.t_ow;
  g.tiles_co = g.cop / g.t_co;
  if (g.split < 1 || g.split > kMaxSplit || g.split > g.cip / g.t_ci) return E_ARGS;
  // every halo window must lie inside the host-padded input
  const int t_ih = p[P_TIH], t_iw = p[P_TIW];
  if (g.base_h < 0 || g.base_w < 0 ||
      (g.tiles_h - 1) * (g.t_oh / g.s) + g.base_h + t_ih > g.ihp ||
      (g.tiles_w - 1) * (g.t_ow / g.s) + g.base_w + t_iw > g.iwp)
    return E_ARGS;
  for (int i = 0; i < kTapWords; ++i) taps->words[i] = p[P_TAPS + i];
  int most_taps = 0;
  for (int ph = 0; ph < g.s; ++ph) {
    const int cnt = taps->words[ph];
    if (cnt < 0 || cnt > kMaxTaps) return E_ARGS;
    most_taps = cnt > most_taps ? cnt : most_taps;
    for (int a = 0; a < cnt; ++a) {
      const int k = taps->words[kMaxStride + ph * kMaxTaps + a];
      const int d = taps->words[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      if (k < 0 || k >= g.k || d < 0 || d + g.t_oh / g.s > t_ih || d + g.t_ow / g.s > t_iw)
        return E_ARGS;
    }
  }
  // warp grid (repro_torch/core/tiling.py: tc_warp_tile, block_threads)
  g.pix = g.t_n * (g.t_oh / g.s) * (g.t_ow / g.s);
  const int mt = (g.pix + 15) / 16, nt = (g.t_co + 7) / 8;
  g.wm = mt >= 2 ? 2 : 1;
  g.wn = nt >= 4 ? 4 : nt >= 2 ? 2 : 1;
  g.mgroups = (mt + g.wm - 1) / g.wm;
  g.ngroups = (nt + g.wn - 1) / g.wn;
  // the wgmma paths (tiling.py: bf16_wgmma_tile, fp32_wgmma_tile): whole
  // m64 tiles of a phase by t_co in groups of N = min(t_co, 64) channels,
  // shared by one or two consumer warpgroups, one or two m64 tiles each,
  // and where their sums take 128 floats a thread, room for the A
  // fragments: bf16 t_ci <= 32, fp32 t_ci 8 (hi and lo, 8 registers a k8
  // step).  fp32: N 64 only (a tap group takes about as long at N 32), dense
  // only, a cluster split of at most 2 (the blocks of a wider split pay
  // the path's fixed cost for a few chunks each), t_ci * 4 bytes a
  // whole swizzle row (32 or 64), phase tiles of more than one pixel an
  // image (a 1x1 root's
  // only tiles: one valid tap a block, each weight read once), and two stages
  // of the most any block of these tiles stages fit the ring: K * K
  // slots of hi and lo boxes, and t_n windows of (t_oh / S + ceil(K / S))
  // x (t_ow / S + ceil(K / S)) pixels of t_ci words (a phase plan's deltas
  // span at most ceil(K / S))
  g.wg = false;
  g.wg_consumers = g.wg_wm = g.wg_n = g.wg_ngroups = g.wg_mgroups = 0;
  const int reach = (g.k + g.s - 1) / g.s;
  const long long f32_x = ((long long)g.t_n * (g.t_oh / g.s + reach) * (g.t_ow / g.s + reach) *
                               g.t_ci * 4 + kWgAlign - 1) / kWgAlign * kWgAlign;
  const bool f32_wg = f32 && p[P_SPARSE] == 0 && g.split <= 2 &&
                      (g.t_oh / g.s) * (g.t_ow / g.s) > 1 &&
                      (g.t_ci == 8 || g.t_ci == 16) &&
                      2 * (f32_x + 8LL * g.k * g.k * g.t_co * g.t_ci) <= kWgF32StageBudget;
  if ((bf16 || f32_wg) && g.pix % 64 == 0 &&
      ((bf16 && g.t_co == 32) || g.t_co == 64 || g.t_co == 128)) {
    const int n = g.t_co < 64 ? g.t_co : 64;
    const int tiles = g.s * g.s * (g.pix / 64) * (g.t_co / n);
    const int consumers = tiles % 2 == 0 ? 2 : 1;
    const int wm = tiles / consumers;
    const bool room = wm * n <= 64 || (bf16 ? g.t_ci <= 32 : g.t_ci == 8);
    // the block's tap lists hold every phase's taps: K * K of them
    if ((wm == 1 || wm == 2) && room && g.k * g.k <= kWgTaps) {
      g.wg = true;
      g.wg_consumers = consumers;
      g.wg_wm = wm;
      g.wg_n = n;
      g.wg_ngroups = g.t_co / n;
      g.wg_mgroups = g.pix / 64;
    }
  }
  *threads = p[P_THREADS];
  if (g.wg) {
    if (*threads != 128 * (g.wg_consumers + 1)) return E_ARGS;
  } else {
    const long long warps = (long long)g.s * g.s * g.mgroups * g.ngroups;
    if (warps * 32 > kMaxThreads || *threads > kMaxThreads) return E_THREADS;
    if (*threads < warps * 32 || *threads % 32) return E_ARGS;
  }
  // int8: every sum of a phase's taps x CIp products must fit the int32
  // accumulator (the reference's accumulator assumes the same)
  if (g.int8 && (long long)most_taps * most_taps * g.cip * 127 * 127 >= (1LL << 31))
    return E_ARGS;
  // shared layout (tiling.py: tc_columns, tc_weight_stride, tc_smem_layout)
  int rows_h, taps_h, rows_w, taps_w;
  window(taps->words, g.s, g.ih, g.pad_l, g.tiles_h, g.t_oh / g.s, g.base_h, &rows_h, &taps_h);
  window(taps->words, g.s, g.iw, g.pad_l, g.tiles_w, g.t_ow / g.s, g.base_w, &rows_w, &taps_w);
  g.win_h = rows_h;
  g.win_w = rows_w;
  g.slots = taps_h * taps_w;
  const int cols = g.ngroups * g.wn * 8;
  long long x_elems, stage;
  int elem;  // bytes per staged element
  if (g.int8) {
    // rows of t_ci bytes at a stride of t_ci + 16; a slot holds `cols`
    // weight rows (CI-minor), zero past t_co
    elem = 1;
    g.cs = g.t_ci + 16;
    g.ws = cols;
    x_elems = (long long)g.t_n * rows_h * rows_w * g.cs;
    stage = x_elems + (long long)g.slots * cols * g.cs;
  } else if (g.wg && f32) {
    // words: the input window as its TMA box lays it out (a pixel's t_ci
    // words a swizzled row), padded to a swizzle atom; then per weight slot
    // its wg_ngroups boxes of N rows by t_ci words (t_ci * N * 4 bytes,
    // whole atoms), then the same boxes' lo planes
    elem = 4;
    g.cs = g.t_ci;
    g.ws = g.wg_n;
    g.w_vec4 = true;
    const long long atom = kWgAlign / 4;
    x_elems = ((long long)g.t_n * rows_h * rows_w * g.cs + atom - 1) / atom * atom;
    stage = x_elems + 2LL * g.slots * g.wg_ngroups * g.t_ci * g.wg_n;
  } else if (g.wg) {
    // 2-byte elements: the input window as the mma.sync path's, padded to
    // a swizzle atom; then per weight slot its wg_ngroups boxes of t_ci
    // k-rows by N channels (whole swizzle atoms: t_ci * N * 2 bytes is a
    // multiple of 1024)
    elem = 2;
    g.cs = g.t_ci + 8;
    g.ws = g.wg_n;
    g.w_vec4 = true;
    const long long atom = kWgAlign / 2;
    x_elems = ((long long)g.t_n * rows_h * rows_w * g.cs + atom - 1) / atom * atom;
    stage = x_elems + (long long)g.slots * g.wg_ngroups * g.t_ci * g.wg_n;
  } else if (bf16) {
    // 2-byte elements: input rows of t_ci + 8 (whole 16-byte rows for
    // ldmatrix, an odd number of them, so that 8 consecutive pixels' rows
    // fall in distinct bank groups), weight rows at fp32's stride in
    // elements (8 mod 16: 16 mod 32 bytes, the same for 8 k-rows)
    elem = 2;
    g.cs = g.t_ci + 8;
    g.ws = cols % 16 == 0 ? cols + 8 : cols;
    g.w_vec4 = g.t_co % 8 == 0 && g.cop % 8 == 0;
    x_elems = (long long)g.t_n * rows_h * rows_w * g.cs;
    stage = x_elems + (long long)g.slots * g.t_ci * g.ws;
  } else {
    elem = 4;
    g.cs = g.t_ci + 4;
    g.ws = cols % 16 == 0 ? cols + 8 : cols;
    g.w_vec4 = g.t_co % 4 == 0 && g.cop % 4 == 0;
    x_elems = ((long long)g.t_n * rows_h * rows_w * g.cs + 3) / 4 * 4;
    stage = x_elems + (long long)g.slots * g.t_ci * g.ws;
  }
  const int budget = !g.wg ? kStageBudget : f32 ? kWgF32StageBudget : kWgStageBudget;
  int stages = 2;
  for (int n = 3; n <= kMaxStages; ++n) {
    if (elem * n * stage <= budget) stages = n;
  }
  // under a split the partial tile (4-byte sums) reuses the ring's memory
  const long long partial = g.split > 1 ? 4LL * g.s * g.s * g.pix * g.t_co : 0;
  *smem = elem * stages * stage > partial ? elem * stages * stage : partial;
  if (g.wg) *smem += kWgAlign;  // the ring is aligned to a swizzle atom in the kernel
  if (*smem > kMaxDynamicSmem) return E_SMEM;
  g.x_elems = (int)x_elems;
  g.stage_elems = (int)stage;
  g.stages = stages;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Writes the launch limits the host's tile choice must respect: the largest
// stride, taps per phase, threads per block, dynamic shared memory per
// block and cluster split (repro_torch/core/tiling.py and kernels/autotune.py
// keep the same values; the launcher checks them when it loads the library).
void deconv2d_tc_limits(int* out) {
  out[0] = kMaxStride;
  out[1] = kMaxTaps;
  out[2] = kMaxThreads;
  out[3] = kMaxDynamicSmem;
  out[4] = kMaxSplit;
}

// What a launch with parameters p runs: out[0] 1 on a wgmma path (bf16
// dense and zero-skip, fp32 dense), else 0 (mma.sync); out[1], out[2] the instance's WM and WN;
// out[3] the stages of its ring; out[4] the threads of a block.  0 or an
// ArgError.
int deconv2d_tc_launch_info(const int* p, int* out) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  out[0] = g.wg ? 1 : 0;
  out[1] = g.wg ? g.wg_wm : g.wm;
  out[2] = g.wg ? g.wg_n / 8 : g.wn;
  out[3] = g.stages;
  out[4] = threads;
  return 0;
}

// The dynamic shared memory one block takes, in bytes (the host's
// `tc_smem_layout` must agree), or an ArgError.
long long deconv2d_tc_smem_bytes(const int* p) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  return smem;
}

// x, w, b, y: f32 or bf16 device pointers, as p's dtype says (x and w
// 16-byte aligned, y 4-byte; y 8-byte on the fp32 wgmma path); w (K, K,
// CIp, COp), or on the fp32 wgmma path (`deconv2d_tc_launch_info`) packed
// CI-minor, (K, K, COp, CIp); p: host int32 array laid out as `Param`
// followed by the tap table, P_SPARSE 0; stream: a cudaStream_t.  0 on
// success.
int deconv2d_tc_forward(const void* x, const void* w, const void* b, void* y, const int* p,
                        void* stream) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  if (g.int8 || p[P_SPARSE]) return E_ARGS;
  if (!aligned16(x) || !aligned16(w)) return E_ALIGN;
  const bool f32 = p[P_DTYPE] == D_F32;
  CUtensorMap map, xmap;
  std::memset(&map, 0, sizeof map);
  std::memset(&xmap, 0, sizeof xmap);
  if (g.wg) {
    if (const int e = weight_map(w, g, f32, &map)) return e;
    if (f32) {
      if (const int e = input_map(x, g, &xmap)) return e;
    }
  }
  if (!f32) {
    const LaunchBf16 a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
                       static_cast<const uint16_t*>(b), static_cast<uint16_t*>(y),
                       Schedule{nullptr, nullptr, nullptr, 0, 0}};
    return dispatch_bf16<false>(a, g, taps, threads, (size_t)smem,
                                static_cast<cudaStream_t>(stream), map);
  }
  const Launch a{static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(b), static_cast<float*>(y),
                 Schedule{nullptr, nullptr, nullptr, 0, 0}};
  return dispatch<false>(a, g, taps, threads, (size_t)smem, static_cast<cudaStream_t>(stream),
                         map, xmap);
}

// The dense kernel's arguments (f32 or bf16) plus the packed zero-skip schedule: count
// (one per CO tile), ci (len per CO tile) and bits (nbw words per entry),
// device int32.  Entries whose CI tile is out of range are skipped.
// 0 on success.
int deconv2d_tc_sparse_forward(const void* x, const void* w, const void* b, void* y,
                               const void* count, const void* ci, const void* bits, int len,
                               int nbw, const int* p, void* stream) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  if (g.int8 || !p[P_SPARSE] || len < 1 || nbw != (g.k * g.k + 31) / 32 || nbw > kMaxBitWords ||
      !count || !ci || !bits)
    return E_ARGS;
  if (!aligned16(x) || !aligned16(w)) return E_ALIGN;
  const Schedule sched{static_cast<const int*>(count), static_cast<const int*>(ci),
                       static_cast<const unsigned*>(bits), len, nbw};
  if (p[P_DTYPE] == D_BF16) {
    const LaunchBf16 a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
                       static_cast<const uint16_t*>(b), static_cast<uint16_t*>(y), sched};
    CUtensorMap map;
    std::memset(&map, 0, sizeof map);
    if (g.wg) {
      if (const int e = weight_map(a.w, g, false, &map)) return e;
    }
    return dispatch_bf16<true>(a, g, taps, threads, (size_t)smem,
                               static_cast<cudaStream_t>(stream), map);
  }
  const Launch a{static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(b), static_cast<float*>(y), sched};
  CUtensorMap map;
  std::memset(&map, 0, sizeof map);
  return dispatch<true>(a, g, taps, threads, (size_t)smem, static_cast<cudaStream_t>(stream),
                        map, map);
}

// x, w int8 device pointers (16-byte aligned; w packed (K, K, COp, CIp)),
// scale and b f32 per padded output channel; with requant != 0 y is int8
// at out_scale, else f32.  p as for `deconv2d_tc_forward`, its dtype
// D_INT8.  0 on success.
int deconv2d_tc_int8_forward(const void* x, const void* w, const void* scale, const void* b,
                             void* y, const int* p, float out_scale, int requant, void* stream) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  if (!g.int8 || p[P_SPARSE] || (requant && !(out_scale > 0.0f))) return E_ARGS;
  if (!aligned16(x) || !aligned16(w)) return E_ALIGN;
  const LaunchInt8 a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                     static_cast<const float*>(scale), static_cast<const float*>(b), y,
                     out_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (requant) return dispatch_int8<true>(a, g, taps, threads, (size_t)smem, st);
  return dispatch_int8<false>(a, g, taps, threads, (size_t)smem, st);
}

}  // extern "C"
