// Halo-tiled, phase-decomposed transposed convolution for Hopper (sm_90a)
// on the FMA units: the bf16 dense and zero-skip kernels, instances of one
// template.  fp32 and int8 layers run on the tensor cores
// (csrc/deconv2d_tc.cu): the int8 instance of this template and its entry
// `deconv2d_int8_forward` are gone, replaced by `deconv2d_tc_int8_forward`.
//
// Replaces two Pallas TPU kernels of the JAX package in bf16, each
// computing the same function on the same host-padded inputs:
//
//  * dense (`deconv2d_forward`): `_deconv2d_kernel`,
//    src/repro/kernels/deconv2d/kernel.py (launched by `deconv2d_pallas_call`)
//
//      y = act(conv_transpose(x, w) + b)   x (N, IHp, IWp, CIp), w (K, K, CIp, COp),
//                                          b (COp), y (N, OHp, OWp, COp), NHWC,
//                                          bf16
//
//  * zero-skip (`deconv2d_sparse_forward`): `_sparse_kernel`,
//    src/repro/kernels/deconv2d_sparse/kernel.py (launched by
//    `deconv2d_sparse_pallas_call`).  The dense function on pruned weights;
//    for each CO tile the CI loop walks only the count[co_tile] slabs of a
//    packed host-built schedule (CI tile ci[co_tile][l]), and each tap is
//    skipped where its bit kh*K + kw of bits[co_tile][l] is 0 (the slab is
//    all zero there), intersected with the block's taps that read real
//    input.  A skipped slab stages nothing and costs no FMA.
//
// What bounds the dense kernel on an H100: FMA throughput on the wide CelebA layers
// (1024->512, 512->256, 256->128 channels: ~134M MACs per image each, with a
// 4x4 kernel reused over every output pixel), and device-memory bytes on the
// 1x1 root layers (every weight is read once and used by one pixel per image)
// and on the thin tanh layers (1 or 3 output channels).
//
// What the design does about it:
//  * One thread block owns one (t_n, t_oh, t_ow, t_co) output tile.  Blocks
//    run in parallel and in no order, so the CI reduction, which the TPU
//    kernel ran as a sequential grid axis with a scratch accumulator, is a
//    loop inside the block here; nothing is carried between blocks.
//  * Per t_ci chunk the block stages the Eq. 5 halo windows of its t_n images
//    (t_n, T_IH, T_IW, t_ci) and the weight slab (K, K, t_ci, t_co) in shared
//    memory, as f32 (bf16 is converted on staging).  Each thread keeps 8
//    independent global loads in flight before it stores them, so staging is not one memory latency per
//    element.  Every staged value is
//    then reused by all the output pixels and channels of the tile: a weight
//    by t_n*T_OH*T_OW/S^2 pixels, an input by t_co channels and K^2/S^2 taps.
//    The window's channel stride is padded by one word so that threads of one
//    warp reading different pixels hit different banks.
//  * Threads are split over the S*S output phases.  A thread walks only the
//    taps of its own phase, from a (phase -> tap, halo-local row) table built
//    on the host from `make_phase_plan` and copied into shared memory: the
//    tap loop has no modulo and no bounds test (the host padding keeps every
//    window in bounds, checked before launch).
//  * Each thread keeps an RP x RC register tile of f32 accumulators (RP pixels
//    of its phase, RC channels; 4 x 8 on wide layers), initialised from the
//    bias, so one shared read of x feeds RC FMAs and one read of w feeds RP.
//    On wide layers a thread's 8 channels are contiguous: its weights come
//    in two 16-byte shared loads per CI step and its outputs leave in two
//    16-byte stores, so the FMA loop is not bound by shared-memory loads.
//  * The epilogue applies relu/tanh in f32 and casts to x's dtype; writes are
//    disjoint (each output element has exactly one owner thread) and
//    consecutive threads store consecutive channels.
//  * Plain FMA in f32: no tensor cores.  bf16 on the tensor cores
//    (mma/wgmma), TMA and warp specialisation are for later work.
//  * Zero-skip saves work in proportion to the slabs it drops: at
//    element-level magnitude pruning few whole slabs are zero, so on the
//    served nets it runs close to the dense kernel plus the schedule reads.
//
// Plain C interface (loaded with ctypes): each `*_forward` launches on the
// given stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxStride = 4;
constexpr int kMaxTaps = 8;
constexpr int kTapWords = kMaxStride + 2 * kMaxStride * kMaxTaps;
constexpr int kMaxThreads = 512;   // with __launch_bounds__: up to 128 registers
constexpr int kStageBatch = 8;     // independent scalar loads per thread in flight
constexpr int kStaticSmem = 4096;  // bound on the kernel's static shared tables
constexpr int kMaxDynamicSmem = 232448 - kStaticSmem;

// Layout of the int32 parameter array the host passes (kept in step with
// repro_torch/kernels/deconv2d/kernel.py::_PARAM_FIELDS).
enum Param {
  P_N, P_IHP, P_IWP, P_CIP, P_K, P_COP, P_OHP, P_OWP, P_S,
  P_TN, P_TOH, P_TOW, P_TCI, P_TCO, P_TIH, P_TIW, P_BASE_H, P_BASE_W,
  P_ACT, P_RP, P_RC, P_DTYPE, P_IH, P_IW, P_PAD_L, P_THREADS, P_TAPS
};

// Argument errors are reported as negative codes, CUDA errors as positive.
enum ArgError { E_ARGS = -1, E_THREADS = -2, E_SMEM = -3, E_REGTILE = -4 };

struct Geometry {
  int n, ihp, iwp, cip, k, cop, ohp, owp, s;
  int t_n, t_oh, t_ow, t_ci, t_co, t_ih, t_iw, base_h, base_w;
  int act;
  int ih, iw, pad_l;  // the unpadded input extent and the left halo padding
  int tiles_h, tiles_w, tiles_co;
};

struct TapTable {
  int words[kTapWords];  // counts[S] | tap k[S][kMaxTaps] | local row[S][kMaxTaps]
};

// The packed zero-skip schedule (device int32 arrays): for CO tile t and
// step l < count[t], slab ci[t*len + l] is computed at the taps whose bit
// kh*K + kw is set in the nbw words bits[(t*len + l)*nbw ...].  Unused by
// the others.
struct Schedule {
  const int* count;
  const int* ci;
  const unsigned* bits;
  int len, nbw;
};

// Staged values are f32 words (bf16 is converted on staging).
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared words of the staged halo windows, rounded up to 16 bytes so that
// the weight slab after them takes 16-byte stores.
__host__ __device__ __forceinline__ int x_words(const Geometry& g) {
  return (g.t_n * g.t_ih * g.t_iw * (g.t_ci + 1) + 3) / 4 * 4;
}

// T: x, w, b and y (bf16).  kSparse walks `sched` in place of every CI
// chunk.
template <typename T, bool kSparse, int RP, int RC>
__global__ void __launch_bounds__(kMaxThreads) deconv2d_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
    Geometry g, TapTable taps, Schedule sched) {
  using Acc = float;
  using V4 = float4;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_taps[kTapWords];
  // per dim (0: rows, 1: cols): which phase taps read any real input for
  // this block, which kernel taps those are, and the staged window span
  __shared__ unsigned char s_tap_ok[2][kMaxStride * kMaxTaps];
  __shared__ unsigned char s_k_ok[2][kMaxStride * kMaxTaps];
  __shared__ int s_span[4];
  // the kernel taps (kh * K + kw) whose weights this block stages
  __shared__ short s_wtaps[kMaxStride * kMaxTaps * kMaxStride * kMaxTaps];
  __shared__ int s_n_wtaps;
  // zero-skip: the current slab's tap bits
  __shared__ unsigned char s_tmask[kMaxStride * kMaxTaps * kMaxStride * kMaxTaps];
#pragma unroll
  for (int i = 0; i < kTapWords; ++i) {
    if (threadIdx.x == 0) s_taps[i] = taps.words[i];
  }

  const int s = g.s;
  const int th = g.t_oh / s, tw = g.t_ow / s;
  const int pix = g.t_n * th * tw;  // output pixels of one phase in the tile
  const int tc_threads = (g.t_co + RC - 1) / RC;
  const int tp_threads = (pix + RP - 1) / RP;
  const int per_phase = tc_threads * tp_threads;
  const int ci_stride = g.t_ci + 1;
  Acc* xs = reinterpret_cast<Acc*>(smem);
  Acc* ws = xs + x_words(g);  // 16-byte aligned

  // block -> output tile
  int tile = blockIdx.x;
  const int co_t = tile % g.tiles_co;
  tile /= g.tiles_co;
  const int ow_t = tile % g.tiles_w;
  const int oh_t = tile / g.tiles_w;
  const int n0 = blockIdx.y * g.t_n;
  const int co0 = co_t * g.t_co;
  const int h0 = oh_t * th + g.base_h;
  const int w0 = ow_t * tw + g.base_w;

  // Tap validity, uniform over the block: a tap whose rows (or columns) in
  // this tile's window all lie in the host padding adds exactly zero, so
  // it is skipped in the FMA loop, its weights are not staged, and only
  // the window span that valid taps read is staged.  On a 1x1 root layer
  // this leaves one tap of K*K per S-pixel tile.
  if (threadIdx.x == 0) {
    for (int dim = 0; dim < 2; ++dim) {
      const int o0 = dim == 0 ? h0 : w0;
      const int span = dim == 0 ? th : tw;
      const int lo_real = g.pad_l;
      const int hi_real = g.pad_l + (dim == 0 ? g.ih : g.iw);
      int lo = 1 << 30, hi = -(1 << 30);
      for (int k = 0; k < kMaxStride * kMaxTaps; ++k) s_k_ok[dim][k] = 0;
      for (int ph_ = 0; ph_ < s; ++ph_) {
        for (int a = 0; a < s_taps[ph_]; ++a) {
          const int d = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph_ * kMaxTaps + a];
          const bool ok = o0 + d < hi_real && o0 + d + span > lo_real;
          s_tap_ok[dim][ph_ * kMaxTaps + a] = ok;
          if (ok) {
            s_k_ok[dim][s_taps[kMaxStride + ph_ * kMaxTaps + a]] = 1;
            lo = min(lo, d);
            hi = max(hi, d + span);
          }
        }
      }
      s_span[2 * dim] = lo < hi ? lo : 0;
      s_span[2 * dim + 1] = lo < hi ? hi : 0;
    }
    int n = 0;
    for (int kh = 0; kh < g.k; ++kh) {
      for (int kw = 0; kw < g.k; ++kw) {
        if (s_k_ok[0][kh] && s_k_ok[1][kw]) s_wtaps[n++] = (short)(kh * g.k + kw);
      }
    }
    s_n_wtaps = n;
  }

  // thread -> (phase, pixel group, channel group); threads past the last
  // phase (blockDim may exceed S*S*per_phase) only help staging
  const int tid = threadIdx.x;
  const int phase = tid / per_phase;
  const int q = tid - phase * per_phase;
  const int tc = q % tc_threads;
  const int tp = q / tc_threads;
  const int ph = phase / s, pw = phase - (phase / s) * s;
  const bool computes = phase < s * s;

  int xoff[RP];
  bool pvalid[RP];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int p = tp + tp_threads * i;
    pvalid[i] = p < pix;
    const int pp = pvalid[i] ? p : 0;
    const int nn = pp / (th * tw);
    const int r = (pp / tw) % th;
    const int c = pp % tw;
    xoff[i] = ((nn * g.t_ih + r) * g.t_iw + c) * ci_stride;
  }
  // wide tiles (RC = 8): a thread owns 8 contiguous channels, read from
  // shared memory and written to y 16 bytes at a time; otherwise channels
  // are strided by the channel-thread count
  constexpr bool kContig = RC % 4 == 0;
  int cols[RC];
  bool cvalid[RC];
  Acc acc[RP][RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    const int co = kContig ? tc * RC + j : tc + tc_threads * j;
    cvalid[j] = co < g.t_co;
    cols[j] = cvalid[j] ? co : 0;
    // initializeToBias()
    const Acc init = load_val(b + co0 + cols[j]);
#pragma unroll
    for (int i = 0; i < RP; ++i) acc[i][j] = init;
  }

  const int kk = g.k;
  const int n_ci = g.cip / g.t_ci;
  const int steps = kSparse ? sched.count[co_t] : n_ci;
  for (int step = 0; step < steps; ++step) {
    int c0 = step * g.t_ci;
    if constexpr (kSparse) {
      // uniform over the block: the entry depends on the CO tile and step only
      const int e = co_t * sched.len + step;
      const int ci_t = sched.ci[e];
      if (ci_t < 0 || ci_t >= n_ci) continue;
      c0 = ci_t * g.t_ci;
      __syncthreads();  // the previous chunk's readers are done
      for (int t = tid; t < kk * kk; t += blockDim.x)
        s_tmask[t] = (sched.bits[(size_t)e * sched.nbw + (t >> 5)] >> (t & 31)) & 1u;
      __syncthreads();
      // the taps to stage: the block's valid taps whose slab is nonzero
      if (tid == 0) {
        int n = 0;
        for (int kh = 0; kh < kk; ++kh) {
          for (int kw = 0; kw < kk; ++kw) {
            if (s_k_ok[0][kh] && s_k_ok[1][kw] && s_tmask[kh * kk + kw])
              s_wtaps[n++] = (short)(kh * kk + kw);
          }
        }
        s_n_wtaps = n;
      }
    }
    __syncthreads();  // the previous chunk's readers are done; tap list ready
    if (kSparse && s_n_wtaps == 0) continue;  // no live tap reads real input
    // x halo windows, the span valid taps read: rows of t_ci channels,
    // kStageBatch loads in flight; host-padding positions are written as 0
    const int lo_h = s_span[0], eh = s_span[1] - s_span[0];
    const int lo_w = s_span[2], ew = s_span[3] - s_span[2];
    const int x_elems = g.t_n * eh * ew * g.t_ci;
    for (int base = tid; base < x_elems; base += blockDim.x * kStageBatch) {
      Acc v[kStageBatch];
      int dst[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int e = base + u * blockDim.x;
        if (e < x_elems) {
          const int ci = e % g.t_ci;
          int rest = e / g.t_ci;
          const int cc = lo_w + rest % ew;
          rest /= ew;
          const int rr = lo_h + rest % eh;
          const int nn = rest / eh;
          const int gh = h0 + rr, gw = w0 + cc;
          const bool real = gh >= g.pad_l && gh < g.pad_l + g.ih && gw >= g.pad_l &&
                            gw < g.pad_l + g.iw;
          const size_t gi =
              ((((size_t)(n0 + nn) * g.ihp + gh) * g.iwp + gw) * g.cip) + c0 + ci;
          v[u] = real ? Acc(load_val(x + gi)) : Acc(0);
          dst[u] = ((nn * g.t_ih + rr) * g.t_iw + cc) * ci_stride + ci;
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        if (base + u * blockDim.x < x_elems) xs[dst[u]] = v[u];
      }
    }
    // weight slab, layout [tap][ci][co]: rows of t_co channels, only the
    // rows of the block's valid taps
    const int w_rows = s_n_wtaps * g.t_ci;
    const int n1 = w_rows * g.t_co;
    for (int base = tid; base < n1; base += blockDim.x * kStageBatch) {
      Acc v[kStageBatch];
      int dst[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int e = base + u * blockDim.x;
        if (e < n1) {
          const int r = e / g.t_co;
          const int co = e - r * g.t_co;
          const int slot = r / g.t_ci;
          const int ci = r - slot * g.t_ci;
          const int tap = s_wtaps[slot];
          v[u] = load_val(w + ((size_t)tap * g.cip + c0 + ci) * g.cop + co0 + co);
          dst[u] = (tap * g.t_ci + ci) * g.t_co + co;
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        if (base + u * blockDim.x < n1) ws[dst[u]] = v[u];
      }
    }
    __syncthreads();

    if (!computes) continue;
    const int n_taps_h = s_taps[ph];
    const int n_taps_w = s_taps[pw];
    for (int a = 0; a < n_taps_h; ++a) {
      if (!s_tap_ok[0][ph * kMaxTaps + a]) continue;
      const int kh = s_taps[kMaxStride + ph * kMaxTaps + a];
      const int dh = s_taps[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      for (int bb = 0; bb < n_taps_w; ++bb) {
        if (!s_tap_ok[1][pw * kMaxTaps + bb]) continue;
        const int kw = s_taps[kMaxStride + pw * kMaxTaps + bb];
        if (kSparse && !s_tmask[kh * kk + kw]) continue;  // an all-zero slab tap
        const int dw = s_taps[kMaxStride + kMaxStride * kMaxTaps + pw * kMaxTaps + bb];
        const Acc* xt = xs + (dh * g.t_iw + dw) * ci_stride;
        const Acc* wt = ws + (kh * kk + kw) * g.t_ci * g.t_co;
        for (int ci = 0; ci < g.t_ci; ++ci) {
          Acc xv[RP], wv[RC];
#pragma unroll
          for (int i = 0; i < RP; ++i) xv[i] = xt[xoff[i] + ci];
#pragma unroll
          if constexpr (kContig) {
            const V4* wrow = reinterpret_cast<const V4*>(wt + ci * g.t_co + tc * RC);
#pragma unroll
            for (int j4 = 0; j4 < RC / 4; ++j4) {
              const V4 t = wrow[j4];
              wv[4 * j4] = t.x;
              wv[4 * j4 + 1] = t.y;
              wv[4 * j4 + 2] = t.z;
              wv[4 * j4 + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < RC; ++j) wv[j] = wt[ci * g.t_co + cols[j]];
          }
#pragma unroll
          for (int i = 0; i < RP; ++i) {
#pragma unroll
            for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
          }
        }
      }
    }
  }

  // fused epilogue: activation in f32, cast, one disjoint write per element
  if (!computes) return;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    if (!pvalid[i]) continue;
    const int p = tp + tp_threads * i;
    const int nn = p / (th * tw);
    const int r = (p / tw) % th;
    const int c = p % tw;
    const int oh = oh_t * g.t_oh + r * s + ph;
    const int ow = ow_t * g.t_ow + c * s + pw;
    const size_t row = (((size_t)(n0 + nn) * g.ohp + oh) * g.owp + ow) * g.cop + co0;
    float v[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      v[j] = acc[i][j];
      if (g.act == 1) v[j] = fmaxf(v[j], 0.0f);
      else if (g.act == 2) v[j] = tanhf(v[j]);
    }
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      if (cvalid[j]) store_from_f32(y + row + cols[j], v[j]);
    }
  }
}

struct Launch {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  Schedule sched;
};

template <typename T, bool kSparse, int RP, int RC>
int launch(const Launch& a, const Geometry& g, const TapTable& taps, int threads,
           size_t smem, cudaStream_t stream) {
  auto kern = deconv2d_kernel<T, kSparse, RP, RC>;
  // the opt-in shared-memory limit, set once per instance and device
  static std::atomic<unsigned> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned bit = 1u << (dev & 31);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  dim3 grid(g.tiles_h * g.tiles_w * g.tiles_co, g.n / g.t_n);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(a.x), static_cast<const T*>(a.w),
                                        static_cast<const T*>(a.b), static_cast<T*>(a.y), g,
                                        taps, a.sched);
  return (int)cudaGetLastError();
}

template <typename T, bool kSparse>
int dispatch(int rp, int rc, const Launch& a, const Geometry& g, const TapTable& taps,
             int threads, size_t smem, cudaStream_t stream) {
#define DECONV_CASE(RP_, RC_) \
  if (rp == RP_ && rc == RC_)   \
    return launch<T, kSparse, RP_, RC_>(a, g, taps, threads, smem, stream);
  DECONV_CASE(4, 8)
  DECONV_CASE(4, 2)
  DECONV_CASE(4, 1)
#undef DECONV_CASE
  return E_REGTILE;
}

long long smem_bytes(const int* p) {
  const long long xw = (long long)p[P_TN] * p[P_TIH] * p[P_TIW] * (p[P_TCI] + 1);
  return 4LL * ((xw + 3) / 4 * 4 + (long long)p[P_K] * p[P_K] * p[P_TCI] * p[P_TCO]);
}

// Reads and checks the parameter array; 0 or an ArgError.
int setup(const int* p, Geometry* gp, TapTable* taps, int* threads, long long* smem) {
  Geometry& g = *gp;
  g.n = p[P_N]; g.ihp = p[P_IHP]; g.iwp = p[P_IWP]; g.cip = p[P_CIP]; g.k = p[P_K];
  g.cop = p[P_COP]; g.ohp = p[P_OHP]; g.owp = p[P_OWP]; g.s = p[P_S];
  g.t_n = p[P_TN]; g.t_oh = p[P_TOH]; g.t_ow = p[P_TOW]; g.t_ci = p[P_TCI]; g.t_co = p[P_TCO];
  g.t_ih = p[P_TIH]; g.t_iw = p[P_TIW]; g.base_h = p[P_BASE_H]; g.base_w = p[P_BASE_W];
  g.act = p[P_ACT];
  g.ih = p[P_IH]; g.iw = p[P_IW]; g.pad_l = p[P_PAD_L];
  if (g.ih < 1 || g.iw < 1 || g.pad_l < 0 || g.pad_l + g.ih > g.ihp || g.pad_l + g.iw > g.iwp)
    return E_ARGS;
  if (g.s < 1 || g.s > kMaxStride || g.k < 1 || g.k > kMaxStride * kMaxTaps || g.t_n < 1 || g.t_ci < 1 || g.t_co < 1 ||
      g.t_oh < g.s || g.t_ow < g.s || g.t_oh % g.s || g.t_ow % g.s || g.n % g.t_n ||
      g.cip % g.t_ci || g.cop % g.t_co || g.ohp % g.t_oh || g.owp % g.t_ow ||
      g.act < 0 || g.act > 2)
    return E_ARGS;
  g.tiles_h = g.ohp / g.t_oh;
  g.tiles_w = g.owp / g.t_ow;
  g.tiles_co = g.cop / g.t_co;
  // every halo window must lie inside the host-padded input
  if (g.base_h < 0 || g.base_w < 0 ||
      (g.tiles_h - 1) * (g.t_oh / g.s) + g.base_h + g.t_ih > g.ihp ||
      (g.tiles_w - 1) * (g.t_ow / g.s) + g.base_w + g.t_iw > g.iwp)
    return E_ARGS;
  for (int i = 0; i < kTapWords; ++i) taps->words[i] = p[P_TAPS + i];
  for (int ph = 0; ph < g.s; ++ph) {
    const int cnt = taps->words[ph];
    if (cnt < 0 || cnt > kMaxTaps) return E_ARGS;
    for (int a = 0; a < cnt; ++a) {
      const int k = taps->words[kMaxStride + ph * kMaxTaps + a];
      const int d = taps->words[kMaxStride + kMaxStride * kMaxTaps + ph * kMaxTaps + a];
      if (k < 0 || k >= g.k || d < 0 || d + g.t_oh / g.s > g.t_ih || d + g.t_ow / g.s > g.t_iw)
        return E_ARGS;
    }
  }
  const int rp = p[P_RP], rc = p[P_RC];
  // contiguous channel groups need whole groups, 16-byte aligned rows
  if (rp < 1 || rc < 1 || (rc % 4 == 0 && g.t_co % rc)) return E_REGTILE;
  const long long pix = (long long)g.t_n * (g.t_oh / g.s) * (g.t_ow / g.s);
  const long long compute_threads =
      (long long)g.s * g.s * ((pix + rp - 1) / rp) * ((g.t_co + rc - 1) / rc);
  *threads = p[P_THREADS];
  if (compute_threads > kMaxThreads || *threads > kMaxThreads) return E_THREADS;
  if (*threads < compute_threads) return E_ARGS;
  *smem = smem_bytes(p);
  if (*smem > kMaxDynamicSmem) return E_SMEM;
  return 0;
}

}  // namespace

extern "C" {

// Writes the launch limits the host's tile choice must respect: the largest
// stride, taps per phase, threads per block and dynamic shared memory per
// block (repro_torch/core/tiling.py keeps the same values; the launcher
// checks them when it loads the library).
void deconv2d_limits(int* out) {
  out[0] = kMaxStride;
  out[1] = kMaxTaps;
  out[2] = kMaxThreads;
  out[3] = kMaxDynamicSmem;
}

// Returns the dynamic shared memory one block takes, in bytes (the host's
// `kernel_smem_bytes` model must agree); the same for both kernels.
long long deconv2d_smem_bytes(const int* p) { return smem_bytes(p); }

// x, w, b, y: device pointers; p: host int32 array laid out as `Param`
// followed by the tap table; stream: a cudaStream_t.  0 on success.
int deconv2d_forward(const void* x, const void* w, const void* b, void* y, const int* p,
                     void* stream) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  const Launch a{x, w, b, y, Schedule{nullptr, nullptr, nullptr, 0, 0}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rp = p[P_RP], rc = p[P_RC];
  if (p[P_DTYPE] == 1)
    return dispatch<__nv_bfloat16, false>(rp, rc, a, g, taps, threads, (size_t)smem, st);
  return E_ARGS;
}

// The dense kernel's arguments plus the packed zero-skip schedule: count
// (one per CO tile), ci (len per CO tile) and bits (nbw words per entry),
// device int32.  Entries whose CI tile is out of range are skipped.
// 0 on success.
int deconv2d_sparse_forward(const void* x, const void* w, const void* b, void* y,
                            const void* count, const void* ci, const void* bits, int len,
                            int nbw, const int* p, void* stream) {
  Geometry g;
  TapTable taps;
  int threads;
  long long smem;
  if (const int e = setup(p, &g, &taps, &threads, &smem)) return e;
  if (len < 1 || nbw != (g.k * g.k + 31) / 32 || !count || !ci || !bits) return E_ARGS;
  const Launch a{x, w, b, y,
                 Schedule{static_cast<const int*>(count), static_cast<const int*>(ci),
                          static_cast<const unsigned*>(bits), len, nbw}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rp = p[P_RP], rc = p[P_RC];
  if (p[P_DTYPE] == 1)
    return dispatch<__nv_bfloat16, true>(rp, rc, a, g, taps, threads, (size_t)smem, st);
  return E_ARGS;
}

}  // extern "C"
