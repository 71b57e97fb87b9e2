// Per-image instance normalisation and activation of one NHWC map, written
// straight into the buffers its consumers read (sm_90a, plain CUDA).
//
// Replaces no Pallas kernel: the JAX package has no normalisation.  It was
// added for the pix2pix U-Net generator (repro_torch/models/unet.py), whose
// 13 normalised maps each feed two consumers: the next encoder conv (through
// LeakyReLU, as the 2x2 space-to-depth input of B1's stride-1 launch) and a
// decoder conv (through ReLU, as one half of the skip concatenation in B1's
// halo-padded input).  A block owns kGroup channels of one image and a
// contiguous 1/split of its pixels; the split's blocks form a cluster:
//
//   1. stats (when gamma is given): each block takes two passes over its
//      pixels, the sum (its mean) and the sum of squares about that mean
//      (its M2); after cluster.sync() every block merges the ranks' (count,
//      mean, M2) in rank order with Chan's formula, read from their shared
//      memory; var is M2 / (H*W), the biased variance.  E[x^2] - E[x]^2 is
//      never formed, and every block computes the same mean and rstd.
//   2. its pixels again: v = (x - mean) * (gamma * rstd) + beta (or v = x
//      without stats), then for each destination LReLU(v) at its slope (0 is
//      ReLU, 1 the identity) stored at its place:
//        plain: t[n, pad + h, pad + w, off + c]
//        s2d:   the map zero-padded by 1 and cut 2x2 into channels,
//               t[n, pad + (h+1)/2, pad + (w+1)/2, off + ((h+1)%2*2 + (w+1)%2)*C + c]
//      Places no pixel reaches (halo, padding ring, padded channels) are
//      never written: the caller keeps them zero.
//
// The map is B1's padded output read through its strides (only the image's
// own H x W x C: never a padded row, column or channel), so statistics cover
// each image's own map and the concat costs no copy.
//
// What bounds it on an H100: device-memory bytes (the map read once for the
// stats and once more for the apply, the second read mostly from L2; one or
// two writes; ~2 flops a byte).  The design keeps the reads 32-byte sectors
// (kGroup = 8 float channels of one pixel per 8 neighbouring threads) and
// the grid near a thousand blocks: at a bucket of 16 the 128 x 128 x 64
// maps give N * C / 8 = 128 (image, channel group) pairs, so their pixels
// are split over a cluster of 8 (a first design without the split ran
// those maps on one block an SM, at 8 % of the HBM bound).  Without stats
// the split needs no cluster and goes to 64.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 8;                   // channels a block owns
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kGroup;   // pixel lanes of a block
constexpr int kMaxClusterSplit = 8;         // blocks of a stats cluster
constexpr int kMaxSplit = 64;               // blocks of a map without stats
constexpr int kMinPixels = 1024;            // pixels a split block takes at least

// In step with `launch_params` in repro_torch/kernels/norm_act/kernel.py.
enum Param {
  kN, kH, kW, kC, kSn, kSh, kSw, kStats,
  kDest0,                 // per destination: sn, sh, sw, pad, off, s2d
  kDestFields = 6,
  kParams = kDest0 + 2 * kDestFields,
};

struct Dest {
  float* ptr;
  long long sn, sh, sw;
  int pad, off, s2d;
  float slope;
};

__device__ __forceinline__ void put(const Dest& d, int n, int h, int w, int c,
                                    int C, float v) {
  if (d.ptr == nullptr) return;
  const float a = v > 0.f ? v : v * d.slope;
  long long at;
  if (d.s2d) {
    const int hh = h + 1, ww = w + 1;
    at = n * d.sn + (long long)(d.pad + (hh >> 1)) * d.sh +
         (long long)(d.pad + (ww >> 1)) * d.sw + d.off +
         ((hh & 1) * 2 + (ww & 1)) * C + c;
  } else {
    at = n * d.sn + (long long)(d.pad + h) * d.sh +
         (long long)(d.pad + w) * d.sw + d.off + c;
  }
  d.ptr[at] = a;
}

// The block's sum of v over its pixel lanes, per channel, in every thread
// of that channel.
__device__ __forceinline__ float block_sum(float v, float (*red)[kGroup],
                                           int lp, int lc) {
  red[lp][lc] = v;
  __syncthreads();
  float s = 0.f;
  for (int j = 0; j < kLanes; ++j) s += red[j][lc];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
norm_act_kernel(const float* __restrict__ src, const float* __restrict__ gamma,
                const float* __restrict__ beta, int H, int W, int C,
                long long sn, long long sh, long long sw, int stats, float eps,
                Dest d0, Dest d1) {
  __shared__ float red[kLanes][kGroup];
  __shared__ float part[3][kGroup];      // this block's count, mean, M2
  __shared__ float s_scale[kGroup];
  __shared__ float s_mu[kGroup];
  const int lc = threadIdx.x % kGroup;
  const int lp = threadIdx.x / kGroup;
  const int c = blockIdx.y * kGroup + lc;
  const int n = blockIdx.z;
  const int rank = blockIdx.x, split = gridDim.x;
  const bool live = c < C;
  const int P = H * W;
  const int p0 = (int)((long long)P * rank / split);
  const int p1 = (int)((long long)P * (rank + 1) / split);
  const float* base = src + n * sn + (live ? c : 0);

  float mu = 0.f, scale = 1.f, shift = 0.f;
  if (stats) {
    float acc = 0.f;
    if (live)
      for (int p = p0 + lp; p < p1; p += kLanes) {
        const int h = p / W, w = p - h * W;
        acc += base[h * sh + w * sw];
      }
    const float cnt = (float)(p1 - p0);   // >= 1: kMinPixels a split block
    const float mean = block_sum(acc, red, lp, lc) / cnt;
    acc = 0.f;
    if (live)
      for (int p = p0 + lp; p < p1; p += kLanes) {
        const int h = p / W, w = p - h * W;
        const float d = base[h * sh + w * sw] - mean;
        acc += d * d;
      }
    const float m2 = block_sum(acc, red, lp, lc);
    if (lp == 0) {
      part[0][lc] = cnt;
      part[1][lc] = mean;
      part[2][lc] = m2;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (lp == 0 && live) {
      float na = 0.f, ma = 0.f, qa = 0.f;
      for (int q = 0; q < split; ++q) {
        const float* pq = cluster.map_shared_rank(&part[0][0], q);
        const float nb = pq[lc];
        if (nb == 0.f) continue;
        const float mb = pq[kGroup + lc], qb = pq[2 * kGroup + lc];
        const float nab = na + nb, delta = mb - ma;
        ma += delta * (nb / nab);
        qa += qb + delta * delta * (na * nb / nab);
        na = nab;
      }
      const float rstd = 1.f / sqrtf(qa / (float)P + eps);
      s_scale[lc] = gamma[c] * rstd;
      s_mu[lc] = ma;
    }
    // no block leaves while another reads its part; s_* are visible after
    cluster.sync();
    if (live) {
      mu = s_mu[lc];
      scale = s_scale[lc];
      shift = beta[c];
    }
  }
  if (!live) return;
  for (int p = p0 + lp; p < p1; p += kLanes) {
    const int h = p / W, w = p - h * W;
    const float x = base[h * sh + w * sw];
    const float v = stats ? (x - mu) * scale + shift : x;
    put(d0, n, h, w, c, C, v);
    put(d1, n, h, w, c, C, v);
  }
}

Dest dest_of(float* ptr, const long long* q, float slope) {
  Dest d;
  d.ptr = ptr;
  d.sn = q[0];
  d.sh = q[1];
  d.sw = q[2];
  d.pad = (int)q[3];
  d.off = (int)q[4];
  d.s2d = (int)q[5];
  d.slope = slope;
  return d;
}

}  // namespace

extern "C" {

// Block size and channel group the host's byte and grid counts assume.
void norm_act_limits(int* out) {
  out[0] = kThreads;
  out[1] = kGroup;
}

// Blocks that split one (image, channel group)'s pixels in a launch over an
// H x W map, with (stats 1) or without statistics.
int norm_act_split(long long H, long long W, int stats) {
  int split = (int)(H * W / kMinPixels);
  const int most = stats ? kMaxClusterSplit : kMaxSplit;
  return split < 1 ? 1 : (split > most ? most : split);
}

// One launch on `stream`: p holds kParams int64 words (Param), f = {eps,
// slope of d0, slope of d1}; gamma and beta are null for the no-statistics
// mode, d1 (and d0) null where there is no such destination.  Returns -1
// for arguments it does not take, else cudaGetLastError().
int norm_act_forward(const float* src, const float* gamma, const float* beta,
                     float* d0, float* d1, const long long* p, const float* f,
                     void* stream) {
  const long long N = p[kN], H = p[kH], W = p[kW], C = p[kC];
  const int stats = (int)p[kStats];
  if (N < 1 || H < 1 || W < 1 || C < 1 || N > 65535 || src == nullptr ||
      H * W > (1LL << 30))
    return -1;
  if (stats && (gamma == nullptr || beta == nullptr)) return -1;
  if (d0 == nullptr && d1 == nullptr) return -1;
  const int split = norm_act_split(H, W, stats);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)split, (unsigned)((C + kGroup - 1) / kGroup),
                     (unsigned)N);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = stats ? split : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, norm_act_kernel, src, gamma, beta, (int)H, (int)W, (int)C,
      p[kSn], p[kSh], p[kSw], stats, f[0], dest_of(d0, p + kDest0, f[1]),
      dest_of(d1, p + kDest0 + kDestFields, f[2]));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
