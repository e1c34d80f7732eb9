// Kernel C1: the sampled contrastive-correlation loss with the bilinear
// sampling inside the kernel, forward (stego_corr_sampled_fwd) and backward
// to the code maps (stego_corr_sampled_bwd).
//
// Replaces stego_tpu/ops/pallas_corr_fused_sampling.py:sampled_corr_fused
// (:389): the forward replaces _sfwd_kernel (:93, pallas_call :171 in
// _run_sfwd), the backward _sbwd_kernel (:187, pallas_call :296 in
// _run_sbwd) and the one-hot fold of the negatives' gradients (:365-374).
// The train step calls each once (ops/corr_fused_sampling.py).
//
// What it computes. A slot is one pair (image b, pair type g): g = 0 is the
// image with itself, g = 1 the image with its KNN positive, g = 2 + k the
// image with image perm_k(b). Side 1 is image b sampled at its coordinates
// grid1[b]; side 2 is the slot's other image sampled at grid2[b] (grid1[b]
// for g = 0). Sampling is bilinear with border clamping and
// align_corners=True, as four taps (stego_tpu/ops/sampling.py:33-59; the
// reference's grid transpose is done by the wrapper). Per sample the
// features (bf16 or f32) and the code (f32) are l2-normalised, and
// fd = f1n f2n^T, cd = c1n c2n^T (S x S). The forward writes the row sums
// s1 = sum_j clamp(cd) fd, s2 = sum_j clamp(cd), s3 = sum_j fd and
// sum_j cd, the side-2 raw code norms, and the residuals c2n (S x CC) and fd
// (S x S); ops/corr_stream.py:finalize turns the sums into the losses.
//
// Rounding points of _sfwd_kernel (:101-135). Feature side, bf16 features
// (a bf16 trunk): tap weights rounded to bf16, products with the bf16
// features accumulated in f32, the sampled value rounded to bf16,
// l2-normalised in f32 (eps 1e-10) and stored as bf16; fd is a bf16 x bf16
// product with f32 accumulation (every such product is exact in f32, so an
// f32 FMA per term is the f32 sum of exact products). f32 features (an f32
// trunk, feat_dtype=float32): f32 tap weights and sampled values, no
// rounding, l2-normalised in f32 (eps 1e-10); fd is f32 x f32 with f32 FMA.
// Code side: f32 throughout, with f32 FMA (no tensor cores, so no TF32).
//
// Bound: at the train step's shapes (B = 16, 28 x 28 maps, 384 feature and
// 70 code channels, S = 121, 7 slots an image) the forward is about 1.5
// GFLOP, nearly all of it fd (121 x 121 x 384 a slot), and it reads a few MB
// of maps (L2-resident: every map is read by the 7 slots of its image) and
// writes 7 MB of residuals. Neither bound is near: at this size a simple
// kernel is bound by its own instruction issue. Design: one block a slot,
// 112 blocks, no block waits on another (side 1 is sampled again in each
// of its image's 7 blocks). Up to 384 bf16 channels, a block samples both
// sides' features into two k-major bf16 panels in shared memory (2 x 384 x
// 136 x 2 B = 204 KB), one warp a sample keeping its samples in registers
// for the l2 norm. Every channel at once would not fit beside the taps
// above that (408 KB of bf16 panels at ViT-B's 768 channels, 418 KB of f32
// at 384): the block first computes every sample's norm over all channels
// (one warp a sample), then samples the channels a chunk at a time again
// with the same FMA order, divided by the norms (bf16: 384 channels a
// chunk; f32: 128, 2 x 128 x 136 x 4 B = 139 KB). Each of the 256 threads
// accumulates an 8 x 8 tile of fd in registers with f32 FMA across the
// chunks in channel order; then the block samples the code into the same
// shared memory (f32 panels) and accumulates the matching 8 x 8 tile of
// cd; row sums reduce over the 16 threads of a row group by warp shuffles.
// The chunks change no sum: at ViT-B's 768 channels fd is the channel-order
// f32 sum it would be in one panel.
//
// Backward (_sbwd_kernel, :187-307), again one block a slot: it recomputes
// cd from the residual code panels (the same FMA order as the forward, so
// the clamp mask is the forward's), forms
// coeff = (-(fd' - shift) mask g_loss + g_cdm) / m with the pointwise
// fd' = fd - rowmean + the group's fd mean, then dz1 = coeff c2n and
// dz2 = coeff^T c1n (the self slot's dz2 is side 1's too), applies the
// l2-normalise Jacobian (_norm_jac, :69-76; the projection is dropped below
// eps) and scatters each sample's gradient through its four taps into the
// code maps with atomicAdd: side 1 into dcode[b], side 2 into dcode_pos[b]
// (g = 1) or dcode[perm_k(b)]. The TPU kernel folds the negatives with a
// one-hot matmul because scatters serialise there; here f32 atomics make
// the gradient's last bits depend on the order of the adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSMax = 128;         // samples a block takes (S <= 128)
constexpr int kPitch = kSMax + 8;  // k-major panel row, in elements
constexpr int kMaxFeat = 768;      // feature channels (ViT-B)
constexpr int kWholeBf16 = 384;    // bf16 channels a panel takes at once
constexpr int kMaxCode = 96;       // code channels
constexpr int kFwdThreads = 256;   // 16 x 16 threads, one 8 x 8 tile each
constexpr int kBwdThreads = 288;   // 9 warps
constexpr int kCoeffPitch = kSMax + 1;
constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum over the 16 lanes of a half warp (the threads of one row group).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four bilinear taps of grid point (gx, gy) on an h x w map: flat
// indices and f32 weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx, in the
// order and rounding of sampling.py:_corner_weights and
// bilinear_sample_weights. On a border clamp fx or fy is 0 and the second
// tap of the pair carries weight 0.
__device__ void make_taps(const float* grid_point, int h, int w, int* idx,
                          float* wt) {
  float ix = __fmul_rn(__fmul_rn(__fadd_rn(grid_point[0], 1.0f), 0.5f),
                       static_cast<float>(w - 1));
  float iy = __fmul_rn(__fmul_rn(__fadd_rn(grid_point[1], 1.0f), 0.5f),
                       static_cast<float>(h - 1));
  ix = fminf(fmaxf(ix, 0.0f), static_cast<float>(w - 1));
  iy = fminf(fmaxf(iy, 0.0f), static_cast<float>(h - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const float fx = __fsub_rn(ix, x0f);
  const float fy = __fsub_rn(iy, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float ax = __fsub_rn(1.0f, fx);
  const float ay = __fsub_rn(1.0f, fy);
  idx[0] = y0 * w + x0;
  idx[1] = y0 * w + x1;
  idx[2] = y1 * w + x0;
  idx[3] = y1 * w + x1;
  wt[0] = __fmul_rn(ay, ax);
  wt[1] = __fmul_rn(ay, fx);
  wt[2] = __fmul_rn(fy, ax);
  wt[3] = __fmul_rn(fy, fx);
}

// Taps of both sides' samples into shared memory: side 0 from grid_a,
// side 1 from grid_b, each (s, 2) f32.
__device__ void load_taps(const float* grid_a, const float* grid_b, int s,
                          int h, int w, int* tap_idx, float* tap_w) {
  for (int i = threadIdx.x; i < 2 * s; i += blockDim.x) {
    const int side = i / s;
    const int k = i - side * s;
    const float* gp = (side == 0 ? grid_a : grid_b) + 2 * k;
    make_taps(gp, h, w, tap_idx + (side * kSMax + k) * 4,
              tap_w + (side * kSMax + k) * 4);
  }
}

// Channel c of the feature sample at taps (idx, wt): sum_t w_t f[idx_t]
// with f32 FMA, the same order wherever it is called. bf16 features take
// the weights rounded to bf16 and round the sum to bf16 (_sfwd_kernel
// :101-110); f32 features neither.
__device__ __forceinline__ float sample_at(const __nv_bfloat16* f,
                                           const int* idx, const float* wt,
                                           int cf, int c) {
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v = fmaf(bf16_round(wt[t]),
             __bfloat162float(f[static_cast<size_t>(idx[t]) * cf + c]), v);
  }
  return bf16_round(v);
}

__device__ __forceinline__ float sample_at(const float* f, const int* idx,
                                           const float* wt, int cf, int c) {
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v = fmaf(wt[t], f[static_cast<size_t>(idx[t]) * cf + c], v);
  }
  return v;
}

// The l2 norms max(|z|, eps) of the feature map f (hw, cf) sampled at s
// points, over all cf channels, into norm (s). One warp a sample, lanes over
// channels: lane l sums channels l, l + 32, ... in order.
template <typename FeatT>
__device__ void feat_norms(const FeatT* f, const int* tap_idx,
                           const float* tap_w, int s, int cf, float* norm) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < s; k += warps) {
    int idx[4];
    float wt[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      idx[t] = tap_idx[k * 4 + t];
      wt[t] = tap_w[k * 4 + t];
    }
    float sq = 0.f;
    for (int c = lane; c < cf; c += 32) {
      const float v = sample_at(f, idx, wt, cf, c);
      sq = fmaf(v, v, sq);
    }
    const float d = fmaxf(sqrtf(warp_sum(sq)), kEps);
    if (lane == 0) norm[k] = d;
  }
}

// Channels c0 .. c0 + depth - 1 of the feature map f sampled at s points and
// divided by their norms (feat_norms), into the k-major panel (depth rows of
// kPitch) in the feature type. One warp a sample, lanes over channels.
template <typename FeatT>
__device__ void sample_feats(const FeatT* f, const int* tap_idx,
                             const float* tap_w, int s, int cf, int c0,
                             int depth, const float* norm, FeatT* panel) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < s; k += warps) {
    int idx[4];
    float wt[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      idx[t] = tap_idx[k * 4 + t];
      wt[t] = tap_w[k * 4 + t];
    }
    const float d = norm[k];
    for (int cl = lane; cl < depth; cl += 32) {
      const float z = sample_at(f, idx, wt, cf, c0 + cl) / d;
      if constexpr (std::is_same<FeatT, float>::value) {
        panel[cl * kPitch + k] = z;
      } else {
        panel[cl * kPitch + k] = __float2bfloat16_rn(z);
      }
    }
  }
}

// Every channel (cf <= kWholeBf16) of the bf16 feature map f sampled at s
// points, l2-normalised, into the k-major bf16 panel in one pass: each lane
// keeps its channels' samples in registers for the norm. The same values as
// feat_norms and then sample_feats, which read the features twice.
__device__ void sample_feats_whole(const __nv_bfloat16* f, const int* tap_idx,
                                   const float* tap_w, int s, int cf,
                                   __nv_bfloat16* panel) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < s; k += warps) {
    int idx[4];
    float wb[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      idx[t] = tap_idx[k * 4 + t];
      wb[t] = bf16_round(tap_w[k * 4 + t]);
    }
    float z[kWholeBf16 / 32];
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kWholeBf16 / 32; ++u) {
      const int c = lane + 32 * u;
      float v = 0.f;
      if (c < cf) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v = fmaf(wb[t],
                   __bfloat162float(f[static_cast<size_t>(idx[t]) * cf + c]),
                   v);
        }
        v = bf16_round(v);
      }
      z[u] = v;
      sq = fmaf(v, v, sq);
    }
    const float d = fmaxf(sqrtf(warp_sum(sq)), kEps);
#pragma unroll
    for (int u = 0; u < kWholeBf16 / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < cf) panel[c * kPitch + k] = __float2bfloat16_rn(z[u] / d);
    }
  }
}

// Samples the f32 code map c (hw, cc) at s points into the k-major f32 panel
// (cc rows of kPitch): z = sum_t w_t c[idx_t], l2-normalised. When z_out is
// given, also writes the normalised rows (s, cc) and the raw norms (s).
__device__ void sample_code(const float* code, const int* tap_idx,
                            const float* tap_w, int s, int cc, float* panel,
                            float* z_out, float* norm_out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < s; k += warps) {
    int idx[4];
    float wt[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      idx[t] = tap_idx[k * 4 + t];
      wt[t] = tap_w[k * 4 + t];
    }
    float z[kMaxCode / 32];
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxCode / 32; ++u) {
      const int c = lane + 32 * u;
      float v = 0.f;
      if (c < cc) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v = fmaf(wt[t], code[static_cast<size_t>(idx[t]) * cc + c], v);
        }
      }
      z[u] = v;
      sq = fmaf(v, v, sq);
    }
    const float n = sqrtf(warp_sum(sq));
    const float d = fmaxf(n, kEps);
#pragma unroll
    for (int u = 0; u < kMaxCode / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < cc) {
        const float zn = z[u] / d;
        panel[c * kPitch + k] = zn;
        if (z_out != nullptr) z_out[k * cc + c] = zn;
      }
    }
    if (norm_out != nullptr && lane == 0) norm_out[k] = n;
  }
}

__device__ __forceinline__ void unpack8(uint4 v, float* out) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
        &words[i]);
    const float2 f = __bfloat1622float2(p);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// acc[i][j] = sum_k a[k][r0 + i] b[k][c0 + j] over k-major bf16 panels.
__device__ __forceinline__ void tile_dot_bf16(const __nv_bfloat16* a,
                                              const __nv_bfloat16* b,
                                              int depth, int r0, int c0,
                                              float (&acc)[8][8]) {
  for (int k = 0; k < depth; ++k) {
    float av[8], bv[8];
    unpack8(*reinterpret_cast<const uint4*>(a + k * kPitch + r0), av);
    unpack8(*reinterpret_cast<const uint4*>(b + k * kPitch + c0), bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][j] = sum_k a[k][r0 + i] b[k][c0 + j] over k-major f32 panels.
__device__ __forceinline__ void tile_dot_f32(const float* a, const float* b,
                                             int depth, int r0, int c0,
                                             float (&acc)[8][8]) {
  for (int k = 0; k < depth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kPitch + r0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + k * kPitch + r0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kPitch + c0);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + k * kPitch + c0 + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// true for the f32 feature instantiation
template <typename FeatT>
__host__ __device__ constexpr bool f32_feats() {
  return std::is_same<FeatT, float>::value;
}

// Feature channels of a panel: 384 bf16 (every channel of ViT-S in one
// chunk) or 128 f32.
template <typename FeatT>
__host__ __device__ constexpr int feat_chunk() {
  return f32_feats<FeatT>() ? 128 : kWholeBf16;
}

// Bytes of the forward's panel region: two feature panels of a chunk of
// channels, later two f32 code panels.
template <typename FeatT>
__host__ __device__ __forceinline__ size_t panels_bytes(int cf, int cc) {
  const int rows = cf > feat_chunk<FeatT>() ? feat_chunk<FeatT>() : cf;
  const size_t feat = 2 * static_cast<size_t>(rows) * kPitch * sizeof(FeatT);
  const size_t code = 2 * static_cast<size_t>(cc) * kPitch * sizeof(float);
  return feat > code ? feat : code;
}

__device__ void zero_shared(void* p, size_t bytes) {
  uint4* q = static_cast<uint4*>(p);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) q[i] = z;
}

// Image, grid and code map of a slot's side 2; false when the slot's
// permutation entry is out of range.
struct Side2 {
  int image;     // index into feats/code (0 <= image < batch)
  bool pos;      // side 2 is the positive map (feats_pos, code_pos)
  bool self;     // g == 0: side 2 is side 1, sampled at grid1
};

__device__ bool side2_of(int b, int g, int batch, const int* perms,
                         Side2* out) {
  out->image = b;
  out->pos = g == 1;
  out->self = g == 0;
  if (g >= 2) {
    const int p = perms[(g - 2) * batch + b];
    if (p < 0 || p >= batch) return false;
    out->image = p;
  }
  return true;
}

// fd (8 x 8 a thread at rows r0, columns c0) of the slot whose side 1 is
// map f1 sampled at the first kSMax taps and side 2 map f2 at the next, over
// the panel region p (the panels_bytes<FeatT> bytes at the start of shared
// memory, zeroed; on return it may be reused). kWhole (bf16, cf <=
// kWholeBf16): every channel sampled and normalised in one pass. Otherwise
// the norms (2 kSMax floats of shared memory) come first, then the channels
// in chunks, fd accumulating over them in channel order. The two are
// separate instantiations: compiled into one kernel with the chunked path,
// the one-pass path ran about 1.3x slower on an H100 (PERF.md).
template <typename FeatT, bool kWhole>
__device__ void feature_fd(const FeatT* f1, const FeatT* f2,
                           const int* tap_idx, const float* tap_w, int s,
                           int cf, unsigned char* p, float* norm, int r0,
                           int c0, float (&fd)[8][8]) {
  constexpr int kChunk = feat_chunk<FeatT>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) fd[i][j] = 0.f;
  }
  FeatT* p1 = reinterpret_cast<FeatT*>(p);
  FeatT* p2 = p1 + static_cast<size_t>(min(kChunk, cf)) * kPitch;
  if constexpr (kWhole) {
    sample_feats_whole(f1, tap_idx, tap_w, s, cf, p1);
    sample_feats_whole(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s, cf, p2);
    __syncthreads();
    tile_dot_bf16(p1, p2, cf, r0, c0, fd);
  } else {
    feat_norms(f1, tap_idx, tap_w, s, cf, norm);
    feat_norms(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s, cf,
               norm + kSMax);
    for (int ch0 = 0; ch0 < cf; ch0 += kChunk) {
      const int depth = min(kChunk, cf - ch0);
      // the norms are written, every thread is done with the last chunk
      __syncthreads();
      sample_feats(f1, tap_idx, tap_w, s, cf, ch0, depth, norm, p1);
      sample_feats(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s, cf, ch0,
                   depth, norm + kSMax, p2);
      __syncthreads();
      if constexpr (f32_feats<FeatT>()) {
        tile_dot_f32(p1, p2, depth, r0, c0, fd);
      } else {
        tile_dot_bf16(p1, p2, depth, r0, c0, fd);
      }
    }
  }
}

template <typename FeatT, bool kWhole>
__global__ void __launch_bounds__(kFwdThreads, 1)
corr_sampled_fwd_kernel(const FeatT* __restrict__ feats,
                        const FeatT* __restrict__ feats_pos,
                        const float* __restrict__ code,
                        const float* __restrict__ code_pos,
                        const float* __restrict__ grid1,
                        const float* __restrict__ grid2,
                        const int* __restrict__ perms, float* __restrict__ acc,
                        float* __restrict__ z2cn, float* __restrict__ fd_out,
                        int batch, int h, int w, int cf, int cc, int s, int g,
                        float lo, float hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.x;
  const int b = slot / g;
  const int gi = slot - b * g;
  const int hw = h * w;
  float* acc_s = acc + static_cast<size_t>(slot) * 5 * s;

  Side2 side2;
  if (!side2_of(b, gi, batch, perms, &side2)) {
    // an out-of-range permutation entry: NaN row sums, no read
    for (int i = threadIdx.x; i < 5 * s; i += blockDim.x) acc_s[i] = NAN;
    return;
  }

  const size_t panel_bytes = panels_bytes<FeatT>(cf, cc);
  int* tap_idx = reinterpret_cast<int*>(smem + panel_bytes);
  float* tap_w = reinterpret_cast<float*>(tap_idx + 2 * kSMax * 4);
  float* norm = tap_w + 2 * kSMax * 4;  // 2 kSMax norms unless kWhole

  const float* g1 = grid1 + static_cast<size_t>(b) * s * 2;
  const float* g2 = (side2.self ? grid1 : grid2) + static_cast<size_t>(b) * s * 2;
  zero_shared(smem, panel_bytes);
  load_taps(g1, g2, s, h, w, tap_idx, tap_w);
  __syncthreads();

  // features: side 1 from feats[b], side 2 from its image
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 8;  // 16 row groups of 8
  const int c0 = (tid & 15) * 8;  // 16 column groups of 8
  const FeatT* f2src = side2.pos ? feats_pos : feats;
  float fd[8][8];
  feature_fd<FeatT, kWhole>(feats + static_cast<size_t>(b) * hw * cf,
                    f2src + static_cast<size_t>(side2.image) * hw * cf,
                    tap_idx, tap_w, s, cf, smem, norm, r0, c0, fd);
  __syncthreads();  // every thread is done with the feature panels

  // code, f32, into the same shared memory
  float* q1 = reinterpret_cast<float*>(smem);
  float* q2 = q1 + static_cast<size_t>(cc) * kPitch;
  zero_shared(smem, 2 * static_cast<size_t>(cc) * kPitch * sizeof(float));
  __syncthreads();
  const float* c2src = side2.pos ? code_pos : code;
  sample_code(code + static_cast<size_t>(b) * hw * cc, tap_idx, tap_w, s, cc,
              q1, nullptr, nullptr);
  sample_code(c2src + static_cast<size_t>(side2.image) * hw * cc,
              tap_idx + kSMax * 4, tap_w + kSMax * 4, s, cc, q2,
              z2cn + static_cast<size_t>(slot) * s * cc, acc_s + 4 * s);
  __syncthreads();

  float cd[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) cd[i][j] = 0.f;
  }
  tile_dot_f32(q1, q2, cc, r0, c0, cd);

  float* fd_s = fd_out + static_cast<size_t>(slot) * s * s;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      if (r < s && c < s) {
        const float cdc = fminf(fmaxf(cd[i][j], lo), hi);
        s1 = fmaf(cdc, fd[i][j], s1);
        s2 += cdc;
        s3 += fd[i][j];
        s4 += cd[i][j];
        fd_s[r * s + c] = fd[i][j];
      }
    }
    s1 = half_warp_sum(s1);
    s2 = half_warp_sum(s2);
    s3 = half_warp_sum(s3);
    s4 = half_warp_sum(s4);
    if ((tid & 15) == 0 && r < s) {
      acc_s[r] = s1;
      acc_s[s + r] = s2;
      acc_s[2 * s + r] = s3;
      acc_s[3 * s + r] = s4;
    }
  }
}

// out tile (8 x 8) at rows m0, columns n0 of sum_k A[m][k] B[k][n], A read
// as a[m * a_m + k * a_k] (scalar), B row-major with row pitch ldb (two
// float4 a row, n0 a multiple of 4).
__device__ __forceinline__ void tile_gemm(const float* a, int a_m, int a_k,
                                          const float* bm, int ldb, int depth,
                                          int m0, int n0, float (&out)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
  }
  for (int k = 0; k < depth; ++k) {
    float av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = a[(m0 + i) * a_m + k * a_k];
    const float4 b0 = *reinterpret_cast<const float4*>(bm + k * ldb + n0);
    const float4 b1 = *reinterpret_cast<const float4*>(bm + k * ldb + n0 + 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
    }
  }
}

// Cotangent of v / max(|v|, eps) for one sample row, lanes over channels
// (_norm_jac, :69-76): (g - [n > eps] vn (vn . g)) / max(n, eps).
__device__ __forceinline__ void norm_jac_row(float (&gv)[kMaxCode / 32],
                                             const float (&vn)[kMaxCode / 32],
                                             float n) {
  float dot = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxCode / 32; ++u) dot = fmaf(vn[u], gv[u], dot);
  dot = warp_sum(dot);
  const float inv = 1.0f / fmaxf(n, kEps);
#pragma unroll
  for (int u = 0; u < kMaxCode / 32; ++u) {
    const float proj = n > kEps ? __fmul_rn(vn[u], dot) : 0.f;
    gv[u] = __fmul_rn(__fsub_rn(gv[u], proj), inv);
  }
}

// Adds one sample row's gradient into the code map through its four taps.
__device__ __forceinline__ void scatter_row(float* dst, const int* idx,
                                            const float* wt, int cc,
                                            const float (&gv)[kMaxCode / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (wt[t] == 0.f) continue;
    float* row = dst + static_cast<size_t>(idx[t]) * cc;
#pragma unroll
    for (int u = 0; u < kMaxCode / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < cc) atomicAdd(row + c, __fmul_rn(wt[t], gv[u]));
    }
  }
}

// scal: (g, 5) per group: g_loss, g_cdm, fd mean, shift, 1/m.
// dz: (slots, 2, s, cc) scratch for dz1 and dz2.
__global__ void __launch_bounds__(kBwdThreads, 1)
corr_sampled_bwd_kernel(const float* __restrict__ grid1,
                        const float* __restrict__ grid2,
                        const int* __restrict__ perms,
                        const float* __restrict__ z2cn,
                        const float* __restrict__ fd_res,
                        const float* __restrict__ acc,
                        const float* __restrict__ scal, float* dz,
                        float* dcode, float* dcode_pos, int batch, int h,
                        int w, int cc, int s, int g, float lo, float hi,
                        int pointwise, float inv_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.x;
  const int b = slot / g;
  const int gi = slot - b * g;
  const int slot0 = b * g;
  Side2 side2;
  if (!side2_of(b, gi, batch, perms, &side2)) return;

  const int cp = (cc + 7) & ~7;  // code channels padded to tiles of 8
  float* z1 = reinterpret_cast<float*>(smem);      // [kSMax][cp] row-major
  float* z2 = z1 + kSMax * cp;                     // [kSMax][cp]
  float* z2t = z2 + kSMax * cp;                    // [cp][kPitch] k-major
  float* coeff = z2t + cp * kPitch;                // [kSMax][kCoeffPitch]
  int* tap_idx = reinterpret_cast<int*>(coeff + kSMax * kCoeffPitch);
  float* tap_w = reinterpret_cast<float*>(tap_idx + 2 * kSMax * 4);

  const float* g1 = grid1 + static_cast<size_t>(b) * s * 2;
  const float* g2 = (side2.self ? grid1 : grid2) + static_cast<size_t>(b) * s * 2;
  const size_t zero_bytes =
      (2 * static_cast<size_t>(kSMax) * cp + static_cast<size_t>(cp) * kPitch)
      * sizeof(float);
  zero_shared(smem, zero_bytes);
  load_taps(g1, g2, s, h, w, tap_idx, tap_w);
  __syncthreads();
  const float* zr1 = z2cn + static_cast<size_t>(slot0) * s * cc;
  const float* zr2 = z2cn + static_cast<size_t>(slot) * s * cc;
  for (int i = threadIdx.x; i < s * cc; i += blockDim.x) {
    const int k = i / cc;
    const int c = i - k * cc;
    z1[k * cp + c] = zr1[i];
    z2[k * cp + c] = zr2[i];
    z2t[c * kPitch + k] = zr2[i];
  }
  __syncthreads();

  const float* sc = scal + gi * 5;
  const float g_loss = sc[0], g_cdm = sc[1], gm = sc[2], shift = sc[3],
              inv_m = sc[4];
  const float* acc_s = acc + static_cast<size_t>(slot) * 5 * s;
  const float* fd_s = fd_res + static_cast<size_t>(slot) * s * s;
  const int tid = threadIdx.x;
  if (tid < 256) {
    const int r0 = (tid >> 4) * 8;
    const int c0 = (tid & 15) * 8;
    // cd again, with the forward's order of FMAs: k-major side 1 is z1
    // read down a column
    float cd[8][8];
    tile_gemm(z1, cp, 1, z2t, kPitch, cc, r0, c0, cd);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      const float rowmean = r < s ? __fmul_rn(acc_s[2 * s + r], inv_n) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + j;
        float v = 0.f;
        if (r < s && c < s) {
          const float fdv = fd_s[r * s + c];
          const float fdp =
              pointwise ? __fadd_rn(__fsub_rn(fdv, rowmean), gm) : fdv;
          const float mask = (cd[i][j] >= lo && cd[i][j] <= hi) ? 1.f : 0.f;
          v = __fmul_rn(-__fsub_rn(fdp, shift), mask);
          v = __fmul_rn(__fadd_rn(__fmul_rn(v, g_loss), g_cdm), inv_m);
        }
        coeff[r * kCoeffPitch + c] = v;
      }
    }
  }
  __syncthreads();

  // dz1 = coeff z2 (rows of side 1), dz2 = coeff^T z1 (rows of side 2)
  float* dz_s = dz + static_cast<size_t>(slot) * 2 * s * cc;
  const int ncg = cp / 8;
  const int tiles = 16 * ncg;
  for (int t = tid; t < 2 * tiles; t += blockDim.x) {
    const int which = t / tiles;
    const int m0 = ((t - which * tiles) / ncg) * 8;
    const int n0 = ((t - which * tiles) % ncg) * 8;
    float out[8][8];
    if (which == 0) {
      tile_gemm(coeff, kCoeffPitch, 1, z2, cp, s, m0, n0, out);
    } else {
      tile_gemm(coeff, 1, kCoeffPitch, z1, cp, s, m0, n0, out);
    }
    float* dst = dz_s + static_cast<size_t>(which) * s * cc;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (m0 + i < s && n0 + j < cc) dst[(m0 + i) * cc + n0 + j] = out[i][j];
      }
    }
  }
  __syncthreads();

  // Jacobian of the normalisation, then back through the taps
  const float* n1 = acc + static_cast<size_t>(slot0) * 5 * s + 4 * s;
  const float* n2 = acc_s + 4 * s;
  float* side2_dst =
      side2.pos ? dcode_pos + static_cast<size_t>(b) * h * w * cc
                : dcode + static_cast<size_t>(side2.image) * h * w * cc;
  float* side1_dst = dcode + static_cast<size_t>(b) * h * w * cc;
  const int lane = tid & 31;
  for (int k = tid >> 5; k < s; k += blockDim.x >> 5) {
    float gv[kMaxCode / 32], vn[kMaxCode / 32];
#pragma unroll
    for (int u = 0; u < kMaxCode / 32; ++u) {
      const int c = lane + 32 * u;
      gv[u] = 0.f;
      vn[u] = 0.f;
      if (c < cc) {
        gv[u] = dz_s[k * cc + c];
        if (gi == 0) gv[u] = __fadd_rn(gv[u], dz_s[(s + k) * cc + c]);
        vn[u] = z1[k * cp + c];
      }
    }
    norm_jac_row(gv, vn, n1[k]);
    scatter_row(side1_dst, tap_idx + k * 4, tap_w + k * 4, cc, gv);
    if (gi == 0) continue;
#pragma unroll
    for (int u = 0; u < kMaxCode / 32; ++u) {
      const int c = lane + 32 * u;
      gv[u] = c < cc ? dz_s[(s + k) * cc + c] : 0.f;
      vn[u] = c < cc ? z2[k * cp + c] : 0.f;
    }
    norm_jac_row(gv, vn, n2[k]);
    scatter_row(side2_dst, tap_idx + (kSMax + k) * 4,
                tap_w + (kSMax + k) * 4, cc, gv);
  }
}

template <typename FeatT, bool kWhole>
size_t fwd_smem_bytes(int cf, int cc) {
  return panels_bytes<FeatT>(cf, cc)
         + 2 * kSMax * 4 * (sizeof(int) + sizeof(float))
         + (kWhole ? 0 : 2 * kSMax * sizeof(float));
}

template <typename FeatT, bool kWhole>
cudaError_t launch_fwd(const void* feats, const void* feats_pos,
                       const void* code, const void* code_pos,
                       const void* grid1, const void* grid2,
                       const void* perms, void* acc, void* z2cn, void* fd,
                       int batch, int h, int w, int cf, int cc, int s, int g,
                       float lo, float hi, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<FeatT, kWhole>(cf, cc);
  cudaError_t err = cudaFuncSetAttribute(
      corr_sampled_fwd_kernel<FeatT, kWhole>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  corr_sampled_fwd_kernel<FeatT, kWhole>
      <<<batch * g, kFwdThreads, smem, stream>>>(
      static_cast<const FeatT*>(feats), static_cast<const FeatT*>(feats_pos),
      static_cast<const float*>(code), static_cast<const float*>(code_pos),
      static_cast<const float*>(grid1), static_cast<const float*>(grid2),
      static_cast<const int*>(perms), static_cast<float*>(acc),
      static_cast<float*>(z2cn), static_cast<float*>(fd), batch, h, w, cf, cc,
      s, g, lo, hi);
  return cudaGetLastError();
}

size_t bwd_smem_bytes(int cc) {
  const size_t cp = (cc + 7) & ~7;
  return (2 * kSMax * cp + cp * kPitch + kSMax * kCoeffPitch) * sizeof(float)
         + 2 * kSMax * 4 * (sizeof(int) + sizeof(float));
}

}  // namespace

// feats, feats_pos: (batch, h * w, cf), bf16 (feat_f32 = 0) or f32
// (feat_f32 = 1); code, code_pos: (batch, h * w, cc) f32; grid1, grid2:
// (batch, s, 2) f32 sample points in the reference's transposed order;
// perms: (g - 2, batch) int32. Writes acc (batch * g, 5, s): s1, s2, s3,
// sum cd and the side-2 code norms of each slot (slot = b * g + pair type);
// z2cn (batch * g, s, cc) and fd (batch * g, s, s). cf <= 768, cc <= 96,
// s <= 128, g >= 2. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int stego_corr_sampled_fwd(
    const void* feats, const void* feats_pos, const void* code,
    const void* code_pos, const void* grid1, const void* grid2,
    const void* perms, void* acc, void* z2cn, void* fd, int batch, int h,
    int w, int cf, int cc, int s, int g, int feat_f32, float lo, float hi,
    int device, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cf <= 0 || cf > kMaxFeat ||
      cc <= 0 || cc > kMaxCode || s <= 0 || s > kSMax || g < 2 ||
      static_cast<long long>(batch) * g > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_f32) {
    err = launch_fwd<float, false>(feats, feats_pos, code, code_pos, grid1,
                                   grid2, perms, acc, z2cn, fd, batch, h, w,
                                   cf, cc, s, g, lo, hi, st);
  } else if (cf <= kWholeBf16) {
    err = launch_fwd<__nv_bfloat16, true>(feats, feats_pos, code, code_pos,
                                          grid1, grid2, perms, acc, z2cn, fd,
                                          batch, h, w, cf, cc, s, g, lo, hi,
                                          st);
  } else {
    err = launch_fwd<__nv_bfloat16, false>(feats, feats_pos, code, code_pos,
                                           grid1, grid2, perms, acc, z2cn,
                                           fd, batch, h, w, cf, cc, s, g, lo,
                                           hi, st);
  }
  return static_cast<int>(err);
}

// Residuals of the forward (z2cn, fd, acc) and scal (g, 5) per group:
// g_loss, g_cdm, fd mean, shift, 1/m. dz: (batch * g, 2, s, cc) f32
// scratch. Adds the code gradients into dcode and dcode_pos, (batch, h * w,
// cc) f32, which the caller zeroes. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int stego_corr_sampled_bwd(
    const void* grid1, const void* grid2, const void* perms, const void* z2cn,
    const void* fd, const void* acc, const void* scal, void* dz, void* dcode,
    void* dcode_pos, int batch, int h, int w, int cc, int s, int g, float lo,
    float hi, int pointwise, float inv_n, int device, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cc <= 0 || cc > kMaxCode || s <= 0 ||
      s > kSMax || g < 2 ||
      static_cast<long long>(batch) * g > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem_bytes(cc);
  err = cudaFuncSetAttribute(corr_sampled_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_sampled_bwd_kernel<<<batch * g, kBwdThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid1), static_cast<const float*>(grid2),
      static_cast<const int*>(perms), static_cast<const float*>(z2cn),
      static_cast<const float*>(fd), static_cast<const float*>(acc),
      static_cast<const float*>(scal), static_cast<float*>(dz),
      static_cast<float*>(dcode), static_cast<float*>(dcode_pos), batch, h, w,
      cc, s, g, lo, hi, pointwise, inv_n);
  return static_cast<int>(cudaGetLastError());
}
