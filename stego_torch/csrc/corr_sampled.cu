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
// kernel is bound by its own instruction issue. Design: one block a slot
// (112 blocks) and pair of sample tiles, no block waits on another (side 1
// is sampled again in each of its image's 7 blocks). Up to 128 samples a
// side a block takes them all; past that the samples come in tiles of up
// to 128 a side, a block for each pair of tiles, and each block writes its
// rows' sums over its side-2 tile to a slot of its own, which the wrapper
// adds in tile order (finalize's pointwise mean needs every row's full
// sums). Up to 384 bf16 channels, a block samples both
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
// shared memory (f32 panels, 96 channels at a time after a norm pass over
// all of them) and accumulates the matching 8 x 8 tile of cd over the
// chunks in channel order; row sums reduce over the 16 threads of a row
// group by warp shuffles. Up to 96 code channels and 128 samples (the
// default shapes) the kOne instantiations sample the code in one pass,
// its norm from the values held in registers, as before the chunks: the
// chunked form cost 7% of the forward there.
// The chunks change no sum: at ViT-B's 768 channels fd is the channel-order
// f32 sum it would be in one panel.
//
// Backward (_sbwd_kernel, :187-307), in two kernels. The first, one block
// a slot and pair of sample tiles as the forward, recomputes
// cd from the residual code panels (the same FMA order as the forward, so
// the clamp mask is the forward's), forms
// coeff = (-(fd' - shift) mask g_loss + g_cdm) / m with the pointwise
// fd' = fd - rowmean + the group's fd mean, then its tiles' parts of
// dz1 = coeff c2n and dz2 = coeff^T c1n (96 code channels at a time), each
// written once to a slot of its own. The second, one block a slot, adds
// the parts in tile order (the self slot's dz2 is side 1's too), applies
// the l2-normalise Jacobian (_norm_jac, :69-76; the projection is dropped
// below eps), which needs the whole row, and scatters each sample's
// gradient through its four taps into the code maps with atomicAdd: side 1
// into dcode[b], side 2 into dcode_pos[b]
// (g = 1) or dcode[perm_k(b)]. The TPU kernel folds the negatives with a
// one-hot matmul because scatters serialise there; here f32 atomics make
// the gradient's last bits depend on the order of the adds. With one code
// chunk and one tile (the default shapes) corr_sampled_bwd_one_kernel does
// both in one block a slot, the backward as it was before the tiles: the
// two kernels cost 16% more there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSMax = 128;         // samples of a side a block takes
constexpr int kPitch = kSMax + 8;  // k-major panel row, in elements
constexpr int kMaxFeat = 768;      // feature channels (ViT-B)
constexpr int kWholeBf16 = 384;    // bf16 channels a panel takes at once
constexpr int kCodeChunk = 96;     // code channels a panel takes at once
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

// Taps of both sides' samples into shared memory: side 0, na samples from
// grid_a, at entries 0 ..; side 1, nb samples from grid_b, at entries kSMax
// ..; each grid (samples, 2) f32.
__device__ void load_taps(const float* grid_a, int na, const float* grid_b,
                          int nb, int h, int w, int* tap_idx, float* tap_w) {
  for (int i = threadIdx.x; i < 2 * kSMax; i += blockDim.x) {
    const int side = i / kSMax;
    const int k = i - side * kSMax;
    if (k >= (side == 0 ? na : nb)) continue;
    const float* gp = (side == 0 ? grid_a : grid_b) + 2 * k;
    make_taps(gp, h, w, tap_idx + i * 4, tap_w + i * 4);
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

// Samples the f32 code map c (hw, cc <= kCodeChunk) at s points into the
// k-major f32 panel (cc rows of kPitch): z = sum_t w_t c[idx_t],
// l2-normalised, in one pass with z held in registers. When z_out is given,
// also writes the normalised rows (s, cc), and when norm_out is, the raw
// norms (s). The same sums as code_norms and sample_code.
__device__ void sample_code_whole(const float* code, const int* tap_idx,
                                  const float* tap_w, int s, int cc,
                                  float* panel, float* z_out,
                                  float* norm_out) {
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
    float z[kCodeChunk / 32];
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kCodeChunk / 32; ++u) {
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
    for (int u = 0; u < kCodeChunk / 32; ++u) {
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

// The raw l2 norms |z| of the f32 code map (hw, cc) sampled at s points,
// z = sum_t w_t c[idx_t] over all cc channels, into norm (s). One warp a
// sample, lanes over channels: lane l sums channels l, l + 32, ... in order.
__device__ void code_norms(const float* code, const int* tap_idx,
                           const float* tap_w, int s, int cc, float* norm) {
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
    for (int c = lane; c < cc; c += 32) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v = fmaf(wt[t], code[static_cast<size_t>(idx[t]) * cc + c], v);
      }
      sq = fmaf(v, v, sq);
    }
    const float n = sqrtf(warp_sum(sq));
    if (lane == 0) norm[k] = n;
  }
}

// Code channels c0 .. c0 + depth - 1 of the f32 code map sampled at s points
// and divided by max(norm, eps) (code_norms), into the k-major f32 panel
// (depth rows of kPitch). When z_out is given, also writes the normalised
// values into its rows (s, cc).
__device__ void sample_code(const float* code, const int* tap_idx,
                            const float* tap_w, int s, int cc, int c0,
                            int depth, const float* norm, float* panel,
                            float* z_out) {
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
    const float d = fmaxf(norm[k], kEps);
    for (int cl = lane; cl < depth; cl += 32) {
      const int c = c0 + cl;
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v = fmaf(wt[t], code[static_cast<size_t>(idx[t]) * cc + c], v);
      }
      const float zn = v / d;
      panel[cl * kPitch + k] = zn;
      if (z_out != nullptr) z_out[k * cc + c] = zn;
    }
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
  const size_t code =
      2 * static_cast<size_t>(min(cc, kCodeChunk)) * kPitch * sizeof(float);
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
// map f1 sampled at the first kSMax taps (s1 of them) and side 2 map f2 at
// the next (s2), over
// the panel region p (the panels_bytes<FeatT> bytes at the start of shared
// memory, zeroed; on return it may be reused). kWhole (bf16, cf <=
// kWholeBf16): every channel sampled and normalised in one pass. Otherwise
// the norms (2 kSMax floats of shared memory) come first, then the channels
// in chunks, fd accumulating over them in channel order. The two are
// separate instantiations: compiled into one kernel with the chunked path,
// the one-pass path ran about 1.3x slower on an H100 (PERF.md).
template <typename FeatT, bool kWhole>
__device__ void feature_fd(const FeatT* f1, const FeatT* f2,
                           const int* tap_idx, const float* tap_w, int s1,
                           int s2, int cf, unsigned char* p, float* norm,
                           int r0, int c0, float (&fd)[8][8]) {
  constexpr int kChunk = feat_chunk<FeatT>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) fd[i][j] = 0.f;
  }
  FeatT* p1 = reinterpret_cast<FeatT*>(p);
  FeatT* p2 = p1 + static_cast<size_t>(min(kChunk, cf)) * kPitch;
  if constexpr (kWhole) {
    sample_feats_whole(f1, tap_idx, tap_w, s1, cf, p1);
    sample_feats_whole(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2, cf, p2);
    __syncthreads();
    tile_dot_bf16(p1, p2, cf, r0, c0, fd);
  } else {
    feat_norms(f1, tap_idx, tap_w, s1, cf, norm);
    feat_norms(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2, cf,
               norm + kSMax);
    for (int ch0 = 0; ch0 < cf; ch0 += kChunk) {
      const int depth = min(kChunk, cf - ch0);
      // the norms are written, every thread is done with the last chunk
      __syncthreads();
      sample_feats(f1, tap_idx, tap_w, s1, cf, ch0, depth, norm, p1);
      sample_feats(f2, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2, cf, ch0,
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

// grid (slots, tiles, tiles): the block takes side 1's samples of tile
// blockIdx.y and side 2's of tile blockIdx.z, up to kSMax each. acc (slots,
// tiles, 5, s): rows 0-3 of tile t hold the row sums over side 2's samples
// of tile t (the wrapper adds the tiles), row 4 of tile 0 the side-2 code
// norms. kOne (cc <= kCodeChunk, one tile): the code in one pass.
template <typename FeatT, bool kWhole, bool kOne>
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
  const int tiles = gridDim.y;
  const int i0 = blockIdx.y * kSMax;  // side 1's first sample
  const int j0 = blockIdx.z * kSMax;  // side 2's first sample
  const int s1n = min(kSMax, s - i0);
  const int s2n = min(kSMax, s - j0);
  const bool first_row_tile = blockIdx.y == 0;
  float* acc_s = acc + (static_cast<size_t>(slot) * tiles + blockIdx.z) * 5 * s;
  float* norm_s = acc + static_cast<size_t>(slot) * tiles * 5 * s + 4 * s;

  Side2 side2;
  if (!side2_of(b, gi, batch, perms, &side2)) {
    // an out-of-range permutation entry: NaN row sums, no read
    for (int i = threadIdx.x; i < 4 * s1n; i += blockDim.x) {
      acc_s[(i / s1n) * s + i0 + i % s1n] = NAN;
    }
    if (first_row_tile) {
      for (int i = threadIdx.x; i < s2n; i += blockDim.x) norm_s[j0 + i] = NAN;
    }
    return;
  }

  const size_t panel_bytes = panels_bytes<FeatT>(cf, cc);
  int* tap_idx = reinterpret_cast<int*>(smem + panel_bytes);
  float* tap_w = reinterpret_cast<float*>(tap_idx + 2 * kSMax * 4);
  float* cnorm = tap_w + 2 * kSMax * 4;  // 2 kSMax code norms
  float* norm = cnorm + 2 * kSMax;       // 2 kSMax feature norms unless kWhole

  const float* g1 = grid1 + (static_cast<size_t>(b) * s + i0) * 2;
  const float* g2 =
      (side2.self ? grid1 : grid2) + (static_cast<size_t>(b) * s + j0) * 2;
  zero_shared(smem, panel_bytes);
  load_taps(g1, s1n, g2, s2n, h, w, tap_idx, tap_w);
  __syncthreads();

  // features: side 1 from feats[b], side 2 from its image
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 8;  // 16 row groups of 8
  const int c0 = (tid & 15) * 8;  // 16 column groups of 8
  const FeatT* f2src = side2.pos ? feats_pos : feats;
  float fd[8][8];
  feature_fd<FeatT, kWhole>(feats + static_cast<size_t>(b) * hw * cf,
                    f2src + static_cast<size_t>(side2.image) * hw * cf,
                    tap_idx, tap_w, s1n, s2n, cf, smem, norm, r0, c0, fd);
  __syncthreads();  // every thread is done with the feature panels

  // code, f32, into the same shared memory, kCodeChunk channels at a time;
  // cd accumulates over the chunks in channel order
  const int cw = min(cc, kCodeChunk);
  float* q1 = reinterpret_cast<float*>(smem);
  float* q2 = q1 + static_cast<size_t>(cw) * kPitch;
  zero_shared(smem, 2 * static_cast<size_t>(cw) * kPitch * sizeof(float));
  const float* c1map = code + static_cast<size_t>(b) * hw * cc;
  const float* c2map =
      (side2.pos ? code_pos : code) + static_cast<size_t>(side2.image) * hw * cc;
  float* z_out = first_row_tile
                     ? z2cn + (static_cast<size_t>(slot) * s + j0) * cc
                     : nullptr;
  float cd[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) cd[i][j] = 0.f;
  }
  if constexpr (kOne) {
    __syncthreads();
    sample_code_whole(c1map, tap_idx, tap_w, s1n, cc, q1, nullptr, nullptr);
    sample_code_whole(c2map, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2n, cc,
                      q2, z_out, norm_s);
    __syncthreads();
    tile_dot_f32(q1, q2, cc, r0, c0, cd);
  } else {
    code_norms(c1map, tap_idx, tap_w, s1n, cc, cnorm);
    code_norms(c2map, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2n, cc,
               cnorm + kSMax);
    for (int ch0 = 0; ch0 < cc; ch0 += kCodeChunk) {
      const int depth = min(kCodeChunk, cc - ch0);
      // the norms are written, every thread is done with the last chunk
      __syncthreads();
      sample_code(c1map, tap_idx, tap_w, s1n, cc, ch0, depth, cnorm, q1,
                  nullptr);
      sample_code(c2map, tap_idx + kSMax * 4, tap_w + kSMax * 4, s2n, cc,
                  ch0, depth, cnorm + kSMax, q2, z_out);
      __syncthreads();
      tile_dot_f32(q1, q2, depth, r0, c0, cd);
    }
    if (first_row_tile) {
      for (int i = tid; i < s2n; i += blockDim.x) {
        norm_s[j0 + i] = cnorm[kSMax + i];
      }
    }
  }

  float* fd_s = fd_out + static_cast<size_t>(slot) * s * s;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      if (r < s1n && c < s2n) {
        const float cdc = fminf(fmaxf(cd[i][j], lo), hi);
        s1 = fmaf(cdc, fd[i][j], s1);
        s2 += cdc;
        s3 += fd[i][j];
        s4 += cd[i][j];
        fd_s[static_cast<size_t>(i0 + r) * s + j0 + c] = fd[i][j];
      }
    }
    s1 = half_warp_sum(s1);
    s2 = half_warp_sum(s2);
    s3 = half_warp_sum(s3);
    s4 = half_warp_sum(s4);
    if ((tid & 15) == 0 && r < s1n) {
      acc_s[i0 + r] = s1;
      acc_s[s + i0 + r] = s2;
      acc_s[2 * s + i0 + r] = s3;
      acc_s[3 * s + i0 + r] = s4;
    }
  }
}

// out tile (8 x 8) at rows m0, columns n0 += sum_k A[m][k] B[k][n], A read
// as a[m * a_m + k * a_k] (scalar), B row-major with row pitch ldb (two
// float4 a row, n0 a multiple of 4).
__device__ __forceinline__ void tile_gemm(const float* a, int a_m, int a_k,
                                          const float* bm, int ldb, int depth,
                                          int m0, int n0, float (&out)[8][8]) {
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

__device__ __forceinline__ void zero8x8(float (&x)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
  }
}

// Code channels c0 .. c0 + depth - 1 of the residual rows into shared
// memory: side 1's n1 rows from r1 into z1 and side 2's n2 rows from r2
// into z2 (row-major, pitch cp) and z2t (k-major, kPitch); rows (s, cc).
__device__ void load_code_chunk(const float* r1, int n1, const float* r2,
                                int n2, int cc, int c0, int depth, int cp,
                                float* z1, float* z2, float* z2t) {
  for (int i = threadIdx.x; i < kSMax * depth; i += blockDim.x) {
    const int k = i / depth;
    const int c = i - k * depth;
    z1[k * cp + c] = k < n1 ? r1[static_cast<size_t>(k) * cc + c0 + c] : 0.f;
    const float v = k < n2 ? r2[static_cast<size_t>(k) * cc + c0 + c] : 0.f;
    z2[k * cp + c] = v;
    z2t[c * kPitch + k] = v;
  }
}

// Channel c of a sample's code gradient: its parts summed over the tiles,
// tile order (dz rows (slots, tiles, 2, s, cc); part: 0 dz1, 1 dz2).
__device__ __forceinline__ float dz_sum(const float* dz_slot, int tiles,
                                        int part, int s, int cc, int k,
                                        int c) {
  float v = 0.f;
  for (int t = 0; t < tiles; ++t) {
    v += dz_slot[((static_cast<size_t>(t) * 2 + part) * s + k) * cc + c];
  }
  return v;
}

// Cotangent of v / max(|v|, eps) for one sample row, lanes over channels
// (_norm_jac, :69-76): (g - [n > eps] vn (vn . g)) / max(n, eps), then
// added into the code map through the sample's four taps. g is the row's
// dz1 (part 0) and, for the self slot, dz2 too (both = 1, as side 2 is
// side 1); vn its normalised code, n its raw norm.
__device__ void jac_scatter_row(const float* dz_slot, int tiles, int part,
                                bool both, int s, int cc, int k,
                                const float* vn, float n, float* dst,
                                const int* idx, const float* wt) {
  const int lane = threadIdx.x & 31;
  auto grad = [&](int c) {
    const float g0 = dz_sum(dz_slot, tiles, part, s, cc, k, c);
    return both ? __fadd_rn(g0, dz_sum(dz_slot, tiles, 1, s, cc, k, c)) : g0;
  };
  float dot = 0.f;
  for (int c = lane; c < cc; c += 32) dot = fmaf(vn[c], grad(c), dot);
  dot = warp_sum(dot);
  const float inv = 1.0f / fmaxf(n, kEps);
  for (int c = lane; c < cc; c += 32) {
    const float proj = n > kEps ? __fmul_rn(vn[c], dot) : 0.f;
    const float gv = __fmul_rn(__fsub_rn(grad(c), proj), inv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (wt[t] != 0.f) {
        atomicAdd(dst + static_cast<size_t>(idx[t]) * cc + c,
                  __fmul_rn(wt[t], gv));
      }
    }
  }
}

// Backward, first kernel, grid (slots, tiles, tiles) as the forward's: the
// coefficients of side 1's samples of tile blockIdx.y against side 2's of
// tile blockIdx.z, then their parts of dz1 = coeff z2 and dz2 = coeff^T z1.
// acc: the forward's sums added over the tiles, (slots, 5, s). scal: (g, 5)
// per group: g_loss, g_cdm, fd mean, shift, 1/m. dz: (slots, tiles, 2, s,
// cc): dz1's part from side-2 tile t at [slot, t, 0], dz2's from side-1
// tile t at [slot, t, 1]; every element is written once.
__global__ void __launch_bounds__(kBwdThreads, 1)
corr_sampled_bwd_kernel(const int* __restrict__ perms,
                        const float* __restrict__ z2cn,
                        const float* __restrict__ fd_res,
                        const float* __restrict__ acc,
                        const float* __restrict__ scal, float* dz, int batch,
                        int cc, int s, int g, float lo, float hi,
                        int pointwise, float inv_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.x;
  const int b = slot / g;
  const int gi = slot - b * g;
  const int slot0 = b * g;
  const int tiles = gridDim.y;
  const int i0 = blockIdx.y * kSMax;
  const int j0 = blockIdx.z * kSMax;
  const int s1n = min(kSMax, s - i0);
  const int s2n = min(kSMax, s - j0);
  Side2 side2;
  if (!side2_of(b, gi, batch, perms, &side2)) return;

  const int cw = min(cc, kCodeChunk);
  const int cp = (cw + 7) & ~7;  // code channels padded to tiles of 8
  float* z1 = reinterpret_cast<float*>(smem);      // [kSMax][cp] row-major
  float* z2 = z1 + kSMax * cp;                     // [kSMax][cp]
  float* z2t = z2 + kSMax * cp;                    // [cp][kPitch] k-major
  float* coeff = z2t + cp * kPitch;                // [kSMax][kCoeffPitch]
  const size_t zero_bytes =
      (2 * static_cast<size_t>(kSMax) * cp + static_cast<size_t>(cp) * kPitch)
      * sizeof(float);
  zero_shared(smem, zero_bytes);
  // side 1's normalised code is the self slot's side 2
  const float* zr1 = z2cn + (static_cast<size_t>(slot0) * s + i0) * cc;
  const float* zr2 = z2cn + (static_cast<size_t>(slot) * s + j0) * cc;

  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 8;
  const int c0 = (tid & 15) * 8;
  // cd again, with the forward's order of FMAs: k-major side 1 is z1 read
  // down a column
  float cd[8][8];
  zero8x8(cd);
  for (int ch0 = 0; ch0 < cc; ch0 += kCodeChunk) {
    const int depth = min(kCodeChunk, cc - ch0);
    __syncthreads();  // every thread is done with the last chunk
    load_code_chunk(zr1, s1n, zr2, s2n, cc, ch0, depth, cp, z1, z2, z2t);
    __syncthreads();
    if (tid < 256) tile_gemm(z1, cp, 1, z2t, kPitch, depth, r0, c0, cd);
  }

  const float* sc = scal + gi * 5;
  const float g_loss = sc[0], g_cdm = sc[1], gm = sc[2], shift = sc[3],
              inv_m = sc[4];
  const float* acc_s = acc + static_cast<size_t>(slot) * 5 * s;
  const float* fd_s = fd_res + static_cast<size_t>(slot) * s * s;
  if (tid < 256) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      const float rowmean =
          r < s1n ? __fmul_rn(acc_s[2 * s + i0 + r], inv_n) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + j;
        float v = 0.f;
        if (r < s1n && c < s2n) {
          const float fdv = fd_s[static_cast<size_t>(i0 + r) * s + j0 + c];
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

  // dz1 = coeff z2 (rows of side 1), dz2 = coeff^T z1 (rows of side 2),
  // a chunk of code channels at a time
  float* dz1 = dz + ((static_cast<size_t>(slot) * tiles + blockIdx.z) * 2 *
                     s + i0) * cc;
  float* dz2 = dz + ((static_cast<size_t>(slot) * tiles + blockIdx.y) * 2 *
                     s + s + j0) * cc;
  for (int ch0 = 0; ch0 < cc; ch0 += kCodeChunk) {
    const int depth = min(kCodeChunk, cc - ch0);
    if (cc > kCodeChunk) {  // else the one chunk is still in place
      __syncthreads();  // every thread is done with the last chunk
      load_code_chunk(zr1, s1n, zr2, s2n, cc, ch0, depth, cp, z1, z2, z2t);
    }
    __syncthreads();  // the chunk and the coefficients are written
    const int ncg = (depth + 7) / 8;
    const int ntiles = 16 * ncg;
    for (int t = tid; t < 2 * ntiles; t += blockDim.x) {
      const int which = t / ntiles;
      const int m0 = ((t - which * ntiles) / ncg) * 8;
      const int n0 = ((t - which * ntiles) % ncg) * 8;
      float out[8][8];
      zero8x8(out);
      if (which == 0) {
        tile_gemm(coeff, kCoeffPitch, 1, z2, cp, s2n, m0, n0, out);
      } else {
        tile_gemm(coeff, 1, kCoeffPitch, z1, cp, s1n, m0, n0, out);
      }
      float* dst = which == 0 ? dz1 : dz2;
      const int rows = which == 0 ? s1n : s2n;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (m0 + i < rows && n0 + j < depth) {
            dst[static_cast<size_t>(m0 + i) * cc + ch0 + n0 + j] = out[i][j];
          }
        }
      }
    }
  }
}

// Backward, second kernel, grid (slots, ceil(s / warps a block)): one warp
// a sample; the Jacobian of the normalisation, then back through the taps
// into the code maps.
__global__ void __launch_bounds__(kBwdThreads)
corr_sampled_scatter_kernel(const float* __restrict__ grid1,
                            const float* __restrict__ grid2,
                            const int* __restrict__ perms,
                            const float* __restrict__ z2cn,
                            const float* __restrict__ acc,
                            const float* __restrict__ dz, float* dcode,
                            float* dcode_pos, int batch, int h, int w, int cc,
                            int s, int g, int tiles) {
  const int slot = blockIdx.x;
  const int b = slot / g;
  const int gi = slot - b * g;
  const int slot0 = b * g;
  Side2 side2;
  if (!side2_of(b, gi, batch, perms, &side2)) return;
  const float* g1 = grid1 + static_cast<size_t>(b) * s * 2;
  const float* g2 = (side2.self ? grid1 : grid2) + static_cast<size_t>(b) * s * 2;
  const float* n1 = acc + static_cast<size_t>(slot0) * 5 * s + 4 * s;
  const float* n2 = acc + static_cast<size_t>(slot) * 5 * s + 4 * s;
  const float* v1 = z2cn + static_cast<size_t>(slot0) * s * cc;
  const float* v2 = z2cn + static_cast<size_t>(slot) * s * cc;
  const float* dz_slot = dz + static_cast<size_t>(slot) * tiles * 2 * s * cc;
  float* side2_dst =
      side2.pos ? dcode_pos + static_cast<size_t>(b) * h * w * cc
                : dcode + static_cast<size_t>(side2.image) * h * w * cc;
  float* side1_dst = dcode + static_cast<size_t>(b) * h * w * cc;
  const int k = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (k >= s) return;  // a whole warp
  int idx[4];
  float wt[4];
  make_taps(g1 + 2 * k, h, w, idx, wt);
  jac_scatter_row(dz_slot, tiles, 0, gi == 0, s, cc, k,
                  v1 + static_cast<size_t>(k) * cc, n1[k], side1_dst, idx, wt);
  if (gi == 0) return;
  make_taps(g2 + 2 * k, h, w, idx, wt);
  jac_scatter_row(dz_slot, tiles, 1, false, s, cc, k,
                  v2 + static_cast<size_t>(k) * cc, n2[k], side2_dst, idx, wt);
}

// Cotangent of v / max(|v|, eps) for one sample row, lanes over channels
// (_norm_jac, :69-76): (g - [n > eps] vn (vn . g)) / max(n, eps).
__device__ __forceinline__ void norm_jac_row(float (&gv)[kCodeChunk / 32],
                                             const float (&vn)[kCodeChunk / 32],
                                             float n) {
  float dot = 0.f;
#pragma unroll
  for (int u = 0; u < kCodeChunk / 32; ++u) dot = fmaf(vn[u], gv[u], dot);
  dot = warp_sum(dot);
  const float inv = 1.0f / fmaxf(n, kEps);
#pragma unroll
  for (int u = 0; u < kCodeChunk / 32; ++u) {
    const float proj = n > kEps ? __fmul_rn(vn[u], dot) : 0.f;
    gv[u] = __fmul_rn(__fsub_rn(gv[u], proj), inv);
  }
}

// Adds one sample row's gradient into the code map through its four taps.
__device__ __forceinline__ void scatter_row(float* dst, const int* idx,
                                            const float* wt, int cc,
                                            const float (&gv)[kCodeChunk / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (wt[t] == 0.f) continue;
    float* row = dst + static_cast<size_t>(idx[t]) * cc;
#pragma unroll
    for (int u = 0; u < kCodeChunk / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < cc) atomicAdd(row + c, __fmul_rn(wt[t], gv[u]));
    }
  }
}

// The backward in one kernel, one block a slot, for cc <= kCodeChunk and
// s <= kSMax (the default shapes): the two kernels above in one block,
// with the code rows and the taps in shared memory and each row's
// gradient in registers. scal: (g, 5) per group: g_loss, g_cdm, fd mean,
// shift, 1/m. dz: (slots, 1, 2, s, cc) scratch for dz1 and dz2.
__global__ void __launch_bounds__(kBwdThreads, 1)
corr_sampled_bwd_one_kernel(const float* __restrict__ grid1,
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
  load_taps(g1, s, g2, s, h, w, tap_idx, tap_w);
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
    zero8x8(cd);
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
    zero8x8(out);
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
    float gv[kCodeChunk / 32], vn[kCodeChunk / 32];
#pragma unroll
    for (int u = 0; u < kCodeChunk / 32; ++u) {
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
    for (int u = 0; u < kCodeChunk / 32; ++u) {
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
         + 2 * kSMax * sizeof(float)
         + (kWhole ? 0 : 2 * kSMax * sizeof(float));
}

int sample_tiles(int s) { return (s + kSMax - 1) / kSMax; }

// Whether C1 takes the code in one pass and the samples in one tile (the
// kOne instantiations).
bool one_tile(int cc, int s) { return cc <= kCodeChunk && s <= kSMax; }

template <typename FeatT, bool kWhole, bool kOne>
cudaError_t launch_fwd_as(const void* feats, const void* feats_pos,
                          const void* code, const void* code_pos,
                          const void* grid1, const void* grid2,
                          const void* perms, void* acc, void* z2cn, void* fd,
                          int batch, int h, int w, int cf, int cc, int s,
                          int g, float lo, float hi, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<FeatT, kWhole>(cf, cc);
  cudaError_t err = cudaFuncSetAttribute(
      corr_sampled_fwd_kernel<FeatT, kWhole, kOne>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = sample_tiles(s);
  corr_sampled_fwd_kernel<FeatT, kWhole, kOne>
      <<<dim3(batch * g, tiles, tiles), kFwdThreads, smem, stream>>>(
      static_cast<const FeatT*>(feats), static_cast<const FeatT*>(feats_pos),
      static_cast<const float*>(code), static_cast<const float*>(code_pos),
      static_cast<const float*>(grid1), static_cast<const float*>(grid2),
      static_cast<const int*>(perms), static_cast<float*>(acc),
      static_cast<float*>(z2cn), static_cast<float*>(fd), batch, h, w, cf, cc,
      s, g, lo, hi);
  return cudaGetLastError();
}

template <typename FeatT, bool kWhole>
cudaError_t launch_fwd(const void* feats, const void* feats_pos,
                       const void* code, const void* code_pos,
                       const void* grid1, const void* grid2,
                       const void* perms, void* acc, void* z2cn, void* fd,
                       int batch, int h, int w, int cf, int cc, int s, int g,
                       float lo, float hi, cudaStream_t stream) {
  auto launch = one_tile(cc, s) ? launch_fwd_as<FeatT, kWhole, true>
                                : launch_fwd_as<FeatT, kWhole, false>;
  return launch(feats, feats_pos, code, code_pos, grid1, grid2, perms, acc,
                z2cn, fd, batch, h, w, cf, cc, s, g, lo, hi, stream);
}

size_t bwd_one_smem_bytes(int cc) {
  const size_t cp = (cc + 7) & ~7;
  return (2 * kSMax * cp + cp * kPitch + kSMax * kCoeffPitch) * sizeof(float)
         + 2 * kSMax * 4 * (sizeof(int) + sizeof(float));
}

size_t bwd_smem_bytes(int cc) {
  const size_t cp = (min(cc, kCodeChunk) + 7) & ~7;
  return (2 * kSMax * cp + cp * kPitch + kSMax * kCoeffPitch) * sizeof(float);
}

bool bad_shape(int batch, int h, int w, int cc, int s, int g) {
  return batch <= 0 || h <= 0 || w <= 0 || cc <= 0 || s <= 0 || g < 2 ||
         static_cast<long long>(batch) * g > 2147483647LL ||
         sample_tiles(s) > 65535;
}

}  // namespace

// feats, feats_pos: (batch, h * w, cf), bf16 (feat_f32 = 0) or f32
// (feat_f32 = 1); code, code_pos: (batch, h * w, cc) f32; grid1, grid2:
// (batch, s, 2) f32 sample points in the reference's transposed order;
// perms: (g - 2, batch) int32. With T = ceil(s / 128) sample tiles, writes
// acc (batch * g, T, 5, s): in tile t, s1, s2, s3 and sum cd of each row
// over the columns of tile t (the caller adds the tiles), and in tile 0 the
// side-2 code norms (slot = b * g + pair type); z2cn (batch * g, s, cc) and
// fd (batch * g, s, s). cf <= 768, g >= 2. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int stego_corr_sampled_fwd(
    const void* feats, const void* feats_pos, const void* code,
    const void* code_pos, const void* grid1, const void* grid2,
    const void* perms, void* acc, void* z2cn, void* fd, int batch, int h,
    int w, int cf, int cc, int s, int g, int feat_f32, float lo, float hi,
    int device, void* stream) {
  if (bad_shape(batch, h, w, cc, s, g) || cf <= 0 || cf > kMaxFeat) {
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

// Residuals of the forward (z2cn, fd, and acc with its tiles added: (batch
// * g, 5, s)) and scal (g, 5) per group: g_loss, g_cdm, fd mean, shift,
// 1/m. dz: (batch * g, T, 2, s, cc) f32 scratch, T = ceil(s / 128). Adds the
// code gradients into dcode and dcode_pos, (batch, h * w, cc) f32, which
// the caller zeroes. Two kernels: the coefficients and dz by tiles, then
// the normalisation's Jacobian and the scatter through the taps (one
// kernel for both when cc <= 96 and s <= 128). Returns
// the CUDA error code of the launches (0 on success).
extern "C" int stego_corr_sampled_bwd(
    const void* grid1, const void* grid2, const void* perms, const void* z2cn,
    const void* fd, const void* acc, const void* scal, void* dz, void* dcode,
    void* dcode_pos, int batch, int h, int w, int cc, int s, int g, float lo,
    float hi, int pointwise, float inv_n, int device, void* stream) {
  if (bad_shape(batch, h, w, cc, s, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (one_tile(cc, s)) {
    const size_t smem = bwd_one_smem_bytes(cc);
    err = cudaFuncSetAttribute(corr_sampled_bwd_one_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    corr_sampled_bwd_one_kernel<<<batch * g, kBwdThreads, smem, st>>>(
        static_cast<const float*>(grid1), static_cast<const float*>(grid2),
        static_cast<const int*>(perms), static_cast<const float*>(z2cn),
        static_cast<const float*>(fd), static_cast<const float*>(acc),
        static_cast<const float*>(scal), static_cast<float*>(dz),
        static_cast<float*>(dcode), static_cast<float*>(dcode_pos), batch, h,
        w, cc, s, g, lo, hi, pointwise, inv_n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = bwd_smem_bytes(cc);
  err = cudaFuncSetAttribute(corr_sampled_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = sample_tiles(s);
  corr_sampled_bwd_kernel<<<dim3(batch * g, tiles, tiles), kBwdThreads, smem,
                            st>>>(
      static_cast<const int*>(perms), static_cast<const float*>(z2cn),
      static_cast<const float*>(fd), static_cast<const float*>(acc),
      static_cast<const float*>(scal), static_cast<float*>(dz), batch, cc, s,
      g, lo, hi, pointwise, inv_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kBwdThreads / 32;
  corr_sampled_scatter_kernel<<<dim3(batch * g, (s + warps - 1) / warps),
                                kBwdThreads, 0, st>>>(
      static_cast<const float*>(grid1), static_cast<const float*>(grid2),
      static_cast<const int*>(perms), static_cast<const float*>(z2cn),
      static_cast<const float*>(acc), static_cast<const float*>(dz),
      static_cast<float*>(dcode), static_cast<float*>(dcode_pos), batch, h, w,
      cc, s, g, tiles);
  return static_cast<int>(cudaGetLastError());
}
