// Kernel L: LayerNorm over the last axis with f32 statistics, forward only,
// and its residual form (L2): r = x + y rounded to x's type, then LN(r).
//
// Replaces stego_tpu/ops/layer_norm.py:_ln_kernel (:39), which
// fused_layer_norm (:208) reaches through _ln_forward (:50, pallas_call :56),
// and _add_ln_kernel (:72), which add_layer_norm (:140) reaches through
// _add_ln_forward (:89, pallas_call :95). The ViT trunk calls the first 25
// times a forward (models/vit.py:_block_ln); the JAX package dispatches the
// residual form nowhere, and neither does the trunk here
// (tools/attention_layouts.py runs it in its chain of sublayers).
//
// Bound: device-memory bytes. Each row is read once and written once; at
// (8 * 785, 384) bf16 that is 9.6 MB a call, a few microseconds at 3.35 TB/s,
// so launch overhead is of the same order. At D = 32 (the tiny ViT of the
// sensitive accuracy instrument) a row is 64 bytes and the launch is all
// there is. Design: one warp per row keeps
// the row in registers (D = 192 is 6 values a lane, 384 is 12, 768 is 24),
// loads and stores VEC values a lane at a time (4 at D = 384 and 768, 2 at
// D = 192, which 128 does not divide) with neighbouring lanes on
// neighbouring addresses, and reduces with warp shuffles: no shared memory,
// no second read of the row. Mean and variance are the two-pass f32 form of
// _ln_kernel (:39-47): mean = sum(x) / D, var = sum((x - mean)^2) / D. The
// residual form reads y beside x, rounds x + y (an f32 sum of two bf16) to
// bf16, writes it as r and takes the statistics over the rounded sum, as
// _add_ln_kernel (:72-86) does, so its LN equals kernel L on r; its output
// is bf16 or f32 (out_dtype).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // warps per block, one row each

// VEC bf16 values (VEC = 2 or 4) at p into out, as floats.
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  } else {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// D = GROUPS * 32 * VEC: each lane holds GROUPS groups of VEC values; group
// c of lane l covers columns (c * 32 + l) * VEC .. + VEC - 1. With
// kResidual, y is added to x and the rounded sum written to r first.
template <int VEC, int GROUPS, bool kResidual, typename OutT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ y,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, __nv_bfloat16* __restrict__ r,
                  OutT* __restrict__ out, int rows, float eps) {
  constexpr int kD = GROUPS * 32 * VEC;
  constexpr int kN = GROUPS * VEC;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * kD;

  float v[kN];
#pragma unroll
  for (int c = 0; c < GROUPS; ++c) {
    load_vec<VEC>(x + base + (c * 32 + lane) * VEC, v + c * VEC);
  }
  if constexpr (kResidual) {
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      float w[VEC];
      load_vec<VEC>(y + base + (c * 32 + lane) * VEC, w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c * VEC + i] = __bfloat162float(
            __float2bfloat16_rn(__fadd_rn(v[c * VEC + i], w[i])));
      }
      store_vec<VEC>(r + base + (c * 32 + lane) * VEC, v + c * VEC);
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) sum += v[i];
  const float mean = warp_sum(sum) * (1.0f / kD);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i] -= mean;
    sq += v[i] * v[i];
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.0f / kD) + eps);

#pragma unroll
  for (int c = 0; c < GROUPS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    float g[VEC], b[VEC], o[VEC];
    load_vec<VEC>(gamma + col, g);
    load_vec<VEC>(beta + col, b);
    // separate roundings, no fused multiply-add: the plain version's order
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      o[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[c * VEC + i], rstd), g[i]), b[i]);
    }
    store_vec<VEC>(out + base + col, o);
  }
}

// Any D = 32 * groups up to 1024 (groups <= kMaxGroups), for the widths
// the three instantiations above do not take (the sensitive accuracy
// instrument's tiny ViT is 32 wide): lane l holds columns c * 32 + l of
// groups c < groups, one bf16 a load, neighbouring lanes on neighbouring
// addresses; the register array is sized for kMaxGroups and every access is
// unrolled under a test of c < groups, so it stays in registers. The same
// two-pass f32 statistics and rounding order as layer_norm_kernel.
constexpr int kMaxGroups = 32;

template <bool kResidual, typename OutT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_any_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ y,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      __nv_bfloat16* __restrict__ r, OutT* __restrict__ out,
                      int rows, int groups, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int d = groups * 32;
  const size_t base = static_cast<size_t>(row) * d;

  float v[kMaxGroups];
#pragma unroll
  for (int c = 0; c < kMaxGroups; ++c) {
    v[c] = 0.f;
    if (c < groups) {
      const size_t at = base + c * 32 + lane;
      v[c] = __bfloat162float(x[at]);
      if constexpr (kResidual) {
        const __nv_bfloat16 rb = __float2bfloat16_rn(
            __fadd_rn(v[c], __bfloat162float(y[at])));
        r[at] = rb;
        v[c] = __bfloat162float(rb);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxGroups; ++c) {
    if (c < groups) sum += v[c];
  }
  const float inv_d = 1.0f / d;
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxGroups; ++c) {
    if (c < groups) {
      v[c] -= mean;
      sq += v[c] * v[c];
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int c = 0; c < kMaxGroups; ++c) {
    if (c < groups) {
      const int col = c * 32 + lane;
      const float o = __fadd_rn(__fmul_rn(__fmul_rn(v[c], rstd), gamma[col]),
                                beta[col]);
      if constexpr (sizeof(OutT) == 4) {
        out[base + col] = o;
      } else {
        out[base + col] = __float2bfloat16_rn(o);
      }
    }
  }
}

template <bool kResidual, typename OutT>
cudaError_t launch(const void* x, const void* y, const void* gamma,
                   const void* beta, void* r, void* out, int rows, int d,
                   float eps, cudaStream_t s) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* rb = static_cast<__nv_bfloat16*>(r);
  auto* o = static_cast<OutT*>(out);
  if (d == 192) {
    layer_norm_kernel<2, 3, kResidual, OutT>
        <<<grid, block, 0, s>>>(xb, yb, g, b, rb, o, rows, eps);
  } else if (d == 384) {
    layer_norm_kernel<4, 3, kResidual, OutT>
        <<<grid, block, 0, s>>>(xb, yb, g, b, rb, o, rows, eps);
  } else if (d == 768) {
    layer_norm_kernel<4, 6, kResidual, OutT>
        <<<grid, block, 0, s>>>(xb, yb, g, b, rb, o, rows, eps);
  } else {
    layer_norm_any_kernel<kResidual, OutT>
        <<<grid, block, 0, s>>>(xb, yb, g, b, rb, o, rows, d / 32, eps);
  }
  return cudaGetLastError();
}

bool bad_width(int rows, int d) {
  return rows <= 0 || d <= 0 || d % 32 != 0 || d > 32 * kMaxGroups;
}

}  // namespace

// x, y: (rows, d) contiguous bf16; gamma, beta: (d,) f32, 16-byte aligned.
// d is a multiple of 32 up to 1024: 192 (ViT-T), 384 (ViT-S) and 768
// (ViT-B) by their own instantiations, the rest (32, the sensitive
// instrument's tiny ViT) by layer_norm_any_kernel. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int stego_layer_norm(const void* x, const void* gamma,
                                const void* beta, void* y, int rows, int d,
                                float eps, int device, void* stream) {
  if (bad_width(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch<false, __nv_bfloat16>(
      x, nullptr, gamma, beta, nullptr, y, rows, d, eps,
      static_cast<cudaStream_t>(stream)));
}

// The residual form: r = bf16(x + y) and out = LN(r), (rows, d) contiguous;
// out is bf16 (out_f32 = 0) or f32 (out_f32 = 1). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int stego_add_layer_norm(const void* x, const void* y,
                                    const void* gamma, const void* beta,
                                    void* r, void* out, int rows, int d,
                                    int out_f32, float eps, int device,
                                    void* stream) {
  if (bad_width(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = out_f32 ? launch<true, float>(x, y, gamma, beta, r, out, rows, d, eps,
                                      s)
                : launch<true, __nv_bfloat16>(x, y, gamma, beta, r, out, rows,
                                              d, eps, s);
  return static_cast<int>(err);
}

extern "C" const char* stego_error_string(int err) {
  // kernels A's and C2's code for a tensor map the CUDA driver refused
  // (csrc/attention.cu, csrc/corr_stream.cu)
  if (err == 20001) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
