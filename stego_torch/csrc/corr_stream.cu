// Kernel C2: the streamed contrastive-correlation loss over normalised
// (rows, N, C) maps, forward (stego_corr_stream_fwd) and backward to the
// code (stego_corr_stream_bwd).
//
// Replaces stego_tpu/ops/pallas_corr.py:fused_correlation_loss_multi
// (:364): the forward replaces _fwd_kernel (:106, pallas_call :141 in
// _run_fwd), the backward _bwd_kernel (:229, pallas_call :285 in _run_bwd).
// The train step calls each once for full_field_loss, pallas_loss_bf16 and
// fused_sampling="off" (ops/corr_stream.py).
//
// What it computes. A pair row r correlates side 1, rows of map idx1[r],
// with side 2, rows of map idx2[r], of one stack of normalised maps: feats
// (maps, n, cf) bf16 and code (maps, n, cc) f32. The wrapper hands in each
// distinct map once and the pair rows by index (the full-field step's
// negatives are code[perm_k(b)]), so no stacked copies exist. For every row
// i of side 1 the forward sums over all columns j of side 2:
//   fd = f1 f2^T, cd = c1 c2^T,
//   s1 = sum_j clamp(cd) fd, s2 = sum_j clamp(cd), s3 = sum_j fd, sum_j cd,
// and writes them to acc (rows, 4, n); ops/corr_stream.py:finalize turns
// them into the per-group losses (one group per pair type and negative).
// The backward recomputes the tiles and forms
//   coeff = (-(fd' - shift) mask g_loss + g_cdm) / m,
// fd' = fd - rowmean_i + gm when pointwise, mask = (lo <= cd <= hi), then
// dc1 = coeff c2 and dc2 = coeff^T c1 (pallas_corr.py:200-264).
//
// Rounding points of the TPU kernel, kept: fd is a bf16 x bf16 product with
// f32 accumulation (mma.sync m16n8k16, every product exact in f32); cd is
// f32 with f32 FMA in channel order (no tensor cores, so no TF32), or with
// code_bf16 a bf16 x bf16 product with f32 accumulation (mma.sync), and then
// the backward rounds coeff and the code to bf16 before its f32 sums
// (pallas_corr.py:251-260). The backward computes cd with the forward's
// function, so every cd, and so the clamp mask, equals the forward's bit for
// bit.
//
// Bound, at the full-field step's shapes (112 pair rows, n = 784, cf = 384,
// cc = 70, 32 distinct maps) on an H100 SXM: the forward is 52.9 GFLOP of
// bf16 products (0.053 ms at 989 TFLOP/s) and 9.6 GFLOP of f32 FMA (0.144 ms
// at 67 TFLOP/s), so ~0.20 ms of compute against ~28 MB of input (0.008 ms
// at 3.35 TB/s): compute-bound. The backward recomputes fd and cd and forms
// dc1 and dc2: ~0.49 ms. With code_bf16 every product has bf16 operands,
// so the bound counts cd, dc1 and dc2 at the tensor cores' rate: ~0.063 ms
// forward, ~0.083 ms backward. This kernel runs only cd on mma.sync there:
// dc1 and dc2 are scalar f32 FMA from shared memory in both instantiations
// (with code_bf16 on bf16-rounded coefficients and code), so its code_bf16
// backward is about as slow as its f32 one.
//
// Design, right before fast. Forward: one block a (64 rows of side 1, pair
// row); 8 warps, each 16 rows by 32 columns of a tile; the block loops over
// 64-column tiles of side 2 through shared memory, which every thread
// fills with 4 loads in flight. fd and cd of a tile are held in the mma
// fragment layout (a thread owns rows g and g + 8 and 8 columns), the row
// sums in registers, reduced over the 4 threads of a row and then over the
// two column halves at the end; each block writes only its own rows, so
// the forward has no atomics. The shared memory (142 KB at the full-field
// shape) allows one block an SM. Backward: one
// block a (64 rows, map) owns the code gradient of those rows and takes
// every pair row that reads the map, in a fixed order (a list the wrapper
// sorts): as side 1 it sums coeff c2 over all column tiles, as side 2 it
// sums coeff^T c1 over all row tiles, recomputing the tile each time. Every
// gradient element is written once, by one thread, after a sum in a fixed
// order, so runs are deterministic (a first Adam step maps any gradient
// above 1e-8 to +-lr, so run-to-run atomics noise would show in the step).
// The price is fd and cd computed twice in the backward. Ragged n (784 and
// 121 are not multiples of 64): tile rows past n are zeros in shared memory
// and masked out of the sums; nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;          // rows and columns of a tile
constexpr int kWarps = 8;          // 16 rows x 32 columns of a tile each
constexpr int kThreads = kWarps * 32;
constexpr int kHalf = kTile / 2;   // columns of a warp
constexpr int kLoadBatch = 4;      // loads a thread has in flight
constexpr int kMaxFeat = 512;      // feature channels
constexpr int kMaxCode = 128;      // code channels
constexpr int kCodePitchF32 = kTile + 2;  // channel-major f32 code tile row
constexpr int kCodePitchBf16 = kTile + 8; // channel-major bf16 code tile row
constexpr int kCoeffPitch = kTile + 1;
constexpr int kOutCols = kMaxCode / 8;    // gradient columns a thread owns
constexpr int kOutRows = kTile * 8 / kThreads;  // gradient rows a thread owns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 from p[0] (low half) and p[stride] (high half).
__device__ __forceinline__ uint32_t pack_column(const __nv_bfloat16* p,
                                                int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory geometry of one launch.
struct Geometry {
  int n, cf, cc;
  int cfp;          // cf rounded up to 16 (mma depth)
  int ccp;          // cc rounded up to 16
  int feat_pitch;   // bf16 elements a feature tile row
  size_t feat_bytes, code_bytes;
};

template <bool kBf16>
__host__ __device__ Geometry make_geometry(int n, int cf, int cc) {
  Geometry g;
  g.n = n;
  g.cf = cf;
  g.cc = cc;
  g.cfp = (cf + 15) & ~15;
  g.ccp = (cc + 15) & ~15;
  g.feat_pitch = g.cfp + 8;
  g.feat_bytes = static_cast<size_t>(kTile) * g.feat_pitch * 2;
  g.code_bytes = kBf16 ? static_cast<size_t>(g.ccp) * kCodePitchBf16 * 2
                       : static_cast<size_t>(g.ccp) * kCodePitchF32 * 4;
  return g;
}

// Rows row0 .. row0 + 63 of one (n, cf) bf16 map into a row-major tile of
// feat_pitch, zeros past n and past cf.
// Loads run in batches of kLoadBatch a thread, all issued before their
// stores, so that a thread waits on one round trip a batch.
__device__ void load_feat_tile(__nv_bfloat16* dst,
                               const __nv_bfloat16* map, int row0,
                               const Geometry& g) {
  const int chunks = g.cfp / 8;  // 16-byte chunks a row
  const int total = kTile * chunks;
  const bool vec = (g.cf % 8) == 0;
  for (int base = threadIdx.x; base < total; base += kLoadBatch * kThreads) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / chunks;
      const int c8 = (idx - r * chunks) * 8;
      const int row = row0 + r;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < total && row < g.n) {
        const __nv_bfloat16* src =
            map + static_cast<size_t>(row) * g.cf + c8;
        if (vec) {
          if (c8 < g.cf) v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[u]);
          for (int k = 0; k < 8 && c8 + k < g.cf; ++k) e[k] = src[k];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int r = idx / chunks;
        *reinterpret_cast<uint4*>(dst + r * g.feat_pitch +
                                  (idx - r * chunks) * 8) = v[u];
      }
    }
  }
}

// Rows row0 .. row0 + 63 of one (n, cc) f32 map into a channel-major tile
// (ccp rows of the code pitch), zeros past n and past cc; bf16 tiles round
// each value.
template <typename T>
__device__ void load_code_tile(T* dst, const float* map, int row0,
                               const Geometry& g) {
  constexpr int pitch =
      sizeof(T) == 4 ? kCodePitchF32 : kCodePitchBf16;
  const int total = kTile * g.ccp;
  for (int base = threadIdx.x; base < total; base += kLoadBatch * kThreads) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / g.ccp;
      const int c = idx - r * g.ccp;
      const int row = row0 + r;
      v[u] = (idx < total && row < g.n && c < g.cc)
                 ? map[static_cast<size_t>(row) * g.cc + c]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int r = idx / g.ccp;
        dst[(idx - r * g.ccp) * pitch + r] = from_float<T>(v[u]);
      }
    }
  }
}

// Warp w owns rows 16 (w % 4) .. + 15 of the i tile and columns
// 32 (w / 4) .. + 31 of the j tile.
__device__ __forceinline__ int warp_row0() { return (threadIdx.x >> 5) % 4 * 16; }
__device__ __forceinline__ int warp_col0() { return (threadIdx.x >> 5) / 4 * kHalf; }

// fd and cd of this warp's 16 rows of the i tile (fa, ca) against its 32
// rows of the j tile (fb, cb), in the mma fragment layout: element
// [nt][e] is row warp_row0() + g + 8 * (e >> 1), column warp_col0() +
// nt * 8 + 2 t + (e & 1).
template <bool kBf16>
__device__ __forceinline__ void corr_tile(const __nv_bfloat16* fa,
                                          const __nv_bfloat16* fb,
                                          const void* ca, const void* cb,
                                          const Geometry& geo,
                                          float (&fd)[4][4],
                                          float (&cd)[4][4]) {
  const int row0 = warp_row0();
  const int col0 = warp_col0();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fd[nt][e] = 0.f;
      cd[nt][e] = 0.f;
    }
  }
  const int fp = geo.feat_pitch;
  for (int kc = 0; kc < geo.cfp / 16; ++kc) {
    const __nv_bfloat16* ap = fa + (row0 + g) * fp + kc * 16 + 2 * t;
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(ap),
        *reinterpret_cast<const uint32_t*>(ap + 8 * fp),
        *reinterpret_cast<const uint32_t*>(ap + 8),
        *reinterpret_cast<const uint32_t*>(ap + 8 * fp + 8)};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* bp =
          fb + (col0 + nt * 8 + g) * fp + kc * 16 + 2 * t;
      mma_bf16(fd[nt], a, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
  if constexpr (kBf16) {
    constexpr int P = kCodePitchBf16;
    const __nv_bfloat16* cab = static_cast<const __nv_bfloat16*>(ca);
    const __nv_bfloat16* cbb = static_cast<const __nv_bfloat16*>(cb);
    for (int kc = 0; kc < geo.ccp / 16; ++kc) {
      const __nv_bfloat16* ap = cab + (kc * 16 + 2 * t) * P + row0 + g;
      const uint32_t a[4] = {pack_column(ap, P), pack_column(ap + 8, P),
                             pack_column(ap + 8 * P, P),
                             pack_column(ap + 8 * P + 8, P)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* bp =
            cbb + (kc * 16 + 2 * t) * P + col0 + nt * 8 + g;
        mma_bf16(cd[nt], a, pack_column(bp, P), pack_column(bp + 8 * P, P));
      }
    }
  } else {
    constexpr int P = kCodePitchF32;
    const float* caf = static_cast<const float*>(ca);
    const float* cbf = static_cast<const float*>(cb);
    for (int k = 0; k < geo.cc; ++k) {
      const float a0 = caf[k * P + row0 + g];
      const float a1 = caf[k * P + row0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(
            cbf + k * P + col0 + nt * 8 + 2 * t);
        cd[nt][0] = fmaf(a0, b.x, cd[nt][0]);
        cd[nt][1] = fmaf(a0, b.y, cd[nt][1]);
        cd[nt][2] = fmaf(a1, b.x, cd[nt][2]);
        cd[nt][3] = fmaf(a1, b.y, cd[nt][3]);
      }
    }
  }
}

// Carves the dynamic shared memory: feature tiles a and b, code tiles a and
// b, and (backward) the coefficient tile.
struct Smem {
  __nv_bfloat16* fa;
  __nv_bfloat16* fb;
  void* ca;
  void* cb;
  float* coeff;
};

__device__ Smem carve(unsigned char* base, const Geometry& g) {
  Smem s;
  s.fa = reinterpret_cast<__nv_bfloat16*>(base);
  s.fb = reinterpret_cast<__nv_bfloat16*>(base + g.feat_bytes);
  s.ca = base + 2 * g.feat_bytes;
  s.cb = base + 2 * g.feat_bytes + g.code_bytes;
  s.coeff = reinterpret_cast<float*>(base + 2 * g.feat_bytes +
                                     2 * g.code_bytes);
  return s;
}

template <bool kBf16>
size_t smem_bytes(int n, int cf, int cc, bool backward) {
  const Geometry g = make_geometry<kBf16>(n, cf, cc);
  return 2 * g.feat_bytes + 2 * g.code_bytes +
         (backward ? static_cast<size_t>(kTile) * kCoeffPitch * 4 : 0);
}

// grid (ceil(n / 64), rows); acc (rows, 4, n).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
corr_stream_fwd_kernel(const __nv_bfloat16* __restrict__ feats,
                       const float* __restrict__ code,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2, float* __restrict__ acc,
                       int maps, int n, int cf, int cc, float lo, float hi) {
  using CodeT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = make_geometry<kBf16>(n, cf, cc);
  const Smem s = carve(smem, geo);
  const int i0 = blockIdx.x * kTile;
  const int r = blockIdx.y;
  const int m1 = idx1[r];
  const int m2 = idx2[r];
  float* acc_r = acc + static_cast<size_t>(r) * 4 * n;
  if (m1 < 0 || m1 >= maps || m2 < 0 || m2 >= maps) {
    // an out-of-range map index: NaN row sums, no read
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      if (i0 + i < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_r[q * n + i0 + i] = NAN;
      }
    }
    return;
  }
  const size_t fstride = static_cast<size_t>(n) * cf;
  const size_t cstride = static_cast<size_t>(n) * cc;
  load_feat_tile(s.fa, feats + m1 * fstride, i0, geo);
  load_code_tile(static_cast<CodeT*>(s.ca), code + m1 * cstride, i0, geo);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int col0 = warp_col0();
  float sums[4][2] = {};  // s1, s2, s3, sum cd of rows g and g + 8
  float fd[4][4], cd[4][4];
  for (int j0 = 0; j0 < n; j0 += kTile) {
    __syncthreads();  // every warp is done with the previous j tile
    load_feat_tile(s.fb, feats + m2 * fstride, j0, geo);
    load_code_tile(static_cast<CodeT*>(s.cb), code + m2 * cstride, j0, geo);
    __syncthreads();
    corr_tile<kBf16>(s.fa, s.fb, s.ca, s.cb, geo, fd, cd);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + col0 + nt * 8 + 2 * t + (e & 1) < n) {
          const float c = cd[nt][e];
          const float cdc = fminf(fmaxf(c, lo), hi);
          const int h = e >> 1;
          sums[0][h] = fmaf(cdc, fd[nt][e], sums[0][h]);
          sums[1][h] += cdc;
          sums[2][h] += fd[nt][e];
          sums[3][h] += c;
        }
      }
    }
  }
  // each row's sums over the 4 threads of its fragment group, then over
  // the two column halves, in that order
  const int g = lane >> 2;
  float* part = reinterpret_cast<float*>(s.fb);  // [half][row][4]
  __syncthreads();  // every warp is done with the last j tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int il = warp_row0() + g + 8 * h;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = group_sum(sums[q][h]);
      if (t == 0) part[((col0 / kHalf) * kTile + il) * 4 + q] = v;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTile * 4; idx += kThreads) {
    const int il = idx / 4;
    const int q = idx - il * 4;
    if (i0 + il < n) {
      acc_r[q * n + i0 + il] = part[il * 4 + q] + part[(kTile + il) * 4 + q];
    }
  }
}

// grid (ceil(n / 64), maps). The block owns rows t0 .. t0 + 63 of map m and
// takes the entries order[offsets[m] .. offsets[m + 1]) of the pair-row
// list: entry e < rows is pair row e reading map m as side 1, e >= rows is
// pair row e - rows reading it as side 2. scal (groups, 5): g_loss, g_cdm,
// fd mean, shift, 1/m; row_group (rows,). Writes dcode (maps, n, cc).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
corr_stream_bwd_kernel(const __nv_bfloat16* __restrict__ feats,
                       const float* __restrict__ code,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2,
                       const float* __restrict__ acc,
                       const float* __restrict__ scal,
                       const int* __restrict__ row_group,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets,
                       float* __restrict__ dcode, int rows, int maps, int n,
                       int cf, int cc, float lo, float hi, int pointwise) {
  using CodeT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  constexpr int CP = kBf16 ? kCodePitchBf16 : kCodePitchF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = make_geometry<kBf16>(n, cf, cc);
  const Smem s = carve(smem, geo);
  const int t0 = blockIdx.x * kTile;
  const int m = blockIdx.y;
  const size_t fstride = static_cast<size_t>(n) * cf;
  const size_t cstride = static_cast<size_t>(n) * cc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp_row0();
  const int col0 = warp_col0();
  // gradient tile: this thread's rows rg * kOutRows + a, columns cg + 8 q
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int nq = (cc + 7) / 8;
  float out[kOutRows][kOutCols];
#pragma unroll
  for (int a = 0; a < kOutRows; ++a) {
#pragma unroll
    for (int q = 0; q < kOutCols; ++q) out[a][q] = 0.f;
  }

  // the block's own rows: side 1 of a side-1 entry, side 2 of a side-2 one
  __nv_bfloat16* f_own = s.fa;
  __nv_bfloat16* f_other = s.fb;
  CodeT* c_own = static_cast<CodeT*>(s.ca);
  CodeT* c_other = static_cast<CodeT*>(s.cb);
  load_feat_tile(f_own, feats + m * fstride, t0, geo);
  load_code_tile(c_own, code + m * cstride, t0, geo);

  float fd[4][4], cd[4][4];
  const int end = offsets[m + 1];
  for (int q_entry = offsets[m]; q_entry < end; ++q_entry) {
    const int entry = order[q_entry];
    const bool side1 = entry < rows;
    const int r = side1 ? entry : entry - rows;
    const int other = side1 ? idx2[r] : idx1[r];
    if (other < 0 || other >= maps) continue;
    const float* sc = scal + row_group[r] * 5;
    const float g_loss = sc[0], g_cdm = sc[1], gm = sc[2], shift = sc[3],
                inv_m = sc[4];
    const float* s3 = acc + (static_cast<size_t>(r) * 4 + 2) * n;
    for (int o0 = 0; o0 < n; o0 += kTile) {
      __syncthreads();  // every thread is done with the previous tiles
      load_feat_tile(f_other, feats + other * fstride, o0, geo);
      load_code_tile(c_other, code + other * cstride, o0, geo);
      __syncthreads();
      const int i0 = side1 ? t0 : o0;
      const int j0 = side1 ? o0 : t0;
      if (side1) {
        corr_tile<kBf16>(f_own, f_other, c_own, c_other, geo, fd, cd);
      } else {
        corr_tile<kBf16>(f_other, f_own, c_other, c_own, geo, fd, cd);
      }
      // coeff of this warp's rows into the shared tile [i][j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int il = row0 + g + 8 * h;
        const bool i_ok = i0 + il < n;
        const float rm =
            (pointwise && i_ok) ? __fdiv_rn(s3[i0 + il], static_cast<float>(n))
                                : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const int jl = col0 + nt * 8 + 2 * t + (e & 1);
            float v = 0.f;
            if (i_ok && j0 + jl < n) {
              const float c = cd[nt][e];
              const float mask = (c >= lo && c <= hi) ? 1.f : 0.f;
              const float fdp =
                  pointwise ? __fadd_rn(__fsub_rn(fd[nt][e], rm), gm)
                            : fd[nt][e];
              v = __fmul_rn(-__fsub_rn(fdp, shift), mask);
              v = __fmul_rn(__fadd_rn(__fmul_rn(v, g_loss), g_cdm), inv_m);
              if (kBf16) v = bf16_round(v);
            }
            s.coeff[il * kCoeffPitch + jl] = v;
          }
        }
      }
      __syncthreads();
      // side 1: out[i][c] += sum_j coeff[i][j] c2[j][c] (c_other holds j);
      // side 2: out[j][c] += sum_i coeff[i][j] c1[i][c] (c_other holds i);
      // scalar f32 FMA in both instantiations
      const int a_m = side1 ? kCoeffPitch : 1;
      const int a_k = side1 ? 1 : kCoeffPitch;
      const int kn = min(kTile, n - o0);
      for (int k = 0; k < kn; ++k) {
        float cv[kOutRows];
#pragma unroll
        for (int a = 0; a < kOutRows; ++a) {
          cv[a] = s.coeff[(rg * kOutRows + a) * a_m + k * a_k];
        }
#pragma unroll
        for (int q = 0; q < kOutCols; ++q) {
          if (q < nq) {
            const float x = to_float(c_other[(cg + 8 * q) * CP + k]);
#pragma unroll
            for (int a = 0; a < kOutRows; ++a) {
              out[a][q] = fmaf(cv[a], x, out[a][q]);
            }
          }
        }
      }
    }
  }
  float* dst = dcode + m * cstride;
#pragma unroll
  for (int a = 0; a < kOutRows; ++a) {
    const int row = t0 + rg * kOutRows + a;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < kOutCols; ++q) {
      const int c = cg + 8 * q;
      if (q < nq && c < cc) dst[static_cast<size_t>(row) * cc + c] = out[a][q];
    }
  }
}

bool bad_shape(int rows, int maps, int n, int cf, int cc) {
  return rows <= 0 || rows > 65535 || maps <= 0 || maps > 65535 || n <= 0 ||
         cf <= 0 || cf > kMaxFeat || cc <= 0 || cc > kMaxCode;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// feats (maps, n, cf) bf16 and code (maps, n, cc) f32, both l2-normalised
// rows; idx1, idx2 (rows,) int32 map indices of each pair row's two sides.
// Writes acc (rows, 4, n) f32: s1, s2, s3 and sum cd of every side-1 row.
// cf <= 512, cc <= 128, rows and maps <= 65535. code_bf16 rounds the code to
// bf16 for cd. Returns the CUDA error code of the launch (0 on success).
extern "C" int stego_corr_stream_fwd(const void* feats, const void* code,
                                     const void* idx1, const void* idx2,
                                     void* acc, int rows, int maps, int n,
                                     int cf, int cc, int code_bf16, float lo,
                                     float hi, int device, void* stream) {
  if (bad_shape(rows, maps, n, cf, cc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kTile - 1) / kTile, rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* c = static_cast<const float*>(code);
  const auto* i1 = static_cast<const int*>(idx1);
  const auto* i2 = static_cast<const int*>(idx2);
  auto* a = static_cast<float*>(acc);
  cudaError_t err;
  if (code_bf16) {
    const size_t smem = smem_bytes<true>(n, cf, cc, false);
    err = prepare(corr_stream_fwd_kernel<true>, device, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    corr_stream_fwd_kernel<true><<<grid, kThreads, smem, st>>>(
        f, c, i1, i2, a, maps, n, cf, cc, lo, hi);
  } else {
    const size_t smem = smem_bytes<false>(n, cf, cc, false);
    err = prepare(corr_stream_fwd_kernel<false>, device, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    corr_stream_fwd_kernel<false><<<grid, kThreads, smem, st>>>(
        f, c, i1, i2, a, maps, n, cf, cc, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and acc; scal (groups, 5) f32: g_loss, g_cdm, fd
// mean, shift, 1/m of each group; row_group (rows,) int32; order (2 rows,)
// int32, the entries of every map in a fixed order (entry e < rows: pair
// row e reads the map as side 1; e >= rows: pair row e - rows as side 2),
// grouped by map with offsets (maps + 1,) int32. Writes every element of
// dcode (maps, n, cc) f32. Returns the CUDA error code of the launch.
extern "C" int stego_corr_stream_bwd(const void* feats, const void* code,
                                     const void* idx1, const void* idx2,
                                     const void* acc, const void* scal,
                                     const void* row_group, const void* order,
                                     const void* offsets, void* dcode,
                                     int rows, int maps, int n, int cf, int cc,
                                     int code_bf16, float lo, float hi,
                                     int pointwise, int device, void* stream) {
  if (bad_shape(rows, maps, n, cf, cc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kTile - 1) / kTile, maps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* c = static_cast<const float*>(code);
  const auto* i1 = static_cast<const int*>(idx1);
  const auto* i2 = static_cast<const int*>(idx2);
  const auto* a = static_cast<const float*>(acc);
  const auto* sc = static_cast<const float*>(scal);
  const auto* rgp = static_cast<const int*>(row_group);
  const auto* ord = static_cast<const int*>(order);
  const auto* off = static_cast<const int*>(offsets);
  auto* d = static_cast<float*>(dcode);
  cudaError_t err;
  if (code_bf16) {
    const size_t smem = smem_bytes<true>(n, cf, cc, true);
    err = prepare(corr_stream_bwd_kernel<true>, device, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    corr_stream_bwd_kernel<true><<<grid, kThreads, smem, st>>>(
        f, c, i1, i2, a, sc, rgp, ord, off, d, rows, maps, n, cf, cc, lo, hi,
        pointwise);
  } else {
    const size_t smem = smem_bytes<false>(n, cf, cc, true);
    err = prepare(corr_stream_bwd_kernel<false>, device, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    corr_stream_bwd_kernel<false><<<grid, kThreads, smem, st>>>(
        f, c, i1, i2, a, sc, rgp, ord, off, d, rows, maps, n, cf, cc, lo, hi,
        pointwise);
  }
  return static_cast<int>(cudaGetLastError());
}
