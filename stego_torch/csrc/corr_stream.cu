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
// (maps, n, cf) bf16 or f32 and code (maps, n, cc) f32. The wrapper hands
// in each distinct map once and the pair rows by index (the full-field
// step's negatives are code[perm_k(b)]), so no stacked copies exist. For
// every row i of side 1 the forward sums over all columns j of side 2:
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
// f32 accumulation (mma.sync m16n8k16, every product exact in f32, each 16
// channels added to the running f32 sum with round to nearest), or with
// f32 features (an f32 trunk, feat_dtype=float32) an f32 x f32 product; cd
// is f32 x f32, or with code_bf16 a bf16 x bf16 product with f32
// accumulation (mma.sync), and then the backward rounds coeff and the code
// to bf16 before its f32 sums (pallas_corr.py:251-260). fd on f32 features
// and the backward's dc1 and dc2 on f32 code run on the tensor cores by
// 3xTF32 (tf32x3.cuh: operands split into TF32 high and low parts, three
// m16n8k8 products an 8-channel step, ~2^-22 of each product left, about
// f32's own rounding; one TF32 product would keep ~2^-11, which the f32
// row-sum gate rejects), each step added to its f32 sum in channel order.
// The f32 cd stays f32 FMA in channel order, whose clamp masks agree with
// the plain version's on the tested shapes (cd_tile says why). code_bf16's dc1
// and dc2 run as bf16 m16n8k16 on the bf16-rounded coefficients and code,
// every product exact in f32. The backward computes fd and cd with the
// forward's function, so every cd, and so the clamp mask, equals the
// forward's bit for bit.
//
// Bound, at the full-field step's shapes (112 pair rows, n = 784, cf = 384,
// cc = 70, 32 distinct maps) on an H100 SXM: the forward is 52.9 GFLOP of
// bf16 products (0.053 ms at 989 TFLOP/s) and 9.6 GFLOP of cd on f32 FMA
// (0.144 ms at 67 TFLOP/s), so ~0.20 ms of compute against ~28 MB of input
// (0.008 ms at 3.35 TB/s): compute-bound. The backward recomputes fd and cd
// and forms dc1 and dc2, 19.3 GFLOP at 3xTF32's ~165 TFLOP/s (a third of
// 495 TFLOP/s of TF32): ~0.31 ms. With f32 features fd is 3xTF32 too:
// ~0.46 ms forward, ~0.58 ms backward. With code_bf16 every product has
// bf16 operands: ~0.063 ms forward, ~0.083 ms backward. The kernel is
// further from these than A: its products are mma.sync, not wgmma, and a
// block is 8 warps, one an SM, whose phases (loads, products, coefficients,
// the gradient's products) are separated by barriers, so the latency of
// each phase, more than the tensor cores, sets its time (PERF.md).
//
// Design, right before fast. Forward: one block a (64 rows of side 1, pair
// row); 8 warps, each 16 rows by 32 columns of a tile; the block loops over
// 64-column tiles of side 2 through shared memory, which cp.async fills with
// every copy of a tile in flight at once (the bf16 code tiles of code_bf16,
// rounded on the way, by loads of 4 a thread in flight). A two-stage ring,
// the next tile's copies in flight during this tile's products, took
// 0.97-1.11x this kernel's time on an H100 (PERF.md), so the block waits for
// its copies. fd and cd of a tile are held in the mma fragment layout (a
// thread owns rows g and g + 8 and 8 columns), the row sums in registers,
// reduced over the 4 threads of a row and then over the two column halves at
// the end; each block writes only its own rows, so the forward has no
// atomics. The shared memory (143 KB at the full-field shape) allows one
// block an SM. Backward: one block a (64 rows, map) owns the code gradient
// of those rows and takes every pair row that reads the map, in a fixed
// order (a list the wrapper sorts): as side 1 it sums coeff c2 over all
// column tiles, as side 2 it sums coeff^T c1 over all row tiles, recomputing
// the tile each time; the coefficient tile goes to shared memory as [own
// row][other row] and the gradient tile stays in registers as mma
// accumulators (dc_tile). Every gradient element is written once, by one
// thread, after a sum in a fixed order, so runs are deterministic (a first
// Adam step maps any gradient above 1e-8 to +-lr, so run-to-run atomics
// noise would show in the step). The price is fd and cd computed twice in
// the backward. Ragged n (784 and 121 are not multiples of 64): tile rows
// past n are zeros in shared memory and masked out of the sums; nothing is
// padded in device memory.
//
// Code channels in chunks: up to 128 (kCodeChunk) the code tiles hold every
// channel, as above. Past that both code tiles come 128 channels at a time
// and cd accumulates over the chunks in channel order (the same sums as
// one tile would give); the backward adds a grid axis over the chunks of
// the gradient's channels, each block recomputing fd and cd for its chunk.
//
// Feature channels in chunks. The block's own 64 rows (side 1 in the
// forward, its map's rows in the backward) stay in shared memory with every
// channel; the other side's tile comes a chunk of channels at a time, and fd
// accumulates over the chunks in registers in channel order, so the chunks
// change no sum. bf16: the own tile row-major (99 KB at ViT-B's 768
// channels), the other side whole up to 384 channels (one chunk: the kernel
// as it was) and above that in chunks of 256 channels (34 KB); two whole
// 768-channel tiles, 198 KB, would not fit beside the code tiles, and
// 384-channel chunks would not beside f32 code tiles of 128 channels and
// the backward's coefficients (236 KB). f32 features: the
// own tile channel-major (108 KB at 384), the other side in chunks of 64
// channels (18 KB), fd by 3xTF32 in the mma fragment layout; above
// 384 channels (216 KB of own tile at 768) the own rows come in the same
// 64-channel chunks too, read again from device memory (L2) for every tile.
// The backward's recomputed fd comes from the same function in the same
// order, so the pointwise fd' = fd - rowmean + gm uses the forward's
// values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;          // rows and columns of a tile
constexpr int kWarps = 8;          // 16 rows x 32 columns of a tile each
constexpr int kThreads = kWarps * 32;
constexpr int kHalf = kTile / 2;   // columns of a warp
constexpr int kLoadBatch = 4;      // loads a thread has in flight
constexpr int kMaxFeat = 768;      // feature channels (ViT-B)
constexpr int kWholeBf16 = 384;    // bf16 channels the other tile takes whole
constexpr int kChunkBf16 = 256;    // bf16 channels of a chunk above that
constexpr int kChunkF32 = 64;      // f32 feature channels of a chunk
constexpr int kOwnMaxF32 = 384;    // f32 channels of a resident own tile
constexpr int kCodeChunk = 128;    // code channels of a code tile
// Row pitches, in elements, that make the fragment loads free of bank
// conflicts: 72 = 8 mod 32 for the channel-major f32 tiles (a 4-byte load
// per thread at channel t, row g: banks 8 t + g) and for the coefficient
// tile (an 8-byte load per thread at row g, columns 2t and 2t + 1: each
// half warp on 32 distinct banks), and for the bf16 code tile (a 4-byte
// pair per thread at channel g, rows 2t and 2t + 1: banks 4 g + t).
constexpr int kCodePitchF32 = kTile + 8;  // channel-major f32 tile row
constexpr int kCodePitchBf16 = kTile + 8; // channel-major bf16 code tile row
constexpr int kCoeffPitch = kTile + 8;
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

// Two bf16-exact f32 values as a bf16 pair, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&p);
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

// Shared-memory geometry of one launch.
struct Geometry {
  int n, cf, cc;
  int cfp;          // cf rounded up to 16 (mma depth)
  int ccp;          // code channels of a code tile (a chunk of up to
                    // kCodeChunk) rounded up to 16
  int chunk;        // feature channels of the other side's tile a step
  bool own_chunked; // f32 above kOwnMaxF32: the own rows in chunks too
  int feat_pitch;   // bf16 elements an own feature tile row
  int chunk_pitch;  // bf16 elements an other-side feature tile row
  // feature tiles a (the block's own rows) and b (the other side's): bf16
  // row-major, a with every channel and b with a chunk; f32 channel-major,
  // a with every channel (or a chunk) and b with a chunk
  size_t feat_a_bytes, feat_b_bytes, code_bytes;
};

template <bool kBf16, bool kFeatF32>
__host__ __device__ Geometry make_geometry(int n, int cf, int cc) {
  Geometry g;
  g.n = n;
  g.cf = cf;
  g.cc = cc;
  g.cfp = (cf + 15) & ~15;
  g.ccp = (min(cc, kCodeChunk) + 15) & ~15;
  g.feat_pitch = g.cfp + 8;
  g.own_chunked = kFeatF32 && cf > kOwnMaxF32;
  if (kFeatF32) {
    g.chunk = kChunkF32;
    g.chunk_pitch = 0;
    g.feat_a_bytes = static_cast<size_t>(g.own_chunked ? kChunkF32 : cf) *
                     kCodePitchF32 * 4;
    g.feat_b_bytes = static_cast<size_t>(kChunkF32) * kCodePitchF32 * 4;
  } else {
    g.chunk = g.cfp <= kWholeBf16 ? g.cfp : kChunkBf16;
    g.chunk_pitch = g.chunk + 8;
    g.feat_a_bytes = static_cast<size_t>(kTile) * g.feat_pitch * 2;
    g.feat_b_bytes = static_cast<size_t>(kTile) * g.chunk_pitch * 2;
  }
  g.code_bytes = kBf16 ? static_cast<size_t>(g.ccp) * kCodePitchBf16 * 2
                       : static_cast<size_t>(g.ccp) * kCodePitchF32 * 4;
  return g;
}

// kBytes (4 or 16) from device memory at src to shared memory at dst by
// cp.async, or zeros where !valid (src is then not read). The copies of a
// tile are all in flight at once and take no registers; cp_async_wait,
// then a barrier, makes every thread's copies visible.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows row0 .. row0 + 63, channels c0 .. c0 + ncp - 1 (ncp: nc rounded up
// to 16, c0 a multiple of 16) of one (n, cf) bf16 map into a row-major tile
// of ``pitch``, zeros past n and past cf: 16-byte cp.async copies where cf
// is a multiple of 8 (the caller waits for them), else element loads in
// batches of kLoadBatch a thread, all issued before their stores.
__device__ void load_feat_tile(__nv_bfloat16* dst,
                               const __nv_bfloat16* map, int row0, int c0,
                               int nc, int pitch, const Geometry& g) {
  const int chunks = ((nc + 15) & ~15) / 8;  // 16-byte chunks a row
  const int total = kTile * chunks;
  if (g.cf % 8 == 0) {
    // (r, c) of idx = r chunks + c, stepped without a division a copy
    int r = threadIdx.x / chunks;
    int c = threadIdx.x - r * chunks;
    const int dr = kThreads / chunks;
    const int dc = kThreads - dr * chunks;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int row = row0 + r;
      const int c8 = c0 + c * 8;
      const bool valid = row < g.n && c8 < g.cf;
      cp_async<16>(dst + r * pitch + c * 8,
                   valid ? map + static_cast<size_t>(row) * g.cf + c8 : map,
                   valid);
      r += dr;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
    return;
  }
  for (int base = threadIdx.x; base < total; base += kLoadBatch * kThreads) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / chunks;
      const int c8 = c0 + (idx - r * chunks) * 8;
      const int row = row0 + r;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < total && row < g.n) {
        const __nv_bfloat16* src =
            map + static_cast<size_t>(row) * g.cf + c8;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[u]);
        for (int k = 0; k < 8 && c8 + k < g.cf; ++k) e[k] = src[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int r = idx / chunks;
        *reinterpret_cast<uint4*>(dst + r * pitch +
                                  (idx - r * chunks) * 8) = v[u];
      }
    }
  }
}

// Rows row0 .. row0 + 63, columns c0 .. c0 + ncols - 1 of a row-major f32
// matrix (row stride ld; rows valid below n, columns below climit) into a
// channel-major shared tile, dst[c * kCodePitchF32 + r], by 4-byte
// cp.async (the caller waits for them), zeros where not valid. A warp
// copies 4 rows x 8 columns at a time: 32-byte pieces of device memory,
// shared-memory banks 8 c + r (two threads a bank at most).
__device__ void load_transposed_f32(float* dst, const float* map, int ld,
                                    int row0, int n, int c0, int ncols,
                                    int climit) {
  const int lane = threadIdx.x & 31;
  const int units = (kTile / 4) * ((ncols + 7) / 8);
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    const int r = (u % (kTile / 4)) * 4 + (lane >> 3);
    const int c = (u / (kTile / 4)) * 8 + (lane & 7);
    if (c < ncols) {
      const int row = row0 + r;
      const int col = c0 + c;
      const bool valid = row < n && col < climit;
      cp_async<4>(dst + c * kCodePitchF32 + r,
                  valid ? map + static_cast<size_t>(row) * ld + col : map,
                  valid);
    }
  }
}

// Rows row0 .. row0 + 63, channels c0 .. c0 + nc - 1 of one (n, cf) f32
// map into a channel-major tile (nc rows of kCodePitchF32), zeros past n.
__device__ void load_feat_tile_f32(float* dst, const float* map, int row0,
                                   int c0, int nc, const Geometry& g) {
  load_transposed_f32(dst, map, g.cf, row0, g.n, c0, nc, g.cf);
}

// Rows row0 .. row0 + 63, channels c0 .. c0 + ccp - 1 of one (n, cc) f32
// map into a channel-major tile (ccp rows of the code pitch), zeros past n
// and past cc: f32 tiles by cp.async (the caller waits for them), bf16
// tiles rounding each value, by loads in batches of kLoadBatch a thread.
template <typename T>
__device__ void load_code_tile(T* dst, const float* map, int row0,
                               const Geometry& g, int c0 = 0) {
  if constexpr (sizeof(T) == 4) {
    load_transposed_f32(dst, map, g.cc, row0, g.n, c0, g.ccp, g.cc);
  } else {
    const int total = kTile * g.ccp;
    for (int base = threadIdx.x; base < total;
         base += kLoadBatch * kThreads) {
      float v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        const int r = idx / g.ccp;
        const int c = idx - r * g.ccp;
        const int row = row0 + r;
        v[u] = (idx < total && row < g.n && c0 + c < g.cc)
                   ? map[static_cast<size_t>(row) * g.cc + c0 + c]
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total) {
          const int r = idx / g.ccp;
          dst[(idx - r * g.ccp) * kCodePitchBf16 + r] =
              from_float<T>(v[u]);
        }
      }
    }
  }
}

// Warp w owns rows 16 (w % 4) .. + 15 of the i tile and columns
// 32 (w / 4) .. + 31 of the j tile.
__device__ __forceinline__ int warp_row0() { return (threadIdx.x >> 5) % 4 * 16; }
__device__ __forceinline__ int warp_col0() { return (threadIdx.x >> 5) / 4 * kHalf; }

// The tiles below hold this warp's 16 rows of the i tile against its 32
// rows of the j tile in the mma fragment layout: element [nt][e] is row
// warp_row0() + g + 8 * (e >> 1), column warp_col0() + nt * 8 + 2 t +
// (e & 1).
__device__ __forceinline__ void zero_tile(float (&x)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
  }
}

// fd += fa fb^T over ``depth`` channels (a multiple of 16) of row-major
// bf16 feature tiles of row pitches pa and pb, by mma.sync: each 16
// channels into a zeroed accumulator, then added to fd in f32 (round to
// nearest). A chain of mma.sync accumulating into fd itself drops the low
// bits of every step the same way: over 768 channels (48 steps) that bias
// put the ViT-B full-field step's gradients 36x further from the plain
// version's than with this order (chip_smoke.py reports both against an
// f64 loss; PERF.md).
__device__ __forceinline__ void fd_bf16(const __nv_bfloat16* fa, int pa,
                                        const __nv_bfloat16* fb, int pb,
                                        int depth, float (&fd)[4][4]) {
  const int row0 = warp_row0();
  const int col0 = warp_col0();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int kc = 0; kc < depth / 16; ++kc) {
    const __nv_bfloat16* ap = fa + (row0 + g) * pa + kc * 16 + 2 * t;
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(ap),
        *reinterpret_cast<const uint32_t*>(ap + 8 * pa),
        *reinterpret_cast<const uint32_t*>(ap + 8),
        *reinterpret_cast<const uint32_t*>(ap + 8 * pa + 8)};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* bp =
          fb + (col0 + nt * 8 + g) * pb + kc * 16 + 2 * t;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, a, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) fd[nt][e] = __fadd_rn(fd[nt][e], part[e]);
    }
  }
}

// fd += a b^T over channels 0 .. depth - 1 of channel-major f32 tiles (rows
// of kCodePitchF32), by 3xTF32 mma.sync (tf32x3.cuh) in 8-channel steps in
// channel order; channels at or past depth read as zeros.
__device__ __forceinline__ void fd_f32(const float* a, const float* b,
                                       int depth, float (&fd)[4][4]) {
  constexpr int P = kCodePitchF32;
  const int row0 = warp_row0();
  const int col0 = warp_col0();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < depth; k0 += 8) {
    const bool k_lo = k0 + t < depth;      // mma columns t and t + 4
    const bool k_hi = k0 + t + 4 < depth;
    const float* ap = a + (k0 + t) * P + row0 + g;
    const float av[4] = {k_lo ? ap[0] : 0.f, k_lo ? ap[8] : 0.f,
                         k_hi ? ap[4 * P] : 0.f, k_hi ? ap[4 * P + 8] : 0.f};
    uint32_t a_hi[4], a_lo[4];
    tf32x3::split(av, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* bp = b + (k0 + t) * P + col0 + nt * 8 + g;
      tf32x3::mma3(fd[nt], a_hi, a_lo, k_lo ? bp[0] : 0.f,
                   k_hi ? bp[4 * P] : 0.f);
    }
  }
}

// cd += ca cb^T over the first ``depth`` channels of channel-major code
// tiles: bf16 by mma.sync (depth rounded up to 16; the tiles hold zeros
// there), f32 by f32 FMA in channel order. The f32 cd stays off the tensor
// cores on purpose: the clamp mask (lo <= cd <= hi) is a step, and a cd
// that differs from the plain version's by a rounding flips it wherever cd
// lies that close to a bound. With FMA in channel order the masks agree
// with the plain version's (a cuBLAS bmm at K = 70, whose order is not
// promised) on every tested shape; with cd by 3xTF32 a few
// of the full-field shape's 69M cd values fell across the zero bound and
// moved their rows' code gradients past the gradient gate
// (tests/test_torch_cuda.py:test_corr_stream_kernel_matches_plain).
template <bool kBf16>
__device__ __forceinline__ void cd_tile(const void* ca, const void* cb,
                                        int depth, float (&cd)[4][4]) {
  const int row0 = warp_row0();
  const int col0 = warp_col0();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (kBf16) {
    constexpr int P = kCodePitchBf16;
    const __nv_bfloat16* cab = static_cast<const __nv_bfloat16*>(ca);
    const __nv_bfloat16* cbb = static_cast<const __nv_bfloat16*>(cb);
    for (int kc = 0; kc < (depth + 15) / 16; ++kc) {
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
    for (int k = 0; k < depth; ++k) {
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

// out += coeff x^T over the 64 other-side rows of a tile (zeros past n):
// coeff is the shared coefficient tile [own row][other row] (pitch
// kCoeffPitch, f32; with kBf16 bf16-rounded values) and x the other side's
// channel-major code tile. Warp w takes own rows 16 (w % 4) .. + 15 and the
// 8-channel groups w / 4 + 2 j (j < 8) below ``groups``, the chunk's
// channels over 8 rounded up, so the two halves of the warps share the
// chunk's groups evenly; out[j] is group j's accumulator in the mma
// fragment layout. f32 code: 3xTF32 in 8-row steps, with the depth index
// permuted (mma column t is row 2t, t + 4 is 2t + 1) so that both fragments
// are 8-byte loads; bf16 code: m16n8k16 on the bf16 coefficients and code,
// whose every product is exact in f32. Each step goes into a zeroed
// accumulator, added to out in f32.
template <bool kBf16>
__device__ __forceinline__ void dc_tile(const float* coeff, const void* x,
                                        int groups, float (&out)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int half = (threadIdx.x >> 5) / 4;
  const float* c0 = coeff + (warp_row0() + g) * kCoeffPitch + 2 * t;
  const float* c1 = c0 + 8 * kCoeffPitch;
  if constexpr (kBf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    for (int k0 = 0; k0 < kTile; k0 += 16) {
      const float2 p0 = *reinterpret_cast<const float2*>(c0 + k0);
      const float2 p1 = *reinterpret_cast<const float2*>(c1 + k0);
      const float2 p2 = *reinterpret_cast<const float2*>(c0 + k0 + 8);
      const float2 p3 = *reinterpret_cast<const float2*>(c1 + k0 + 8);
      const uint32_t a[4] = {pack_bf16(p0), pack_bf16(p1), pack_bf16(p2),
                             pack_bf16(p3)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int grp = half + 2 * j;
        if (grp < groups) {
          const __nv_bfloat16* xp =
              xb + (grp * 8 + g) * kCodePitchBf16 + k0 + 2 * t;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, a, *reinterpret_cast<const uint32_t*>(xp),
                   *reinterpret_cast<const uint32_t*>(xp + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) out[j][e] = __fadd_rn(out[j][e], part[e]);
        }
      }
    }
  } else {
    const float* xf = static_cast<const float*>(x);
    for (int k0 = 0; k0 < kTile; k0 += 8) {
      const float2 p0 = *reinterpret_cast<const float2*>(c0 + k0);
      const float2 p1 = *reinterpret_cast<const float2*>(c1 + k0);
      const float av[4] = {p0.x, p1.x, p0.y, p1.y};
      uint32_t a_hi[4], a_lo[4];
      tf32x3::split(av, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int grp = half + 2 * j;
        if (grp < groups) {
          const float2 xv = *reinterpret_cast<const float2*>(
              xf + (grp * 8 + g) * kCodePitchF32 + k0 + 2 * t);
          tf32x3::mma3(out[j], a_hi, a_lo, xv.x, xv.y);
        }
      }
    }
  }
}

// Carves the dynamic shared memory: feature tiles a (the block's own rows)
// and b (the other side's), code tiles a and b, and (backward) the
// coefficient tile.
struct Smem {
  void* fa;
  void* fb;
  void* ca;
  void* cb;
  float* coeff;
};

__device__ Smem carve(unsigned char* base, const Geometry& g) {
  const size_t feat = g.feat_a_bytes + g.feat_b_bytes;
  Smem s;
  s.fa = base;
  s.fb = base + g.feat_a_bytes;
  s.ca = base + feat;
  s.cb = base + feat + g.code_bytes;
  s.coeff = reinterpret_cast<float*>(base + feat + 2 * g.code_bytes);
  return s;
}

template <bool kBf16, bool kFeatF32>
size_t smem_bytes(int n, int cf, int cc, bool backward) {
  const Geometry g = make_geometry<kBf16, kFeatF32>(n, cf, cc);
  return g.feat_a_bytes + g.feat_b_bytes + 2 * g.code_bytes +
         (backward ? static_cast<size_t>(kTile) * kCoeffPitch * 4 : 0);
}

template <bool kFeatF32>
using FeatType = typename std::conditional<kFeatF32, float,
                                           __nv_bfloat16>::type;

// Rows row0 .. row0 + 63 of one feature map into the own tile s.fa, every
// channel, unless the own rows come in chunks (f32 above kOwnMaxF32).
template <bool kFeatF32>
__device__ void load_own_feats(const Smem& s, const FeatType<kFeatF32>* map,
                               int row0, const Geometry& geo) {
  if constexpr (kFeatF32) {
    if (!geo.own_chunked) {
      load_feat_tile_f32(static_cast<float*>(s.fa), map, row0, 0, geo.cf,
                         geo);
    }
  } else {
    load_feat_tile(static_cast<__nv_bfloat16*>(s.fa), map, row0, 0, geo.cf,
                   geo.feat_pitch, geo);
  }
}

// fd and cd of the block's own 64 rows (rows own0 .. own0 + 63 of f_own; the
// code in s.ca and, unless chunked, the features in s.fa, loaded) against
// rows o0 .. o0 + 63 of the other side's maps f_other and c_other, which it
// loads into s.fb and s.cb: the own rows are the i tile when own_first,
// else the j tile. Starts with a barrier, so every thread is done with the
// previous other tile (and the own tile is loaded); ends with the other
// code tile in s.cb (above kCodeChunk code channels: its chunk ``keep``,
// when keep >= 0).
// The other side's feature channels come geo.chunk at a time (and the own
// rows' too when geo.own_chunked), fd accumulating over the chunks in
// channel order. Above kCodeChunk code channels both code tiles come a
// chunk at a time too (the own rows' from c_own), cd accumulating over them
// in channel order.
template <bool kBf16, bool kFeatF32>
__device__ void tile_against(const Smem& s, const FeatType<kFeatF32>* f_own,
                             const float* c_own, int own0,
                             const FeatType<kFeatF32>* f_other,
                             const float* c_other, int o0, bool own_first,
                             const Geometry& geo, float (&fd)[4][4],
                             float (&cd)[4][4], int keep = -1) {
  using CodeT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  zero_tile(fd);
  zero_tile(cd);
  for (int c0 = 0; c0 < geo.cf; c0 += geo.chunk) {
    const int nc = min(geo.chunk, geo.cf - c0);
    __syncthreads();  // every thread is done with the last chunk
    if constexpr (kFeatF32) {
      float* own = static_cast<float*>(s.fa);
      float* other = static_cast<float*>(s.fb);
      load_feat_tile_f32(other, f_other, o0, c0, nc, geo);
      if (geo.own_chunked) load_feat_tile_f32(own, f_own, own0, c0, nc, geo);
      if (c0 == 0) load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo);
      cp_async_wait();
      __syncthreads();
      const float* mine = geo.own_chunked ? own : own + c0 * kCodePitchF32;
      if (own_first) {
        fd_f32(mine, other, nc, fd);
      } else {
        fd_f32(other, mine, nc, fd);
      }
    } else {
      const auto* own = static_cast<const __nv_bfloat16*>(s.fa) + c0;
      auto* other = static_cast<__nv_bfloat16*>(s.fb);
      const int pa = geo.feat_pitch, pb = geo.chunk_pitch;
      const int depth = (nc + 15) & ~15;
      load_feat_tile(other, f_other, o0, c0, nc, pb, geo);
      if (c0 == 0) load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo);
      cp_async_wait();
      __syncthreads();
      if (own_first) {
        fd_bf16(own, pa, other, pb, depth, fd);
      } else {
        fd_bf16(other, pb, own, pa, depth, fd);
      }
    }
  }
  const void* ci = own_first ? s.ca : s.cb;
  const void* cj = own_first ? s.cb : s.ca;
  if (geo.cc <= kCodeChunk) {
    cd_tile<kBf16>(ci, cj, geo.cc, cd);
    return;
  }
  int last = 0;
  for (int k0 = 0; k0 < geo.cc; k0 += kCodeChunk) {
    __syncthreads();  // every thread is done with the last code tiles
    load_code_tile(static_cast<CodeT*>(s.ca), c_own, own0, geo, k0);
    load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo, k0);
    cp_async_wait();
    __syncthreads();
    cd_tile<kBf16>(ci, cj, min(kCodeChunk, geo.cc - k0), cd);
    last = k0 / kCodeChunk;
  }
  if (keep >= 0 && keep != last) {
    __syncthreads();
    load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo,
                   keep * kCodeChunk);
    cp_async_wait();
    __syncthreads();
  }
}

// grid (ceil(n / 64), rows); acc (rows, 4, n).
template <bool kBf16, bool kFeatF32>
__global__ void __launch_bounds__(kThreads, 1)
corr_stream_fwd_kernel(const FeatType<kFeatF32>* __restrict__ feats,
                       const float* __restrict__ code,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2, float* __restrict__ acc,
                       int maps, int n, int cf, int cc, float lo, float hi) {
  using CodeT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = make_geometry<kBf16, kFeatF32>(n, cf, cc);
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
  load_own_feats<kFeatF32>(s, feats + m1 * fstride, i0, geo);
  load_code_tile(static_cast<CodeT*>(s.ca), code + m1 * cstride, i0, geo);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int col0 = warp_col0();
  float sums[4][2] = {};  // s1, s2, s3, sum cd of rows g and g + 8
  float fd[4][4], cd[4][4];
  for (int j0 = 0; j0 < n; j0 += kTile) {
    tile_against<kBf16, kFeatF32>(s, feats + m1 * fstride,
                                  code + m1 * cstride, i0,
                                  feats + m2 * fstride, code + m2 * cstride,
                                  j0, true, geo, fd, cd);
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

// grid (ceil(n / 64), maps, code chunks). The block owns rows t0 .. t0 + 63
// of map m, code channels kCodeChunk blockIdx.z .. + kCodeChunk - 1, and
// takes the entries order[offsets[m] .. offsets[m + 1]) of the pair-row
// list: entry e < rows is pair row e reading map m as side 1, e >= rows is
// pair row e - rows reading it as side 2. scal (groups, 5): g_loss, g_cdm,
// fd mean, shift, 1/m; row_group (rows,). Writes dcode (maps, n, cc).
template <bool kBf16, bool kFeatF32>
__global__ void __launch_bounds__(kThreads, 1)
corr_stream_bwd_kernel(const FeatType<kFeatF32>* __restrict__ feats,
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
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = make_geometry<kBf16, kFeatF32>(n, cf, cc);
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
  const int q0 = blockIdx.z * kCodeChunk;  // the block's first code channel
  const int groups = (min(kCodeChunk, cc - q0) + 7) / 8;
  // the gradient tile of the block's rows (dc_tile's layout): rows row0 +
  // g + 8 (e >> 1), channels q0 + 8 (warp / 4 + 2 j) + 2t + (e & 1)
  float out[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
  }

  // the block's own rows: side 1 of a side-1 entry, side 2 of a side-2 one
  load_own_feats<kFeatF32>(s, feats + m * fstride, t0, geo);
  load_code_tile(static_cast<CodeT*>(s.ca), code + m * cstride, t0, geo);

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
      // the forward's function: fd and cd equal the forward's bit for bit
      tile_against<kBf16, kFeatF32>(s, feats + m * fstride,
                                    code + m * cstride, t0,
                                    feats + other * fstride,
                                    code + other * cstride, o0, side1, geo,
                                    fd, cd, blockIdx.z);
      const int i0 = side1 ? t0 : o0;
      const int j0 = side1 ? o0 : t0;
      // coeff of this warp's rows into the shared tile [own row][other
      // row]: [i][j] for side 1, [j][i] for side 2
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
            s.coeff[side1 ? il * kCoeffPitch + jl : jl * kCoeffPitch + il] =
                v;
          }
        }
      }
      __syncthreads();
      // side 1: out[i][c] += sum_j coeff[i][j] c2[j][c] (s.cb holds j);
      // side 2: out[j][c] += sum_i coeff[i][j] c1[i][c] (s.cb holds i);
      // both are out += coeff c_other^T with coeff as [own][other]
      dc_tile<kBf16>(s.coeff, s.cb, groups, out);
    }
  }
  float* dst = dcode + m * cstride;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = t0 + row0 + g + 8 * (e >> 1);
      const int c = q0 + 8 * (tid / 128 + 2 * j) + 2 * t + (e & 1);
      if (row < n && c < cc) dst[static_cast<size_t>(row) * cc + c] = out[j][e];
    }
  }
}

bool bad_shape(int rows, int maps, int n, int cf, int cc) {
  return rows <= 0 || rows > 65535 || maps <= 0 || maps > 65535 || n <= 0 ||
         cf <= 0 || cf > kMaxFeat || cc <= 0 ||
         (cc + kCodeChunk - 1) / kCodeChunk > 65535;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kBf16, bool kFeatF32>
cudaError_t launch_fwd(const void* feats, const void* code, const void* idx1,
                       const void* idx2, void* acc, int rows, int maps, int n,
                       int cf, int cc, float lo, float hi, int device,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<kBf16, kFeatF32>(n, cf, cc, false);
  cudaError_t err =
      prepare(corr_stream_fwd_kernel<kBf16, kFeatF32>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, rows);
  corr_stream_fwd_kernel<kBf16, kFeatF32><<<grid, kThreads, smem, stream>>>(
      static_cast<const FeatType<kFeatF32>*>(feats),
      static_cast<const float*>(code), static_cast<const int*>(idx1),
      static_cast<const int*>(idx2), static_cast<float*>(acc), maps, n, cf,
      cc, lo, hi);
  return cudaGetLastError();
}

template <bool kBf16, bool kFeatF32>
cudaError_t launch_bwd(const void* feats, const void* code, const void* idx1,
                       const void* idx2, const void* acc, const void* scal,
                       const void* row_group, const void* order,
                       const void* offsets, void* dcode, int rows, int maps,
                       int n, int cf, int cc, float lo, float hi,
                       int pointwise, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes<kBf16, kFeatF32>(n, cf, cc, true);
  cudaError_t err =
      prepare(corr_stream_bwd_kernel<kBf16, kFeatF32>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, maps,
                  (cc + kCodeChunk - 1) / kCodeChunk);
  corr_stream_bwd_kernel<kBf16, kFeatF32><<<grid, kThreads, smem, stream>>>(
      static_cast<const FeatType<kFeatF32>*>(feats),
      static_cast<const float*>(code), static_cast<const int*>(idx1),
      static_cast<const int*>(idx2), static_cast<const float*>(acc),
      static_cast<const float*>(scal), static_cast<const int*>(row_group),
      static_cast<const int*>(order), static_cast<const int*>(offsets),
      static_cast<float*>(dcode), rows, maps, n, cf, cc, lo, hi, pointwise);
  return cudaGetLastError();
}

}  // namespace

// feats (maps, n, cf), bf16 (feat_f32 = 0) or f32 (feat_f32 = 1), and code
// (maps, n, cc) f32, both l2-normalised rows; idx1, idx2 (rows,) int32 map
// indices of each pair row's two sides. Writes acc (rows, 4, n) f32: s1,
// s2, s3 and sum cd of every side-1 row. cf <= 768, rows and maps <=
// 65535; code channels above 128 come in chunks of 128. code_bf16 rounds
// the code to bf16 for cd. Returns the CUDA error code of the launch (0 on success).
extern "C" int stego_corr_stream_fwd(const void* feats, const void* code,
                                     const void* idx1, const void* idx2,
                                     void* acc, int rows, int maps, int n,
                                     int cf, int cc, int code_bf16,
                                     int feat_f32, float lo, float hi,
                                     int device, void* stream) {
  if (bad_shape(rows, maps, n, cf, cc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, void*, int, int, int, int, int,
                                 float, float, int, cudaStream_t);
  Launch launch;
  if (code_bf16) {
    launch = feat_f32 ? &launch_fwd<true, true> : &launch_fwd<true, false>;
  } else {
    launch = feat_f32 ? &launch_fwd<false, true> : &launch_fwd<false, false>;
  }
  return static_cast<int>(launch(feats, code, idx1, idx2, acc, rows, maps, n,
                                 cf, cc, lo, hi, device, st));
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
                                     int code_bf16, int feat_f32, float lo,
                                     float hi, int pointwise, int device,
                                     void* stream) {
  if (bad_shape(rows, maps, n, cf, cc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const void*, const void*,
                                 const void*, const void*, const void*, void*,
                                 int, int, int, int, int, float, float, int,
                                 int, cudaStream_t);
  Launch launch;
  if (code_bf16) {
    launch = feat_f32 ? &launch_bwd<true, true> : &launch_bwd<true, false>;
  } else {
    launch = feat_f32 ? &launch_bwd<false, true> : &launch_bwd<false, false>;
  }
  return static_cast<int>(launch(feats, code, idx1, idx2, acc, scal,
                                 row_group, order, offsets, dcode, rows, maps,
                                 n, cf, cc, lo, hi, pointwise, device, st));
}
