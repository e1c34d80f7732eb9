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
// The backward forms
//   coeff = (-(fd' - shift) mask g_loss + g_cdm) / m,
// fd' = fd - rowmean_i + gm when pointwise, mask = (lo <= cd <= hi), then
// dc1 = coeff c2 and dc2 = coeff^T c1 (pallas_corr.py:200-264).
//
// What the forward keeps. The backward needs neither the features nor cd:
// only fd and the clamp mask of every (pair row, i, j), and the row sums.
// rowmean, gm and the group scalars are known only after the forward, but
// fd and the mask are known inside it, tile by tile. So when a gradient is
// taken the forward also writes fd (rows, n, np) f32 (np: n rounded up to
// 4, a 16-byte row pitch) and the mask as bits (rows, n, W) uint32 (bit j %
// 32 of word j / 32; W: ceil(n / 32) rounded up to 4), both from the
// fragments its row sums use, so the backward's coefficients are the ones
// the forward's sums saw, bit for bit. The JAX kernel recomputes fd and cd
// in its backward ("fd/cd are never stored", pallas_corr.py:200-226): on
// the TPU VMEM is small and the grid runs in order on one core, so
// recomputing is cheaper than a round trip through HBM. On the H100 the
// recompute was three products a tile (the forward's and one for each
// gradient side) and feature tiles of 99-216 KB a block, one block an SM;
// storing costs 4 bytes and a bit an entry (275 MB and 8.6 MB at the
// full-field shape, a third of a GiB on an 80 GB card) and 0.08 ms of writes.
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
// every product exact in f32.
//
// Bounds, at the full-field step's shapes (112 pair rows, n = 784, cf = 384,
// cc = 70, 32 distinct maps) on an H100 SXM. Forward: 52.9 GFLOP of bf16 fd
// (0.053 ms at 989 TFLOP/s) and 9.6 GFLOP of cd (0.058 ms at 3xTF32's ~165
// TFLOP/s), against ~28 MB of input; with a gradient it also writes 284 MB
// of fd and mask (0.085 ms at 3.35 TB/s). Backward: dc1 and dc2, 19.3
// GFLOP (0.117 ms at 3xTF32, 0.02 ms on bf16 code), against one read of
// the stored 284 MB and ~14 MB of code and gradient (0.089 ms): bound by
// its products on f32 code, whatever the feature type and trunk width
// (recomputing fd and cd its least time was 0.23 ms on bf16 features and
// 0.50 ms on f32 ones). This design reads each stored tile once for each
// gradient side (and code chunk), 0.174 ms of bytes, which its ownership
// needs and the gradient does not.
//
// Forward design, right before fast: one block a (64 rows of side 1, pair
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
// atomics. A warp's 32 columns are one mask word of each of its rows: the 4
// threads of a row OR their bits together and one stores the word; fd goes
// out as 8-byte stores, the 4 threads of a row on 32 contiguous bytes (a
// whole 32-byte sector). Two ways of writing whole rows instead were slower
// on an H100 (PERF.md): staging the block's tile in shared memory for
// 16-byte stores, which costs two barriers a tile, and each warp's rows by
// bulk copies of 128 bytes. The shared memory (143 KB at the full-field
// shape) allows one block an SM.
//
// Backward design, Hopper's shape (a TMA-fed ring, a producer warp,
// consumer warps). One block a (64 rows t0 of map m, code chunk) owns the
// code gradient of those rows and takes every pair row that reads the map,
// in a fixed order (a list the wrapper sorts): as side 1 it sums coeff c2
// over the column tiles o0 of fd[r, t0.., o0..], as side 2 coeff^T c1 over
// the row tiles o0 of fd[r, o0.., t0..]. Each step is three boxes: the
// 64 x 64 fd tile and its mask words (3-d tensor maps over (rows, n, np)
// and (rows, n, W), zeros past n; a mask box row is the 4 words from a
// 16-byte boundary, as TMA needs, so it holds the tile's 2 and 2 others)
// and the other side's code tile, which comes from a copy the wrapper lays
// out as TMA needs it (code rows are 280 bytes, not a multiple of 16):
// (maps, n / 64 tiles, cc, 64) channel-major, bf16-rounded for code_bf16;
// its boxes are 72 wide, so they land at dc_tile's conflict-free pitch with
// zeros in the last 8 columns and past cc, which TMA fills without reading
// device memory. One producer warp keeps a ring of 2-4 such stages full (as
// many as let two blocks share an SM: ~99 KB at cc = 70 f32) and waits on
// each stage's "empty" mbarrier; the 8 consumer warps wait on its "full"
// one, form the coefficients from fd, mask and the row means into a shared
// tile [own row][other row] (conflict-free reads of fd; side 2 transposes
// on the way), and run dc_tile on it against the code tile; the gradient
// tile stays in registers as mma accumulators. The entries and tiles come
// in the order of the backward that recomputed fd and cd, and each
// coefficient is the same arithmetic on the same fd and mask, so dcode is
// that backward's bit for bit. Every gradient element is written once, by
// one thread, after a sum in a fixed order, so runs are deterministic (a
// first Adam step maps any gradient above 1e-8 to +-lr, so run-to-run
// atomics noise would show in the step). What sets its pace
// (tools/c2_ablation.py, PERF.md): dc_tile's products, about two thirds of
// its time on f32 code (3xTF32 on mma.sync, the code operand split into
// TF32 parts by every warp for every entry), then the coefficients; the
// ring alone, with neither, runs at about 60% of the memory rate. dc_tile
// stays mma.sync all the same: wgmma would change the order of the sums,
// and dcode would no longer be the recompute backward's bit for bit.
// Ragged n (784 and 121 are not multiples of 64): tile rows and columns
// past n are zeros or masked out of the sums (a zero fd is not a zero
// coefficient); the forward's buffers are padded only to their pitches.
//
// Code channels in chunks: up to 128 (kCodeChunk) the code tiles hold every
// channel, as above. Past that both of the forward's code tiles come 128
// channels at a time and cd accumulates over the chunks in channel order
// (the same sums as one tile would give); the backward adds a grid axis over
// the chunks of the gradient's channels, each block reading fd and the mask
// again for its chunk.
//
// Feature channels in chunks (forward). The block's own 64 rows (side 1)
// stay in shared memory with every channel; the other side's tile comes a
// chunk of channels at a time, and fd accumulates over the chunks in
// registers in channel order, so the chunks change no sum. bf16: the own
// tile row-major (99 KB at ViT-B's 768 channels), the other side whole up
// to 384 channels (one chunk) and above that in chunks of 256 channels (34
// KB); two whole 768-channel tiles, 198 KB, would not fit beside the code
// tiles. f32 features: the own tile channel-major (108 KB at 384), the
// other side in chunks of 64 channels (18 KB), fd by 3xTF32 in the mma
// fragment layout; above 384 channels (216 KB of own tile at 768) the own
// rows come in the same 64-channel chunks too, read again from device
// memory (L2) for every tile.

#include <cuda.h>
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
// 8-channel groups w / 4 + 2 j, j < kSlots: with kSlots = ceil(g / 2) for a
// chunk of g groups (its channels over 8 rounded up) the two halves of the
// warps share the chunk's groups evenly, and a group past g (one at most)
// is zeros of the tile, whose outputs are not written. The slot count is a
// constant, so the compiler interleaves the groups' products (a test of g
// at run time held each group's behind the one before, measurably slower
// on an H100). out[j] is group j's accumulator in the
// mma fragment layout. f32 code: 3xTF32 in 8-row steps, with the depth index
// permuted (mma column t is row 2t, t + 4 is 2t + 1) so that both fragments
// are 8-byte loads; bf16 code: m16n8k16 on the bf16 coefficients and code,
// whose every product is exact in f32. Each step goes into a zeroed
// accumulator, added to out in f32. ``live`` (kSlots unless a run-time
// count is timed against the constant: tools/c2_ablation.py) limits the
// slots at run time.
template <bool kBf16, int kSlots>
__device__ __forceinline__ void dc_tile(const float* coeff, const void* x,
                                        float (&out)[8][4],
                                        int live = kSlots) {
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
      for (int j = 0; j < kSlots; ++j) {
        const int grp = half + 2 * j;
        if (j < live) {
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
      for (int j = 0; j < kSlots; ++j) {
        const int grp = half + 2 * j;
        if (j < live) {
          const float2 xv = *reinterpret_cast<const float2*>(
              xf + (grp * 8 + g) * kCodePitchF32 + k0 + 2 * t);
          tf32x3::mma3(out[j], a_hi, a_lo, xv.x, xv.y);
        }
      }
    }
  }
}

// Carves the forward's dynamic shared memory: feature tiles a (the block's
// own rows) and b (the other side's) and code tiles a and b.
struct Smem {
  void* fa;
  void* fb;
  void* ca;
  void* cb;
};

__device__ Smem carve(unsigned char* base, const Geometry& g) {
  const size_t feat = g.feat_a_bytes + g.feat_b_bytes;
  Smem s;
  s.fa = base;
  s.fb = base + g.feat_a_bytes;
  s.ca = base + feat;
  s.cb = base + feat + g.code_bytes;
  return s;
}

template <bool kBf16, bool kFeatF32>
size_t smem_bytes(int n, int cf, int cc) {
  const Geometry g = make_geometry<kBf16, kFeatF32>(n, cf, cc);
  return g.feat_a_bytes + g.feat_b_bytes + 2 * g.code_bytes;
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
// loads into s.fb and s.cb: the own rows are the i tile, the other's the j
// tile. Starts with a barrier, so every thread is done with the previous
// other tile (and the own tile is loaded).
// The other side's feature channels come geo.chunk at a time (and the own
// rows' too when geo.own_chunked), fd accumulating over the chunks in
// channel order. Above kCodeChunk code channels both code tiles come a
// chunk at a time too (the own rows' from c_own), cd accumulating over them
// in channel order.
template <bool kBf16, bool kFeatF32>
__device__ void tile_against(const Smem& s, const FeatType<kFeatF32>* f_own,
                             const float* c_own, int own0,
                             const FeatType<kFeatF32>* f_other,
                             const float* c_other, int o0,
                             const Geometry& geo, float (&fd)[4][4],
                             float (&cd)[4][4]) {
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
      fd_f32(geo.own_chunked ? own : own + c0 * kCodePitchF32, other, nc, fd);
    } else {
      const auto* own = static_cast<const __nv_bfloat16*>(s.fa) + c0;
      auto* other = static_cast<__nv_bfloat16*>(s.fb);
      const int pa = geo.feat_pitch, pb = geo.chunk_pitch;
      const int depth = (nc + 15) & ~15;
      load_feat_tile(other, f_other, o0, c0, nc, pb, geo);
      if (c0 == 0) load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo);
      cp_async_wait();
      __syncthreads();
      fd_bf16(own, pa, other, pb, depth, fd);
    }
  }
  if (geo.cc <= kCodeChunk) {
    cd_tile<kBf16>(s.ca, s.cb, geo.cc, cd);
    return;
  }
  for (int k0 = 0; k0 < geo.cc; k0 += kCodeChunk) {
    __syncthreads();  // every thread is done with the last code tiles
    load_code_tile(static_cast<CodeT*>(s.ca), c_own, own0, geo, k0);
    load_code_tile(static_cast<CodeT*>(s.cb), c_other, o0, geo, k0);
    cp_async_wait();
    __syncthreads();
    cd_tile<kBf16>(s.ca, s.cb, min(kCodeChunk, geo.cc - k0), cd);
  }
}

// Row pitches of the forward's stored fd (f32 elements) and mask (32-bit
// words) for n columns: multiples of 16 bytes, as a TMA box row needs
// (ops/corr_stream.py:fd_pitch and mask_words give the same).
__host__ __device__ __forceinline__ int fd_pitch(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int mask_words(int n) {
  return ((n + 31) / 32 + 3) & ~3;
}

// The fd tile and clamp mask of this warp's fragments (rows i0 + warp_row0()
// .., columns j0 + warp_col0() ..) into fd_r (n rows of fd_pitch(n)) and
// mask_r (n rows of mask_words(n)), the rows of pair row r: fd as 8-byte
// stores, and a row's 32 columns, the warp's, as one word that the 4
// threads of the row OR together. Rows and columns past n are not stored.
__device__ __forceinline__ void keep_tile(float* fd_r, uint32_t* mask_r,
                                          int i0, int j0, int n,
                                          const float (&fd)[4][4],
                                          const float (&cd)[4][4], float lo,
                                          float hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int jw = j0 + warp_col0();  // the warp's first column, word jw / 32
  const int np = fd_pitch(n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + warp_row0() + g + 8 * h;
    uint32_t bits = 0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = nt * 8 + 2 * t;  // the pair's first column in the word
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float x = cd[nt][2 * h + u];
        if (jw + c + u < n && x >= lo && x <= hi) bits |= 1u << (c + u);
      }
      if (i < n && jw + c < n) {
        *reinterpret_cast<float2*>(fd_r + static_cast<size_t>(i) * np + jw +
                                   c) =
            make_float2(fd[nt][2 * h], fd[nt][2 * h + 1]);
      }
    }
    bits |= __shfl_xor_sync(kFull, bits, 1);
    bits |= __shfl_xor_sync(kFull, bits, 2);
    if (t == 0 && i < n && jw < n) {
      mask_r[static_cast<size_t>(i) * mask_words(n) + jw / 32] = bits;
    }
  }
}

// grid (ceil(n / 64), rows); acc (rows, 4, n); fd_out and mask_out, when not
// null, the fd and clamp mask of every valid entry (keep_tile).
template <bool kBf16, bool kFeatF32>
__global__ void __launch_bounds__(kThreads, 1)
corr_stream_fwd_kernel(const FeatType<kFeatF32>* __restrict__ feats,
                       const float* __restrict__ code,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2, float* __restrict__ acc,
                       float* __restrict__ fd_out,
                       uint32_t* __restrict__ mask_out, int maps, int n,
                       int cf, int cc, float lo, float hi) {
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
    // an out-of-range map index: NaN row sums, no read, no fd or mask
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
                                  j0, geo, fd, cd);
    if (fd_out != nullptr) {
      keep_tile(fd_out + static_cast<size_t>(r) * n * fd_pitch(n),
                mask_out + static_cast<size_t>(r) * n * mask_words(n), i0, j0,
                n, fd, cd, lo, hi);
    }
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

// dc_tile with kSlots = slots (1 to 8), chosen at run time.
template <bool kBf16>
__device__ __forceinline__ void dc_slots(int slots, const float* coeff,
                                         const void* x, float (&out)[8][4]) {
  switch (slots) {
    case 1: dc_tile<kBf16, 1>(coeff, x, out); break;
    case 2: dc_tile<kBf16, 2>(coeff, x, out); break;
    case 3: dc_tile<kBf16, 3>(coeff, x, out); break;
    case 4: dc_tile<kBf16, 4>(coeff, x, out); break;
    case 5: dc_tile<kBf16, 5>(coeff, x, out); break;
    case 6: dc_tile<kBf16, 6>(coeff, x, out); break;
    case 7: dc_tile<kBf16, 7>(coeff, x, out); break;
    default: dc_tile<kBf16, 8>(coeff, x, out);
  }
}

// ---- The backward: a TMA-fed ring of stored fd, mask and code tiles ----

constexpr int kConsumerThreads = kThreads;   // the 8 warps of dc_tile
constexpr int kBwdThreads = kThreads + 32;   // and one producer warp
constexpr int kFdTileBytes = kTile * kTile * 4;
// A row of the mask box: 4 words, the 128 columns from a multiple of 128
// that hold the tile's 64 (a box starts on 16 bytes and is a multiple of 16
// bytes long); the tile's are words (j0 / 32) % 4 and the next.
constexpr int kMaskBoxWords = 4;
constexpr int kMaskTileBytes = kTile * kMaskBoxWords * 4;
constexpr int kCoeffBytes = kTile * kCoeffPitch * 4;
constexpr int kMaxStages = 4;
constexpr int kTmaAlign = 128;  // of every box in shared memory
// The most shared memory a block may take for two blocks an SM: (228 KB of
// the SM less 1 KB reserved a block) / 2.
constexpr size_t kTwoBlockSmem = (228 * 1024 - 2 * 1024) / 2;
constexpr int kTensorMapError = 20001;  // as kernel A's (csrc/attention.cu)
constexpr int kCoeffBarrier = 1;        // the consumers' named barrier

// Parts of the backward left out, for timing what each costs
// (tools/c2_ablation.py builds this file with STEGO_C2_BWD_ABLATION set;
// the port's own build leaves it 0): bit kAblateDc the products (dc_tile),
// bit kAblateCoeff the coefficients (the tile keeps what it held), bit
// kAblateSlots dc_tile's constant slot count (a run-time count of up to 8
// instead). The outputs of a build with any bit set are wrong.
#ifndef STEGO_C2_BWD_ABLATION
#define STEGO_C2_BWD_ABLATION 0
#endif
constexpr int kAblation = STEGO_C2_BWD_ABLATION;
constexpr int kAblateDc = 1;
constexpr int kAblateCoeff = 2;
constexpr int kAblateSlots = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (x, y, z) of a 3-d tensor map into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Bytes of one code tile box: the chunk's channels (at most kCodeChunk,
// rounded up to 16) of 64 rows at the code pitch.
template <bool kBf16>
__host__ __device__ int bwd_code_bytes(int cc) {
  const int ccp = (min(cc, kCodeChunk) + 15) & ~15;
  return kBf16 ? ccp * kCodePitchBf16 * 2 : ccp * kCodePitchF32 * 4;
}

// A stage of the ring: the fd tile, its mask words, the other side's code.
__host__ __device__ __forceinline__ int bwd_stage_bytes(int code_bytes) {
  return kFdTileBytes + kMaskTileBytes + code_bytes;
}

// The block's dynamic shared memory: room to align, the stages, the
// coefficient tile, then a full and an empty mbarrier a stage.
inline size_t bwd_smem(int stage_bytes, int stages) {
  return kTmaAlign + static_cast<size_t>(stages) * stage_bytes + kCoeffBytes +
         2 * 8 * stages;
}

// As many stages (2 to kMaxStages) as let two blocks share an SM; two when
// even those do not (a 128-channel f32 code chunk: one block an SM).
inline int bwd_stages(int stage_bytes) {
  int stages = kMaxStages;
  while (stages > 2 && bwd_smem(stage_bytes, stages) > kTwoBlockSmem) --stages;
  return stages;
}

// A group's backward scalars (scal's row).
struct Scalars {
  float g_loss, g_cdm, gm, shift, inv_m;
};

// The coefficient of one entry (pallas_corr.py:243-250): fd' - shift under
// the clamp mask, times g_loss, plus g_cdm, over m; bf16-rounded with
// kBf16. The operations of the backward that recomputed fd and cd, in its
// order, so its coefficients bit for bit.
template <bool kBf16>
__device__ __forceinline__ float coefficient(float fd, bool in_clamp,
                                             float rm, const Scalars& sc,
                                             int pointwise) {
  const float mask = in_clamp ? 1.f : 0.f;
  const float fdp = pointwise ? __fadd_rn(__fsub_rn(fd, rm), sc.gm) : fd;
  float v = __fmul_rn(-__fsub_rn(fdp, sc.shift), mask);
  v = __fmul_rn(__fadd_rn(__fmul_rn(v, sc.g_loss), sc.g_cdm), sc.inv_m);
  return kBf16 ? bf16_round(v) : v;
}

// Row i's mean of fd over its n columns (s3 / n), or 0 past n or when not
// pointwise.
__device__ __forceinline__ float row_mean(const float* s3, int i, int n,
                                          int pointwise) {
  return (pointwise && i < n) ? __fdiv_rn(s3[i], static_cast<float>(n)) : 0.f;
}

// grid (ceil(n / 64), maps, code chunks), kBwdThreads threads. The block
// owns rows t0 .. t0 + 63 of map m, code channels kCodeChunk blockIdx.z ..
// + kCodeChunk - 1, and takes the entries order[offsets[m] ..
// offsets[m + 1]) of the pair-row list: entry e < rows is pair row e
// reading map m as side 1, e >= rows is pair row e - rows reading it as
// side 2; an entry whose other map is out of range is skipped. Tensor maps:
// tfd over the forward's fd (n, n, rows; row pitch fd_pitch(n)), tmask over
// its mask words (mask_words(n), n, rows), tcode over the code tiles
// (64, cc, maps x ceil(n / 64)), whose boxes of 72 x ccp land at the code
// pitch with zeros past row 64 and channel cc. scal (groups, 5): g_loss,
// g_cdm, fd mean, shift, 1/m; row_group (rows,). Writes dcode (maps, n, cc).
template <bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 2)
corr_stream_bwd_kernel(const __grid_constant__ CUtensorMap tfd,
                       const __grid_constant__ CUtensorMap tmask,
                       const __grid_constant__ CUtensorMap tcode,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2,
                       const float* __restrict__ acc,
                       const float* __restrict__ scal,
                       const int* __restrict__ row_group,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets,
                       float* __restrict__ dcode, int rows, int maps, int n,
                       int cc, int stages, int pointwise) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kTmaAlign - 1) &
      ~uintptr_t(kTmaAlign - 1));
  const int code_bytes = bwd_code_bytes<kBf16>(cc);
  const int stage_bytes = bwd_stage_bytes(code_bytes);
  float* coeff = reinterpret_cast<float*>(smem + stages * stage_bytes);
  const uint32_t bar_full = smem_u32(smem + stages * stage_bytes + kCoeffBytes);
  const uint32_t bar_empty = bar_full + 8 * stages;
  const int t0 = blockIdx.x * kTile;
  const int m = blockIdx.y;
  const int q0 = blockIdx.z * kCodeChunk;  // the block's first code channel
  const int tiles = (n + kTile - 1) / kTile;
  const int begin = offsets[m];
  const int end = offsets[m + 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: one thread walks the consumers' steps and issues the
    // three boxes of each into the next free stage
    if (lane == 0) {
      const uint32_t tx = static_cast<uint32_t>(stage_bytes);
      int k = 0;
      for (int q = begin; q < end; ++q) {
        const int entry = order[q];
        const bool side1 = entry < rows;
        const int r = side1 ? entry : entry - rows;
        const int other = side1 ? idx2[r] : idx1[r];
        if (other < 0 || other >= maps) continue;
        for (int o = 0; o < tiles; ++o, ++k) {
          const int st = k % stages;
          mbar_wait(bar_empty + 8 * st, ((k / stages) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * st;
          const uint32_t dst = smem_u32(smem + st * stage_bytes);
          // fd[r, i0.., j0..]: the own rows are i (side 1) or j (side 2)
          const int i0 = side1 ? t0 : o * kTile;
          const int j0 = side1 ? o * kTile : t0;
          mbar_expect_tx(full, tx);
          tma_load_3d(dst, &tfd, full, j0, i0, r);
          tma_load_3d(dst + kFdTileBytes, &tmask, full, j0 / 128 * 4, i0, r);
          tma_load_3d(dst + kFdTileBytes + kMaskTileBytes, &tcode, full, 0,
                      q0, other * tiles + o);
        }
      }
    }
    return;
  }

  // dc_tile's slots: half of the chunk's 8-channel groups, rounded up
  const int slots = ((min(kCodeChunk, cc - q0) + 7) / 8 + 1) / 2;
  // the gradient tile of the block's rows (dc_tile's layout): rows
  // warp_row0() + g + 8 (e >> 1), channels q0 + 8 (warp / 4 + 2 j) + 2t +
  // (e & 1)
  float out[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
  }
  int k = 0;
  for (int q = begin; q < end; ++q) {
    const int entry = order[q];
    const bool side1 = entry < rows;
    const int r = side1 ? entry : entry - rows;
    const int other = side1 ? idx2[r] : idx1[r];
    if (other < 0 || other >= maps) continue;
    const float* g5 = scal + row_group[r] * 5;
    const Scalars sc = {g5[0], g5[1], g5[2], g5[3], g5[4]};
    const float* s3 = acc + (static_cast<size_t>(r) * 4 + 2) * n;
    // side 1: the means of this thread's rows (tid / 16 + 16 q of the
    // block's own), one division each an entry
    float rm1[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      rm1[q4] = side1 ? row_mean(s3, t0 + (tid >> 4) + 16 * q4, n, pointwise)
                      : 0.f;
    }
    for (int o = 0; o < tiles; ++o, ++k) {
      const int st = k % stages;
      const uint8_t* stage = smem + st * stage_bytes;
      const float* fdt = reinterpret_cast<const float*>(stage);
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(stage + kFdTileBytes);
      const int i0 = side1 ? t0 : o * kTile;
      const int j0 = side1 ? o * kTile : t0;
      const int w0 = (j0 / 32) % kMaskBoxWords;  // the tile's first word
      // side 2: lane l < 16 takes the mean of the warp's row 4 (warp / 2) +
      // 16 (l / 4) + l % 4 of the tile, read before the wait and shared
      // by shuffles
      const float rm2 =
          side1 ? 0.f
                : row_mean(s3, i0 + 4 * (warp >> 1) + 16 * (lane >> 2 & 3) +
                                   (lane & 3),
                           n, pointwise);
      mbar_wait(bar_full + 8 * st, (k / stages) & 1);
      // coeff [own row][other row] from the tile [i][j]: [i][j] for side 1,
      // [j][i] for side 2; zero past n
      if constexpr ((kAblation & kAblateCoeff) != 0) {
      } else if (side1) {
        // a thread a row's 4 columns: 16-byte reads and writes
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int a = (tid >> 4) + 16 * q4;
          const int c = (tid & 15) * 4;
          const float4 x = *reinterpret_cast<const float4*>(fdt + a * kTile + c);
          const uint32_t bits =
              words[a * kMaskBoxWords + w0 + c / 32] >> (c & 31);
          const bool i_ok = i0 + a < n;
          const float rm = rm1[q4];
          const float xs[4] = {x.x, x.y, x.z, x.w};
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = (i_ok && j0 + c + u < n)
                       ? coefficient<kBf16>(xs[u], (bits >> u) & 1u, rm, sc,
                                            pointwise)
                       : 0.f;
          }
          *reinterpret_cast<float4*>(coeff + a * kCoeffPitch + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
        // a lane a column b, 4 rows a0 .. a0 + 3 of it: reads on 32 banks,
        // one 16-byte write of coeff row b
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int task = warp + kWarps * q4;
          const int b = (task & 1) * 32 + lane;
          const int a0 = (task >> 1) * 4;  // 4 (warp / 2) + 16 q4
          const bool j_ok = j0 + b < n;
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int a = a0 + u;
            const bool in_clamp =
                (words[a * kMaskBoxWords + w0 + b / 32] >> (b & 31)) & 1u;
            const float rm = __shfl_sync(kFull, rm2, 4 * q4 + u);
            v[u] = (i0 + a < n && j_ok)
                       ? coefficient<kBf16>(fdt[a * kTile + b], in_clamp, rm,
                                            sc, pointwise)
                       : 0.f;
          }
          *reinterpret_cast<float4*>(coeff + b * kCoeffPitch + a0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      asm volatile("bar.sync %0, %1;\n" ::"n"(kCoeffBarrier),
                   "n"(kConsumerThreads)
                   : "memory");
      // side 1: out[i][c] += sum_j coeff[i][j] c2[j][c];
      // side 2: out[j][c] += sum_i coeff[i][j] c1[i][c];
      // both are out += coeff c_other^T with coeff as [own][other]
      const void* code_tile = stage + kFdTileBytes + kMaskTileBytes;
      if constexpr ((kAblation & kAblateSlots) != 0) {
        dc_tile<kBf16, 8>(coeff, code_tile, out, slots);
      } else if constexpr ((kAblation & kAblateDc) == 0) {
        dc_slots<kBf16>(slots, coeff, code_tile, out);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // the stage is free
      // every warp is done with coeff before the next tile's coefficients
      asm volatile("bar.sync %0, %1;\n" ::"n"(kCoeffBarrier),
                   "n"(kConsumerThreads)
                   : "memory");
    }
  }
  const int g = lane >> 2;
  const int t = lane & 3;
  float* dst = dcode + static_cast<size_t>(m) * n * cc;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = t0 + warp_row0() + g + 8 * (e >> 1);
      const int c = q0 + 8 * (tid / 128 + 2 * j) + 2 * t + (e & 1);
      if (row < n && c < cc) dst[static_cast<size_t>(row) * cc + c] = out[j][e];
    }
  }
}

bool bad_shape(int rows, int maps, int n, int cc) {
  return rows <= 0 || rows > 65535 || maps <= 0 || maps > 65535 || n <= 0 ||
         cc <= 0 || (cc + kCodeChunk - 1) / kCodeChunk > 65535;
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
                       const void* idx2, void* acc, void* fd, void* mask,
                       int rows, int maps, int n, int cf, int cc, float lo,
                       float hi, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes<kBf16, kFeatF32>(n, cf, cc);
  cudaError_t err =
      prepare(corr_stream_fwd_kernel<kBf16, kFeatF32>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, rows);
  corr_stream_fwd_kernel<kBf16, kFeatF32><<<grid, kThreads, smem, stream>>>(
      static_cast<const FeatType<kFeatF32>*>(feats),
      static_cast<const float*>(code), static_cast<const int*>(idx1),
      static_cast<const int*>(idx2), static_cast<float*>(acc),
      static_cast<float*>(fd), static_cast<uint32_t*>(mask), maps, n, cf, cc,
      lo, hi);
  return cudaGetLastError();
}

// A 3-d tensor map (d0, d1, d2) of elem_bytes-byte elements whose rows (dim
// 0) are ``pitch`` elements apart and slices (dim 2) d1 rows, with boxes of
// (b0, b1, 1) and zeros out of bounds; false when the CUDA driver refuses
// it.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* base, int d0, int d1, int d2, int pitch, int b0,
              int b1) {
  const cuuint64_t row = static_cast<cuuint64_t>(pitch) * elem_bytes;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                        static_cast<cuuint64_t>(d1),
                        static_cast<cuuint64_t>(d2)};
  cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(d1)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                       static_cast<cuuint32_t>(b1), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static_assert(kCodePitchF32 == kCodePitchBf16, "one code-tile pitch");

template <bool kBf16>
int launch_bwd(const void* fd, const void* mask, const void* code_tiles,
               const void* idx1, const void* idx2, const void* acc,
               const void* scal, const void* row_group, const void* order,
               const void* offsets, void* dcode, int rows, int maps, int n,
               int cc, int pointwise, int device, cudaStream_t stream) {
  const int stage_bytes = bwd_stage_bytes(bwd_code_bytes<kBf16>(cc));
  const int stages = bwd_stages(stage_bytes);
  const size_t smem = bwd_smem(stage_bytes, stages);
  cudaError_t err = prepare(corr_stream_bwd_kernel<kBf16>, device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  const int ccp = (min(cc, kCodeChunk) + 15) & ~15;
  CUtensorMap tfd, tmask, tcode;
  if (!make_map(&tfd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, fd, n, n, rows,
                fd_pitch(n), kTile, kTile) ||
      !make_map(&tmask, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, mask,
                mask_words(n), n, rows, mask_words(n), kMaskBoxWords,
                kTile) ||
      !make_map(&tcode,
                kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                kBf16 ? 2 : 4, code_tiles, kTile, cc, maps * tiles, kTile,
                kCodePitchF32, ccp)) {
    return kTensorMapError;
  }
  const dim3 grid(tiles, maps, (cc + kCodeChunk - 1) / kCodeChunk);
  corr_stream_bwd_kernel<kBf16><<<grid, kBwdThreads, smem, stream>>>(
      tfd, tmask, tcode, static_cast<const int*>(idx1),
      static_cast<const int*>(idx2), static_cast<const float*>(acc),
      static_cast<const float*>(scal), static_cast<const int*>(row_group),
      static_cast<const int*>(order), static_cast<const int*>(offsets),
      static_cast<float*>(dcode), rows, maps, n, cc, stages, pointwise);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (maps, n, cf), bf16 (feat_f32 = 0) or f32 (feat_f32 = 1), and code
// (maps, n, cc) f32, both l2-normalised rows; idx1, idx2 (rows,) int32 map
// indices of each pair row's two sides. Writes acc (rows, 4, n) f32: s1,
// s2, s3 and sum cd of every side-1 row; and, unless fd and mask are null
// (no gradient is taken), fd (rows, n, fd_pitch(n)) f32 and the clamp mask
// (rows, n, mask_words(n)) of 32-bit words (bit j % 32 of word j / 32) of
// every pair row whose map indices are in range, columns below n. cf <=
// 768, rows and maps <= 65535; code channels above 128 come in chunks of
// 128. code_bf16 rounds the code to bf16 for cd. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int stego_corr_stream_fwd(const void* feats, const void* code,
                                     const void* idx1, const void* idx2,
                                     void* acc, void* fd, void* mask,
                                     int rows, int maps, int n, int cf,
                                     int cc, int code_bf16, int feat_f32,
                                     float lo, float hi, int device,
                                     void* stream) {
  if (bad_shape(rows, maps, n, cc) || cf <= 0 || cf > kMaxFeat ||
      (fd == nullptr) != (mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, void*, void*, void*, int, int,
                                 int, int, int, float, float, int,
                                 cudaStream_t);
  Launch launch;
  if (code_bf16) {
    launch = feat_f32 ? &launch_fwd<true, true> : &launch_fwd<true, false>;
  } else {
    launch = feat_f32 ? &launch_fwd<false, true> : &launch_fwd<false, false>;
  }
  return static_cast<int>(launch(feats, code, idx1, idx2, acc, fd, mask,
                                 rows, maps, n, cf, cc, lo, hi, device, st));
}

// The forward's fd and mask (as it writes them) and acc; code_tiles (maps,
// ceil(n / 64), cc, 64) f32, or bf16 with code_bf16: the code maps by
// 64-row tile, channel-major, rows past n zero
// (ops/corr_stream.py:code_tiles); idx1, idx2 (rows,) int32; scal
// (groups, 5) f32: g_loss, g_cdm, fd mean, shift, 1/m of each group;
// row_group (rows,) int32; order (2 rows,) int32, the entries of every map
// in a fixed order (entry e < rows: pair row e reads the map as side 1; e
// >= rows: pair row e - rows as side 2), grouped by map with offsets (maps +
// 1,) int32. Writes every element of dcode (maps, n, cc) f32. Returns the
// CUDA error code of the launch, or 20001 when the CUDA driver refuses a
// tensor map.
extern "C" int stego_corr_stream_bwd(const void* fd, const void* mask,
                                     const void* code_tiles, const void* idx1,
                                     const void* idx2, const void* acc,
                                     const void* scal, const void* row_group,
                                     const void* order, const void* offsets,
                                     void* dcode, int rows, int maps, int n,
                                     int cc, int code_bf16, int pointwise,
                                     int device, void* stream) {
  if (bad_shape(rows, maps, n, cc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (code_bf16 ? &launch_bwd<true> : &launch_bwd<false>)(
      fd, mask, code_tiles, idx1, idx2, acc, scal, row_group, order, offsets,
      dcode, rows, maps, n, cc, pointwise, device, st);
}

// The backward's launch at cc code channels (f32 or, with code_bf16, bf16
// code tiles): its ring stages, dynamic shared memory (bytes) and the
// blocks an SM holds by the occupancy API, into out[0..2]. Returns the CUDA
// error code (0 on success).
extern "C" int stego_corr_stream_bwd_occupancy(int cc, int code_bf16,
                                               int device, int* out) {
  if (cc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int stage_bytes = code_bf16 ? bwd_stage_bytes(bwd_code_bytes<true>(cc))
                                    : bwd_stage_bytes(bwd_code_bytes<false>(cc));
  const int stages = bwd_stages(stage_bytes);
  const size_t smem = bwd_smem(stage_bytes, stages);
  cudaError_t err =
      code_bf16 ? prepare(corr_stream_bwd_kernel<true>, device, smem)
                : prepare(corr_stream_bwd_kernel<false>, device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = code_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, corr_stream_bwd_kernel<true>, kBwdThreads,
                        smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, corr_stream_bwd_kernel<false>, kBwdThreads,
                        smem);
  out[0] = stages;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  return static_cast<int>(err);
}
