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
// f32 accumulation (every product exact in f32, each 16 channels added to
// the running f32 sum with round to nearest), or with f32 features (an f32
// trunk, feat_dtype=float32) an f32 x f32 product; cd is f32 x f32, or with
// code_bf16 a bf16 x bf16 product with f32 accumulation, and then the
// backward rounds coeff and the code to bf16 before its f32 sums
// (pallas_corr.py:251-260). The f32 products run on the tensor cores by
// 3xTF32 (tf32x3.cuh: operands split into TF32 high and low parts, three
// products an 8-channel step, ~2^-22 of each product left, about f32's own
// rounding; one TF32 product would keep ~2^-11, which the f32 row-sum gate
// rejects), each step added to its f32 sum in channel order: fd on f32
// features, the f32 cd and the backward's dc1 and dc2. The clamp mask (lo
// <= cd <= hi) is a step, and a cd that moves by a rounding flips it where
// cd lies that close to a bound; so every f32 cd within fixup_eps of a
// bound is recomputed by f32 FMA in channel order, the forward's cd before
// 3xTF32 (fixup_eps derives the margin), and every stored mask bit and
// every clamped value near a bound is that FMA's. code_bf16's dc1 and dc2
// run as bf16 m16n8k16 on the bf16-rounded coefficients and code, every
// product exact in f32.
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
// Forward design, Hopper's shape (a TMA ring, a producer, wgmma).
// Persistent blocks, one an SM (min(items, SMs)), walk the items: 128 rows
// of side 1 of a pair row, row tiles fastest, so that the blocks at work
// read the same side-2 maps from L2. A block is two consumer warpgroups of
// 64 side-1 rows (one warpgroup a block took about 1.5x the time: each
// side-2 box then feeds 64 rows, not 128) and a producer warpgroup, which
// gives its registers to the consumers (setmaxnreg, up to 240 a consumer
// thread: with a producer warp, ptxas held the kernel to 168, spilled 52
// bytes and took 1.01-1.06x the time). For every 64-column tile of side 2
// the producer's one thread puts the tile's stages, features first and
// then code, into a ring of three 48 KB stages by TMA; a stage is boxes of
// 64 rows x 128 bytes (one 128-byte swizzle row of channels) of each
// consumer's side-1 rows and of side 2's rows: bf16 two panels of 64
// channels, f32 the TF32 high and low parts of one panel of 32. The entry's first launches copy the operands as the tensor
// maps read them (corr_stream_fwd_prep_kernel: the f32 features' and
// code's TF32 parts, code_bf16's bf16 code; a TMA box row is a multiple of
// 16 bytes and a code row of 70 f32 is 280, so the code is copied anyway;
// splitting in shared memory instead, in a consumer pass over each f32
// stage, halved those bytes and was slower). The consumers wait
// on a stage's full mbarrier, take fd on wgmma m64n64k16 (bf16) or
// m64n64k8 .tf32 (three products a step), both operands K-major from the
// swizzled boxes, each k-step into a zeroed accumulator added to fd by
// __fadd_rn, two accumulators taking turns so that one's adds overlap the
// next step's products; the f32 cd the same way and code_bf16's cd chained
// in its accumulator; then each warp arrives on the stage's empty
// mbarrier. Code channels past one panel simply take more stages, summed
// in channel order; so do feature channels, up to 2048. A tile's epilogue:
// the fix-up (the warp takes its entries near a bound one at a time: its
// lanes copy both code rows from device memory into the warp's shared
// memory and every lane runs the chain on broadcast reads), then fd staged
// in shared memory as two swizzled 32-column boxes for TMA stores, which
// clip rows and columns past n (plain 8-byte stores, with room for a
// fourth stage, were slower), the mask words by plain stores, and the row
// sums in registers.
// The wgmma accumulator gives each thread rows g and g + 8 at columns
// 8 j + 2 t and 8 j + 2 t + 1, the mma.sync layout, so each row's sums go
// over the columns in a thread, then over the 4 threads of its fragment
// group: every block writes only its own rows, without atomics, and runs
// are deterministic. What sets its pace (tools/c2_ablation.py; PERF.md):
// the ring's loads alone take about half of the full-field kernel's time
// (side 1's boxes are read again for every column tile, and f32 operands
// as their TF32 parts, 8 bytes a channel), the fix-up a fifth at 70 code
// channels and two fifths at 160 (each entry waits on device memory and a
// chain of cc FMAs, and the block's warpgroups wait for each other at the
// next stage), fd's and cd's products and their adds most of the rest.
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
// Code channels in chunks (backward): up to 128 (kCodeChunk) the code tiles
// hold every channel, as above; past that the backward adds a grid axis
// over the chunks of the gradient's channels, each block reading fd and
// the mask again for its chunk.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;          // rows and columns of a tile
constexpr int kWarps = 8;          // the backward's consumer warps
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFeat = 2048;     // feature channels (ResNet-50's layer4)
constexpr int kCodeChunk = 128;    // code channels of a backward code tile
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

// Two bf16-exact f32 values as a bf16 pair, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The backward's warp w owns rows 16 (w % 4) .. + 15 of a tile.
__device__ __forceinline__ int warp_row0() { return (threadIdx.x >> 5) % 4 * 16; }

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

// Row pitches of the forward's stored fd (f32 elements) and mask (32-bit
// words) for n columns: multiples of 16 bytes, as a TMA box row needs
// (ops/corr_stream.py:fd_pitch and mask_words give the same).
__host__ __device__ __forceinline__ int fd_pitch(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int mask_words(int n) {
  return ((n + 31) / 32 + 3) & ~3;
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

// ---- TMA, mbarriers and wgmma (the forward's and the backward's ring) ----

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

// A wgmma shared-memory descriptor of a K-major box of 64 rows of 128
// bytes with TMA's 128-byte swizzle at addr (1024-byte aligned): stride
// byte offset 1024 (8 rows), layout 1 (B128); the leading byte offset is
// not read for a swizzled K-major operand. A k-step of 32 bytes along the
// rows adds 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to r across the asynchronous
// wgmma that reads or writes it.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define STEGO_WGMMA_D32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define STEGO_WGMMA_OUT32(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64) = A B^T (+ d when accumulate), one 16-deep bf16 step: A and B
// from shared memory, both K-major, by descriptor.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STEGO_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : STEGO_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same, one 8-deep TF32 step (tf32 operands are K-major only).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " STEGO_WGMMA_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : STEGO_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- The forward: a TMA ring of 128-byte channel panels, wgmma ----

// Parts of the forward left out or added, for timing and checking
// (tools/c2_ablation.py and tests/test_torch_cuda.py build this file with
// STEGO_C2_FWD_ABLATION set; the port's own build leaves it 0): bit
// kFwdNoFd the fd products, bit kFwdNoCd the cd products (and the fix-up),
// bit kFwdNoKeep the stores of fd and the mask (all three leave the ring's
// loads alone), bit kFwdNoFixup the fix-up of cd near the clamp bounds, bit
// kFwdCountFixup a count of the entries the fix-up recomputes and the
// largest |cd_3x - cd_fma| over them (stego_corr_stream_fwd_fixups reads
// both). The outputs of a build with any of the first four bits set are
// wrong.
#ifndef STEGO_C2_FWD_ABLATION
#define STEGO_C2_FWD_ABLATION 0
#endif
constexpr int kFwdAblation = STEGO_C2_FWD_ABLATION;
constexpr int kFwdNoFd = 1;
constexpr int kFwdNoCd = 2;
constexpr int kFwdNoKeep = 4;
constexpr int kFwdNoFixup = 8;
constexpr int kFwdCountFixup = 16;

// Consumer warpgroups a block, each 64 rows of side 1
constexpr int kConsumers = 2;
constexpr int kWarpgroup = 128;
// and a producer warpgroup, one thread of which starts every copy: a whole
// warpgroup, so that setmaxnreg can hand its registers to the consumers
constexpr int kFwdThreads = (kConsumers + 1) * kWarpgroup;
// Registers a thread of the producer and of a consumer holds after
// setmaxnreg: 128 x 24 + 256 x 240 = 64512 with two consumers, within the
// 384 x 168 that a block of 384 threads is launched with.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBlockRows = kConsumers * kTile;
constexpr int kPanelBytes = 128;  // channels a box row: one swizzle row
constexpr int kBoxBytes = kTile * kPanelBytes;  // a box: 64 rows, 8 KB
// A stage is two halves of kSideBoxes boxes: each consumer's side-1 rows,
// then side 2's rows. Unsplit operands (bf16) fill the halves with two
// consecutive panels of 64 channels; split ones (f32 by 3xTF32) with the
// TF32 high and low parts of one panel of 32 channels.
constexpr int kSideBoxes = kConsumers + 1;
constexpr int kFwdStageBytes = 2 * kSideBoxes * kBoxBytes;
// The kept fd tile staged in shared memory, 16 KB a consumer, and written by
// TMA stores.
constexpr int kOutTileBytes = kTile * kTile * 4;
constexpr int kOutBytes = kConsumers * kOutTileBytes;
constexpr int kFixupBytes = kConsumers * 4 * 256 * 4;  // 1 KB a warp
// Ring stages: as many as fit beside the rest (3)
constexpr int kFwdStages = (192 * 1024 - kOutBytes) / kFwdStageBytes;
constexpr size_t kFwdSmem = 1024 +
                            static_cast<size_t>(kFwdStages) * kFwdStageBytes +
                            kOutBytes + kFixupBytes + 2 * 8 * kFwdStages;
static_assert(kFwdStages >= 2 && kFwdSmem <= 232448, "the forward's ring");
constexpr int kStepsBf16 = 8;  // 16-channel steps of a bf16 stage
constexpr int kStepsTf32 = 4;  // 8-channel steps of a split stage

// kFwdCountFixup's count, and the largest |cd_3x - cd_fma| over the
// entries counted (the bits of a non-negative float, which order as the
// float does)
__device__ unsigned long long g_fixups;
__device__ unsigned int g_fixup_gap;

// The fix-up's margin for cc code channels. The f32 cd is taken by 3xTF32
// on the tensor cores, and every entry within eps of a clamp bound is
// recomputed by f32 FMA in channel order, the cd of the forward before (and the
// plain version's order where that is the same), so every stored mask bit
// and every clamped value near a bound is that FMA's. For code rows of norm
// <= 1 (prep's l2 normalisation, eps 1e-10: S = sum_k |a_k b_k| <= 1 up to
// its rounding), with u = 2^-24 and K = cc:
//   FMA in channel order: |cd_fma - a.b| <= K u S (one rounding a step);
//   3xTF32: the split's dropped a_lo b_lo and the rounding of lo, <= 12 u S
//     (hi and lo keep 11 bits each: 2^-22 of each product, three terms);
//     the sums of each 8-channel step, <= 24 u S (the tensor core's three
//     products into a zeroed accumulator, or the plain emulation's f32
//     sums of 8 exact products, ops/tf32.py); each step's add to cd, <=
//     ceil(K / 8) u S;
// so |cd_3x - cd_fma| <= (36 + ceil(K / 8) + K) u (1 + 2^-10), and eps, 8x
// that with room to spare, is (300 + 10 K) u: 2^-14 at K = 70, 2^-12.2 at
// K = 300. An entry at least eps from every bound has cd_3x and cd_fma on
// the same side of it, so its mask bit and clamped value agree; inside eps
// the FMA value replaces cd (in the mask, clamp(cd) and sum cd).
// ops/tf32.py:fixup_eps gives the same.
__host__ __device__ __forceinline__ float fixup_eps(int cc) {
  return (300.f + 10.f * static_cast<float>(cc)) * 5.9604645e-8f;
}

// What one column tile of one launch streams: the feature and code
// operands' stages and k-steps and the channels of their tensor maps.
struct FwdPlan {
  int feat_dim, feat_stages, feat_steps;
  int code_dim, code_stages, code_steps;
};

template <bool kBf16, bool kFeatF32>
__host__ __device__ FwdPlan fwd_plan(int cf, int cc) {
  FwdPlan p;
  if (kFeatF32) {
    p.feat_dim = (cf + 3) & ~3;  // a 16-byte row
    p.feat_stages = (cf + 31) / 32;
    p.feat_steps = (cf + 7) / 8;
  } else {
    p.feat_dim = (cf + 7) & ~7;
    p.feat_stages = (cf + 127) / 128;
    p.feat_steps = (cf + 15) / 16;
  }
  if (kBf16) {
    p.code_dim = (cc + 7) & ~7;
    p.code_stages = (cc + 127) / 128;
    p.code_steps = (cc + 15) / 16;
  } else {
    p.code_dim = (cc + 3) & ~3;
    p.code_stages = (cc + 31) / 32;
    p.code_steps = (cc + 7) / 8;
  }
  return p;
}

// Box b (b < kConsumers: that consumer's rows; kConsumers: side 2's) of
// half h of the stage at address stage.
__device__ __forceinline__ uint32_t box_addr(uint32_t stage, int h, int b) {
  return stage + static_cast<uint32_t>((h * kSideBoxes + b) * kBoxBytes);
}

// The producer's loads of stage s of an operand (tensor maps hi and lo, dim
// channels) for side-1 rows i0 of map m1 (the live consumers' boxes) and
// side-2 rows j0 of map m2, completing on the mbarrier full: an f32 stage
// (kSplit) the TF32 high and low parts of one panel of 32 channels; a bf16
// stage two panels of 64, the second not loaded where it lies past the
// channels.
template <bool kSplit>
__device__ __forceinline__ void load_stage(uint32_t stage, uint32_t full,
                                           const CUtensorMap* hi,
                                           const CUtensorMap* lo, int s,
                                           int dim, int live, int i0, int m1,
                                           int j0, int m2) {
  const int halves = (kSplit || 64 * (2 * s + 1) < dim) ? 2 : 1;
  mbar_expect_tx(full, halves * (live + 1) * kBoxBytes);
  for (int h = 0; h < halves; ++h) {
    const CUtensorMap* map = (kSplit && h == 1) ? lo : hi;
    const int c0 = kSplit ? 32 * s : 64 * (2 * s + h);
    for (int b = 0; b < live; ++b) {
      tma_load_3d(box_addr(stage, h, b), map, full, c0, i0 + kTile * b, m1);
    }
    tma_load_3d(box_addr(stage, h, kConsumers), map, full, c0, j0, m2);
  }
}

// One k-step s of a stage into d (accumulate: add to d, else overwrite):
// bf16, panel s / 4, 32 bytes a step; split, the three products of 3xTF32
// (tf32x3.cuh: a_lo b_hi, then a_hi b_lo and a_hi b_hi added) of step s.
template <bool kSplit>
__device__ __forceinline__ void step_products(float (&d)[32], uint32_t stage,
                                           int wg, int s, int accumulate) {
  if constexpr (kSplit) {
    const uint32_t k = 2 * s;
    const uint64_t a_hi = smem_desc(box_addr(stage, 0, wg)) + k;
    const uint64_t a_lo = smem_desc(box_addr(stage, 1, wg)) + k;
    const uint64_t b_hi = smem_desc(box_addr(stage, 0, kConsumers)) + k;
    const uint64_t b_lo = smem_desc(box_addr(stage, 1, kConsumers)) + k;
    wgmma_tf32(d, a_lo, b_hi, accumulate);
    wgmma_tf32(d, a_hi, b_lo, 1);
    wgmma_tf32(d, a_hi, b_hi, 1);
  } else {
    const int h = s / 4;
    const uint32_t k = 2 * (s % 4);
    wgmma_bf16(d, smem_desc(box_addr(stage, h, wg)) + k,
               smem_desc(box_addr(stage, h, kConsumers)) + k, accumulate);
  }
}

// acc += the first `steps` k-steps of a stage, each into a zeroed
// accumulator that is then added to acc in f32 (round to nearest), the
// order that removed a bias: a chain of tensor-core steps accumulating into acc
// itself drops the low bits of every step the same way (over ViT-B's 768
// channels that bias put the full-field step's gradients 36x further from
// the plain version's). Two accumulators take turns, so that one step's
// adds overlap the next step's products.
template <bool kSplit>
__device__ __forceinline__ void promote_stage(float (&acc)[32],
                                              float (&p0)[32],
                                              float (&p1)[32], uint32_t stage,
                                              int wg, int steps) {
  constexpr int kMax = kSplit ? kStepsTf32 : kStepsBf16;
  fence_regs(p0);
  wgmma_fence();
  step_products<kSplit>(p0, stage, wg, 0, 0);
  wgmma_commit();
#pragma unroll
  for (int s = 0; s < kMax; ++s) {
    if (s < steps) {
      float(&cur)[32] = (s & 1) ? p1 : p0;
      float(&nxt)[32] = (s & 1) ? p0 : p1;
      if (s + 1 < steps) {
        fence_regs(nxt);
        wgmma_fence();
        step_products<kSplit>(nxt, stage, wg, s + 1, 0);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(cur);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], cur[i]);
    }
  }
}

// code_bf16's cd += the first `steps` 16-channel steps of a stage, chained
// in the accumulator (accumulate false on the first step of the first
// stage): the order of the mma.sync chain before; every product is exact in
// f32.
__device__ __forceinline__ void chain_stage(float (&acc)[32], uint32_t stage,
                                            int wg, int steps, bool first) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStepsBf16; ++s) {
    if (s < steps) step_products<false>(acc, stage, wg, s, !(first && s == 0));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// cd of code rows a and b by f32 FMA over their cc channels in channel
// order, v = fmaf(a_k, b_k, v) from 0: the FMA cd of the forward before,
// the fix-up's arithmetic. The whole warp takes one entry: its lanes copy
// both rows, 128 channels at a time, into the warp's 1 KB of shared memory
// (coalesced loads, all in flight at once, so an entry waits on L2 about
// once a chunk), and every lane runs the chain on broadcast reads of them,
// so all lanes end with the same v.
__device__ __forceinline__ float warp_cd_fma(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int cc, int lane, float* rows) {
  float v = 0.f;
  for (int c0 = 0; c0 < cc; c0 += 128) {
    const int m = min(128, cc - c0);
    float av[4], bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 32 * q + lane;
      av[q] = k < m ? a[c0 + k] : 0.f;
      bv[q] = k < m ? b[c0 + k] : 0.f;
    }
    __syncwarp();  // every lane is done with the last chunk
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rows[32 * q + lane] = av[q];
      rows[128 + 32 * q + lane] = bv[q];
    }
    __syncwarp();
#pragma unroll 8
    for (int k = 0; k < m; ++k) v = fmaf(rows[k], rows[128 + k], v);
  }
  return v;
}

// grid: persistent blocks over the items (row tile of kBlockRows side-1
// rows, pair row), row tiles fastest; kFwdThreads threads: kConsumers
// consumer warpgroups, then the producer's. acc (rows, 4, n); fd_out and
// mask_out, when not null, the fd and clamp mask of every valid entry.
// Tensor maps (channels, n, maps), 128-byte swizzle: tf_hi and tf_lo over
// the features (bf16, or f32's TF32 parts), tc_hi and tc_lo over the code
// (f32's TF32 parts, or bf16 with code_bf16); tfd over fd_out (n, n,
// rows; boxes of 32 x 64), which the TMA stores write; code is the f32
// code, which the fix-up reads.
template <bool kBf16, bool kFeatF32>
__global__ void __launch_bounds__(kFwdThreads, 1)
corr_stream_fwd_kernel(const __grid_constant__ CUtensorMap tf_hi,
                       const __grid_constant__ CUtensorMap tf_lo,
                       const __grid_constant__ CUtensorMap tc_hi,
                       const __grid_constant__ CUtensorMap tc_lo,
                       const __grid_constant__ CUtensorMap tfd,
                       const float* __restrict__ code,
                       const int* __restrict__ idx1,
                       const int* __restrict__ idx2, float* __restrict__ acc,
                       float* __restrict__ fd_out,
                       uint32_t* __restrict__ mask_out, int rows, int maps,
                       int n, int cf, int cc, float lo, float hi) {
  // f32 cd near a bound recomputed by FMA (not code_bf16's, not ablated)
  constexpr bool kFixup =
      !kBf16 && (kFwdAblation & (kFwdNoCd | kFwdNoFixup)) == 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t out_tiles = base + kFwdStages * kFwdStageBytes;
  const uint32_t bar_full = out_tiles + kOutBytes + kFixupBytes;
  const uint32_t bar_empty = bar_full + 8 * kFwdStages;
  const FwdPlan plan = fwd_plan<kBf16, kFeatF32>(cf, cc);
  const int row_tiles = (n + kBlockRows - 1) / kBlockRows;
  const int items = row_tiles * rows;
  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup;

  if (tid == 0) {
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // the producer: one thread walks the consumers' stages and starts each
    // one's boxes into the next free slot of the ring, on few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid % kWarpgroup == 0) {
      int k = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int r = it / row_tiles;
        const int i0 = (it - r * row_tiles) * kBlockRows;
        const int m1 = idx1[r];
        const int m2 = idx2[r];
        if (m1 < 0 || m1 >= maps || m2 < 0 || m2 >= maps) continue;
        const int live = min(kConsumers, (n - i0 + kTile - 1) / kTile);
        for (int j0 = 0; j0 < n; j0 += kTile) {
          for (int s = 0; s < plan.feat_stages + plan.code_stages; ++s, ++k) {
            const int st = k % kFwdStages;
            mbar_wait(bar_empty + 8 * st, ((k / kFwdStages) & 1) ^ 1);
            const uint32_t stage = base + st * kFwdStageBytes;
            if (s < plan.feat_stages) {
              load_stage<kFeatF32>(stage, bar_full + 8 * st, &tf_hi, &tf_lo,
                                   s, plan.feat_dim, live, i0, m1, j0, m2);
            } else {
              load_stage<!kBf16>(stage, bar_full + 8 * st, &tc_hi, &tc_lo,
                                 s - plan.feat_stages, plan.code_dim, live,
                                 i0, m1, j0, m2);
            }
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: side-1 rows i0 + 64 wg .. + 63 of each item, on
  // the registers the producer gave up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = (tid / 32) % 4;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float eps = fixup_eps(cc);
  // the warp's 1 KB for the fix-up's code rows
  float* fixup_rows = reinterpret_cast<float*>(
      smem + kFwdStages * kFwdStageBytes + kOutBytes) + (tid / 32) * 256;
  const int words = mask_words(n);
  float p0[32] = {}, p1[32] = {};  // the products' turns
  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / row_tiles;
    const int i0 = (it - r * row_tiles) * kBlockRows;
    const int m1 = idx1[r];
    const int m2 = idx2[r];
    float* acc_r = acc + static_cast<size_t>(r) * 4 * n;
    if (m1 < 0 || m1 >= maps || m2 < 0 || m2 >= maps) {
      // an out-of-range map index: NaN row sums, no read, no fd or mask
      for (int i = tid; i < kBlockRows; i += kConsumers * kWarpgroup) {
        if (i0 + i < n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc_r[q * n + i0 + i] = NAN;
        }
      }
      continue;
    }
    const int row_base = i0 + kTile * wg + 16 * warp + g;  // rows h = 0, 1: +8h
    const bool live = i0 + kTile * wg < n;
    const float* code1 = code + static_cast<size_t>(m1) * n * cc;
    const float* code2 = code + static_cast<size_t>(m2) * n * cc;
    float sums[4][2] = {};  // s1, s2, s3, sum cd of rows row_base + 8h
    for (int j0 = 0; j0 < n; j0 += kTile) {
      float fd[32], cd[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fd[i] = 0.f;
        cd[i] = 0.f;
      }
      for (int s = 0; s < plan.feat_stages; ++s, ++k) {
        const int st = k % kFwdStages;
        mbar_wait(bar_full + 8 * st, (k / kFwdStages) & 1);
        if ((kFwdAblation & kFwdNoFd) == 0 && live) {
          const int per = kFeatF32 ? kStepsTf32 : kStepsBf16;
          promote_stage<kFeatF32>(fd, p0, p1, base + st * kFwdStageBytes, wg,
                                  min(per, plan.feat_steps - s * per));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      }
      for (int s = 0; s < plan.code_stages; ++s, ++k) {
        const int st = k % kFwdStages;
        mbar_wait(bar_full + 8 * st, (k / kFwdStages) & 1);
        if ((kFwdAblation & kFwdNoCd) == 0 && live) {
          const uint32_t stage = base + st * kFwdStageBytes;
          if constexpr (kBf16) {
            chain_stage(cd, stage, wg,
                        min(kStepsBf16, plan.code_steps - s * kStepsBf16),
                        s == 0);
          } else {
            promote_stage<true>(cd, p0, p1, stage, wg,
                                min(kStepsTf32,
                                    plan.code_steps - s * kStepsTf32));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      }
      if (!live) continue;
      // the accumulators' element 4 c + e: row row_base + 8 (e >> 1),
      // column j0 + 8 c + 2 t + (e & 1)
      if constexpr (kFixup) {
        // the fix-up: this thread's entries within eps of a bound, as bits
        // of its 32 slots; then the warp's, one entry at a time
        uint32_t near = 0;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const float x = cd[u];
          const int i = row_base + 8 * ((u & 3) >> 1);
          const int j = j0 + 8 * (u >> 2) + 2 * t + (u & 1);
          if ((fabsf(x - lo) < eps || fabsf(x - hi) < eps) && i < n &&
              j < n) {
            near |= 1u << u;
          }
        }
        for (uint32_t todo = __ballot_sync(kFull, near != 0); todo != 0;
             todo = __ballot_sync(kFull, near != 0)) {
          const int src = __ffs(todo) - 1;
          const int u = __ffs(__shfl_sync(kFull, near, src)) - 1;
          const int i = row_base - g + (src >> 2) + 8 * ((u & 3) >> 1);
          const int j = j0 + 8 * (u >> 2) + 2 * (src & 3) + (u & 1);
          const float v = warp_cd_fma(code1 + static_cast<size_t>(i) * cc,
                                      code2 + static_cast<size_t>(j) * cc,
                                      cc, lane, fixup_rows);
          if (lane == src) {
            [[maybe_unused]] float x = 0.f;  // cd by 3xTF32
#pragma unroll
            for (int q = 0; q < 32; ++q) {
              if (q == u) {
                x = cd[q];
                cd[q] = v;
              }
            }
            near &= near - 1;
            if constexpr ((kFwdAblation & kFwdCountFixup) != 0) {
              atomicAdd(&g_fixups, 1ull);
              atomicMax(&g_fixup_gap, __float_as_uint(fabsf(x - v)));
            }
          }
        }
      }
      if ((kFwdAblation & kFwdNoKeep) == 0 && fd_out != nullptr) {
        // fd staged in shared memory for the TMA stores; a row's 64
        // columns as two mask words, each the OR of the 4 threads' bits
        uint32_t* mask_r = mask_out + static_cast<size_t>(r) * n * words;
        const uint32_t out = out_tiles + wg * kOutTileBytes;
        // the tile's last stores have read the staging tile
        if (tid % kWarpgroup == 0) {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWarpgroup)
                     : "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = row_base + 8 * h;
          uint32_t bits[2] = {0u, 0u};
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = 8 * c + 2 * t;  // the pair's first column
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const float x = cd[4 * c + 2 * h + v];
              if (j0 + col + v < n && x >= lo && x <= hi) {
                bits[c / 4] |= 1u << ((col + v) % 32);
              }
            }
            // two 128-byte swizzled boxes of 32 columns: row rr's 16-byte
            // chunk q sits at chunk q ^ (rr % 8)
            const int rr = 16 * warp + g + 8 * h;
            const uint32_t at = out + (c / 4) * (kOutTileBytes / 2) +
                                rr * 128 +
                                ((((col % 32) / 4) ^ (rr % 8)) * 16) +
                                (col % 4) * 4;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at),
                         "f"(fd[4 * c + 2 * h]), "f"(fd[4 * c + 2 * h + 1])
                         : "memory");
          }
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            bits[w] |= __shfl_xor_sync(kFull, bits[w], 1);
            bits[w] |= __shfl_xor_sync(kFull, bits[w], 2);
          }
          if (t < 2 && i < n && j0 + 32 * t < n) {
            __stcs(mask_r + static_cast<size_t>(i) * words + j0 / 32 + t,
                   t == 0 ? bits[0] : bits[1]);
          }
        }
        // the staged tile, seen by the TMA's reads; the box clips rows and
        // columns past n
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWarpgroup)
                     : "memory");
        if (tid % kWarpgroup == 0) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (j0 + 32 * b >= n) break;  // the box lies past the columns
            asm volatile(
                "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
                " [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                    reinterpret_cast<uint64_t>(&tfd)),
                "r"(out + b * (kOutTileBytes / 2)), "r"(j0 + 32 * b),
                "r"(i0 + kTile * wg), "r"(r)
                : "memory");
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        if (j0 + 8 * (u >> 2) + 2 * t + (u & 1) < n) {
          const float c = cd[u];
          const float cdc = fminf(fmaxf(c, lo), hi);
          const int h = (u & 3) >> 1;
          sums[0][h] = fmaf(cdc, fd[u], sums[0][h]);
          sums[1][h] += cdc;
          sums[2][h] += fd[u];
          sums[3][h] += c;
        }
      }
    }
    if (!live) continue;
    // each row's sums over the 4 threads of its fragment group
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row_base + 8 * h;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = group_sum(sums[q][h]);
        if (t == 0 && i < n) acc_r[q * n + i] = v;
      }
    }
  }
  if (tid % kWarpgroup == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The forward's copies of its inputs as the tensor maps read them, rows of
// c channels into rows of cp (zeros past c): kSplitF32 the TF32 high and
// low parts of f32 values (tf32x3.cuh's split), kRoundBf16 f32 rounded to
// bf16 (code_bf16), kPadBf16 bf16 copied (rows not a multiple of 16 bytes).
enum PrepMode : int { kSplitF32 = 0, kRoundBf16 = 1, kPadBf16 = 2 };

template <int kMode>
__global__ void corr_stream_fwd_prep_kernel(const void* __restrict__ src,
                                            void* __restrict__ hi,
                                            float* __restrict__ lo,
                                            long long rows, int c, int cp) {
  const long long total = rows * cp;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = idx / cp;
    const int k = static_cast<int>(idx - row * cp);
    const long long from = row * c + k;
    if constexpr (kMode == kPadBf16) {
      static_cast<__nv_bfloat16*>(hi)[idx] =
          k < c ? static_cast<const __nv_bfloat16*>(src)[from]
                : __float2bfloat16_rn(0.f);
    } else {
      const float x = k < c ? static_cast<const float*>(src)[from] : 0.f;
      if constexpr (kMode == kSplitF32) {
        uint32_t h, l;
        tf32x3::split(x, h, l);
        static_cast<float*>(hi)[idx] = __uint_as_float(h);
        lo[idx] = __uint_as_float(l);
      } else {
        static_cast<__nv_bfloat16*>(hi)[idx] = __float2bfloat16_rn(x);
      }
    }
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

// A 3-d tensor map (d0, d1, d2) of elem_bytes-byte elements whose rows (dim
// 0) are ``pitch`` elements apart and slices (dim 2) d1 rows, with boxes of
// (b0, b1, 1) and zeros out of bounds, swizzled as ``swizzle`` says; false
// when cuTensorMapEncodeTiled refuses it.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* base, int d0, int d1, int d2, int pitch, int b0,
              int b1,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
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
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The copy kernel of one input (corr_stream_fwd_prep_kernel): rows rows of
// c channels into rows of cp.
template <int kMode>
cudaError_t prep(const void* src, void* hi, void* lo, long long rows, int c,
                 int cp, int sms, cudaStream_t stream) {
  const long long total = rows * cp;
  const int blocks = static_cast<int>(
      std::min<long long>((total + 255) / 256, 8LL * sms));
  corr_stream_fwd_prep_kernel<kMode><<<blocks, 256, 0, stream>>>(
      src, hi, static_cast<float*>(lo), rows, c, cp);
  return cudaGetLastError();
}

// The forward's launch: the copies its tensor maps read (the f32 operands'
// TF32 parts into hi and lo, code_bf16's bf16 code into code_hi, bf16
// features whose rows are not a multiple of 16 bytes padded into feat_hi),
// the tensor maps, then the kernel on min(items, SMs) persistent blocks.
template <bool kBf16, bool kFeatF32>
int launch_fwd(const void* feats, const void* code, const void* idx1,
               const void* idx2, void* acc, void* fd, void* mask,
               void* feat_hi, void* feat_lo, void* code_hi, void* code_lo,
               int rows, int maps, int n, int cf, int cc, float lo, float hi,
               int device, cudaStream_t stream) {
  const auto kernel = corr_stream_fwd_kernel<kBf16, kFeatF32>;
  cudaError_t err = prepare(kernel, device, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdPlan plan = fwd_plan<kBf16, kFeatF32>(cf, cc);
  const long long map_rows = static_cast<long long>(maps) * n;
  const void* f_hi = feats;
  const void* f_lo = feats;
  if (kFeatF32) {
    if (feat_hi == nullptr || feat_lo == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = prep<kSplitF32>(feats, feat_hi, feat_lo, map_rows, cf,
                          plan.feat_dim, sms, stream);
    f_hi = feat_hi;
    f_lo = feat_lo;
  } else if (plan.feat_dim != cf) {
    if (feat_hi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = prep<kPadBf16>(feats, feat_hi, nullptr, map_rows, cf,
                         plan.feat_dim, sms, stream);
    f_hi = f_lo = feat_hi;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (code_hi == nullptr || (!kBf16 && code_lo == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = kBf16 ? prep<kRoundBf16>(code, code_hi, nullptr, map_rows, cc,
                                 plan.code_dim, sms, stream)
              : prep<kSplitF32>(code, code_hi, code_lo, map_rows, cc,
                                plan.code_dim, sms, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* c_lo = kBf16 ? code_hi : code_lo;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // a box row is one 128-byte panel: 32 f32 or 64 bf16 channels
  const int fe = kFeatF32 ? 4 : 2;
  const int ce = kBf16 ? 2 : 4;
  CUtensorMap tf_hi, tf_lo, tc_hi, tc_lo;
  if (!make_map(&tf_hi, kFeatF32 ? f32 : bf16, fe, f_hi, plan.feat_dim, n,
                maps, plan.feat_dim, kPanelBytes / fe, kTile, sw) ||
      !make_map(&tf_lo, kFeatF32 ? f32 : bf16, fe, f_lo, plan.feat_dim, n,
                maps, plan.feat_dim, kPanelBytes / fe, kTile, sw) ||
      !make_map(&tc_hi, kBf16 ? bf16 : f32, ce, code_hi, plan.code_dim, n,
                maps, plan.code_dim, kPanelBytes / ce, kTile, sw) ||
      !make_map(&tc_lo, kBf16 ? bf16 : f32, ce, c_lo, plan.code_dim, n, maps,
                plan.code_dim, kPanelBytes / ce, kTile, sw)) {
    return kTensorMapError;
  }
  CUtensorMap tfd = tf_hi;  // read only with fd
  if (fd != nullptr &&
      !make_map(&tfd, f32, 4, fd, n, n, rows, fd_pitch(n), kTile / 2, kTile,
                sw)) {
    return kTensorMapError;
  }
  const long long items =
      static_cast<long long>((n + kBlockRows - 1) / kBlockRows) * rows;
  const int grid = static_cast<int>(std::min<long long>(items, sms));
  kernel<<<grid, kFwdThreads, kFwdSmem, stream>>>(
      tf_hi, tf_lo, tc_hi, tc_lo, tfd, static_cast<const float*>(code),
      static_cast<const int*>(idx1), static_cast<const int*>(idx2),
      static_cast<float*>(acc), static_cast<float*>(fd),
      static_cast<uint32_t*>(mask), rows, maps, n, cf, cc, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, bool kFeatF32>
int fwd_occupancy(int device, int* out) {
  const auto kernel = corr_stream_fwd_kernel<kBf16, kFeatF32>;
  cudaError_t err = prepare(kernel, device, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kFwdThreads, kFwdSmem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(kFwdSmem);
  out[2] = blocks;
  out[3] = kFwdStages;
  return static_cast<int>(err);
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
// every pair row whose map indices are in range, columns below n. The
// buffers the caller prepares for the copies the tensor maps read (row
// pitches: f32 channels rounded up to 4, bf16 to 8): f32 features' TF32
// parts feat_hi and feat_lo (maps, n, cf4) f32, or bf16 features of cf not
// a multiple of 8 padded into feat_hi (maps, n, cf8) bf16 (else both may be
// null); f32 code's TF32 parts code_hi and code_lo (maps, n, cc4) f32, or
// with code_bf16 the bf16 code in code_hi (maps, n, cc8) (code_lo may then
// be null). cf <= 2048, rows and maps <= 65535, any cc. code_bf16 rounds the
// code to bf16 for cd. Returns the CUDA error code of the launches (0 on
// success), or 20001 when cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int stego_corr_stream_fwd(const void* feats, const void* code,
                                     const void* idx1, const void* idx2,
                                     void* acc, void* fd, void* mask,
                                     void* feat_hi, void* feat_lo,
                                     void* code_hi, void* code_lo, int rows,
                                     int maps, int n, int cf, int cc,
                                     int code_bf16, int feat_f32, float lo,
                                     float hi, int device, void* stream) {
  if (bad_shape(rows, maps, n, cc) || cf <= 0 || cf > kMaxFeat ||
      (fd == nullptr) != (mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         void*, void*, void*, void*, void*, void*, void*, int,
                         int, int, int, int, float, float, int, cudaStream_t);
  Launch launch;
  if (code_bf16) {
    launch = feat_f32 ? &launch_fwd<true, true> : &launch_fwd<true, false>;
  } else {
    launch = feat_f32 ? &launch_fwd<false, true> : &launch_fwd<false, false>;
  }
  return launch(feats, code, idx1, idx2, acc, fd, mask, feat_hi, feat_lo,
                code_hi, code_lo, rows, maps, n, cf, cc, lo, hi, device, st);
}

// The forward kernel's registers a thread, dynamic shared memory (bytes),
// blocks an SM by the occupancy API and ring stages, into out[0..3], for
// its f32 or bf16 code and features. Returns the CUDA error code (0 on
// success).
extern "C" int stego_corr_stream_fwd_occupancy(int code_bf16, int feat_f32,
                                               int device, int* out) {
  if (code_bf16) {
    return feat_f32 ? fwd_occupancy<true, true>(device, out)
                    : fwd_occupancy<true, false>(device, out);
  }
  return feat_f32 ? fwd_occupancy<false, true>(device, out)
                  : fwd_occupancy<false, false>(device, out);
}

// The entries the forward's fix-up recomputed since the last call, into
// *count (unsigned long long), and the largest |cd by 3xTF32 - cd by FMA|
// over them, into *gap (float); both then set to 0. A build with
// STEGO_C2_FWD_ABLATION's bit 16 records them; every other build reads 0.
// Returns the CUDA error code.
extern "C" int stego_corr_stream_fwd_fixups(int device, void* count,
                                            void* gap) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(count, g_fixups, sizeof(unsigned long long));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(gap, g_fixup_gap, sizeof(unsigned int));
  }
  const unsigned long long zero = 0;
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_fixups, &zero, sizeof(zero));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_fixup_gap, &zero, sizeof(unsigned int));
  }
  return static_cast<int>(err);
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
