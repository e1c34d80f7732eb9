// Kernel A: forward-only attention softmax(q k^T * scale) v, one head of
// d = 64 at a time: bf16 in and out with f32 logits and accumulator, and an
// f32 instantiation (A-f32) for an f32 trunk; and heads of d = 8, 16 and
// 32, bf16 or f32, by a kernel of its own, a warp per 16 query rows on
// mma.sync (attention_narrow_kernel below).
//
// Replaces the attention kernels of stego_tpu/ops/flash_attention.py:
// _pair_kernel (:391, pallas_call :453 in pair_attention) and
// _pair_kv_kernel (:470, :541 in pair_kv_attention), which the ViT trunk
// runs on token-major q/k/v of an even head count; _batch_resident_kernel
// (:188, :244 in batch_resident_attention), _kv_resident_kernel (:264, :324
// in kv_resident_attention) and _resident_kernel (:124, :168 in
// resident_attention), which trunk_attention (:369) runs on head-major
// q/k/v of an odd head count (ViT-T's 3); _flash_kernel (:29, :94 in
// flash_attention) and _packed_kernel (:589, :651 in packed_attention); and
// the layout experiments of scripts/bench_attncore.py (:95, :134) and
// scripts/bench_attn_vitb.py (:114, :150, :183). The JAX trunk sends f32
// q/k/v through the same kernels (stego_tpu/models/vit.py:186-239). The TPU
// needs one kernel for each layout because a Pallas block is cut by lane
// slices; here every tensor comes with its own (batch, token, head) element
// strides, so token-major (B, N, H * 64), head-major (B, H, N, 64) and the
// packed (B, N, 3, H * 64) qkv are all the same kernel reading other
// strides.
//
// Bound: at the trunk's shapes (N = 785 .. 3137, d = 64) the work is
// 4 N^2 d operations a head against 4 N d 2 bytes of q, k, v and out, so
// the tensor cores, not memory, set the floor.
//
// The bf16 kernel, designed for Hopper. A block is one producer warpgroup
// and kConsumers consumer warpgroups (2 or 3, chosen by the grid's waves:
// consumers_for), each owning 64 query rows of one (batch, head); a
// consumer whose rows all lie past N exits at once. One thread of the
// producer issues every copy through the Tensor Memory Accelerator (TMA):
// the block's q tiles once, then K (and V) tiles of 128 keys into a ring of
// kStages shared-memory stages, each with a "full" mbarrier that the copy
// completes and an "empty" one that every consumer thread arrives on when
// it is done with the stage. One tensor map an operand is built on the
// host for each launch from the (d, N, H, B) dims and the caller's
// strides, with 128-byte swizzle; rows past N load as zeros. The producer
// gives its registers to the consumers (setmaxnreg). The consumers take
// both products on wgmma: s = q k^T as m64n128k16 with q and k read from
// shared memory (K-major descriptors of the swizzled tiles), f32 logits in
// registers; then p = exp(..) rounded to bf16 in the accumulator's layout,
// which is the register layout of wgmma's A operand, and acc += p v as
// m64n64k16 with v read from shared memory through an MN-major
// (transposed) descriptor. A pass that takes p v issues tile t's q k^T
// and tile t - 1's p v together; the other consumer warpgroups' softmax
// runs meanwhile. exp is 2^x on the special-function unit (ex2.approx)
// after one FMA. The key tail is masked to -inf; query rows past N are computed
// on zeros and not stored.
//
// The form (a template parameter) keeps the rounding points of the TPU
// kernel it replaces:
//   kTwoPass (pair, pair_kv, batch_resident, kv_resident, packed and the
//     layout experiments): q is multiplied by scale in q's dtype, logits
//     and the row sum are f32, p = exp(s - max) is rounded to v's dtype
//     before the PV product, the f32 accumulator is divided by the sum at
//     the end. An online softmax rounds p against a running max and
//     rescales the accumulator later; on peaked rows its outputs differed
//     from the one-pass form by more than the 5e-3 atol in the tail
//     (measured on an H100 at B=8, N=785 and 1601, H=6). So the first pass
//     streams K and keeps only each row's max; the second streams K and V
//     and takes p against that final max, as the TPU kernels do. The price
//     is a second q k^T product: half again as much tensor-core work.
//   kResident (_resident_kernel): the scale multiplies the f32 logits, and
//     p is the normalised softmax, rounded before the PV product, whose f32
//     sum is the output. The first pass keeps each row's max and its sum of
//     exp(s - max), rescaled when the max grows; the second takes
//     p = exp(s - max) / sum (the bf16 kernel: times 1 / sum).
//   kFlash (_flash_kernel): the scale multiplies the f32 logits, and the
//     softmax is online over 128-key blocks, as on the TPU (TK = 128): each
//     block takes the row max over its 128 keys, p = exp(s - running max) is
//     rounded, and the sum and the accumulator are rescaled by
//     exp(old max - new max). One pass.
//   kNoSoftmax (bench_attncore.py:84-85, do_softmax=False): p = s, the
//     logits of the scaled q, rounded, and no division. One pass.
// At d = 64 the scale is 0.125, exact in bf16, so where it is applied
// changes nothing in bf16; the forms differ in p.
//
// The f32 kernel (A-f32) keeps the same forms; in f32 p is not rounded
// (p.astype(v.dtype) is a no-op), so the forms differ only in where the
// scale and the division fall. So the softmax forms take one pass with an
// online softmax (the two passes' sums up to f32 rounding), the scale on q
// (two-pass) or on the logits (flash, and resident: dividing each p by the
// row's sum before the product, or the product's sum after it, differs only
// by f32 rounding, so resident runs the flash form). They take both products
// on the tensor cores by 3xTF32 (tf32x3.cuh): one TF32 product keeps about
// three digits, outside the JAX package's f32 tolerance (2e-5), but the
// three products of split operands keep ~2^-22 of each product, about f32's
// own rounding. Bound: 4 N^2 d operations a head at 3xTF32's ~165 TFLOP/s on
// an H100 SXM (a third of 495 TFLOP/s of TF32). It takes the products on
// mma.sync, not wgmma, and spends instructions on splitting every K and V
// element in each warp that reads it and on adding each step's product in
// f32; those instructions and the latency of their chains, not the tensor
// cores, set its time. Its design: the A-f32 note further down. The
// no_softmax form stays on f32 FMA in depth, then key order
// (attention_f32_fma_kernel says why).
//
// No atomics: every output element is written by one thread, so runs are
// deterministic.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;          // one 128-byte swizzle row
constexpr int kBlockM = 64;                      // query rows a warpgroup
constexpr int kBlockN = 128;                     // keys a K/V tile
constexpr int kStages = 4;                       // K/V stages of the ring
constexpr int kQBytes = kBlockM * kRowBytes;     // 8 KB
constexpr int kKVBytes = kBlockN * kRowBytes;    // 16 KB
constexpr int kWarpgroup = 128;
// Registers a thread of the producer and of a consumer warpgroup holds
// after setmaxnreg: with two consumers 128 x 24 + 256 x 240 = 64512, within
// the 384 x 168 that a block of 384 threads is launched with; with three
// 128 x 24 + 384 x 160 = 64512, within 512 x 128.
constexpr int kProducerRegs = 24;
template <int kConsumers>
__host__ __device__ constexpr int consumer_regs() {
  return kConsumers == 2 ? 240 : 160;
}
// Devices whose launch set-up is remembered.
constexpr int kMaxDevices = 64;
// Reported by stego_attention when the driver refuses a tensor map.
constexpr int kTensorMapError = 20001;

enum Form : int { kTwoPass = 0, kResident = 1, kFlash = 2, kNoSoftmax = 3 };

struct Strides {
  long long b, n, h;  // in elements; the head-dim stride is 1
};

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

// The box at (dim 0, row, head, batch) of a 4-d tensor map into shared
// memory, completing on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte swizzled tile at addr
// (1024-byte aligned): leading and stride byte offsets, layout 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128) = A B^T (+ d when accumulate): A and B from shared memory,
// both K-major, by descriptor.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A B: A (64 x 16, bf16) from registers in the accumulator
// layout's pairs, B from shared memory, MN-major (transposed), by descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Reduces over the four threads of an accumulator row group.
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The wgmma accumulator of a warpgroup's 64 rows against 8-column blocks:
// element [4 j + e] of warp w, lane l is row 16 w + l / 4 + 8 (e >> 1),
// column 8 j + 2 (l % 4) + (e & 1). A thread holds two rows, r = e >> 1.

// 2^a on the special-function unit (ex2.approx, relative error ~2^-22).
// exp(x - m) is taken as 2^(x log2 e - m log2 e), one FMA and one ex2; p
// is rounded to bf16 after it. -inf gives 0.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_fast(float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(a));
  return y;
}

// This thread's largest logit of row r in a 128-key tile.
__device__ __forceinline__ float tile_max(const float (&s)[64], int r) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    m = fmaxf(m, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  }
  return m;
}

// Shared memory of a block: the consumers' q tiles, the K and V stages,
// then the mbarriers (q, full x kStages, empty x kStages), from a
// 1024-byte aligned base.
template <int kConsumers>
struct Layout {
  static constexpr int kQ = 0;
  static constexpr int kK = kConsumers * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int kForm, int kConsumers>
__global__ void __launch_bounds__((kConsumers + 1) * kWarpgroup, 1)
attention_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, Strides os, int n,
                 float scale) {
  using L = Layout<kConsumers>;
  // q scaled in bf16 before the product, or the f32 logits after it
  constexpr bool kScaleQ = kForm == kTwoPass || kForm == kNoSoftmax;
  // a first pass over K alone (the row max, and the sum for kResident)
  constexpr bool kTwoPasses = kForm == kTwoPass || kForm == kResident;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int q0 = blockIdx.x * kConsumers * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (n + kBlockN - 1) / kBlockN;
  const int loads = kTwoPasses ? 2 * tiles : tiles;
  const int wg = threadIdx.x / kWarpgroup;
  // consumers with a query row below n; the others exit at once
  const int active = min(kConsumers, (n - q0 + kBlockM - 1) / kBlockM);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, active * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // the producer: one thread issues every copy, on few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % kWarpgroup == 0) {
      mbar_expect_tx(bar_q, active * kQBytes);
      for (int c = 0; c < active; ++c) {
        tma_load(base + L::kQ + c * kQBytes, &tq, bar_q, q0 + c * kBlockM, h,
                 b);
      }
      for (int i = 0; i < loads; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const bool with_v = !kTwoPasses || i >= tiles;
        const int k0 = (i >= tiles ? i - tiles : i) * kBlockN;
        mbar_expect_tx(bar_full + 8 * st, with_v ? 2 * kKVBytes : kKVBytes);
        tma_load(base + L::kK + st * kKVBytes, &tk, bar_full + 8 * st, k0, h,
                 b);
        if (with_v) {
          tma_load(base + L::kV + st * kKVBytes, &tv, bar_full + 8 * st, k0,
                   h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64 wg .., on the registers the
  // producer gave up
  if (wg >= active) return;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(consumer_regs<kConsumers>()));
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint8_t* my_q = smem + L::kQ + wg * kQBytes;
  mbar_wait(bar_q, 0);
  if (kScaleQ) {
    // q * scale, rounded to bf16, as the TPU kernel does
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);
    for (int i = tid; i < kQBytes / 16; i += kWarpgroup) {
      uint4 v = reinterpret_cast<uint4*>(my_q)[i];
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __bfloat1622float2(p[u]);
        const float2 y = __bfloat1622float2(sc2);
        p[u] = __floats2bfloat162_rn(x.x * y.x, x.y * y.y);
      }
      reinterpret_cast<uint4*>(my_q)[i] = v;
    }
    // the generic-proxy writes, seen by wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "r"(kWarpgroup)
                 : "memory");
  }
  const uint64_t dq = smem_desc(base + L::kQ + wg * kQBytes, 16, 1024);

  float s[64];     // logits, then p, of a tile: 64 rows x 128 keys
  uint32_t p[32];  // bf16 p of the tile whose p v product is in flight, in
                   // wgmma's A-operand layout
  float acc[32];   // the output's 64 rows x 64 dims
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  auto full_wait = [&](int i) {
    mbar_wait(bar_full + 8 * (i % kStages), (i / kStages) & 1);
  };
  auto release = [&](int i) { mbar_arrive(bar_empty + 8 * (i % kStages)); };
  // issues s = q k^T over the K tile of load i
  auto issue_s = [&](int i) {
    const uint64_t dk = smem_desc(base + L::kK + (i % kStages) * kKVBytes,
                                  16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      // a 16-channel step is 32 bytes along the swizzled row
      wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    }
    wgmma_commit();
  };
  // issues acc += p v over the V tile of load i. The caller fences acc and
  // p before the first wgmma it issues with this one: a register defined
  // between two wgmma of one stage makes ptxas serialise them.
  auto issue_pv = [&](int i) {
    const uint64_t dv = smem_desc(base + L::kV + (i % kStages) * kKVBytes,
                                  8192, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // 16 keys are two 8-row groups, 2048 bytes
      wgmma_rs_n64(acc, p + 4 * kk, dv + 128 * kk);
    }
    wgmma_commit();
  };
  // the logits of tile kt in s: the scale unless q carries it, keys at or
  // past n set to -inf
  auto finish_s = [&](int kt) {
    const int k0 = kt * kBlockN;
#pragma unroll
    for (int u = 0; u < 64; ++u) {
      if (!kScaleQ) s[u] *= scale;
    }
    if (k0 + kBlockN > n) {
#pragma unroll
      for (int u = 0; u < 64; ++u) {
        if (k0 + (u >> 2) * 8 + 2 * t + (u & 1) >= n) s[u] = -INFINITY;
      }
    }
  };
  auto pack = [&](uint32_t (&dst)[32]) {
#pragma unroll
    for (int u = 0; u < 32; ++u) dst[u] = pack_bf16(s[2 * u], s[2 * u + 1]);
  };
  // Loads first .. first + tiles - 1, one pass with p v products: soft(kt)
  // turns tile kt's logits in s into p (f32, in s), and rescale(kt) may
  // then touch acc. The q k^T of tile kt and the p v product of tile
  // kt - 1 are issued together and waited for together: working out tile
  // kt's softmax while the p v product still ran made ptxas serialise the
  // wgmma (its warning C7513), and the kernel slower.
  auto stream_pv = [&](int first, auto&& soft, auto&& rescale) {
    full_wait(first);
    issue_s(first);
    wgmma_wait<0>();
    fence_regs(s);
    finish_s(0);
    soft(0);
    pack(p);
    rescale(0);
    for (int kt = 1; kt < tiles; ++kt) {
      const int i = first + kt;
      full_wait(i);
      fence_regs(acc);
      fence_regs(p);
      issue_s(i);
      issue_pv(i - 1);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p);
      release(i - 1);
      finish_s(kt);
      soft(kt);
      pack(p);
      rescale(kt);
    }
    fence_regs(acc);
    fence_regs(p);
    issue_pv(first + tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    release(first + tiles - 1);
  };
  auto no_rescale = [](int) {};

  // what the accumulator is divided by at the end
  float row_div[2] = {1.f, 1.f};

  if constexpr (kForm == kNoSoftmax) {
    stream_pv(0, [&](int kt) {
      if ((kt + 1) * kBlockN > n) {
#pragma unroll
        for (int u = 0; u < 64; ++u) {
          if (s[u] == -INFINITY) s[u] = 0.f;  // a key past n
        }
      }
    }, no_rescale);
  } else if constexpr (kForm == kFlash) {
    float run_max[2] = {-INFINITY, -INFINITY};
    float run_sum[2] = {0.f, 0.f};
    float corr[2];
    stream_pv(0, [&](int) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's max over the block's 128 keys (key k0 is real)
        const float m_new = fmaxf(run_max[r], group_max(tile_max(s, r)));
        corr[r] = exp2_fast((run_max[r] - m_new) * kLog2e);
        run_max[r] = m_new;
        run_sum[r] *= corr[r];
        const float mlog = m_new * kLog2e;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[4 * j + e] = exp2_fast(fmaf(s[4 * j + e], kLog2e, -mlog));
            run_sum[r] += s[4 * j + e];
          }
        }
      }
    }, [&](int) {
#pragma unroll
      for (int u = 0; u < 32; ++u) acc[u] *= corr[(u >> 1) & 1];
    });
    row_div[0] = group_sum(run_sum[0]);
    row_div[1] = group_sum(run_sum[1]);
  } else {
    // Pass 1: each row's max over all keys; kResident also the sum of
    // exp(s - max), rescaled when this thread's max grows.
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    for (int kt = 0; kt < tiles; ++kt) {
      full_wait(kt);
      issue_s(kt);
      wgmma_wait<0>();
      fence_regs(s);
      release(kt);
      finish_s(kt);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(row_max[r], tile_max(s, r));
        if (kForm == kResident && m_new != -INFINITY) {
          // -inf until one of this thread's keys is real
          row_sum[r] *= exp2_fast((row_max[r] - m_new) * kLog2e);
          const float mlog = m_new * kLog2e;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            row_sum[r] += exp2_fast(fmaf(s[4 * j + 2 * r], kLog2e, -mlog)) +
                          exp2_fast(fmaf(s[4 * j + 2 * r + 1], kLog2e, -mlog));
          }
        }
        row_max[r] = m_new;
      }
    }
    float mlog[2], inv_sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = group_max(row_max[r]);
      if (kForm == kResident) {
        row_sum[r] =
            group_sum(row_sum[r] * exp2_fast((row_max[r] - m) * kLog2e));
        inv_sum[r] = __frcp_rn(row_sum[r]);
      }
      mlog[r] = m * kLog2e;
    }

    // Pass 2: p = exp(s - max) (kResident: times 1 / the row's sum),
    // acc += bf16(p) v; kTwoPass sums p in f32 for the end.
    float p_sum[2] = {0.f, 0.f};
    stream_pv(tiles, [&](int) {
#pragma unroll
      for (int u = 0; u < 64; ++u) {
        const int r = (u >> 1) & 1;
        s[u] = exp2_fast(fmaf(s[u], kLog2e, -mlog[r]));
        if (kForm == kResident) {
          s[u] *= inv_sum[r];
        } else {
          p_sum[r] += s[u];
        }
      }
    }, no_rescale);
    if (kForm == kTwoPass) {
      row_div[0] = group_sum(p_sum[0]);
      row_div[1] = group_sum(p_sum[1]);
    }
  }

  // no division where the divisor is 1 (kResident, kNoSoftmax)
  constexpr bool kDivide = kForm == kTwoPass || kForm == kFlash;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * kBlockM + warp * 16 + g + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* op = o + b * os.b + row * os.n + h * os.h + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float lo = acc[4 * j + 2 * r], hi = acc[4 * j + 2 * r + 1];
      *reinterpret_cast<uint32_t*>(op + j * 8) =
          kDivide ? pack_bf16(lo / row_div[r], hi / row_div[r])
                  : pack_bf16(lo, hi);
    }
  }
}

// A-f32: one block a (64 query rows, head, image), 4 warps of 16 rows, both
// products by 3xTF32 on mma.sync m16n8k8 (tf32x3.cuh). K and V come in tiles
// of kF32Keys keys through a two-stage cp.async ring, so that tile t + 1
// loads while tile t is used. Each warp keeps its q fragment in registers
// (scaled where the form scales q, split at each use), takes s = q k^T for a
// tile (8 depth steps), the softmax in registers (each row's max and sum
// over the 4 threads that hold it, by shuffles), and acc += p v (8 key
// steps), p split after its exp. The depth index of both products is
// permuted (mma column t is depth 2t, t + 4 is 2t + 1): a K fragment is then
// one 8-byte load, and the accumulator of s, which holds keys 2t and 2t + 1
// of rows g and g + 8, is already p's A fragment. Row pitches of 72 (K) and
// 68 (V) floats make both fragment loads free of bank conflicts.
constexpr int kF32Rows = 64;        // query rows a block
constexpr int kF32Threads = 128;    // 4 warps, 16 rows each
constexpr int kF32Keys = 64;        // keys a K/V tile
constexpr int kKPitch = kHeadDim + 8;
constexpr int kVPitch = kHeadDim + 4;
constexpr int kF32Stage = kF32Keys * (kKPitch + kVPitch);   // floats a stage
constexpr int kF32Smem = 2 * kF32Stage * 4;                 // 70 KB

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Keys k0 .. k0 + kF32Keys - 1 of one head (row stride sn elements) into a
// shared tile of the given row pitch by cp.async, 16 bytes a copy; rows at
// or past n are zeros.
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch,
                                              const float* head, long long sn,
                                              int k0, int n) {
  constexpr int kChunks = kHeadDim / 4;  // 16-byte copies a row
  for (int c = threadIdx.x; c < kF32Keys * kChunks; c += kF32Threads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool valid = k0 + r < n;
    cp_async16(dst + r * pitch + col, head + (valid ? (k0 + r) * sn : 0) + col,
               valid);
  }
}

// Streams the K and V tiles of keys 0 .. n - 1 through the ring, calling
// body(k0, k tile, v tile) on each once every warp can read it; every warp
// is done with a stage before it is refilled.
template <typename Body>
__device__ __forceinline__ void stream_f32(float* smem, const float* kh,
                                           long long ksn, const float* vh,
                                           long long vsn, int n, Body&& body) {
  const int tiles = (n + kF32Keys - 1) / kF32Keys;
  auto issue = [&](int i) {
    float* st = smem + (i & 1) * kF32Stage;
    load_tile_f32(st, kKPitch, kh, ksn, i * kF32Keys, n);
    load_tile_f32(st + kF32Keys * kKPitch, kVPitch, vh, vsn, i * kF32Keys,
                  n);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(0);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      issue(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* st = smem + (i & 1) * kF32Stage;
    body(i * kF32Keys, st, st + kF32Keys * kKPitch);
    __syncthreads();
  }
}

// Blocks an SM. On an H100 (B=8, N=785), three (168 registers a thread)
// ran faster than two (255 registers), and 4 warps a block faster than 2
// or 8; q split at each use ran as fast as q held split.
constexpr int kF32MinBlocks = 3;

// exp(x - m) as 2^((x - m) log2 e) on the special-function unit
// (ex2.approx, relative error ~2^-22): the difference first, so that the
// product's rounding scales with it (p near 1 is where the sums' weight
// is); -inf gives 0.
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2_fast((x - m) * kLog2e);
}

template <int kForm>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int n, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale) {
  constexpr bool kScaleQ = kForm == kTwoPass;
  extern __shared__ __align__(16) float smem_f32[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kF32Rows + warp * 16;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;

  // q's A fragments of the 8 depth steps: rows g and g + 8 (zeros past n),
  // depths 8 st + 2t and 8 st + 2t + 1; q * scale in f32 where the form
  // scales q. Kept in f32 and split at each use (32 registers fewer than
  // the split fragments).
  float qf[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool live = row < n;
    const float* qp = q + b * qs.b +
                      static_cast<long long>(live ? row : 0) * qs.n +
                      h * qs.h + 2 * t;
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      float2 x = live ? *reinterpret_cast<const float2*>(qp + 8 * st)
                      : make_float2(0.f, 0.f);
      if (kScaleQ) {
        x.x *= scale;
        x.y *= scale;
      }
      qf[st][r] = x.x;
      qf[st][2 + r] = x.y;
    }
  }

  // s[nt][e]: the logit of row g + 8 (e >> 1) and key k0 + 8 nt + 2t +
  // (e & 1), the scale after the product unless q has it; keys past n
  // -inf
  float s[8][4];
  auto logits = [&](int k0, const float* sk) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      uint32_t q_hi[4], q_lo[4];
      tf32x3::split(qf[st], q_hi, q_lo);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 kk = *reinterpret_cast<const float2*>(
            sk + (nt * 8 + g) * kKPitch + st * 8 + 2 * t);
        tf32x3::mma3(s[nt], q_hi, q_lo, kk.x, kk.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kScaleQ) s[nt][e] *= scale;
        if (k0 + nt * 8 + 2 * t + (e & 1) >= n) {
          s[nt][e] = -INFINITY;
        }
      }
    }
  };
  // acc[nt][e]: row g + 8 (e >> 1), output column 8 nt + 2t + (e & 1)
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  // acc += p v over the tile, p = s
  auto pv = [&](const float* sv) {
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      const float a[4] = {s[st][0], s[st][2], s[st][1], s[st][3]};
      uint32_t a_hi[4], a_lo[4];
      tf32x3::split(a, a_hi, a_lo);
      const float* vp = sv + (st * 8 + 2 * t) * kVPitch + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        tf32x3::mma3(acc[nt], a_hi, a_lo, vp[nt * 8], vp[kVPitch + nt * 8]);
      }
    }
  };
  // this thread's largest logit of row r in the tile, over the row's threads
  auto row_max = [&](int r) {
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m = fmaxf(m, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    }
    return group_max(m);
  };
  static_assert(kForm == kTwoPass || kForm == kFlash,
                "resident runs as kFlash, no_softmax on attention_f32_fma_kernel");
  // one pass with an online softmax: in f32 p is not rounded, so p against a
  // running max, with the sum and acc rescaled when it grows, is the
  // two-pass form up to f32 rounding
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  stream_f32(smem_f32, kh, ks.n, vh, vs.n, n,
             [&](int k0, const float* sk, const float* sv) {
               logits(k0, sk);
#pragma unroll
               for (int r = 0; r < 2; ++r) {
                 const float m_new = fmaxf(m[r], row_max(r));
                 const float corr = exp_diff(m[r], m_new);
                 m[r] = m_new;
                 l[r] *= corr;
#pragma unroll
                 for (int nt = 0; nt < 8; ++nt) {
                   acc[nt][2 * r] *= corr;
                   acc[nt][2 * r + 1] *= corr;
#pragma unroll
                   for (int e = 2 * r; e < 2 * r + 2; ++e) {
                     s[nt][e] = exp_diff(s[nt][e], m_new);
                     l[r] += s[nt][e];
                   }
                 }
               }
               pv(sv);
             });
  const float row_div[2] = {group_sum(l[0]), group_sum(l[1])};

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* op = o + b * os.b + static_cast<long long>(row) * os.n + h * os.h +
                2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 x = make_float2(acc[nt][2 * r] / row_div[r],
                                   acc[nt][2 * r + 1] / row_div[r]);
      *reinterpret_cast<float2*>(op + nt * 8) = x;
    }
  }
}

// A-f32's no_softmax form (p = the logits of the scaled q, no division):
// one thread a query row, kFmaRows rows a block, K and V streaming through
// shared memory in tiles of kBlockN keys, both products by f32 FMA in
// depth, then key order, which agrees with the plain version within the
// gate on the tested shapes (cuBLAS promises no order). Its output is a sum of N
// unnormalised products with cancellation, so the elementwise 2e-5 gate it
// is held to measures the order of the f32 sums, not their accuracy: the
// plain f32 version itself misses that gate against an f64 evaluation at
// N = 785 (tests/test_torch_tf32x3.py), and so does any other order, 3xTF32
// included. This form is off every model path (the layout ladder runs it
// in bf16).
constexpr int kFmaRows = 128;
constexpr int kFmaSmem = 2 * kBlockN * kHeadDim * 4;

// Rows k0 .. k0 + kBlockN - 1 of one head (row stride sn elements) into a
// dense shared tile, zeros at or past n.
__device__ __forceinline__ void load_tile_fma(float* dst, const float* head,
                                              long long sn, int k0, int n) {
  constexpr int kChunks = kHeadDim / 4;  // float4 a row
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < n) {
      v = *reinterpret_cast<const float4*>(head + (k0 + r) * sn + col);
    }
    *reinterpret_cast<float4*>(dst + r * kHeadDim + col) = v;
  }
}

__global__ void __launch_bounds__(kFmaRows)
attention_f32_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int n, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale) {
  extern __shared__ __align__(16) float smem_fma[];
  float* s_k = smem_fma;
  float* s_v = smem_fma + kBlockN * kHeadDim;
  const int row = blockIdx.x * kFmaRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = row < n;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  float qr[kHeadDim];
  float acc[kHeadDim];
  const float* qp = q + b * qs.b +
                    static_cast<long long>(live ? row : 0) * qs.n + h * qs.h;
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) {
    qr[c] = live ? qp[c] * scale : 0.f;  // q * scale in f32, as q's dtype
    acc[c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile_fma(s_k, kh, ks.n, k0, n);
    load_tile_fma(s_v, vh, vs.n, k0, n);
    __syncthreads();
    const int kn = min(kBlockN, n - k0);
    for (int j = 0; j < kn; ++j) {
      const float* kr = s_k + j * kHeadDim;
      const float* vr = s_v + j * kHeadDim;
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) p = fmaf(qr[c], kr[c], p);
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
    }
  }
  if (!live) return;
  float* op = o + b * os.b + static_cast<long long>(row) * os.n + h * os.h;
#pragma unroll
  for (int c = 0; c < kHeadDim; c += 4) {
    *reinterpret_cast<float4*>(op + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
}

// A 4-d tensor map (64, n, heads, batch) of bf16 rows with the given
// element strides, boxes of box_rows rows of one head, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int n, int heads,
              int batch, Strides st, int box_rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim),
                        static_cast<cuuint64_t>(n),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.n) * 2,
                           static_cast<cuuint64_t>(st.h) * 2,
                           static_cast<cuuint64_t>(st.b) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kHeadDim),
                       static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Two or three consumers a block, whichever the grid's waves favour: the
// blocks of c consumers take ceil(blocks / SMs) waves of c x 64 rows, and a
// block of three did its rows ~10% faster than one of two on an H100 (B=32,
// N=785, H=12 and B=8, N=785, H=6: PERF.md). By that count three win at
// ViT-T's and ViT-S's N = 785 and ViT-B's train trunk, two at N = 1601.
int consumers_for(int n, int heads, int batch) {
  static int sms[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return 2;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return 2;
  }
  const long long pairs = static_cast<long long>(heads) * batch;
  auto cost = [&](int c) {
    const long long blocks = (n + c * kBlockM - 1) / (c * kBlockM) * pairs;
    return static_cast<double>((blocks + sms[device] - 1) / sms[device]) * c;
  };
  return cost(3) * 0.9 < cost(2) ? 3 : 2;
}

template <int kForm, int kConsumers>
cudaError_t launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, void* o, int batch, int n,
                        int heads, Strides os, float scale,
                        cudaStream_t stream) {
  constexpr int kSmem = Layout<kConsumers>::kAlloc;
  auto kernel = attention_kernel<kForm, kConsumers>;
  // set up once a device (a host call costs microseconds a launch)
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !ready[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    // setmaxnreg.inc waits for registers the block does not have, so a
    // build that launched with fewer than the pool above would hang
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * (kConsumers + 1) <
        kProducerRegs + kConsumers * consumer_regs<kConsumers>()) {
      return cudaErrorInvalidConfiguration;
    }
    if (device < kMaxDevices) ready[device] = true;
  }
  const int rows = kConsumers * kBlockM;
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  kernel<<<grid, (kConsumers + 1) * kWarpgroup, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, n, scale);
  return cudaGetLastError();
}

// consumers: 2 or 3 consumer warpgroups a block, or 0 to choose by the
// grid (consumers_for).
template <int kForm>
cudaError_t launch_form(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, void* o, int batch, int n,
                        int heads, Strides os, float scale, int consumers,
                        cudaStream_t stream) {
  switch (consumers ? consumers : consumers_for(n, heads, batch)) {
    case 3:
      return launch_bf16<kForm, 3>(tq, tk, tv, o, batch, n, heads, os, scale,
                                   stream);
    default:
      return launch_bf16<kForm, 2>(tq, tk, tv, o, batch, n, heads, os, scale,
                                   stream);
  }
}

// kForm's A-f32 kernel: the tensor-core one, or the FMA one for kNoSoftmax.
template <int kForm>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int n, int heads, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale,
                       cudaStream_t stream) {
  constexpr bool kFma = kForm == kNoSoftmax;
  constexpr int kRows = kFma ? kFmaRows : kF32Rows;
  constexpr int kThreads = kFma ? kFmaRows : kF32Threads;
  constexpr int kSmem = kFma ? kFmaSmem : kF32Smem;
  void (*kernel)(const float*, const float*, const float*, float*, int,
                 Strides, Strides, Strides, Strides, float);
  if constexpr (kFma) {
    kernel = attention_f32_fma_kernel;
  } else {
    kernel = attention_f32_kernel<kForm>;
  }
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !ready[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) ready[device] = true;
  }
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, qs, ks, vs, os,
      scale);
  return cudaGetLastError();
}

bool bad_args(int batch, int n, int heads, int form) {
  return batch <= 0 || n <= 0 || heads <= 0 || heads > 65535 ||
         batch > 65535 || form < kTwoPass || form > kNoSoftmax;
}

int attention_bf16(const void* q, const void* k, const void* v, void* o,
                   int batch, int n, int heads, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int form,
                   int consumers, int device, cudaStream_t st) {
  if (bad_args(batch, n, heads, form)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, n, heads, batch, qs, kBlockM) ||
      !make_map(&tk, k, n, heads, batch, ks, kBlockN) ||
      !make_map(&tv, v, n, heads, batch, vs, kBlockN)) {
    return kTensorMapError;
  }
  const int c = consumers;
  switch (form) {
    case kResident:
      err = launch_form<kResident>(tq, tk, tv, o, batch, n, heads, os, scale, c, st);
      break;
    case kFlash:
      err = launch_form<kFlash>(tq, tk, tv, o, batch, n, heads, os, scale, c, st);
      break;
    case kNoSoftmax:
      err = launch_form<kNoSoftmax>(tq, tk, tv, o, batch, n, heads, os, scale, c, st);
      break;
    default:
      err = launch_form<kTwoPass>(tq, tk, tv, o, batch, n, heads, os, scale, c, st);
  }
  return static_cast<int>(err);
}


// The kernel for narrow heads, d = 8, 16 or 32, on bf16 q/k/v and,
// instantiated on float, on f32 ones: the sensitive accuracy instrument's
// tiny ViT (width 32, 4 heads of 8, N = 65 tokens at res 64;
// stego_torch/data/synthetic.py:tiny_benchmark_setup) and an f32 trunk of
// those widths with use_flash_attention. The JAX package's Pallas kernels
// take any d, so at these widths this kernel replaces the same TPU kernels
// as the one above (stego_tpu/ops/flash_attention.py: _batch_resident_kernel
// :188, _kv_resident_kernel :264, _resident_kernel :124, _flash_kernel :29;
// the token-major and no-softmax entries reach it through their strides and
// form).
//
// Bound: at N = 65 a head is 4 N^2 d = 0.14 MFLOP (d = 32) against
// 4 N d 2 bytes of q, k, v and out, far below both of the card's rates at
// this grid's 64 blocks; what bounds the kernel is the launch and one pass
// over q, k, v and out, each a dependent trip to memory.
//
// Design. A warp owns 16 query rows of one (batch, head); a block holds
// ceil(N / 16) such warps of one (batch, head), at most kNarrowMaxWarps (a
// launch parameter, not a template: N = 65 takes 5 warps, 80 rows, and the
// grid (ceil(N / rows), H, B) is 64 blocks at B = 16, H = 4). A warp whose
// rows all lie past N takes part in the loads only, so no (batch, head)
// computes more than one warp tile past N; rows past N within it are
// computed on zeros and not stored. Each warp holds q in registers as A
// fragments for the whole call (scaled where the form scales q) and takes
// both products on mma.sync: s = q k^T and acc += p v as independent
// tensor-core steps, where the old kernel (one thread a query row) ran d
// dependent f32 FMAs a key for each product.
//   bf16: s on m16n8k16 (m16n8k8 at d = 8: no padding in depth), K
//     fragments by ldmatrix; p packed to bf16 straight from s's accumulator
//     registers (the C layout of m16n8 is the A layout of the next product)
//     and acc += p v on m16n8k16, V fragments by ldmatrix.trans.
//   f32: both products by 3xTF32 on m16n8k8 (tf32x3.cuh), the depth index
//     permuted as in A-f32, so that a K fragment is one 8-byte load and s's
//     accumulator is p's A fragment.
// K and V come in tiles of TK = 128 keys (flash's block), in the element
// type, through a two-stage cp.async ring of 16-byte copies (one stage when
// N <= 128); keys at or past N load as zeros and are masked (s = -inf; p = 0
// in no_softmax). A tile's logits for a warp's 16 rows stay in registers (16
// n-tiles of 8 keys; a thread holds 2 keys of each for rows g and g + 8), so
// the row max, the sum and the division are register passes after one
// product; n-tiles wholly past N are neither multiplied nor exponentiated.
// Where N > 128 the two-pass and resident forms take each row's max (and
// resident's sum, rescaled as the max grows) in a first sweep over the K
// tiles and the product again in a second over K and V. Row pitches keep
// ldmatrix and the f32 fragment loads free of bank conflicts (NarrowSmem).
// Not wgmma: it takes 64-row tiles and a 16-element depth, so N = 65 would be
// two 64-row tiles, nearly half of them padding, d = 8 would be padded to 16,
// and its rate buys nothing at 0.14 MFLOP a head.
//
// The forms keep the rounding points of the kernel above in either type:
//   two-pass: q * scale in q's dtype (the scale itself of that dtype, as
//     the plain version's torch.tensor(scale, dtype=q.dtype)), p = exp(s -
//     the row's final max) rounded to T, its f32 sum unrounded, the output
//     acc / sum;
//   resident: the scale on the f32 logits, p times 1 / the row's sum
//     before it is rounded, no division after;
//   flash: the scale on the f32 logits, an online softmax over blocks of
//     exactly TK = 128 keys: each block's max over the whole block before
//     any exp, p rounded against the new max, the sum and acc rescaled by
//     exp(old max - new max), the output acc / sum;
//   no_softmax: q scaled as two-pass, p = s rounded to T, no division.
// In f32 every rounding to T is the identity (p.astype(v.dtype) is a no-op).
// No atomics, and every sum in a fixed order: runs are deterministic.
constexpr int kNarrowTile = kBlockN;  // keys a K/V tile: TK, flash's block
constexpr int kNarrowMaxWarps = 8;    // warps a block, 16 query rows each

// Shared memory of the ring, in bytes: each stage K then V, kNarrowTile
// rows each at these pitches.
//   bf16: ldmatrix reads 8 rows of 16 bytes a matrix; a pitch that is an
//     odd multiple of 16 bytes puts them in 8 distinct bank groups (48 and
//     80 bytes for d = 16 and 32; d = 8's 16-byte rows are contiguous).
//   f32: a K fragment is 8 bytes at row g, word 2t (t = 0..3): a pitch of
//     8 words mod 32 keeps each half warp's 4 rows apart (d = 8: 8 words;
//     16: 24; 32: 40); a V element is at row 2t, word g: 2 x pitch = 8 or
//     24 words mod 32 keeps the 4 rows apart (d + 4 words: 12, 20, 36).
template <int kD, typename T>
struct NarrowSmem {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kRow = kD * static_cast<int>(sizeof(T));
  static constexpr int kKPitch =
      kF32 ? 4 * (kD == 8 ? 8 : kD + 8) : (kRow == 16 ? 16 : kRow + 16);
  static constexpr int kVPitch = kF32 ? 4 * (kD + 4) : kKPitch;
  static constexpr int kV = kNarrowTile * kKPitch;  // V's offset in a stage
  static constexpr int kStage = kV + kNarrowTile * kVPitch;
};

// x rounded to T and back: bf16 rounds to nearest even, f32 is exact
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* op, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* op, float a, float b) {
  *reinterpret_cast<float2*>(op) = make_float2(a, b);
}

// kCount 8 x 8 matrices of 16-bit elements from shared memory: lanes
// 8i .. 8i + 7 give the row addresses of matrix i, and r[i] holds (row g,
// columns 2t and 2t + 1) of it, or with kTrans (rows 2t and 2t + 1,
// column g).
template <int kCount, bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t (&r)[kCount], uint32_t addr) {
  static_assert((kCount == 1 && !kTrans) || kCount == 2 || kCount == 4,
                "x1 (K at d = 8), x2 or x4");
  if constexpr (kCount == 1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0]) : "r"(addr) : "memory");
  } else if constexpr (kCount == 2) {
    if constexpr (kTrans) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
    } else {
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
    }
  } else {
    if constexpr (kTrans) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
          : "memory");
    } else {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
          : "memory");
    }
  }
}

// c += a b, one bf16 product into f32 on mma.sync m16n8k16 (A 16 x 16
// row-major, B 16 x 8 column-major). Fragments (g = lane / 4, t = lane % 4;
// two bf16 a register, the lower index in the low half): a[0] = A[g][2t..],
// a[1] = A[g + 8][2t..], a[2] = A[g][2t + 8..], a[3] = A[g + 8][2t + 8..];
// b0 = B[2t..][g], b1 = B[2t + 8..][g]; c as tf32x3.cuh's C.
__device__ __forceinline__ void mma_bf16_k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same, 8 deep (m16n8k8): a0 = A[g][2t..], a1 = A[g + 8][2t..],
// b0 = B[2t..][g].
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Keys k0 .. k0 + kc - 1 of one head (row stride sn elements) into a
// shared tile of the given pitch by cp.async, 16 bytes a copy; rows kc ..
// the next multiple of 16 are zeros (the products read them; p is 0 there).
template <int kD, typename T>
__device__ __forceinline__ void load_narrow(uint8_t* dst, int pitch,
                                            const T* head, long long sn,
                                            int k0, int kc) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kChunks = kD / kPer;                       // copies a row
  const int rows = min(kNarrowTile, (kc + 15) & ~15);
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int col = c % kChunks;
    const bool valid = r < kc;
    cp_async16(dst + r * pitch + 16 * col,
               head + (valid ? static_cast<long long>(k0 + r) * sn : 0) +
                   col * kPer,
               valid);
  }
}

template <int kD, int kForm, typename T>
__global__ void __launch_bounds__(kNarrowMaxWarps * 32)
attention_narrow_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int n,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale) {
  using S = NarrowSmem<kD, T>;
  constexpr bool kF32 = S::kF32;
  // two-pass and no_softmax: q * scale in q's dtype; resident and flash:
  // the scale multiplies the f32 logits
  constexpr bool kScaleQ = kForm == kTwoPass || kForm == kNoSoftmax;
  // the forms that take p against the row's final max
  constexpr bool kFinalMax = kForm == kTwoPass || kForm == kResident;
  constexpr int kNT = kNarrowTile / 8;  // n-tiles of 8 keys a tile
  constexpr int kDT = kD / 8;           // n-tiles of 8 output columns
  extern __shared__ __align__(16) uint8_t smem_narrow[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const bool live = row0 < n;  // the warp has a query row below n
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;
  const int tiles = (n + kNarrowTile - 1) / kNarrowTile;
  // a first sweep over K alone (the row max, and resident's sum)
  const bool two_sweeps = kFinalMax && tiles > 1;
  const int loads = two_sweeps ? 2 * tiles : tiles;

  // load i: tile i (i - tiles in the second sweep), K, and V unless it is
  // the first sweep's
  auto issue = [&](int i) {
    uint8_t* st = smem_narrow + (i & 1) * S::kStage;
    const int k0 = (i < tiles ? i : i - tiles) * kNarrowTile;
    const int kc = min(kNarrowTile, n - k0);
    load_narrow<kD, T>(st, S::kKPitch, kh, ks.n, k0, kc);
    if (!two_sweeps || i >= tiles) {
      load_narrow<kD, T>(st + S::kV, S::kVPitch, vh, vs.n, k0, kc);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(0);

  // q's A fragments (zeros past n), loaded while the first tile lands.
  // bf16: qa[ks] of depth step ks (16 deep; d = 8 one step of 8 in qa[0][0]
  // and qa[0][1]). f32: qa[st] the TF32 high part and q_lo[st] the low part
  // of 8-deep step st, mma column t at depth 8 st + 2t, t + 4 at 8 st + 2t +
  // 1.
  constexpr int kQSteps = kF32 ? kDT : (kD + 15) / 16;
  uint32_t qa[kQSteps][4] = {};
  uint32_t q_lo[kF32 ? kQSteps : 1][4] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool real = row < n;
    const T* qp = q + b * qs.b + static_cast<long long>(real ? row : 0) * qs.n +
                  h * qs.h + 2 * t;
    if constexpr (kF32) {
#pragma unroll
      for (int st = 0; st < kQSteps; ++st) {
        float2 x = real ? *reinterpret_cast<const float2*>(qp + 8 * st)
                        : make_float2(0.f, 0.f);
        if (kScaleQ) {
          x.x *= scale;
          x.y *= scale;
        }
        tf32x3::split(x.x, qa[st][r], q_lo[st][r]);
        tf32x3::split(x.y, qa[st][2 + r], q_lo[st][2 + r]);
      }
    } else {
      const float sq = round_to<T>(scale);
#pragma unroll
      for (int st = 0; st < kQSteps; ++st) {
#pragma unroll
        for (int half = 0; half < (kD == 8 ? 1 : 2); ++half) {
          uint32_t x =
              real ? *reinterpret_cast<const uint32_t*>(qp + 16 * st + 8 * half)
                   : 0u;
          if (kScaleQ) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
            x = pack_bf16(f.x * sq, f.y * sq);
          }
          qa[st][2 * half + r] = x;
        }
      }
    }
  }

  // s[nt][e]: the logit of row g + 8 (e >> 1) and key 8 nt + 2t + (e & 1)
  // of the tile, then p
  float s[kNT][4];
  // acc[j][e]: row g + 8 (e >> 1), output column 8 j + 2t + (e & 1)
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // s = q k^T over the tile's live n-tiles (kc keys), the scale unless q
  // carries it, keys at or past kc -inf (no_softmax: 0)
  auto logits = [&](const uint8_t* sk, int kc) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (8 * nt >= kc) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (kF32) {
        const float* kr = reinterpret_cast<const float*>(
            sk + (8 * nt + g) * S::kKPitch) + 2 * t;
#pragma unroll
        for (int st = 0; st < kQSteps; ++st) {
          const float2 kk = *reinterpret_cast<const float2*>(kr + 8 * st);
          tf32x3::mma3(s[nt], qa[st], q_lo[st], kk.x, kk.y);
        }
      } else {
        // the tile's keys 8 nt .. 8 nt + 7, one 16-byte matrix a depth chunk
        uint32_t kb[kDT];
        ldsm<kDT, false>(kb, smem_u32(sk + (8 * nt + (lane & 7)) * S::kKPitch +
                                      16 * ((lane >> 3) % kDT)));
        if constexpr (kD == 8) {
          mma_bf16_k8(s[nt], qa[0][0], qa[0][1], kb[0]);
        } else {
#pragma unroll
          for (int st = 0; st < kQSteps; ++st) {
            mma_bf16_k16(s[nt], qa[st], kb[2 * st], kb[2 * st + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kScaleQ) s[nt][e] *= scale;
        if (8 * nt + 2 * t + (e & 1) >= kc) {
          s[nt][e] = kForm == kNoSoftmax ? 0.f : -INFINITY;
        }
      }
    }
  };
  // this thread's largest logit of row r in the tile
  auto tile_max = [&](int r) {
    float x = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      x = fmaxf(x, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    }
    return x;
  };
  // s = exp(s - mx[r]) over the live n-tiles, 0 past them; returns this
  // thread's sums of row 0 and row 1 (in sum[])
  auto exp_rows = [&](const float (&mx)[2], int kc, float (&sum)[2]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (8 * nt < kc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp_diff(s[nt][e], mx[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
    }
  };
  // acc += p v over the tile's live keys, p = s rounded to T
  auto pv = [&](const uint8_t* sv, int kc) {
    if constexpr (kF32) {
#pragma unroll
      for (int st = 0; st < kNT; ++st) {
        if (8 * st >= kc) break;
        const float a[4] = {s[st][0], s[st][2], s[st][1], s[st][3]};
        uint32_t a_hi[4], a_lo[4];
        tf32x3::split(a, a_hi, a_lo);
        const float* vp = reinterpret_cast<const float*>(
            sv + (8 * st + 2 * t) * S::kVPitch) + g;
        constexpr int kNext = S::kVPitch / 4;  // the next key's row
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          tf32x3::mma3(acc[j], a_hi, a_lo, vp[8 * j], vp[kNext + 8 * j]);
        }
      }
    } else {
      // V's matrices of a 16-key step: mi = 2 j + half is keys 8 half ..
      // 8 half + 7, columns 8 j .. 8 j + 7; 4 a load (2 at d = 8)
      constexpr int kM = 2 * kDT;
      constexpr int kPer = kM < 4 ? kM : 4;
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        if (16 * kk >= kc) break;
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t vb[kM];
#pragma unroll
        for (int grp = 0; grp < kM / kPer; ++grp) {
          const int mi = grp * kPer + (lane >> 3) % kPer;
          uint32_t part[kPer];
          ldsm<kPer, true>(part,
                           smem_u32(sv + (16 * kk + 8 * (mi & 1) + (lane & 7)) *
                                             S::kVPitch +
                                    16 * (mi >> 1)));
#pragma unroll
          for (int i = 0; i < kPer; ++i) vb[grp * kPer + i] = part[i];
        }
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          mma_bf16_k16(acc[j], a, vb[2 * j], vb[2 * j + 1]);
        }
      }
    }
  };

  // kFinalMax: each row's max (mt: this thread's, m: the row's) and
  // resident's sum of exp(s - max) (lt, rescaled as mt grows; l the row's)
  float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.f, 0.f};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto body = [&](int i, const uint8_t* st) {
    const int first = i < tiles;
    const int kc = min(kNarrowTile,
                       n - (first ? i : i - tiles) * kNarrowTile);
    logits(st, kc);
    if constexpr (kForm == kNoSoftmax) {
      pv(st + S::kV, kc);
    } else if constexpr (kForm == kFlash) {
      // the block's max over all its keys, then p against the new max
      float sum[2] = {0.f, 0.f};
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], group_max(tile_max(r)));
        const float corr = exp_diff(m[r], m_new[r]);
        m[r] = m_new[r];
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          acc[j][2 * r] *= corr;
          acc[j][2 * r + 1] *= corr;
        }
      }
      exp_rows(m_new, kc, sum);
      l[0] += sum[0];
      l[1] += sum[1];
      pv(st + S::kV, kc);
    } else if (two_sweeps && first) {
      // the first sweep: this thread's max and (resident) rescaled sum
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(mt[r], tile_max(r));
        if (kForm == kResident && m_new != -INFINITY) {
          lt[r] *= exp_diff(mt[r], m_new);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (8 * nt < kc) {
              lt[r] += exp_diff(s[nt][2 * r], m_new) +
                       exp_diff(s[nt][2 * r + 1], m_new);
            }
          }
        }
        mt[r] = m_new;
      }
      if (i == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = group_max(mt[r]);
          if (kForm == kResident) {
            l[r] = group_sum(lt[r] * exp_diff(mt[r], m[r]));
          }
        }
      }
    } else {
      if (!two_sweeps) {
        m[0] = group_max(tile_max(0));
        m[1] = group_max(tile_max(1));
      }
      float sum[2] = {0.f, 0.f};
      exp_rows(m, kc, sum);
      if constexpr (kForm == kResident) {
        if (!two_sweeps) {
          l[0] = group_sum(sum[0]);
          l[1] = group_sum(sum[1]);
        }
        // p times 1 / the row's sum: an IEEE division a p took the form
        // to 2-3x the two-pass form's time on an H100
        const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (8 * nt < kc) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
          }
        }
      } else {
        l[0] += sum[0];
        l[1] += sum[1];
      }
      pv(st + S::kV, kc);
    }
  };

  for (int i = 0; i < loads; ++i) {
    if (i + 1 < loads) {
      issue(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (live) body(i, smem_narrow + (i & 1) * S::kStage);
    __syncthreads();
  }
  if (!live) return;

  // two-pass and flash divide by the row's sum of p; resident and
  // no_softmax do not
  constexpr bool kDivide = kForm == kTwoPass || kForm == kFlash;
  float row_div[2] = {1.f, 1.f};
  if (kDivide) {
    row_div[0] = group_sum(l[0]);
    row_div[1] = group_sum(l[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    T* op = o + b * os.b + static_cast<long long>(row) * os.n + h * os.h +
            2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const float lo = acc[j][2 * r], hi = acc[j][2 * r + 1];
      if (kDivide) {
        store_pair(op + 8 * j, lo / row_div[r], hi / row_div[r]);
      } else {
        store_pair(op + 8 * j, lo, hi);
      }
    }
  }
}

template <int kD, int kForm, typename T>
cudaError_t launch_narrow_form(const void* q, const void* k, const void* v,
                               void* o, int batch, int n, int heads,
                               Strides qs, Strides ks, Strides vs,
                               Strides os, float scale, cudaStream_t stream) {
  using S = NarrowSmem<kD, T>;
  auto kernel = attention_narrow_kernel<kD, kForm, T>;
  // set up once a device: two stages of f32 at d = 32 pass 48 KB
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !ready[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * S::kStage);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) ready[device] = true;
  }
  const int warps = n < 16 * kNarrowMaxWarps ? (n + 15) / 16 : kNarrowMaxWarps;
  const int rows = 16 * warps;
  const int tiles = (n + kNarrowTile - 1) / kNarrowTile;
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  kernel<<<grid, 32 * warps, (tiles > 1 ? 2 : 1) * S::kStage, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, qs, ks, vs, os,
      scale);
  return cudaGetLastError();
}

template <int kD, typename T>
cudaError_t launch_narrow(const void* q, const void* k, const void* v,
                          void* o, int batch, int n, int heads, Strides qs,
                          Strides ks, Strides vs, Strides os, float scale,
                          int form, cudaStream_t stream) {
  switch (form) {
    case kResident:
      return launch_narrow_form<kD, kResident, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, stream);
    case kFlash:
      return launch_narrow_form<kD, kFlash, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, stream);
    case kNoSoftmax:
      return launch_narrow_form<kD, kNoSoftmax, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, stream);
    default:
      return launch_narrow_form<kD, kTwoPass, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, stream);
  }
}

template <typename T>
int attention_narrow(const void* q, const void* k, const void* v, void* o,
                     int batch, int n, int heads, int head_dim, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale,
                     int form, int device, void* stream) {
  if (bad_args(batch, n, heads, form)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 8:
      err = launch_narrow<8, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, form, st);
      break;
    case 16:
      err = launch_narrow<16, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, form, st);
      break;
    case 32:
      err = launch_narrow<32, T>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, form, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, o: bf16 with element strides (batch, token, head) per tensor and
// a contiguous head dimension of 64. Every base pointer must be 16-byte
// aligned and the strides multiples of 8 (the tensor maps' 16 bytes). form:
// 0 two-pass, 1 resident (normalised p), 2 flash (online over 128-key
// blocks), 3 no softmax. Returns the CUDA error code of the launch (0 on
// success), or 20001 when the driver refuses a tensor map.
extern "C" int stego_attention(const void* q, const void* k, const void* v,
                               void* o, int batch, int n, int heads,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh,
                               long long v_sb, long long v_sn, long long v_sh,
                               long long o_sb, long long o_sn, long long o_sh,
                               float scale, int form, int device,
                               void* stream) {
  return attention_bf16(q, k, v, o, batch, n, heads, Strides{q_sb, q_sn, q_sh},
                        Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
                        Strides{o_sb, o_sn, o_sh}, scale, form, 0, device,
                        static_cast<cudaStream_t>(stream));
}

// stego_attention with the consumer warpgroups a block (64 query rows
// each) given: 2 or 3, or 0 to choose by the grid as stego_attention does.
// The outputs do not depend on it. For timing the choice
// (stego_torch/tools/attention_consumers.py).
extern "C" int stego_attention_consumers(
    const void* q, const void* k, const void* v, void* o, int batch, int n,
    int heads, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    float scale, int form, int consumers, int device, void* stream) {
  if (consumers != 0 && consumers != 2 && consumers != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return attention_bf16(q, k, v, o, batch, n, heads, Strides{q_sb, q_sn, q_sh},
                        Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
                        Strides{o_sb, o_sn, o_sh}, scale, form, consumers,
                        device, static_cast<cudaStream_t>(stream));
}

// The same on f32 q, k, v and o (A-f32): the same strides and forms.
extern "C" int stego_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n,
    int heads, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    float scale, int form, int device, void* stream) {
  if (bad_args(batch, n, heads, form)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kResident:  // in f32 the flash form's arithmetic (the header says why)
    case kFlash:
      err = launch_f32<kFlash>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, st);
      break;
    case kNoSoftmax:
      err = launch_f32<kNoSoftmax>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, st);
      break;
    default:
      err = launch_f32<kTwoPass>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, st);
  }
  return static_cast<int>(err);
}

// The narrow-head kernel (attention_narrow_kernel) on bf16 q, k, v and o:
// head_dim 8, 16 or 32, the same strides (multiples of 8 elements, 16-byte
// aligned bases) and forms as stego_attention. Returns the CUDA error code
// of the launch.
extern "C" int stego_attention_narrow(
    const void* q, const void* k, const void* v, void* o, int batch, int n,
    int heads, int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float scale, int form, int device, void* stream) {
  return attention_narrow<__nv_bfloat16>(
      q, k, v, o, batch, n, heads, head_dim, Strides{q_sb, q_sn, q_sh},
      Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
      Strides{o_sb, o_sn, o_sh}, scale, form, device, stream);
}

// The same on f32 q, k, v and o: its float instantiation.
extern "C" int stego_attention_narrow_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n,
    int heads, int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float scale, int form, int device, void* stream) {
  return attention_narrow<float>(
      q, k, v, o, batch, n, heads, head_dim, Strides{q_sb, q_sn, q_sh},
      Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
      Strides{o_sb, o_sn, o_sh}, scale, form, device, stream);
}
