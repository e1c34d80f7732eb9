// Kernel A: forward-only attention softmax(q k^T * scale) v, one head of
// d = 64 at a time, bf16 in and out, f32 logits and accumulator.
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
// scripts/bench_attn_vitb.py (:114, :150, :183). The TPU needs one kernel
// for each layout because a Pallas block is cut by lane slices; here every
// tensor comes with its own (batch, token, head) element strides, so
// token-major (B, N, H * 64), head-major (B, H, N, 64) and the packed
// (B, N, 3, H * 64) qkv are all the same kernel reading other strides.
//
// Bound: at the trunk's shapes (N = 785 .. 3137, d = 64) the work is
// 4 * N^2 * d flops a head against 4 * N * d * 2 bytes of q, k, v and out, so
// the tensor cores, not memory, set the floor; what costs time in a simple
// kernel is the softmax between the two products and waiting on loads.
//
// The TPU kernels keep a head's whole K/V in VMEM and take one softmax over
// the whole row. One head's K and V at N = 3137 are 803 KB, above the 227 KB
// of shared memory a block can have, so this kernel does not: each block
// owns 64 query rows of one (batch, head) and streams K/V through shared
// memory in 64-key tiles, with the row max, row sum and accumulator in f32
// registers. Products are mma.sync m16n8k16 bf16 with f32 accumulation; each
// of the 4 warps owns 16 query rows. The key tail (N is never a multiple of
// 64 here) is masked to -inf, query rows past N are computed on zeros and
// not stored.
//
// The form (a template parameter) keeps the rounding points of the TPU
// kernel it replaces:
//   kTwoPass (pair, pair_kv, batch_resident, kv_resident, packed and the
//     layout experiments): q is multiplied by scale in bf16, logits and the
//     row sum are f32, p = exp(s - max) is rounded to bf16 before the PV
//     product, the f32 accumulator is divided by the sum at the end. An
//     online softmax rounds p against a running max and rescales the
//     accumulator later; on peaked rows its outputs differed from the
//     one-pass form by more than the 5e-3 atol in the tail (measured on an
//     H100 at B=8, N=785 and 1601, H=6). So the first pass streams K and
//     keeps only each row's max; the second streams K and V and takes p
//     against that final max, as the TPU kernels do. The price is a second
//     q k^T product: half again as much tensor-core work.
//   kResident (_resident_kernel): the scale multiplies the f32 logits, and
//     p is the normalised softmax, rounded to bf16 before the PV product,
//     whose f32 sum is the output. The first pass keeps each row's max and
//     its sum of exp(s - max), rescaled when the max grows; the second takes
//     p = exp(s - max) / sum.
//   kFlash (_flash_kernel): the scale multiplies the f32 logits, and the
//     softmax is online over 128-key blocks, as on the TPU (TK = 128): each
//     block takes the row max over its 128 keys, p = exp(s - running max) is
//     rounded to bf16, and the sum and the accumulator are rescaled by
//     exp(old max - new max). One pass; the K/V tile is 128 keys.
//   kNoSoftmax (bench_attncore.py:84-85, do_softmax=False): p = s, the
//     logits of the bf16-scaled q, rounded to bf16, and no division. One
//     pass.
// At d = 64 the scale is 0.125, exact in bf16, so where it is applied
// changes nothing; the forms differ in p.
//
// No atomics: every output element is written by one thread, so runs are
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
// Shared-memory rows are padded from 64 to 72 bf16 (144 bytes, 36 words):
// consecutive rows start 4 banks apart, so the fragment loads below are free
// of bank conflicts and every row stays 16-byte aligned.
constexpr int kRow = kHeadDim + 8;

struct Strides {
  long long b, n, h;  // in elements; the head-dim stride is 1
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 from p[0] (low half) and p[stride] (high half).
__device__ __forceinline__ uint32_t pack_column(const __nv_bfloat16* p,
                                                int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

// Copies rows row0 .. row0 + 63 of one head (row stride sn elements) into a
// padded shared tile, with zeros for rows at or past n.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          long long sn, int row0, int n) {
  constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < kBlockK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(head + (row0 + r) * sn + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kRow + col) = val;
  }
}

// s = (q * scale) k^T for this warp's 16 rows and the 64 keys of the tile
// at k0: 8 tiles of 8 keys, keys at or past n set to -inf.
__device__ __forceinline__ void score_tile(float (&s)[8][4],
                                           const uint32_t (&qf)[4][4],
                                           const __nv_bfloat16* s_k, int g,
                                           int t, int k0, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const __nv_bfloat16* kp = s_k + (j * 8 + g) * kRow + kc * 16 + t * 2;
      mma_bf16(s[j], qf[kc], *reinterpret_cast<const uint32_t*>(kp),
               *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }
  if (k0 + kBlockK > n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + t * 2 + (e & 1) >= n) s[j][e] = -INFINITY;
      }
    }
  }
}

// Reduces over the four threads of a fragment row group.
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc += bf16(p) v over the 64 keys of the tile s_v: the p accumulators of
// key tiles 2 kc and 2 kc + 1 are the A fragment of k-step kc; B is v read
// down a column of the tile.
__device__ __forceinline__ void pv_tile(float (&acc)[8][4],
                                        const float (&p)[8][4],
                                        const __nv_bfloat16* s_v, int g,
                                        int t) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t pf[4] = {
        pack_bf16(p[2 * kc][0], p[2 * kc][1]),
        pack_bf16(p[2 * kc][2], p[2 * kc][3]),
        pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
        pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]),
    };
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* vp = s_v + (kc * 16 + t * 2) * kRow + j * 8 + g;
      mma_bf16(acc[j], pf, pack_column(vp, kRow),
               pack_column(vp + 8 * kRow, kRow));
    }
  }
}

// This thread's largest logit of row r (0: row g, 1: row g + 8) in a tile.
__device__ __forceinline__ float tile_max(const float (&s)[8][4], int r) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  return m;
}

enum Form : int { kTwoPass = 0, kResident = 1, kFlash = 2, kNoSoftmax = 3 };

template <int kForm>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int n, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale) {
  // the online form takes 128 keys a step, the others 64
  constexpr int kKeys = kForm == kFlash ? 2 * kBlockK : kBlockK;
  // q scaled in bf16 before the product, or the f32 logits after it
  constexpr bool kScaleQ = kForm == kTwoPass || kForm == kNoSoftmax;
  __shared__ __align__(16) __nv_bfloat16 s_q[kBlockQ * kRow];
  __shared__ __align__(16) __nv_bfloat16 s_k[kKeys * kRow];
  __shared__ __align__(16) __nv_bfloat16 s_v[kKeys * kRow];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;

  load_tile(s_q, qh, qs.n, q0, n);
  __syncthreads();

  // A fragments of this warp's 16 query rows, 4 k-steps of 16 dims each;
  // with kScaleQ multiplied by scale and rounded to bf16 as the TPU kernel
  // does.
  const float sc = kScaleQ ? __bfloat162float(__float2bfloat16(scale)) : 1.f;
  uint32_t qf[4][4];
  const __nv_bfloat16* qw = s_q + warp * 16 * kRow;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + (r & 1) * 8;
      const int col = kc * 16 + (r >> 1) * 8 + t * 2;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qw + row * kRow + col));
      qf[kc][r] = kScaleQ ? pack_bf16(x.x * sc, x.y * sc)
                          : pack_bf16(x.x, x.y);
    }
  }

  // logits of the 64 keys of a shared tile at key k0, masked keys -inf
  auto scores = [&](float (&s)[8][4], const __nv_bfloat16* tile, int k0) {
    score_tile(s, qf, tile, g, t, k0, n);
    if (!kScaleQ) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      }
    }
  };

  // This thread's two rows are g and g + 8 of the warp's 16: index 0 and 1
  // below, held in s[j][2r] and s[j][2r + 1].
  float s[8][4];
  float acc[8][4];  // 8 column tiles of 8 dims
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // what the accumulator is divided by at the end
  float row_div[2] = {1.f, 1.f};

  if constexpr (kForm == kNoSoftmax) {
    for (int k0 = 0; k0 < n; k0 += kBlockK) {
      __syncthreads();
      load_tile(s_k, kh, ks.n, k0, n);
      load_tile(s_v, vh, vs.n, k0, n);
      __syncthreads();
      scores(s, s_k, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (s[j][e] == -INFINITY) s[j][e] = 0.f;  // a key past n
        }
      }
      pv_tile(acc, s, s_v, g, t);
    }
  } else if constexpr (kForm == kFlash) {
    float s2[8][4];
    float run_max[2] = {-INFINITY, -INFINITY};
    float run_sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += 2 * kBlockK) {
      __syncthreads();
      load_tile(s_k, kh, ks.n, k0, n);
      load_tile(s_k + kBlockK * kRow, kh, ks.n, k0 + kBlockK, n);
      load_tile(s_v, vh, vs.n, k0, n);
      load_tile(s_v + kBlockK * kRow, vh, vs.n, k0 + kBlockK, n);
      __syncthreads();
      scores(s, s_k, k0);
      scores(s2, s_k + kBlockK * kRow, k0 + kBlockK);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's max over the block's 128 keys (key k0 is real)
        const float m_new = fmaxf(
            run_max[r], group_max(fmaxf(tile_max(s, r), tile_max(s2, r))));
        const float corr = expf(run_max[r] - m_new);
        run_max[r] = m_new;
        run_sum[r] *= corr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][2 * r] *= corr;
          acc[j][2 * r + 1] *= corr;
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[j][e] = expf(s[j][e] - m_new);
            s2[j][e] = expf(s2[j][e] - m_new);
            run_sum[r] += s[j][e];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          run_sum[r] += s2[j][2 * r] + s2[j][2 * r + 1];
        }
      }
      pv_tile(acc, s, s_v, g, t);
      pv_tile(acc, s2, s_v + kBlockK * kRow, g, t);
    }
    row_div[0] = group_sum(run_sum[0]);
    row_div[1] = group_sum(run_sum[1]);
  } else {
    // Pass 1: each row's max over all keys; kResident also the sum of
    // exp(s - max), rescaled when this thread's max grows.
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += kBlockK) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile(s_k, kh, ks.n, k0, n);
      __syncthreads();
      scores(s, s_k, k0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(row_max[r], tile_max(s, r));
        if (kForm == kResident && m_new != -INFINITY) {
          // -inf until one of this thread's keys is real
          row_sum[r] *= row_max[r] == -INFINITY ? 0.f
                                                : expf(row_max[r] - m_new);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            row_sum[r] += expf(s[j][2 * r] - m_new) +
                          expf(s[j][2 * r + 1] - m_new);
          }
        }
        row_max[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = group_max(row_max[r]);
      if (kForm == kResident) {
        row_sum[r] = group_sum(row_max[r] == -INFINITY
                                   ? 0.f
                                   : row_sum[r] * expf(row_max[r] - m));
      }
      row_max[r] = m;
    }

    // Pass 2: p = exp(s - max) (kResident: divided by the row's sum),
    // acc += bf16(p) v; kTwoPass sums p in f32 for the end.
    float p_sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += kBlockK) {
      __syncthreads();
      load_tile(s_k, kh, ks.n, k0, n);
      load_tile(s_v, vh, vs.n, k0, n);
      __syncthreads();
      scores(s, s_k, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - row_max[e >> 1]);
          if (kForm == kResident) {
            s[j][e] = __fdiv_rn(s[j][e], row_sum[e >> 1]);
          } else {
            p_sum[e >> 1] += s[j][e];
          }
        }
      }
      pv_tile(acc, s, s_v, g, t);
    }
    if (kForm == kTwoPass) {
      row_div[0] = group_sum(p_sum[0]);
      row_div[1] = group_sum(p_sum[1]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* op = o + b * os.b + row * os.n + h * os.h + t * 2;
    // no division where the divisor is 1 (kResident, kNoSoftmax)
    const bool divide = kForm == kTwoPass || kForm == kFlash;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float lo = acc[j][2 * r], hi = acc[j][2 * r + 1];
      *reinterpret_cast<uint32_t*>(op + j * 8) =
          divide ? pack_bf16(lo / row_div[r], hi / row_div[r])
                 : pack_bf16(lo, hi);
    }
  }
}

template <int kForm>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int n, int heads, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_kernel<kForm><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n,
      qs, ks, vs, os, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 with element strides (batch, token, head) per tensor and
// a contiguous head dimension of 64. Every base pointer must be 16-byte
// aligned and the q/k/v token strides multiples of 8. form: 0 two-pass, 1
// resident (normalised p), 2 flash (online over 128-key blocks), 3 no
// softmax. Returns the CUDA error code of the launch (0 on success).
extern "C" int stego_attention(const void* q, const void* k, const void* v,
                               void* o, int batch, int n, int heads,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh,
                               long long v_sb, long long v_sn, long long v_sh,
                               long long o_sb, long long o_sn, long long o_sh,
                               float scale, int form, int device,
                               void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || heads > 65535 || batch > 65535 ||
      form < kTwoPass || form > kNoSoftmax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kResident:
      err = launch<kResident>(q, k, v, o, batch, n, heads, qs, ks, vs, os,
                              scale, st);
      break;
    case kFlash:
      err = launch<kFlash>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale,
                           st);
      break;
    case kNoSoftmax:
      err = launch<kNoSoftmax>(q, k, v, o, batch, n, heads, qs, ks, vs, os,
                               scale, st);
      break;
    default:
      err = launch<kTwoPass>(q, k, v, o, batch, n, heads, qs, ks, vs, os,
                             scale, st);
  }
  return static_cast<int>(err);
}
