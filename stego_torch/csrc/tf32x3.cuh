// f32 products on the tensor cores by 3xTF32, for kernels A-f32
// (attention.cu) and C2 (corr_stream.cu).
//
// TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product of f32
// operands is off by ~2^-11 of its size: about three decimal digits, outside
// the JAX package's f32 tolerances. 3xTF32 splits each f32 operand into a
// TF32 high part, hi = rna(x), and a TF32 low part, lo = rna(x - hi) (x - hi
// is exact in f32), and takes a b = a_hi b_hi + a_hi b_lo + a_lo b_hi. The
// dropped a_lo b_lo and the rounding of lo leave ~2^-22 of each product,
// about f32's own rounding, at three times the tensor-core work of one TF32
// pass: an H100 SXM's 495 TFLOP/s of TF32 become ~165 TFLOP/s of f32,
// against 67 TFLOP/s of f32 FMA.
//
// mma3 takes one 8-deep step of mma.sync m16n8k8 (row.col, f32 += tf32 x
// tf32): the two small products first, then the large one, all into a
// zeroed accumulator, which is then added to the running f32 sum with
// round to nearest (__fadd_rn). A chain of tensor-core steps accumulating
// into the sum itself drops the low bits of every step the same way; over
// hundreds of channels that bias showed through Adam's first step in C2's
// bf16 products (PERF.md, PR 6).
//
// Fragment layouts of m16n8k8 with tf32 operands (g = lane / 4,
// t = lane % 4): A (16 x 8, row-major) a[0] = A[g][t], a[1] = A[g + 8][t],
// a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4]; B (8 x 8, k by n) b[0] =
// B[t][g], b[1] = B[t + 4][g]; C (16 x 8) c[0] = C[g][2t], c[1] =
// C[g][2t + 1], c[2] = C[g + 8][2t], c[3] = C[g + 8][2t + 1]. Where only the
// sum over k matters, the k index may be permuted in A and B alike: the
// kernels map mma column t to depth 2t and t + 4 to 2t + 1 where that makes
// a fragment one 8-byte load, or makes the accumulator of one product the A
// operand of the next with no shuffle.

#pragma once

#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (to nearest, ties away from zero), as its f32 bits:
// half a TF32 ulp added to the magnitude's bits, the low 13 bits cleared.
// For every finite x these are the bits of cvt.rna.tf32.f32, which ptxas
// builds from the same two integer operations behind a test for
// infinities and NaNs, a third of the split's instructions (A-f32 ran
// measurably slower with it on an H100); an infinite or NaN operand still
// gives a NaN product, through lo.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// c += a b, one m16n8k8 TF32 product. Not volatile: the product has no
// side effect, so the compiler may interleave the dependent products of
// one step with those of the next (in program order each would wait for
// the one before it).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b for one 8-deep step of split operands: a_lo b_hi + a_hi b_lo +
// a_hi b_hi into a zeroed accumulator, added to acc in f32.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_lo, b_hi);
  mma_tf32(part, a_hi, b_lo);
  mma_tf32(part, a_hi, b_hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
}

// The same with the B operand given as f32 values, split here.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], float b0,
                                     float b1) {
  uint32_t b_hi[2], b_lo[2];
  split(b0, b_hi[0], b_lo[0]);
  split(b1, b_hi[1], b_lo[1]);
  mma3(acc, a_hi, a_lo, b_hi, b_lo);
}

}  // namespace tf32x3
