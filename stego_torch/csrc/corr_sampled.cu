// Kernel C1: the sampled contrastive-correlation loss with the bilinear
// sampling on the card, as gather -> C2 -> adjoint: the gather kernel
// (stego_corr_sampled_gather) samples every distinct set of samples once,
// kernel C2's forward and backward (csrc/corr_stream.cu) take the products and
// their gradient, and the adjoint kernel (stego_corr_sampled_adjoint) carries
// that gradient back through the normalisation and the taps to the code maps.
//
// Replaces stego_tpu/ops/pallas_corr_fused_sampling.py:sampled_corr_fused
// (:389): its forward _sfwd_kernel (:93, pallas_call :171 in _run_sfwd), its
// backward _sbwd_kernel (:187, pallas_call :296 in _run_sbwd) and the one-hot
// fold of the negatives' gradients (:365-374). The train step calls the
// forward and the backward once each (ops/corr_fused_sampling.py).
//
// What it computes. A slot (pair type g, image b) is pair row g * B + b,
// group-major, one group per pair type. Its side 1 is image b's feature and
// code maps sampled at coords1[b]; its side 2 is the same for g = 0, the KNN
// positive's maps (feats_pos[b], code_pos[b]) at coords2[b] for g = 1, and
// image perm_k(b)'s maps at coords2[b] for g = 2 + k. So there are G * B
// distinct sets of S samples (G = 2 + neg): set b is side 1, set B + b the
// positive, set (2 + k) B + b a negative, and row g * B + b pairs set b with
// set b (g = 0) or with set g * B + b. Sampling is bilinear with border
// clamping and align_corners=True, as four taps
// (stego_tpu/ops/sampling.py:33-59), at the points of the reference's
// transposed grid (src/modules.py:287). Per sample the features and the code
// are l2-normalised (eps 1e-10), and fd = f1n f2n^T, cd = c1n c2n^T (S x S);
// the loss is C2's closed form in the row sums of clamp(cd) fd, clamp(cd), fd
// and cd.
//
// Rounding points of _sfwd_kernel (:101-135), kept by the gather. bf16
// features (a bf16 trunk): tap weights rounded to bf16, the four products
// added by f32 FMA in tap order, the sample rounded to bf16, l2-normalised in
// f32 and stored as bf16. f32 features (an f32 trunk): f32 throughout. Code:
// f32 throughout. Each norm is the warp's sum of squares (each lane's channels
// by FMA, then a butterfly over the lanes).
//
// Why the products go through C2. Once sampled, C1's products are C2's at N =
// S: 112 pair rows of 121 samples, 384 feature and 70 code channels at the
// train step's shape, the grid-sampled C2 shape. C2's Hopper forward and
// backward take them on the tensor cores (fd by bf16 wgmma, or 3xTF32 on f32
// features; cd by 3xTF32 with every cd near a clamp bound recomputed by f32
// FMA in channel order, so that each clamp mask is that FMA's), and its
// backward reads the fd and mask the forward keeps, in a fixed order, without
// atomics. The forward C1 had before (one block a slot, fd and cd by f32 FMA
// on 8 x 8 register tiles, side 1 sampled again in each of its image's blocks,
// 112 blocks on 132 SMs) took 0.2553 ms there on an H100 SXM at 700 W, and its
// backward 0.1015 (PERF.md). C2's forward needs code rows of norm at most 1
// for its fix-up's margin: the gather's rows are z / max(|z|, 1e-10), of norm
// 1 to within a few roundings, or 0 below eps.
//
// Gather: one warp a sample, lanes over groups of 4 channels (an 8- or 16-byte
// load a tap and group, where the widths allow), 8 samples a block: 1694
// blocks at the train step's shape (13,552 samples), more than a wave of 8
// blocks an SM. It reads each of the sample's four tap rows of the feature and
// code maps once (56.8 MB at the train step's shape, bf16 at 384 channels:
// hits in L2, which holds the 19 MB of maps) and writes the sets (10.4 MB of
// features and 3.8 MB of code), the raw code norms (the normalisation's
// Jacobian needs them) and each tap's code-map row and weight. Bound by bytes:
// ~0.012 ms at HBM rate for the maps read once (26 MB) and what it must write
// (15 MB). A sample's values wait in the warp's slice of shared memory between
// the sum of squares and the divide, so the taps are read once (any width:
// max(cf, cc) floats a warp). It reads the coordinates in place, in the
// reference's transposed order. Its first warp also writes the pair rows'
// layout that C2's forward and backward read (map indices, groups, and each
// map's entries in the order C2's wrapper would sort them), so no sort or copy
// runs for them. A slot whose permutation entry is out of range reads nothing:
// its set is written as zeros, its pair row's side-2 index is -1, so C2 gives
// it NaN row sums and no gradient, and its taps carry no code-map row.
//
// Adjoint: C2's backward gives dL/d(normalised code) of every set. A Jacobian
// kernel (one warp a sample) takes each sample's gradient once through the
// l2-normalise Jacobian (_norm_jac, :69-76: (g - [n > eps] vn (vn . g)) /
// max(n, eps)); the adjoint kernel then carries it through the sample's four
// taps into the code maps: set b into code[b], set B + b into code_pos[b], set
// (2 + k) B + b into code[perm_k(b)]. The TPU kernel folds the negatives with
// a one-hot matmul because scatters serialise there; C1 before added with f32
// atomics, so the gradient's last bits followed the order of the adds. Here
// the adjoint pulls: a warp owns 8 consecutive rows of one code map, walks the
// sets that land on that map (its own set, and for code[b] the negatives whose
// permutation entry is b) 32 samples at a time, finds by the gather's tap rows
// the samples with a tap on its rows, and adds each one's row, times the tap's
// weight, to its rows in shared memory, in entry order (set, sample, tap).
// Every element of the gradient is written once, after a sum in a fixed order,
// so two runs give the same bits, and no sort of the 54,208 taps runs (a
// stable device sort of them took 0.048 ms on an H100 SXM at 700 W, twice a
// first adjoint that read the sorted order). Bound by bytes: the function
// reads the sets' gradient and code (3.8 MB each at the train step's shape)
// and writes both code maps' gradient once (7.0 MB), ~0.0045 ms at HBM rate;
// the Jacobian's rows (3.8 MB) pass between the two kernels through L2, and
// the adjoint reads a sample's row again for each warp it lands on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarps = 8;  // a block: one warp a sample or code-map row
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFeat = 768;       // feature channels (ViT-B)
constexpr int kLaneChannels = 4;    // adjoint: channels a lane sums a pass
constexpr int kPix = 8;             // adjoint: code-map rows a warp owns
constexpr int kChunks = 4;          // adjoint: 32-sample key chunks at once
constexpr int kBatch = 2;           // adjoint: landing samples loaded at once
constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }

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

// kVec consecutive elements at p (an aligned vector) as floats.
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (kVec == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 q = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&q);
}

template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack_bf16x2(u.x), b = unpack_bf16x2(u.y);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else if constexpr (kVec == 2) {
    const float2 a = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(const float (&v)[kVec], float* p) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(const float (&v)[kVec],
                                          __nv_bfloat16* p) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// One warp samples the map m (rows of c channels, c a multiple of kVec)
// at the taps (idx, wt), lanes over groups of kVec channels (lane l:
// groups l, l + 32, ..., one vector load a tap and group): z = sum_t wt_t
// m[idx_t] by f32 FMA in tap order, kept in the warp's buffer buf (c
// floats, 16-byte aligned; a lane reads back only its own channels), then
// z / max(|z|, eps) stored to out. kBf16: the weights and z rounded to
// bf16 (bf16 features). The sum of squares goes over a lane's channels in
// order, then a butterfly over the lanes. Returns |z| on every lane.
template <bool kBf16, int kVec, typename InT, typename OutT>
__device__ float sample_row(const InT* m, const int* idx, const float* wt,
                            int c, float* buf, OutT* out) {
  const int lane = threadIdx.x & 31;
  const int groups = c / kVec;
  const InT* r[4];
  float w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    r[t] = m + static_cast<size_t>(idx[t]) * c;
    w[t] = kBf16 ? bf16_round(wt[t]) : wt[t];
  }
  float sq = 0.f;
  for (int q = lane; q < groups; q += 32) {
    float x[4][kVec];
#pragma unroll
    for (int t = 0; t < 4; ++t) load_vec(r[t] + q * kVec, x[t]);
    float z[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) v = fmaf(w[t], x[t][e], v);
      if (kBf16) v = bf16_round(v);
      z[e] = v;
      sq = fmaf(v, v, sq);
    }
    store_vec(z, buf + q * kVec);
  }
  const float n = sqrtf(warp_sum(sq));
  const float d = fmaxf(n, kEps);
  for (int q = lane; q < groups; q += 32) {
    float z[kVec];
    load_vec(buf + q * kVec, z);
#pragma unroll
    for (int e = 0; e < kVec; ++e) z[e] = z[e] / d;
    store_vec(z, out + q * kVec);
  }
  return n;
}

// Floats of a warp's buffer in the gather: the wider of the two rows,
// rounded up to 4 so that each warp's slice stays 16-byte aligned.
__host__ __device__ __forceinline__ int buf_floats(int cf, int cc) {
  return ((cf > cc ? cf : cc) + 3) & ~3;
}

// The pair rows' layout as C2 reads it, written by the gather's first
// threads for the R = batch * g rows (row r = gi * batch + b). idx1[r] = b;
// idx2[r] = b (gi = 0), r, or -1 for an out-of-range permutation entry;
// row_group[r] = gi. C2's backward takes each map's entries (e < R: row e
// reads the map as side 1; e >= R: row e - R as side 2) from order, in the
// order a stable sort of [idx1; idx2] gives (ops/corr_stream.py:
// backward_launch), set m's at offsets[m] .. offsets[m + 1]: set m < batch
// is side 1 of rows m, batch + m, ..., then side 2 of row m (g + 1
// entries); a later set is side 2 of its own row, or nothing when that
// row's entry is out of range (the sort's leading -1 keys are left out).
__device__ void pair_layout(const long long* perms, int* idx1, int* idx2,
                            int* row_group, int* order, int* offsets,
                            int batch, int g) {
  if (blockIdx.x != 0 || threadIdx.x >= 32) return;  // one warp
  const int lane = threadIdx.x;
  const int rows = batch * g;
  int later = 0;  // valid sets in [batch, r0)
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int r = r0 + lane;
    const int gi = r / batch;
    const int b = r - gi * batch;
    bool valid = r < rows;
    if (valid && gi >= 2) {
      const long long p = perms[r - 2 * batch];
      valid = p >= 0 && p < batch;
    }
    const unsigned before =
        __ballot_sync(kFull, valid && r >= batch) & ((1u << lane) - 1);
    const int at = batch * (g + 1) + later + __popc(before);
    if (r < rows) {
      idx1[r] = b;
      idx2[r] = gi == 0 ? b : valid ? r : -1;
      row_group[r] = gi;
      if (r < batch) {
        offsets[r] = r * (g + 1);
        for (int j = 0; j < g; ++j) order[r * (g + 1) + j] = j * batch + r;
        order[r * (g + 1) + g] = rows + r;
      } else {
        offsets[r] = at;
        if (valid) order[at] = rows + r;
      }
    }
    later += __popc(__ballot_sync(kFull, valid && r >= batch));
  }
  if (lane == 0) offsets[rows] = batch * (g + 1) + later;
}

// One warp a (set, sample) item = set * s + sample, sets group-major (set
// = gi * batch + b); sample k = i * s1 + j of set gi * batch + b is
// coords[b, j, i], the reference's transposed grid (coords1 for gi = 0,
// coords2 else). Writes the normalised feature row fsets[item] (cf,
// FeatT) and code row csets[item] (cc, f32), the raw code norm
// norms[item], and for each tap t keys[4 item + t], the code-map row it
// lands on (maps code[0..batch) then code_pos[0..batch), h * w rows each;
// 2 * batch * h * w, past every row, for a tap of weight 0 or a set whose
// permutation entry is out of range) and wts[4 item + t], its weight. The
// first warp of block 0 also writes the pair rows' layout (pair_layout).
template <typename FeatT, int kFeatVec, int kCodeVec>
__global__ void __launch_bounds__(kThreads)
corr_sampled_gather_kernel(const FeatT* __restrict__ feats,
                           const FeatT* __restrict__ feats_pos,
                           const float* __restrict__ code,
                           const float* __restrict__ code_pos,
                           const float* __restrict__ coords1,
                           const float* __restrict__ coords2,
                           const long long* __restrict__ perms,
                           FeatT* __restrict__ fsets,
                           float* __restrict__ csets,
                           float* __restrict__ norms, int* __restrict__ keys,
                           float* __restrict__ wts, int* __restrict__ idx1,
                           int* __restrict__ idx2, int* __restrict__ row_group,
                           int* __restrict__ order, int* __restrict__ offsets,
                           int batch, int h, int w, int cf, int cc, int s1,
                           int s2, int g) {
  extern __shared__ float buf_all[];
  pair_layout(perms, idx1, idx2, row_group, order, offsets, batch, g);
  const int s = s1 * s2;
  const int hw = h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t item = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (item >= static_cast<size_t>(batch) * g * s) return;  // a whole warp
  const int set = static_cast<int>(item / s);
  const int k = static_cast<int>(item - static_cast<size_t>(set) * s);
  const int gi = set / batch;
  const int b = set - gi * batch;
  long long image = b;
  if (gi >= 2) image = perms[set - 2 * batch];
  const bool valid = image >= 0 && image < batch;
  const bool pos = gi == 1;
  const int i = k / s1;
  const int j = k - i * s1;
  int idx[4];
  float wt[4];
  make_taps((gi == 0 ? coords1 : coords2) +
                ((static_cast<size_t>(b) * s1 + j) * s2 + i) * 2,
            h, w, idx, wt);
  if (lane < 4) {
    const int ti = lane == 0 ? idx[0] : lane == 1 ? idx[1]
                 : lane == 2 ? idx[2] : idx[3];
    const float tw = lane == 0 ? wt[0] : lane == 1 ? wt[1]
                   : lane == 2 ? wt[2] : wt[3];
    const int map = pos ? batch + b : static_cast<int>(image);
    keys[4 * item + lane] =
        valid && tw != 0.f ? map * hw + ti : 2 * batch * hw;
    wts[4 * item + lane] = tw;
  }
  FeatT* fo = fsets + item * cf;
  float* co = csets + item * cc;
  if (!valid) {  // no pair row reads this set
    for (int ch = lane; ch < cf; ch += 32) store_as(0.f, fo + ch);
    for (int ch = lane; ch < cc; ch += 32) co[ch] = 0.f;
    if (lane == 0) norms[item] = 0.f;
    return;
  }
  float* buf = buf_all + static_cast<size_t>(warp) * buf_floats(cf, cc);
  const size_t map = static_cast<size_t>(image) * hw;
  sample_row<std::is_same<FeatT, __nv_bfloat16>::value, kFeatVec>(
      (pos ? feats_pos : feats) + map * cf, idx, wt, cf, buf, fo);
  const float n = sample_row<false, kCodeVec>(
      (pos ? code_pos : code) + map * cc, idx, wt, cc, buf, co);
  if (lane == 0) norms[item] = n;
}

// One warp a sample row: gv = dL/d(its normalised code) g (a row of
// dsets) through the l2-normalise Jacobian, (g - [n > eps] vn (vn . g)) /
// max(n, eps), vn its normalised code row (csets) and n its raw norm; the
// dot lane by lane in channel order, then a butterfly.
__global__ void __launch_bounds__(kThreads)
corr_sampled_jacobian_kernel(const float* __restrict__ dsets,
                             const float* __restrict__ csets,
                             const float* __restrict__ norms,
                             float* __restrict__ gv, int items, int cc) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;  // a whole warp
  const float* gr = dsets + static_cast<size_t>(item) * cc;
  float* out = gv + static_cast<size_t>(item) * cc;
  const float* vn = csets + static_cast<size_t>(item) * cc;
  const float n = norms[item];
  float dot = 0.f;
  for (int ch = lane; ch < cc; ch += 32) dot = fmaf(vn[ch], gr[ch], dot);
  dot = warp_sum(dot);
  const float inv = 1.0f / fmaxf(n, kEps);
  for (int ch = lane; ch < cc; ch += 32) {
    const float proj = n > kEps ? __fmul_rn(vn[ch], dot) : 0.f;
    out[ch] = __fmul_rn(__fsub_rn(gr[ch], proj), inv);
  }
}

// One warp kPix consecutive rows of one code map (maps code[0..batch) then
// code_pos[0..batch), h * w rows each): their gradient, every (set, sample,
// tap) entry that lands on one of them added in entry order (set, then
// sample, then tap), which is what makes two runs give the same bits. Map
// t reads set t (side 1 for t < batch, the positive after) and, for t <
// batch, the negative sets whose permutation entry is t, in order; a
// sample's four keys (the gather's) say which of the warp's rows its taps
// land on, kChunks chunks of 32 samples loaded at once. A sample that lands
// adds its row of gv (the Jacobian kernel's), times each landing tap's
// weight, to the warp's rows in shared memory (kPix x 128 floats, lane l
// owning channels l + 32 u); kBatch such samples have their rows loaded
// together. Past 128 code channels the warp takes the entries again for
// each 128. Writes every element of the warp's rows of dcode (zeros where
// no tap lands).
__global__ void __launch_bounds__(kThreads)
corr_sampled_adjoint_kernel(const float* __restrict__ gv,
                            const int* __restrict__ keys,
                            const float* __restrict__ wts,
                            const long long* __restrict__ perms,
                            float* __restrict__ dcode, int batch, int hw,
                            int cc, int s, int g) {
  constexpr int kWidth = 32 * kLaneChannels;  // channels a pass
  __shared__ float acc_all[kWarps][kPix * kWidth];
  const int lane = threadIdx.x & 31;
  float* acc = acc_all[threadIdx.x >> 5];
  const int tiles = (hw + kPix - 1) / kPix;  // warps a map
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= 2 * batch * tiles) return;  // a whole warp
  const int t = task / tiles;
  const int p0 = (task - t * tiles) * kPix;
  const unsigned pix = static_cast<unsigned>(min(kPix, hw - p0));
  const int base = t * hw + p0;  // the warp's first row, as a key
  const int negs = (g - 2) * batch;
  for (int c0 = 0; c0 < cc; c0 += kWidth) {
    for (int e = lane; e < kPix * kWidth; e += 32) acc[e] = 0.f;
    // the map's own set (bit 0 of the chunk before the permutations), then
    // a chunk of 32 permutation entries at a time: the negative sets whose
    // entry is t, in order
    for (int e0 = -32; e0 < negs; e0 += 32) {
      unsigned sets = e0 < 0;
      if (e0 >= 0 && t < batch) {
        sets = __ballot_sync(kFull, e0 + lane < negs && perms[e0 + lane] == t);
      }
      for (; sets != 0; sets &= sets - 1) {
        const int set = e0 < 0 ? t : 2 * batch + e0 + __ffs(sets) - 1;
        for (int k0 = 0; k0 < s; k0 += 32 * kChunks) {
          // lane = sample k0 + 32 c + lane of chunk c
          const size_t first = static_cast<size_t>(set) * s + k0;
          int4 key[kChunks];
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            key[c] = make_int4(-1, -1, -1, -1);
            if (k0 + 32 * c + lane < s) {
              key[c] = reinterpret_cast<const int4*>(keys)[first + 32 * c +
                                                           lane];
            }
          }
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const unsigned lands =
                (static_cast<unsigned>(key[c].x - base) < pix) |
                (static_cast<unsigned>(key[c].y - base) < pix) << 1 |
                (static_cast<unsigned>(key[c].z - base) < pix) << 2 |
                (static_cast<unsigned>(key[c].w - base) < pix) << 3;
            unsigned m = __ballot_sync(kFull, lands != 0);
            while (m != 0) {
              // the next kBatch landing samples (src -1: none), in order
              int src[kBatch];
#pragma unroll
              for (int j = 0; j < kBatch; ++j) {
                src[j] = m != 0 ? __ffs(m) - 1 : -1;
                m &= m - 1;
              }
              float row[kBatch][kLaneChannels];
              float tw[kBatch][4];
              unsigned taps[kBatch];
#pragma unroll
              for (int j = 0; j < kBatch; ++j) {
                const int l = src[j] < 0 ? 0 : src[j];
                taps[j] = src[j] < 0 ? 0u : __shfl_sync(kFull, lands, l);
                const size_t item = first + 32 * c + l;
#pragma unroll
                for (int u = 0; u < kLaneChannels; ++u) {
                  const int ch = c0 + lane + 32 * u;
                  row[j][u] = taps[j] != 0 && ch < cc
                                  ? gv[item * cc + ch] : 0.f;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  tw[j][i] = (taps[j] >> i) & 1 ? wts[4 * item + i] : 0.f;
                }
              }
#pragma unroll
              for (int j = 0; j < kBatch; ++j) {
                const int l = src[j] < 0 ? 0 : src[j];
                const int at[4] = {__shfl_sync(kFull, key[c].x, l) - base,
                                   __shfl_sync(kFull, key[c].y, l) - base,
                                   __shfl_sync(kFull, key[c].z, l) - base,
                                   __shfl_sync(kFull, key[c].w, l) - base};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  if ((taps[j] >> i) & 1) {
                    float* a = acc + at[i] * kWidth + lane;
#pragma unroll
                    for (int u = 0; u < kLaneChannels; ++u) {
                      a[32 * u] =
                          __fadd_rn(a[32 * u], __fmul_rn(tw[j][i], row[j][u]));
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();
    for (int q = 0; q < static_cast<int>(pix); ++q) {
      float* out = dcode + static_cast<size_t>(base + q) * cc;
#pragma unroll
      for (int u = 0; u < kLaneChannels; ++u) {
        const int ch = c0 + lane + 32 * u;
        if (ch < cc) out[ch] = acc[q * kWidth + lane + 32 * u];
      }
    }
    __syncwarp();
  }
}

// Elements a vector load takes from rows of c elements of size bytes
// whose buffers all start at addresses in ptrs: 4 (or for f32 code 2)
// where the rows and buffers allow it, else 1.
int vec_width(int c, size_t bytes, std::initializer_list<const void*> ptrs,
              int widest) {
  for (int v = widest; v > 1; v /= 2) {
    bool ok = c % v == 0;
    for (const void* p : ptrs) {
      ok = ok && reinterpret_cast<uintptr_t>(p) % (v * bytes) == 0;
    }
    if (ok) return v;
  }
  return 1;
}

template <typename FeatT, int kFeatVec, int kCodeVec>
cudaError_t launch_gather_as(const void* feats, const void* feats_pos,
                             const void* code, const void* code_pos,
                             const void* coords1, const void* coords2,
                             const void* perms, void* fsets, void* csets,
                             void* norms, void* keys, void* wts, void* idx1,
                             void* idx2, void* row_group, void* order,
                             void* offsets, int batch, int h, int w, int cf,
                             int cc, int s1, int s2, int g,
                             cudaStream_t stream) {
  auto kernel = corr_sampled_gather_kernel<FeatT, kFeatVec, kCodeVec>;
  const size_t smem =
      static_cast<size_t>(kWarps) * buf_floats(cf, cc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(batch) * g * s1 * s2;
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const FeatT*>(feats), static_cast<const FeatT*>(feats_pos),
      static_cast<const float*>(code), static_cast<const float*>(code_pos),
      static_cast<const float*>(coords1), static_cast<const float*>(coords2),
      static_cast<const long long*>(perms), static_cast<FeatT*>(fsets),
      static_cast<float*>(csets), static_cast<float*>(norms),
      static_cast<int*>(keys), static_cast<float*>(wts),
      static_cast<int*>(idx1), static_cast<int*>(idx2),
      static_cast<int*>(row_group), static_cast<int*>(order),
      static_cast<int*>(offsets), batch, h, w, cf, cc, s1, s2, g);
  return cudaGetLastError();
}

// The gather's instantiation for its vector widths: features 4 or 1
// elements a load, code 4, 2 or 1.
template <typename FeatT, int kFeatVec>
cudaError_t launch_gather(int code_vec, const void* feats,
                          const void* feats_pos, const void* code,
                          const void* code_pos, const void* coords1,
                          const void* coords2, const void* perms, void* fsets,
                          void* csets, void* norms, void* keys, void* wts,
                          void* idx1, void* idx2, void* row_group,
                          void* order, void* offsets, int batch, int h, int w,
                          int cf, int cc, int s1, int s2, int g,
                          cudaStream_t stream) {
  auto launch = code_vec == 4   ? &launch_gather_as<FeatT, kFeatVec, 4>
                : code_vec == 2 ? &launch_gather_as<FeatT, kFeatVec, 2>
                                : &launch_gather_as<FeatT, kFeatVec, 1>;
  return launch(feats, feats_pos, code, code_pos, coords1, coords2, perms,
                fsets, csets, norms, keys, wts, idx1, idx2, row_group, order,
                offsets, batch, h, w, cf, cc, s1, s2, g, stream);
}

// Shapes the kernels take: every tap entry (4 batch g s) and code-map row
// (2 batch h w, and the past-the-end key) indexed by an int.
bool bad_shape(int batch, int h, int w, int cc, int s, int g) {
  return batch <= 0 || h <= 0 || w <= 0 || cc <= 0 || s <= 0 || g < 2 ||
         2LL * batch * h * w >= 2147483647LL ||
         4LL * batch * g * s >= 2147483647LL;
}

}  // namespace

// feats, feats_pos: (batch, h * w, cf), bf16 (feat_f32 = 0) or f32
// (feat_f32 = 1); code, code_pos: (batch, h * w, cc) f32; coords1,
// coords2: (batch, s1, s2, 2) f32 sample points in [-1, 1], (x, y) (the
// reference's coordinates, sampled in its transposed order); perms: (g -
// 2, batch) int64. Writes, for the batch * g sets (set gi * batch + b) of s
// = s1 * s2 samples: fsets (sets, s, cf) in the feature type and csets
// (sets, s, cc) f32, the l2-normalised samples; norms (sets, s), the raw
// code norms; keys (sets, s, 4) int32, each tap's row of the code maps
// [code; code_pos] (2 * batch * h * w rows; that count for no row), and
// wts (sets, s, 4) f32, its weight; and the pair rows' layout for C2:
// idx1, idx2, row_group (sets,) int32, order (2 sets,) int32, offsets
// (sets + 1,) int32 (pair_layout). cf <= 768, g >= 2. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int stego_corr_sampled_gather(
    const void* feats, const void* feats_pos, const void* code,
    const void* code_pos, const void* coords1, const void* coords2,
    const void* perms, void* fsets, void* csets, void* norms, void* keys,
    void* wts, void* idx1, void* idx2, void* row_group, void* order,
    void* offsets, int batch, int h, int w, int cf, int cc, int s1, int s2,
    int g, int feat_f32, int device, void* stream) {
  if (bad_shape(batch, h, w, cc, s1 * s2, g) || s1 <= 0 || s2 <= 0 ||
      cf <= 0 || cf > kMaxFeat) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int feat_vec = vec_width(cf, feat_f32 ? 4 : 2,
                                 {feats, feats_pos, fsets}, 4);
  const int code_vec = vec_width(cc, 4, {code, code_pos, csets}, 4);
  using Launch = cudaError_t (*)(
      int, const void*, const void*, const void*, const void*, const void*,
      const void*, const void*, void*, void*, void*, void*, void*, void*,
      void*, void*, void*, void*, int, int, int, int, int, int, int, int,
      cudaStream_t);
  Launch launch;
  if (feat_f32) {
    launch = feat_vec == 4 ? &launch_gather<float, 4>
                           : &launch_gather<float, 1>;
  } else {
    launch = feat_vec == 4 ? &launch_gather<__nv_bfloat16, 4>
                           : &launch_gather<__nv_bfloat16, 1>;
  }
  err = launch(code_vec, feats, feats_pos, code, code_pos, coords1, coords2,
               perms, fsets, csets, norms, keys, wts, idx1, idx2, row_group,
               order, offsets, batch, h, w, cf, cc, s1, s2, g, st);
  return static_cast<int>(err);
}

// dsets (sets, s, cc) f32: dL/d(the normalised code sets), from C2's
// backward; csets, norms, keys, wts: the gather's; perms (g - 2, batch)
// int64; gv (sets, s, cc) f32 scratch (dsets through the normalisation's
// Jacobian). Writes every element of dcode (2 * batch, h * w, cc) f32, the
// gradient of the code maps [code; code_pos]. Two launches, the Jacobian
// kernel and the adjoint kernel. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int stego_corr_sampled_adjoint(const void* dsets,
                                          const void* csets,
                                          const void* norms, const void* keys,
                                          const void* wts, const void* perms,
                                          void* gv, void* dcode, int batch,
                                          int h, int w, int cc, int s, int g,
                                          int device, void* stream) {
  if (bad_shape(batch, h, w, cc, s, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int items = batch * g * s;
  corr_sampled_jacobian_kernel<<<(items + kWarps - 1) / kWarps, kThreads, 0,
                                 st>>>(static_cast<const float*>(dsets),
                                       static_cast<const float*>(csets),
                                       static_cast<const float*>(norms),
                                       static_cast<float*>(gv), items, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = 2LL * batch * ((h * w + kPix - 1) / kPix);
  const unsigned blocks = static_cast<unsigned>((tasks + kWarps - 1) / kWarps);
  corr_sampled_adjoint_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(gv), static_cast<const int*>(keys),
      static_cast<const float*>(wts), static_cast<const long long*>(perms),
      static_cast<float*>(dcode), batch, h * w, cc, s, g);
  return static_cast<int>(cudaGetLastError());
}
