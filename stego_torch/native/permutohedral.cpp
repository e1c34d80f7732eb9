// Permutohedral-lattice high-dimensional Gaussian filtering.
//
// Implements the lattice splat/blur/slice algorithm of Adams, Baek & Davis,
// "Fast High-Dimensional Filtering Using the Permutohedral Lattice"
// (Eurographics 2010) from the published algorithm description. This is the
// exact-backend replacement for the reference's pydensecrf dependency
// (reference src/crf.py uses pydensecrf's dense bilateral message passing):
// the mean-field CRF's bilateral term is one lattice filter per iteration.
//
// The lattice structure depends only on the POSITIONS, so it is built once
// per kernel (hashing, simplex enumeration, blur-neighbor resolution) and
// then applied to many value arrays — the mean-field loop filters the same
// kernel 10+ times per image, and rebuilding per call dominated the round-3
// single-shot ABI (~29 s/img at res 320; the split brings it to ~1 s/img).
//
// C ABI (ctypes-friendly):
//   void* permutohedral_create(positions[N*pd], N, pd)
//       builds the lattice for these positions (pre-divided by the desired
//       standard deviations) and returns an opaque handle.
//   permutohedral_apply(handle, values[N*vd], out[N*vd], vd)
//       computes out_i = sum_j exp(-|p_i - p_j|^2 / 2) v_j (approximately,
//       with the lattice's built-in kernel normalization). No hashing — the
//       splat offsets and blur neighbor indices are precomputed.
//   permutohedral_destroy(handle)
//   permutohedral_filter(positions, values, out, n, pd, vd)
//       one-shot convenience wrapper (create + apply + destroy).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Open-addressing hash table over fixed-width short keys stored contiguously
// (pd small ints; the pd+1-th coordinate is implied by the zero-sum
// constraint). The round-4 std::unordered_map<std::vector<short>> version
// paid a heap allocation + indirect hash per lookup — at res 320 bilateral
// (5-D, ~100k points, ~600k lookups) the build took ~1.9 s; this flat table
// (linear probing, power-of-two capacity, memcmp key equality — the layout
// the original Adams/Baek/Davis implementation uses) cuts the build ~5x.
// Insertion order is unchanged, so lattice indices — and therefore all
// filter outputs — are bit-identical to the map version.
struct FlatHash {
  int pd;
  int capacity;       // power of two
  int n_entries = 0;
  std::vector<int> slots;    // capacity; -1 = empty
  std::vector<short> keys;   // max_entries * pd, insertion-ordered

  FlatHash(int pd_, int max_entries) : pd(pd_) {
    capacity = 16;
    while (capacity < max_entries * 2) capacity <<= 1;
    slots.assign(static_cast<size_t>(capacity), -1);
    keys.resize(static_cast<size_t>(max_entries) * pd);
  }

  size_t hash(const short* k) const {
    size_t h = 0;
    for (int i = 0; i < pd; ++i)
      h = h * 2531011u + static_cast<size_t>(k[i] + 32768);
    return h;
  }

  // Find the key's index; when ``insert`` and absent, append it.
  int lookup(const short* k, bool insert) {
    size_t h = hash(k) & static_cast<size_t>(capacity - 1);
    for (;;) {
      int e = slots[h];
      if (e == -1) {
        if (!insert) return -1;
        std::memcpy(keys.data() + static_cast<size_t>(n_entries) * pd, k,
                    static_cast<size_t>(pd) * sizeof(short));
        slots[h] = n_entries;
        return n_entries++;
      }
      if (std::memcmp(keys.data() + static_cast<size_t>(e) * pd, k,
                      static_cast<size_t>(pd) * sizeof(short)) == 0)
        return e;
      h = (h + 1) & static_cast<size_t>(capacity - 1);
    }
  }
};

struct Lattice {
  int pd = 0;         // position dimensionality
  int n = 0;          // number of input points
  int n_lattice = 0;  // number of occupied lattice points

  // Per input point: pd+1 enclosing simplex vertices + barycentric weights.
  std::vector<int> offsets;           // n * (pd+1)
  std::vector<float> barycentric;     // n * (pd+1)
  // Per lattice point and axis: the two blur neighbors (-1 = absent),
  // laid out axis-major: neighbors[j * n_lattice * 2 + i * 2 + dir].
  std::vector<int> neighbors;
};

void build_lattice(const float* positions, int n, int pd, Lattice& out) {
  const int d1 = pd + 1;
  out.pd = pd;
  out.n = n;
  out.offsets.resize(static_cast<size_t>(n) * d1);
  out.barycentric.resize(static_cast<size_t>(n) * d1);

  // Elevation scale factors. inv_std_dev makes a unit-variance Gaussian after
  // the three-tap [1 2 1]/4 blur along each of the pd+1 lattice axes.
  std::vector<float> scale_factor(pd);
  const float inv_std_dev = std::sqrt(2.0f / 3.0f) * d1;
  for (int i = 0; i < pd; ++i) {
    scale_factor[i] =
        inv_std_dev / std::sqrt(static_cast<float>((i + 1) * (i + 2)));
  }

  // worst case every point inserts d1 distinct keys
  FlatHash hash(pd, n * d1);

  std::vector<float> elevated(d1);
  std::vector<int> rem0(d1);
  std::vector<int> rank(d1);
  std::vector<float> bary(d1 + 1);
  std::vector<short> key(pd);

  for (int p = 0; p < n; ++p) {
    const float* pos = positions + static_cast<size_t>(p) * pd;

    // 1) elevate into the hyperplane sum(x)=0 in R^{pd+1}
    float sm = 0.0f;
    for (int i = pd; i > 0; --i) {
      float cf = pos[i - 1] * scale_factor[i - 1];
      elevated[i] = sm - i * cf;
      sm += cf;
    }
    elevated[0] = sm;

    // 2) nearest zero-colored lattice point: round to multiples of pd+1
    int sum = 0;
    for (int i = 0; i <= pd; ++i) {
      float v = elevated[i] / d1;
      int up = static_cast<int>(std::ceil(v)) * d1;
      int down = static_cast<int>(std::floor(v)) * d1;
      rem0[i] = (up - elevated[i] < elevated[i] - down) ? up : down;
      sum += rem0[i];
    }
    sum /= d1;

    // 3) rank differential coordinates
    for (int i = 0; i <= pd; ++i) rank[i] = 0;
    for (int i = 0; i < pd; ++i) {
      for (int j = i + 1; j <= pd; ++j) {
        if (elevated[i] - rem0[i] < elevated[j] - rem0[j])
          ++rank[i];
        else
          ++rank[j];
      }
    }

    // fix points that rounded onto the wrong simplex (sum != 0)
    for (int i = 0; i <= pd; ++i) {
      rank[i] += sum;
      if (rank[i] < 0) {
        rank[i] += d1;
        rem0[i] += d1;
      } else if (rank[i] > pd) {
        rank[i] -= d1;
        rem0[i] -= d1;
      }
    }

    // 4) barycentric coordinates
    for (int i = 0; i <= pd + 1; ++i) bary[i] = 0.0f;
    for (int i = 0; i <= pd; ++i) {
      float delta = (elevated[i] - rem0[i]) / d1;
      bary[pd - rank[i]] += delta;
      bary[pd + 1 - rank[i]] -= delta;
    }
    bary[0] += 1.0f + bary[pd + 1];

    // 5) record the pd+1 enclosing simplex vertices
    for (int remainder = 0; remainder <= pd; ++remainder) {
      for (int i = 0; i < pd; ++i) {
        key[i] = static_cast<short>(
            rem0[i] + (rank[i] >= d1 - remainder ? remainder - d1 : remainder));
      }
      int idx = hash.lookup(key.data(), /*insert=*/true);
      out.offsets[static_cast<size_t>(p) * d1 + remainder] = idx;
      out.barycentric[static_cast<size_t>(p) * d1 + remainder] =
          bary[remainder];
    }
  }

  // 6) resolve the blur neighbors once: along axis j the neighbors of key k
  // are k +/- (1,...,1, -pd at position j, 1,...).
  const int n_lattice = hash.n_entries;
  out.n_lattice = n_lattice;
  out.neighbors.assign(static_cast<size_t>(d1) * n_lattice * 2, -1);
  std::vector<short> nkey(pd);
  for (int j = 0; j <= pd; ++j) {
    int* nj = out.neighbors.data() + static_cast<size_t>(j) * n_lattice * 2;
    for (int i = 0; i < n_lattice; ++i) {
      const short* k = hash.keys.data() + static_cast<size_t>(i) * pd;
      for (int dir = 0; dir < 2; ++dir) {
        int sgn = dir == 0 ? 1 : -1;
        for (int c = 0; c < pd; ++c) nkey[c] = static_cast<short>(k[c] + sgn);
        if (j < pd) nkey[j] = static_cast<short>(k[j] - sgn * pd);
        nj[static_cast<size_t>(i) * 2 + dir] =
            hash.lookup(nkey.data(), /*insert=*/false);
      }
    }
  }
}

void apply_lattice(const Lattice& lat, const float* values_in, float* out,
                   int vd) {
  const int pd = lat.pd;
  const int d1 = pd + 1;
  const int n = lat.n;
  const int n_lattice = lat.n_lattice;

  // Thread-local reusable scratch: the two lattice-value buffers are ~50 MB
  // each at res-320 bilateral — a fresh allocation per apply pays page
  // faults on every one of the mean-field loop's 20 filter calls.
  // thread_local keeps apply reentrant across threads sharing one handle
  // (the cached spatial kernel; ops/crf_exact.py).
  static thread_local std::vector<float> lattice_values;
  static thread_local std::vector<float> new_values;
  lattice_values.assign(static_cast<size_t>(n_lattice) * vd, 0.0f);
  for (int p = 0; p < n; ++p) {
    const float* v = values_in + static_cast<size_t>(p) * vd;
    for (int remainder = 0; remainder <= pd; ++remainder) {
      int idx = lat.offsets[static_cast<size_t>(p) * d1 + remainder];
      float w = lat.barycentric[static_cast<size_t>(p) * d1 + remainder];
      float* lv = lattice_values.data() + static_cast<size_t>(idx) * vd;
      for (int c = 0; c < vd; ++c) lv[c] += w * v[c];
    }
  }

  // blur along each lattice direction with [1 2 1]/4 using the precomputed
  // neighbor indices (no hashing), ping-ponging a double buffer
  new_values.resize(lattice_values.size());
  for (int j = 0; j <= pd; ++j) {
    const int* nj =
        lat.neighbors.data() + static_cast<size_t>(j) * n_lattice * 2;
    for (int i = 0; i < n_lattice; ++i) {
      float* dst = new_values.data() + static_cast<size_t>(i) * vd;
      const float* self = lattice_values.data() + static_cast<size_t>(i) * vd;
      for (int c = 0; c < vd; ++c) dst[c] = 0.5f * self[c];
      for (int dir = 0; dir < 2; ++dir) {
        int ni = nj[static_cast<size_t>(i) * 2 + dir];
        if (ni >= 0) {
          const float* nv =
              lattice_values.data() + static_cast<size_t>(ni) * vd;
          for (int c = 0; c < vd; ++c) dst[c] += 0.25f * nv[c];
        }
      }
    }
    lattice_values.swap(new_values);
  }

  // slice with the same barycentric weights
  const float alpha = 1.0f / (1.0f + std::pow(2.0f, -pd));
  for (int p = 0; p < n; ++p) {
    float* o = out + static_cast<size_t>(p) * vd;
    for (int c = 0; c < vd; ++c) o[c] = 0.0f;
    for (int remainder = 0; remainder <= pd; ++remainder) {
      int idx = lat.offsets[static_cast<size_t>(p) * d1 + remainder];
      float w = lat.barycentric[static_cast<size_t>(p) * d1 + remainder];
      const float* lv = lattice_values.data() + static_cast<size_t>(idx) * vd;
      for (int c = 0; c < vd; ++c) o[c] += alpha * w * lv[c];
    }
  }
}

}  // namespace

extern "C" void* permutohedral_create(const float* positions, int n, int pd) {
  Lattice* lat = new Lattice();
  build_lattice(positions, n, pd, *lat);
  return lat;
}

extern "C" void permutohedral_apply(void* handle, const float* values_in,
                                    float* out, int vd) {
  apply_lattice(*static_cast<Lattice*>(handle), values_in, out, vd);
}

extern "C" void permutohedral_destroy(void* handle) {
  delete static_cast<Lattice*>(handle);
}

extern "C" void permutohedral_filter(const float* positions,
                                     const float* values_in, float* out,
                                     int n, int pd, int vd) {
  Lattice lat;
  build_lattice(positions, n, pd, lat);
  apply_lattice(lat, values_in, out, vd);
}
