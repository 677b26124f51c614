// Native coordinate-pyramid + kernel-map builder.
//
// Host-side replacement for MinkowskiEngine's C++ coordinate manager
// (reference models/modules/common.py:192-203 consumes it): builds the
// stride pyramid and padded gather-index kernel maps that the TPU conv
// kernels consume. Called from Python via ctypes (sparse/graph_native.py);
// the numpy builder (sparse/graph_host.py) is the reference oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC graph_builder.cpp -o libgraph_builder.so
//
// Key packing matches sparse/graph_host.py: (b,x,y,z) -> 16 bits per field,
// coords offset by 2^15.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kCoordOff = 1 << 15;
constexpr int kFieldBits = 16;

inline uint64_t pack_key(int32_t b, int32_t x, int32_t y, int32_t z) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(b)) << (3 * kFieldBits)) |
         (static_cast<uint64_t>(static_cast<uint16_t>(x + kCoordOff)) << (2 * kFieldBits)) |
         (static_cast<uint64_t>(static_cast<uint16_t>(y + kCoordOff)) << kFieldBits) |
         static_cast<uint64_t>(static_cast<uint16_t>(z + kCoordOff));
}

inline int32_t floordiv(int32_t a, int32_t s) {
  return (a >= 0) ? a / s : -((-a + s - 1) / s);
}

// Open-addressing hash table: key -> row index.
struct HashTable {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit HashTable(size_t n) {
    size_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    keys.assign(cap, ~0ull);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline uint64_t hash(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
  }

  // Insert if absent; returns row of the existing/new entry.
  inline int32_t insert(uint64_t key, int32_t row) {
    uint64_t h = hash(key) & mask;
    while (true) {
      if (keys[h] == ~0ull) {
        keys[h] = key;
        vals[h] = row;
        return row;
      }
      if (keys[h] == key) return vals[h];
      h = (h + 1) & mask;
    }
  }

  inline int32_t find(uint64_t key) const {
    uint64_t h = hash(key) & mask;
    while (true) {
      if (keys[h] == ~0ull) return -1;
      if (keys[h] == key) return vals[h];
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Build the coordinate pyramid.
//   coords0: (n0, 4) int32 rows (b,x,y,z), already unique, any order.
//   num_levels levels with capacities caps[l]; level strides are 1 << l.
// Outputs (preallocated by the caller):
//   level_coords[l]: (caps[l], 4) int32 — level 0 is coords0 truncated;
//     deeper levels sorted by packed key.
//   level_nums: (num_levels,) int32 valid counts.
// Returns 0 on success.
int lgs_build_pyramid(const int32_t* coords0, int64_t n0, int num_levels,
                      const int64_t* caps, int32_t** level_coords,
                      int32_t* level_nums) {
  int64_t n = n0 < caps[0] ? n0 : caps[0];
  std::memcpy(level_coords[0], coords0, sizeof(int32_t) * 4 * n);
  level_nums[0] = static_cast<int32_t>(n);

  std::vector<uint64_t> cur_keys(n);
  const int32_t* cur = level_coords[0];
  int64_t cur_n = n;

  for (int l = 1; l < num_levels; ++l) {
    const int32_t s = 1 << l;
    HashTable table(cur_n);
    std::vector<uint64_t> keys;
    keys.reserve(cur_n / 2);
    for (int64_t i = 0; i < cur_n; ++i) {
      const int32_t* c = cur + 4 * i;
      uint64_t k = pack_key(c[0], floordiv(c[1], s) * s, floordiv(c[2], s) * s,
                            floordiv(c[3], s) * s);
      int32_t row = table.insert(k, static_cast<int32_t>(keys.size()));
      if (row == static_cast<int32_t>(keys.size())) keys.push_back(k);
    }
    // sorted-key order (grouped kernel maps rely on it)
    std::sort(keys.begin(), keys.end());
    int64_t m = static_cast<int64_t>(keys.size());
    if (m > caps[l]) m = caps[l];
    int32_t* out = level_coords[l];
    for (int64_t i = 0; i < m; ++i) {
      uint64_t k = keys[i];
      out[4 * i + 0] = static_cast<int32_t>(k >> (3 * kFieldBits));
      out[4 * i + 1] = static_cast<int32_t>(((k >> (2 * kFieldBits)) & 0xffff)) - kCoordOff;
      out[4 * i + 2] = static_cast<int32_t>(((k >> kFieldBits) & 0xffff)) - kCoordOff;
      out[4 * i + 3] = static_cast<int32_t>((k & 0xffff)) - kCoordOff;
    }
    level_nums[l] = static_cast<int32_t>(m);
    cur = out;
    cur_n = m;
  }
  return 0;
}

// Build one kernel map.
//   in_coords: (n_in, 4) valid rows of the input level.
//   out_coords: (n_out, 4) valid rows of the output level.
//   offsets: (k, 3) int32 query offsets (already scaled/negated by the
//     caller exactly as sparse/graph_host.py:_kernel_map does).
//   idx_out: (k, out_capacity) int32 preallocated, filled with -1 padding.
int lgs_kernel_map(const int32_t* in_coords, int64_t n_in,
                   const int32_t* out_coords, int64_t n_out,
                   const int32_t* offsets, int k, int64_t out_capacity,
                   int32_t* idx_out) {
  HashTable table(n_in > 0 ? n_in : 1);
  for (int64_t i = 0; i < n_in; ++i) {
    const int32_t* c = in_coords + 4 * i;
    table.insert(pack_key(c[0], c[1], c[2], c[3]), static_cast<int32_t>(i));
  }
  for (int kk = 0; kk < k; ++kk) {
    const int32_t ox = offsets[3 * kk], oy = offsets[3 * kk + 1], oz = offsets[3 * kk + 2];
    int32_t* row = idx_out + kk * out_capacity;
    for (int64_t i = 0; i < n_out; ++i) {
      const int32_t* c = out_coords + 4 * i;
      row[i] = table.find(pack_key(c[0], c[1] + ox, c[2] + oy, c[3] + oz));
    }
    for (int64_t i = n_out; i < out_capacity; ++i) row[i] = -1;
  }
  return 0;
}

// Composed sentinel remap of one kernel map (the expand_sentinels inner
// loop, sparse/graph_host.py): one pass instead of numpy's
// table-gather + concatenate + column-gather (3 full-map passes/copies).
//   idx_in:  (k, cap_out) int32 flat map; first n_out_old columns valid.
//   table:   input-row remap (len n_in_old), or NULL for identity;
//            entries < 0 in the map stay -1.
//   colmap:  output-column permutation (len cap_out; value n_out_old means
//            "no old column" -> -1), or NULL to remap columns in place
//            (idx_out may alias idx_in; columns >= n_out_old untouched).
int lgs_remap_map(const int32_t* idx_in, int32_t* idx_out, int k,
                  int64_t cap_out, int64_t n_out_old, const int32_t* table,
                  const int32_t* colmap) {
  for (int kk = 0; kk < k; ++kk) {
    const int32_t* src = idx_in + static_cast<int64_t>(kk) * cap_out;
    int32_t* dst = idx_out + static_cast<int64_t>(kk) * cap_out;
    if (colmap == nullptr) {
      for (int64_t j = 0; j < n_out_old; ++j) {
        int32_t v = src[j];
        dst[j] = (v < 0) ? -1 : table[v];
      }
    } else {
      for (int64_t j = 0; j < cap_out; ++j) {
        int32_t cm = colmap[j];
        if (cm >= n_out_old) {
          dst[j] = -1;
          continue;
        }
        int32_t v = src[cm];
        dst[j] = (v < 0) ? -1 : (table ? table[v] : v);
      }
    }
  }
  return 0;
}

// Deduplicate integer coords: writes indices of first occurrences (in
// input order) to keep_out, returns the count.
int64_t lgs_quantize(const int32_t* coords, int64_t n, int32_t* keep_out) {
  HashTable table(n > 0 ? n : 1);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = coords + 4 * i;
    uint64_t key = pack_key(c[0], c[1], c[2], c[3]);
    int32_t row = table.insert(key, static_cast<int32_t>(i));
    if (row == static_cast<int32_t>(i)) keep_out[m++] = static_cast<int32_t>(i);
  }
  return m;
}

}  // extern "C"
