// Native fused-map builder: emits MaskedShiftMap arrays for stride-1 k3
// maps directly from hash probes — no (27, cap) flat table, no numpy
// fusion passes. This is the production loader's hot path: the per-batch
// host graph build bounds end-to-end throughput on a 1-CPU host
// (PERF.md round 4), and the reference hides the analogous cost inside
// MinkowskiEngine's GPU kernel-map build + DataLoader workers
// (reference main.py, ME coordinate manager).
//
// The numpy path (sparse/graph_host.py:_try_masked_shift_map et al.) is
// the correctness oracle; tests assert array-exact equality. Algorithms
// here mirror it step for step:
//   pass 1  lgs_k3_analyze  — per (row, column) dz probes, sentinel demand
//           collection (graph_host.py:_sentinel_plan semantics)
//   pass 2  lgs_k3_emit     — expanded-layout anchors + masks + far-COO
//           (graph_host.py:_try_masked_shift_map anchor rules)
//   pass 3  lgs_k3_windows  — median-centered per-(tile, column) windows
//           over anchors and their inverse tiling, menu trial order and
//           budgets identical to graph_host.py:_percol_windows/_WINDOW_MENU
//
// Compiled into libgraph_builder.so together with graph_builder.cpp
// (sparse/graph_native.py).

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

// Open-addressing hash (same scheme as graph_builder.cpp).
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

  inline void insert(uint64_t key, int32_t row) {
    uint64_t h = hash(key) & mask;
    while (keys[h] != ~0ull) {
      if (keys[h] == key) return;
      h = (h + 1) & mask;
    }
    keys[h] = key;
    vals[h] = row;
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

void sort_unique(std::vector<int64_t>& v) {
  std::sort(v.begin(), v.end());
  v.erase(std::unique(v.begin(), v.end()), v.end());
}

}  // namespace

extern "C" {

// Pass 1: per-column dz probes + sentinel demand plan for one level's
// stride-1 k3 map. coords (n, 4) int32 sorted by packed key; zs = level
// stride; coldxdy (8, 2) raw column offsets in ascending layout order
// (graph_host.py:_k3_column_layout), scaled by zs here.
//
// Per (row i, column g) outcome -> flags[g * n + i]:
//   0 none (guard), 1 direct (dz=0 exists, anchors_old = its row),
//   2 combined (dz=-1 and dz=+1 only; anchors_old = a),
//   3 bottom (dz=-1 only; anchors_old = a),
//   4 top (dz=+1 only; anchors_old = c - 1).
// mpz/mnz: center-column dz -/+ presence per row (physical adjacency of
// sorted keys — no probe needed).
// Demands (graph_host.py:_sentinel_plan): deduped boundary inserts,
// sorted by (pos, kind-rank bottom-before-top); returns the count, or
// -1 on a plan conflict (combined boundary also has a one-sided demand,
// or a combined pair is not physically adjacent) — caller falls back to
// the numpy path.
int64_t lgs_k3_analyze(const int32_t* coords, int64_t n, int32_t zs,
                       const int32_t* coldxdy, int32_t* anchors_old,
                       uint8_t* flags, uint8_t* mpz, uint8_t* mnz,
                       int32_t* ins_pos, uint8_t* ins_mp, uint8_t* ins_mn,
                       int64_t max_dem) {
  HashTable table(n > 0 ? n : 1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = coords + 4 * i;
    table.insert(pack_key(c[0], c[1], c[2], c[3]), static_cast<int32_t>(i));
  }
  // center column adjacency: prev/next physical row is the z-/+ neighbor
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = coords + 4 * i;
    mpz[i] = 0;
    mnz[i] = 0;
    if (i > 0) {
      const int32_t* p = coords + 4 * (i - 1);
      mpz[i] = (p[0] == c[0] && p[1] == c[1] && p[2] == c[2] &&
                p[3] == c[3] - zs);
    }
    if (i + 1 < n) {
      const int32_t* q = coords + 4 * (i + 1);
      mnz[i] = (q[0] == c[0] && q[1] == c[1] && q[2] == c[2] &&
                q[3] == c[3] + zs);
    }
  }

  std::vector<int64_t> both, bot, top;
  for (int g = 0; g < 8; ++g) {
    const int32_t dx = coldxdy[2 * g] * zs, dy = coldxdy[2 * g + 1] * zs;
    int32_t* arow = anchors_old + g * n;
    uint8_t* frow = flags + g * n;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t* c = coords + 4 * i;
      const int32_t x = c[1] + dx, y = c[2] + dy;
      int32_t b0 = table.find(pack_key(c[0], x, y, c[3]));
      if (b0 >= 0) {
        arow[i] = b0;
        frow[i] = 1;
        continue;
      }
      int32_t a = table.find(pack_key(c[0], x, y, c[3] - zs));
      int32_t cc = table.find(pack_key(c[0], x, y, c[3] + zs));
      if (a >= 0 && cc >= 0) {
        if (cc != a + 1) return -1;  // size-1 hole rows must be adjacent
        arow[i] = a;
        frow[i] = 2;
        both.push_back(a);
      } else if (a >= 0) {
        arow[i] = a;
        frow[i] = 3;
        bot.push_back(a);
      } else if (cc >= 0) {
        arow[i] = cc - 1;
        frow[i] = 4;
        top.push_back(cc - 1);
      } else {
        arow[i] = -1;
        frow[i] = 0;
      }
    }
  }

  sort_unique(both);
  sort_unique(bot);
  sort_unique(top);
  // combined boundaries must host no one-sided demand (_sentinel_plan)
  for (int64_t p : both) {
    if (std::binary_search(bot.begin(), bot.end(), p) ||
        std::binary_search(top.begin(), top.end(), p))
      return -1;
  }
  // merge sorted by (pos, rank): both/bottom rank 0, top rank 1
  struct Dem {
    int64_t pos;
    uint8_t rank, mp, mn;
  };
  std::vector<Dem> dems;
  dems.reserve(both.size() + bot.size() + top.size());
  for (int64_t p : both) dems.push_back({p, 0, 1, 1});
  for (int64_t p : bot) dems.push_back({p, 0, 1, 0});
  for (int64_t p : top) dems.push_back({p, 1, 0, 1});
  std::sort(dems.begin(), dems.end(), [](const Dem& a, const Dem& b) {
    return a.pos != b.pos ? a.pos < b.pos : a.rank < b.rank;
  });
  if (static_cast<int64_t>(dems.size()) > max_dem) return -1;
  for (size_t j = 0; j < dems.size(); ++j) {
    ins_pos[j] = static_cast<int32_t>(dems[j].pos);
    ins_mp[j] = dems[j].mp;
    ins_mn[j] = dems[j].mn;
  }
  return static_cast<int64_t>(dems.size());
}

// Pass 2: expanded-layout anchors + masks + far-overflow routing.
// new_pos (n): expanded row of each old row; sent_rows/mp/mn (n_sent):
// sentinel rows and their masks. Anchor rules per flag (mirrors
// _try_masked_shift_map): direct -> new_pos[b0]; combined/bottom ->
// new_pos[a] + 1 (the boundary's bottom/combined sentinel); top ->
// new_pos[p + 1] - 1 (the row before c). Entries with
// |anchor - out| > margin go to the (col, out, in) COO and are guarded
// (graph_host.py GWIN_MARGIN routing). Returns the COO count or -1 when
// it exceeds max_ov (pathological: caller falls back).
int64_t lgs_k3_emit(const int32_t* anchors_old, const uint8_t* flags,
                    const uint8_t* mpz, const uint8_t* mnz, int64_t n,
                    const int32_t* new_pos, const int32_t* sent_rows,
                    const uint8_t* sent_mp, const uint8_t* sent_mn,
                    int64_t n_sent, int64_t cap, int32_t margin,
                    int32_t* anchors_abs, uint8_t* mp, uint8_t* mn,
                    uint8_t* mc, int32_t* ov_cols, int32_t* ov_outs,
                    int32_t* ov_ins, int64_t max_ov) {
  std::fill(mp, mp + cap, uint8_t{0});
  std::fill(mn, mn + cap, uint8_t{0});
  std::fill(mc, mc + cap, uint8_t{0});
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = new_pos[i];
    mp[r] = mpz[i];
    mn[r] = mnz[i];
    mc[r] = 1;
  }
  for (int64_t j = 0; j < n_sent; ++j) {
    const int64_t s = sent_rows[j];
    mp[s] = sent_mp[j];
    mn[s] = sent_mn[j];
  }

  int64_t n_ov = 0;
  const int32_t guard = static_cast<int32_t>(cap);
  for (int g = 0; g < 8; ++g) {
    const int32_t* arow = anchors_old + g * n;
    const uint8_t* frow = flags + g * n;
    int32_t* out = anchors_abs + g * cap;
    std::fill(out, out + cap, guard);
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t f = frow[i];
      if (f == 0) continue;
      int32_t t;
      if (f == 1)
        t = new_pos[arow[i]];
      else if (f == 4)
        t = new_pos[arow[i] + 1] - 1;
      else
        t = new_pos[arow[i]] + 1;
      const int64_t r = new_pos[i];
      const int64_t d = static_cast<int64_t>(t) - r;
      if (d > margin || d < -static_cast<int64_t>(margin)) {
        if (n_ov >= max_ov) return -1;
        ov_cols[n_ov] = g;
        ov_outs[n_ov] = static_cast<int32_t>(r);
        ov_ins[n_ov] = t;
        ++n_ov;
      } else {
        out[r] = t;
      }
    }
  }
  return n_ov;
}

namespace {

// Lower median of valid (< cap) anchors per (column, tile); empty tiles
// get the proportional default ti * tile (graph_host.py:_percol_windows).
void tile_medians(const int32_t* anchors, int64_t cap, int64_t tile,
                  int64_t cap_guard, std::vector<int64_t>& med) {
  const int64_t n_tiles = cap / tile;
  med.assign(8 * n_tiles, 0);
  std::vector<int32_t> buf(tile);
  for (int g = 0; g < 8; ++g) {
    const int32_t* arow = anchors + g * cap;
    for (int64_t t = 0; t < n_tiles; ++t) {
      int64_t cnt = 0;
      const int32_t* seg = arow + t * tile;
      for (int64_t j = 0; j < tile; ++j)
        if (seg[j] < cap_guard) buf[cnt++] = seg[j];
      int64_t m;
      if (cnt == 0) {
        m = t * tile;  // default: cap_in == cap here, factor 1
      } else {
        int64_t k = (cnt - 1) / 2;
        std::nth_element(buf.begin(), buf.begin() + k, buf.begin() + cnt);
        m = buf[k];
      }
      med[g * n_tiles + t] = m;
    }
  }
}

inline int64_t window_start(int64_t med, int64_t win, int64_t cap) {
  int64_t w0 = med - win / 2;
  if (w0 < 0) w0 = 0;
  if (w0 > cap - win) w0 = cap - win;
  return w0 & ~int64_t{7};
}

}  // namespace

// Pass 3: selector-kernel window annotation. Tries the same (tile, win)
// menu in the same order as graph_host.py:_WINDOW_MENU over both the
// forward anchors and their inverse tiling; first config whose
// out-of-window counts fit the budget wins. Routes forward misses into
// the ov COO (guarding anchors_abs) and inverse misses into the dW COO.
// Outputs: wstart/inv_wstart tile-major (tile * 8 + col). Returns the
// chosen menu index, or -1 when none fits (no window annotation — the
// gather paths still serve the conv).
int lgs_k3_windows(int32_t* anchors_abs, int64_t cap, int64_t n_far,
                   int64_t ov_budget, const int32_t* menu_t,
                   const int32_t* menu_w, int n_menu, int32_t* wstart,
                   int32_t* inv_wstart, int32_t* ovf_cols, int32_t* ovf_outs,
                   int32_t* ovf_ins, int64_t* n_ovf, int32_t* dw_cols,
                   int32_t* dw_outs, int32_t* dw_ins, int64_t* n_dw,
                   int64_t max_ov) {
  *n_ovf = 0;
  *n_dw = 0;
  // inverse tiling over the COMPLETE pair set: far-routed pairs included
  // (they were guarded in anchors_abs but their (col, out, in) is in the
  // caller's far COO; the numpy oracle builds inv before far routing, so
  // restore them here from that COO)
  std::vector<int32_t> inv(8 * cap, static_cast<int32_t>(cap));
  for (int g = 0; g < 8; ++g) {
    const int32_t* arow = anchors_abs + g * cap;
    int32_t* irow = inv.data() + g * cap;
    for (int64_t o = 0; o < cap; ++o) {
      const int32_t a = arow[o];
      if (a < cap) irow[a] = static_cast<int32_t>(o);
    }
  }
  for (int64_t j = 0; j < n_far; ++j)
    inv[static_cast<int64_t>(ovf_cols[j]) * cap + ovf_ins[j]] = ovf_outs[j];

  std::vector<int64_t> med_f, med_i;
  int64_t cached_tile = -1;
  for (int mi = 0; mi < n_menu; ++mi) {
    const int64_t t = menu_t[mi], w = menu_w[mi];
    if (cap % t || cap < (2 * t > w ? 2 * t : w)) continue;
    if (t != cached_tile) {
      tile_medians(anchors_abs, cap, t, cap, med_f);
      tile_medians(inv.data(), cap, t, cap, med_i);
      cached_tile = t;
    }
    const int64_t n_tiles = cap / t;
    int64_t bad_f = 0, bad_i = 0;
    for (int g = 0; g < 8 && bad_i <= ov_budget; ++g) {
      const int32_t* arow = anchors_abs + g * cap;
      const int32_t* irow = inv.data() + g * cap;
      for (int64_t ti = 0; ti < n_tiles; ++ti) {
        const int64_t wf = window_start(med_f[g * n_tiles + ti], w, cap);
        const int64_t wi = window_start(med_i[g * n_tiles + ti], w, cap);
        const int64_t base = ti * t;
        for (int64_t j = 0; j < t; ++j) {
          const int32_t a = arow[base + j];
          bad_f += (a < cap) & ((a < wf) | (a >= wf + w));
          const int32_t v = irow[base + j];
          bad_i += (v < cap) & ((v < wi) | (v >= wi + w));
        }
      }
    }
    if (n_far + bad_f > ov_budget || bad_i > ov_budget) continue;
    if (bad_f > max_ov - n_far || bad_i > max_ov) continue;
    // accept: fill starts, route misses
    for (int g = 0; g < 8; ++g) {
      int32_t* arow = anchors_abs + g * cap;
      const int32_t* irow = inv.data() + g * cap;
      for (int64_t ti = 0; ti < n_tiles; ++ti) {
        const int64_t wf = window_start(med_f[g * n_tiles + ti], w, cap);
        const int64_t wi = window_start(med_i[g * n_tiles + ti], w, cap);
        wstart[ti * 8 + g] = static_cast<int32_t>(wf);
        inv_wstart[ti * 8 + g] = static_cast<int32_t>(wi);
        const int64_t base = ti * t;
        for (int64_t j = 0; j < t; ++j) {
          const int64_t o = base + j;
          const int32_t a = arow[o];
          if (a < cap && (a < wf || a >= wf + w)) {
            ovf_cols[n_far + *n_ovf] = g;
            ovf_outs[n_far + *n_ovf] = static_cast<int32_t>(o);
            ovf_ins[n_far + *n_ovf] = a;
            ++*n_ovf;
            arow[o] = static_cast<int32_t>(cap);
          }
          const int32_t v = irow[o];
          if (v < cap && (v < wi || v >= wi + w)) {
            dw_cols[*n_dw] = g;
            dw_outs[*n_dw] = static_cast<int32_t>(o);  // T3 row (anchor r)
            dw_ins[*n_dw] = v;                         // gradient row o
            ++*n_dw;
          }
        }
      }
    }
    return mi;
  }
  return -1;
}

// Delta-encode anchors to the int16 wire format (graph_host.py
// production encoding): kept anchors satisfy |a - o| <= margin after the
// routing above, guard (== cap) -> -32768.
int lgs_delta_encode(const int32_t* anchors_abs, int64_t cap,
                     int16_t* out) {
  for (int g = 0; g < 8; ++g) {
    const int32_t* arow = anchors_abs + g * cap;
    int16_t* orow = out + g * cap;
    for (int64_t o = 0; o < cap; ++o) {
      const int32_t a = arow[o];
      orow[o] = (a >= cap) ? int16_t{-32768}
                           : static_cast<int16_t>(static_cast<int64_t>(a) - o);
    }
  }
  return 0;
}

}  // extern "C"
