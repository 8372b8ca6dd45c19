// Native mesh-preprocessing kernels for the TPU FR solver.
//
// Copied from hifiles_tpu/native/mesh_kernels.cc (lines 1-223) for
// hifiles_tpu_torch, which imports nothing of hifiles_tpu; host code only.
//
// Replaces the reference's C++ geometry layer (ref:src/mesh.cpp:375-485
// set_face_connectivity, ref:src/geometry.cpp CompConectivity) with three
// flat-array kernels called from Python via ctypes:
//   hf_build_faces   -- hash-match interior faces + orientation tags
//   hf_match_fpts    -- batched geometric flux-point matching
//   hf_partition     -- greedy-BFS balanced mesh partitioner (the
//                       reference shells out to ParMETIS,
//                       ref:src/geometry.cpp:1040-1200)
//
// All interfaces are plain C ABI over int64/double buffers allocated by the
// caller; no ownership crosses the boundary.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <queue>
#include <array>
#include <algorithm>

namespace {

struct FaceKey {
  std::array<int64_t, 4> v;  // sorted corner vertex ids, -1 padded
  bool operator==(const FaceKey& o) const { return v == o.v; }
};

struct FaceKeyHash {
  size_t operator()(const FaceKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (int64_t x : k.v) {
      h ^= static_cast<uint64_t>(x) + 0x9e3779b97f4a7c15ull;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

// Orientation tag of face b relative to face a (same vertex multiset),
// mirroring mesh/core.py _compare_faces (ref:src/mesh.cpp:853-952).
int rot_tag(const int64_t* a, const int64_t* b, int nv) {
  if (nv == 2) {
    if ((a[0] == b[0] && a[1] == b[1]) || (a[0] == b[1] && a[1] == b[0]))
      return 0;
    return -1;
  }
  static const int perms3[3][3] = {{0, 2, 1}, {2, 1, 0}, {1, 0, 2}};
  static const int perms4[4][4] = {
      {1, 0, 3, 2}, {3, 2, 1, 0}, {0, 3, 2, 1}, {2, 1, 0, 3}};
  if (nv == 3) {
    for (int t = 0; t < 3; ++t) {
      bool ok = true;
      for (int i = 0; i < 3 && ok; ++i) ok = a[i] == b[perms3[t][i]];
      if (ok) return t;
    }
    return -1;
  }
  if (nv == 4) {
    for (int t = 0; t < 4; ++t) {
      bool ok = true;
      for (int i = 0; i < 4 && ok; ++i) ok = a[i] == b[perms4[t][i]];
      if (ok) return t;
    }
    return -1;
  }
  return -1;
}

}  // namespace

extern "C" {

// Interior-face hashing.  Inputs: n_f candidate faces as flat rows
// (cell, locf, nv, v0..v3 with -1 padding).  Outputs: int_out rows
// (l, kl, r, kr, rtag, nv) and unmatched row indices.  Returns 0 on
// success, 1 on an orientation mismatch (vertices shared, no perm).
int hf_build_faces(int64_t n_f, const int64_t* face_cell,
                   const int64_t* face_locf, const int64_t* face_nv,
                   const int64_t* face_verts /* (n_f, 4) */,
                   int64_t* int_out /* (n_f/2+1, 6) */, int64_t* n_int,
                   int64_t* unmatched /* (n_f,) */, int64_t* n_unmatched) {
  std::unordered_map<FaceKey, int64_t, FaceKeyHash> open;
  open.reserve(static_cast<size_t>(n_f));
  int64_t ni = 0;
  for (int64_t r = 0; r < n_f; ++r) {
    FaceKey key;
    for (int i = 0; i < 4; ++i) key.v[i] = face_verts[4 * r + i];
    std::sort(key.v.begin(), key.v.end());
    auto it = open.find(key);
    if (it == open.end()) {
      open.emplace(key, r);
      continue;
    }
    int64_t r0 = it->second;
    open.erase(it);
    int tag = rot_tag(face_verts + 4 * r0, face_verts + 4 * r,
                      static_cast<int>(face_nv[r]));
    if (tag < 0) return 1;
    int64_t* row = int_out + 6 * ni++;
    row[0] = face_cell[r0];
    row[1] = face_locf[r0];
    row[2] = face_cell[r];
    row[3] = face_locf[r];
    row[4] = tag;
    row[5] = face_nv[r];
  }
  *n_int = ni;
  int64_t nu = 0;
  for (const auto& kv : open) unmatched[nu++] = kv.second;
  std::sort(unmatched, unmatched + nu);
  *n_unmatched = nu;
  return 0;
}

// Batched centroid-relative flux-point matching (mesh/elements.py
// match_fpts; replaces the reference's rotation-tag luts,
// ref:src/inters.cpp:153-262).  pos_l/pos_r: (n_face, nfp, nd).
// perm out: (n_face, nfp) with pos_r[f, perm[f,j]] == pos_l[f,j].
// Returns the index of the first failing face, or -1 on success.
int64_t hf_match_fpts(int64_t n_face, int64_t nfp, int64_t nd,
                      const double* pos_l, const double* pos_r, double tol,
                      int64_t* perm) {
  std::vector<double> a(nfp * nd), b(nfp * nd);
  std::vector<char> taken(nfp);
  for (int64_t f = 0; f < n_face; ++f) {
    const double* pl = pos_l + f * nfp * nd;
    const double* pr = pos_r + f * nfp * nd;
    double cl[3] = {0, 0, 0}, cr[3] = {0, 0, 0};
    for (int64_t j = 0; j < nfp; ++j)
      for (int64_t m = 0; m < nd; ++m) {
        cl[m] += pl[j * nd + m];
        cr[m] += pr[j * nd + m];
      }
    double scale = 1e-30;
    for (int64_t j = 0; j < nfp; ++j)
      for (int64_t m = 0; m < nd; ++m) {
        a[j * nd + m] = pl[j * nd + m] - cl[m] / nfp;
        b[j * nd + m] = pr[j * nd + m] - cr[m] / nfp;
        scale = std::max(scale, std::fabs(a[j * nd + m]));
      }
    const double lim = tol * std::max(1.0, scale);
    std::fill(taken.begin(), taken.end(), 0);
    for (int64_t j = 0; j < nfp; ++j) {
      double best = 1e300;
      int64_t arg = -1;
      for (int64_t k = 0; k < nfp; ++k) {
        double d2 = 0;
        for (int64_t m = 0; m < nd; ++m) {
          double d = a[j * nd + m] - b[k * nd + m];
          d2 += d * d;
        }
        if (d2 < best) {
          best = d2;
          arg = k;
        }
      }
      if (arg < 0 || taken[arg] || std::sqrt(best) > lim) return f;
      taken[arg] = 1;
      perm[f * nfp + j] = arg;
    }
  }
  return -1;
}

// Greedy max-gain balanced partitioner over the element adjacency graph
// (CSR xadj/adjncy).  Grows each part from a peripheral seed, always
// absorbing the frontier cell with the MOST neighbours already in the
// current part (Farhat's greedy algorithm) via a lazy max-heap — compact,
// low-cut parts with EXACT target sizes; the TPU mesh requires equal shard
// extents (the reference uses ParMETIS for the same job,
// ref:src/geometry.cpp:1040-1200).
void hf_partition(int64_t n_cells, const int64_t* xadj, const int64_t* adjncy,
                  int64_t n_parts, int64_t* part) {
  std::fill(part, part + n_cells, int64_t{-1});
  std::vector<int32_t> gain(n_cells);
  int64_t base = n_cells / n_parts, extra = n_cells % n_parts;
  for (int64_t p = 0; p < n_parts; ++p) {
    int64_t target = base + (p < extra ? 1 : 0);
    int64_t filled = 0;
    std::fill(gain.begin(), gain.end(), 0);
    // (gain, cell) lazy max-heap; stale entries skipped on pop
    std::priority_queue<std::pair<int32_t, int64_t>> heap;
    auto absorb = [&](int64_t c) {
      part[c] = p;
      ++filled;
      for (int64_t e = xadj[c]; e < xadj[c + 1]; ++e) {
        int64_t nb = adjncy[e];
        if (part[nb] == -1) heap.emplace(++gain[nb], nb);
      }
    };
    while (filled < target) {
      int64_t pick = -1;
      while (!heap.empty()) {
        auto [g, c] = heap.top();
        heap.pop();
        if (part[c] == -1 && gain[c] == g) {
          pick = c;
          break;
        }
      }
      if (pick < 0) {
        // peripheral seed: fewest unassigned neighbours
        int64_t best = INT64_MAX;
        for (int64_t c = 0; c < n_cells; ++c) {
          if (part[c] != -1) continue;
          int64_t deg = 0;
          for (int64_t e = xadj[c]; e < xadj[c + 1]; ++e)
            if (part[adjncy[e]] == -1) ++deg;
          if (deg < best) {
            best = deg;
            pick = c;
          }
        }
      }
      absorb(pick);
    }
  }
}

}  // extern "C"
