// Native meshlet clustering — the C++ runtime component of the scene
// pipeline. Role parity: the reference links the C++ meshoptimizer
// library through Rust bindings (Cargo.toml `meshopt`) and calls
// build_meshlets / compute_meshlet_bounds (gpu_uploader.rs:577-608).
// This implements the same contract (max_vertices / max_triangles
// capacity clustering + bounding sphere / normal cone per meshlet) as a
// standalone C library exposed via ctypes (hala_tpu/native/__init__.py);
// ops/meshlets.py falls back to the Python implementation when the
// shared object has not been built.
//
// Build: cc -O2 -shared -fPIC -o libhala_native.so meshopt.cpp (see
// hala_tpu/native/__init__.py, which invokes this automatically).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

struct MeshletOut {
  float center[3];
  float radius;
  float cone_apex[3];
  float cone_cutoff;
  float cone_axis[3];
  int32_t num_vertices;
  int32_t offset_vertices;
  int32_t num_primitives;
  int32_t offset_primitives;
};

// Greedy scan-order clustering with vertex-budget lookahead.
// indices: (num_indices) u32, positions: (num_vertices, 3) f32.
// Outputs are written into caller-allocated arrays sized for the worst
// case (num_tris meshlets). Returns the number of meshlets produced.
int32_t hala_build_meshlets(
    const uint32_t* indices, int64_t num_indices,
    const float* positions, int64_t num_vertices,
    int32_t max_vertices, int32_t max_triangles,
    MeshletOut* meshlets_out,
    uint32_t* meshlet_vertices_out,   // worst case num_indices
    uint32_t* meshlet_primitives_out  // packed 3 x u8 per tri
) {
  (void)num_vertices;
  const int64_t num_tris = num_indices / 3;
  int32_t n_meshlets = 0;
  int64_t v_off = 0, p_off = 0;

  std::unordered_map<uint32_t, uint8_t> local;  // global -> local vertex
  std::vector<uint32_t> tri_buf;
  tri_buf.reserve(max_triangles * 3);

  auto flush = [&]() {
    if (tri_buf.empty()) return;
    MeshletOut& m = meshlets_out[n_meshlets];

    // Bounding sphere (center of AABB; radius = max distance).
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    std::vector<uint32_t> verts(local.size());
    for (auto& kv : local) verts[kv.second] = kv.first;
    for (uint32_t g : verts) {
      for (int a = 0; a < 3; ++a) {
        float p = positions[g * 3 + a];
        if (p < mn[a]) mn[a] = p;
        if (p > mx[a]) mx[a] = p;
      }
    }
    float r2 = 0.f;
    for (int a = 0; a < 3; ++a) m.center[a] = 0.5f * (mn[a] + mx[a]);
    for (uint32_t g : verts) {
      float d2 = 0.f;
      for (int a = 0; a < 3; ++a) {
        float dd = positions[g * 3 + a] - m.center[a];
        d2 += dd * dd;
      }
      if (d2 > r2) r2 = d2;
    }
    m.radius = std::sqrt(r2);

    // Normal cone: average face normal; cutoff from the worst deviation.
    float axis[3] = {0, 0, 0};
    std::vector<float> normals(tri_buf.size());  // 3 per tri
    for (size_t t = 0; t < tri_buf.size() / 3; ++t) {
      const float* a = positions + tri_buf[t * 3 + 0] * 3;
      const float* b = positions + tri_buf[t * 3 + 1] * 3;
      const float* c = positions + tri_buf[t * 3 + 2] * 3;
      float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                    e1[2] * e2[0] - e1[0] * e2[2],
                    e1[0] * e2[1] - e1[1] * e2[0]};
      float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
      for (int k = 0; k < 3; ++k) {
        float nk = len > 0 ? n[k] / len : 0.f;
        normals[t * 3 + k] = nk;
        axis[k] += nk;
      }
    }
    float alen = std::sqrt(axis[0] * axis[0] + axis[1] * axis[1] +
                           axis[2] * axis[2]);
    if (alen > 0)
      for (float& a : axis) a /= alen;
    else
      axis[2] = 1.f;
    float mindp = 1.f;
    for (size_t t = 0; t < tri_buf.size() / 3; ++t) {
      float dp = normals[t * 3] * axis[0] + normals[t * 3 + 1] * axis[1] +
                 normals[t * 3 + 2] * axis[2];
      if (dp < mindp) mindp = dp;
    }
    for (int k = 0; k < 3; ++k) {
      m.cone_axis[k] = axis[k];
      m.cone_apex[k] = m.center[k];
    }
    m.cone_cutoff =
        mindp > 0.f ? std::sqrt(std::fmax(0.f, 1.f - mindp * mindp)) : 1.f;

    // Emit vertex + packed primitive streams.
    m.num_vertices = (int32_t)verts.size();
    m.offset_vertices = (int32_t)v_off;
    m.num_primitives = (int32_t)(tri_buf.size() / 3);
    m.offset_primitives = (int32_t)p_off;
    for (uint32_t g : verts) meshlet_vertices_out[v_off++] = g;
    for (size_t t = 0; t < tri_buf.size() / 3; ++t) {
      uint32_t a = local[tri_buf[t * 3 + 0]];
      uint32_t b = local[tri_buf[t * 3 + 1]];
      uint32_t c = local[tri_buf[t * 3 + 2]];
      meshlet_primitives_out[p_off++] = a | (b << 8) | (c << 16);
    }
    ++n_meshlets;
    local.clear();
    tri_buf.clear();
  };

  for (int64_t t = 0; t < num_tris; ++t) {
    const uint32_t a = indices[t * 3], b = indices[t * 3 + 1],
                   c = indices[t * 3 + 2];
    int fresh = (local.find(a) == local.end()) +
                (local.find(b) == local.end()) +
                (local.find(c) == local.end());
    if ((int32_t)local.size() + fresh > max_vertices ||
        (int32_t)tri_buf.size() / 3 + 1 > max_triangles) {
      flush();
    }
    for (uint32_t g : {a, b, c}) {
      if (local.find(g) == local.end())
        local.emplace(g, (uint8_t)local.size());
    }
    tri_buf.push_back(a);
    tri_buf.push_back(b);
    tri_buf.push_back(c);
  }
  flush();
  return n_meshlets;
}

// Morton-3D encode (10 bits/axis) for host-side cluster ordering — the
// native counterpart of ops/morton.py morton3d_np for big scenes.
static inline uint32_t expand_bits(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

void hala_morton3d(const float* points, int64_t n, const float* bmin,
                   const float* bmax, uint32_t* codes_out) {
  float ext[3];
  for (int a = 0; a < 3; ++a) {
    ext[a] = bmax[a] - bmin[a];
    if (ext[a] < 1e-9f) ext[a] = 1e-9f;
  }
  for (int64_t i = 0; i < n; ++i) {
    uint32_t cell[3];
    for (int a = 0; a < 3; ++a) {
      float q = (points[i * 3 + a] - bmin[a]) / ext[a];
      if (q < 0.f) q = 0.f;
      if (q > 0.9999999f) q = 0.9999999f;
      cell[a] = (uint32_t)(q * 1024.f);
    }
    codes_out[i] = (expand_bits(cell[0]) << 2) | (expand_bits(cell[1]) << 1) |
                   expand_bits(cell[2]);
  }
}

// Binned-SAH leaf partition — the native counterpart of
// ops/sahbuild.sah_leaves (same split rule: longest centroid axis,
// `bins` equal-width bins, argmin of the area*count cost with cost
// accumulated in double exactly like numpy promotes f32*int64).
// Outputs: leaf_sizes (<= n entries) and the concatenated leaf
// triangle indices in DFS near-child-first order (out_order, n
// entries). Returns the leaf count. Python assembles the padded slot
// map; ops/sahbuild.py falls back to numpy when the .so is absent.
int64_t hala_sah_slots(
    const float* t_lo, const float* t_hi, int64_t n,
    int32_t leaf_size, int32_t bins,
    int64_t* out_order, int32_t* out_leaf_sizes) {
  // suffix-sweep buffers below are sized for bins <= 48; reject larger
  // requests here rather than relying on the Python-side guard (any
  // other caller of the exported symbol would overflow the stack).
  if (bins > 48 || bins < 2) return -1;
  std::vector<float> cent(n * 3);
  for (int64_t i = 0; i < n * 3; ++i)
    cent[i] = 0.5f * (t_lo[i] + t_hi[i]);

  std::vector<std::vector<int64_t>> stack;
  {
    std::vector<int64_t> all(n);
    for (int64_t i = 0; i < n; ++i) all[i] = i;
    stack.push_back(std::move(all));
  }
  int64_t n_leaves = 0, write = 0;
  std::vector<float> bin_lo(bins * 3), bin_hi(bins * 3);
  std::vector<int64_t> cnt(bins);
  while (!stack.empty()) {
    std::vector<int64_t> s = std::move(stack.back());
    stack.pop_back();
    const int64_t m = (int64_t)s.size();
    if (m <= leaf_size) {
      out_leaf_sizes[n_leaves++] = (int32_t)m;
      for (int64_t i = 0; i < m; ++i) out_order[write++] = s[i];
      continue;
    }
    float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = 0; i < m; ++i)
      for (int a = 0; a < 3; ++a) {
        float c = cent[s[i] * 3 + a];
        if (c < lo[a]) lo[a] = c;
        if (c > hi[a]) hi[a] = c;
      }
    int ax = 0;
    float ext = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > ext) { ext = hi[a] - lo[a]; ax = a; }
    auto halve = [&](bool by_centroid) {
      int64_t k = m / 2;
      std::vector<int64_t> left(s.begin(), s.begin() + k);
      std::vector<int64_t> right(s.begin() + k, s.end());
      if (by_centroid) {
        std::nth_element(
            s.begin(), s.begin() + k, s.end(),
            [&](int64_t a_, int64_t b_) {
              return cent[a_ * 3 + ax] < cent[b_ * 3 + ax];
            });
        left.assign(s.begin(), s.begin() + k);
        right.assign(s.begin() + k, s.end());
      }
      stack.push_back(std::move(right));
      stack.push_back(std::move(left));
    };
    if (!(ext > 0.f)) { halve(false); continue; }
    const float scale = (float)bins / ext;
    for (int b = 0; b < bins; ++b) {
      cnt[b] = 0;
      for (int a = 0; a < 3; ++a) {
        bin_lo[b * 3 + a] = 3e38f;
        bin_hi[b * 3 + a] = -3e38f;
      }
    }
    std::vector<int32_t> bidx(m);
    for (int64_t i = 0; i < m; ++i) {
      int64_t bi = (int64_t)((cent[s[i] * 3 + ax] - lo[ax]) * scale);
      if (bi < 0) bi = 0;
      if (bi > bins - 1) bi = bins - 1;
      bidx[i] = (int32_t)bi;
      ++cnt[bi];
      for (int a = 0; a < 3; ++a) {
        float vlo = t_lo[s[i] * 3 + a], vhi = t_hi[s[i] * 3 + a];
        if (vlo < bin_lo[bi * 3 + a]) bin_lo[bi * 3 + a] = vlo;
        if (vhi > bin_hi[bi * 3 + a]) bin_hi[bi * 3 + a] = vhi;
      }
    }
    auto area = [](const float* alo, const float* ahi) {
      float e[3];
      for (int a = 0; a < 3; ++a) {
        e[a] = ahi[a] - alo[a];
        if (e[a] < 0.f) e[a] = 0.f;
      }
      return e[0] * e[1] + e[1] * e[2] + e[2] * e[0];
    };
    double best_cost = 1e300;
    int best_cut = -1;
    float pre_lo[3], pre_hi[3], suf_lo[48 * 3], suf_hi[48 * 3];
    // suffix sweep (bins <= 48 supported; BINS default is 16)
    for (int a = 0; a < 3; ++a) {
      suf_lo[(bins - 1) * 3 + a] = bin_lo[(bins - 1) * 3 + a];
      suf_hi[(bins - 1) * 3 + a] = bin_hi[(bins - 1) * 3 + a];
    }
    for (int b = bins - 2; b >= 0; --b)
      for (int a = 0; a < 3; ++a) {
        suf_lo[b * 3 + a] =
            bin_lo[b * 3 + a] < suf_lo[(b + 1) * 3 + a]
                ? bin_lo[b * 3 + a] : suf_lo[(b + 1) * 3 + a];
        suf_hi[b * 3 + a] =
            bin_hi[b * 3 + a] > suf_hi[(b + 1) * 3 + a]
                ? bin_hi[b * 3 + a] : suf_hi[(b + 1) * 3 + a];
      }
    for (int a = 0; a < 3; ++a) {
      pre_lo[a] = 3e38f;
      pre_hi[a] = -3e38f;
    }
    int64_t n_left = 0;
    for (int cut = 1; cut < bins; ++cut) {
      const int b = cut - 1;
      for (int a = 0; a < 3; ++a) {
        if (bin_lo[b * 3 + a] < pre_lo[a]) pre_lo[a] = bin_lo[b * 3 + a];
        if (bin_hi[b * 3 + a] > pre_hi[a]) pre_hi[a] = bin_hi[b * 3 + a];
      }
      n_left += cnt[b];
      const int64_t n_right = m - n_left;
      if (n_left == 0 || n_right == 0) continue;
      double cost = (double)area(pre_lo, pre_hi) * (double)n_left +
                    (double)area(&suf_lo[cut * 3], &suf_hi[cut * 3]) *
                        (double)n_right;
      if (cost < best_cost) {
        best_cost = cost;
        best_cut = cut;
      }
    }
    if (best_cut < 0) { halve(true); continue; }
    std::vector<int64_t> left, right;
    left.reserve(m);
    right.reserve(m);
    for (int64_t i = 0; i < m; ++i)
      (bidx[i] < best_cut ? left : right).push_back(s[i]);
    stack.push_back(std::move(right));
    stack.push_back(std::move(left));
  }
  return n_leaves;
}

}  // extern "C"

