// Device code shared by the grouped walk (grouped_walk.cu) and the
// wavefront walk (wavefront_walk.cu): the test of one 128-ray group
// against one cluster's 128 triangle slots by the factored
// Moller-Trumbore of the JAX package's `_mm_chunk_test`
// (hala_tpu/ops/traverse.py), restricted to the 16-slot spans each ray
// enters, and the lexicographic (t, slot) merge.
//
// The four determinants are dot products of per-ray features against
// per-triangle coefficients, both re-centred on the cluster's AABB
// centre cc = 0.5 * (cmin + cmax) for conditioning:
//
//   v0' = v0 - cc, n = e1 x e2, c0 = v0'.n, c1 = e2 x v0', c2 = v0' x e1
//   o'  = o - cc,  w' = o x d - cc x d
//   det   = -(d.n)              u_num = w'.e2 - d.c1
//   v_num = -(w'.e1 + d.c2)     t_num = o'.n - c0
//
// This is not the classic Moller-Trumbore of cluster_walk.cuh and rounds
// differently, which is why the engines re-evaluate their winners with
// `canonical_hit`. The TPU kernel forms the four sums as one (16,512) x
// (16,128) matrix product; here each thread owns one ray and runs the
// products in fp32 on the CUDA cores, every three-term dot product
// summed left to right, as `mm_chunk_test_plain` of ops/traverse.py
// does (compiled with --fmad=false, so both round alike).
//
// The admissibility rule (ops/cluster.py; ops/traverse.py
// `mm_span_mask`): a pair (ray, slot) at the factored t is accepted
// only where the ray enters the padded box of the slot's cluster at
// tn_c <= t and the padded box of the slot's span of 16 at tn_s <= t,
// i.e. where lim = max(tn_c, tn_s) <= t. The rule reads no running best
// t, so the result does not rest on the order of the walk, and the
// same rule holds K2, K5 and K6 on the classic test. A span is skipped
// where lim > t_cur (the ray's best t at the start of the entry, its
// t_max while it has no hit and for any-hit): each admissible pair
// there has t > t_cur, so it cannot win, ties included.
// The plain version applies the same rule, so it is part of the
// function, not a trusted skip: the factored test cannot be given a
// padding margin (for a ray nearly parallel to an edge its barycentric
// numerators are rounding noise), so without the rule it may accept a
// ray that passes a triangle's width away. The boxes are formed from
// the slots while the block stages the entry, not read from row 9 of
// `tri_packed`: hand-built blocks may lack that row. Where the uploader
// or `with_pretest_row` wrote it, it holds the same `span_boxes` (the
// uploader also counts a real slot whose edges are both zero, which
// cannot hit). They are tested with the arithmetic of cluster_walk.cuh
// `padded_entry`.
//
// Per entry the block stages the cluster's 16 coefficients per slot and
// its 8 padded span boxes in shared memory from rows 0-8 of its
// `tri_packed` block (read from L2; a cp.async prefetch of the next
// entry's rows during the test gained nothing, as 8 blocks an SM hide
// the latency); each lane tests its ray against the 8 boxes; a warp
// runs a span's 16 slots only where one of its lanes enters it. Inside,
// the division-free terms (det, the two barycentric numerators and
// their sum) reject a slot before t_num, the IEEE reciprocal and the
// range test are formed: 43 instructions per (ray, slot) pair from the
// first of its 4 broadcast 16-byte loads of shared memory to the
// reject branch (cuobjdump -sass on sm_90a), 46 with the branch's
// reconvergence; a pair that passes adds about 25 more.

#pragma once

#include <cuda_runtime.h>

#include "cluster_walk.cuh"

namespace hala {

constexpr int kMmGroup = 128;   // rays per group = threads per block
constexpr int kMmSlots = 128;   // triangle slots per cluster
constexpr int kMmBlock = 16 * kMmSlots;  // floats per packed cluster block
constexpr int kMmRows = 9;      // rows 0-8: v0, e1, e2
constexpr int kMmSpan = 16;     // slots per span
constexpr int kMmSpans = kMmSlots / kMmSpan;
constexpr float kMmEps = 1.0e-7f;
constexpr float kMmTMin = 1.0e-4f;
constexpr float kMmInf = 3.0e38f;
constexpr float kMmFar = 3.0e37f;    // the box of a span without triangles
constexpr float kMmWhole = 1.0e38f;  // the box of a span with a non-finite corner
constexpr unsigned kMmFull = 0xffffffffu;

// A ray: origin, direction and their reciprocals for the slab test
// (cluster_walk.cuh `Ray`), o x d and the range's end.
struct MmRay : Ray {
  float wx, wy, wz;  // o x d
  float t_max;
};

struct MmBest {
  float t;  // kMmInf while there is no hit
  int tri;  // global slot, -1 while there is none
  float u, v;
};

// What a block keeps in shared memory: the staged entry.
struct MmShared {
  float4 coef[kMmSlots * 4];  // [n.xyz, c1.x] [c1.yz, c2.xy] [c2.z, e1.xyz] [e2.xyz, c0]
  float box[kMmSpans * 6];    // padded span boxes [lo_p.xyz | hi_p.xyz]
};

__device__ __forceinline__ MmRay mm_load_ray(const float* o, const float* d,
                                             const float* tmax, int i) {
  MmRay r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.invx = 1.0f / r.dx;
  r.invy = 1.0f / r.dy;
  r.invz = 1.0f / r.dz;
  r.wx = r.oy * r.dz - r.oz * r.dy;
  r.wy = r.oz * r.dx - r.ox * r.dz;
  r.wz = r.ox * r.dy - r.oy * r.dx;
  r.t_max = tmax[i];
  return r;
}

// Thread `slot` reads its column of rows 0-8 (v0, e1, e2) of cluster
// c's block.
__device__ __forceinline__ void mm_load_rows(const float* __restrict__ tri_packed,
                                             int c, int slot, float q[kMmRows]) {
  const float* src = tri_packed + static_cast<size_t>(c) * kMmBlock + slot;
#pragma unroll
  for (int k = 0; k < kMmRows; ++k) q[k] = __ldg(src + k * kMmSlots);
}

// The 16 lanes of a span (lanes 16 h .. 16 h + 15 of a warp) reduce
// their slots' corners.
__device__ __forceinline__ float span_min(float x) {
#pragma unroll
  for (int off = kMmSpan / 2; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kMmFull, x, off));
  return x;
}

__device__ __forceinline__ float span_max(float x) {
#pragma unroll
  for (int off = kMmSpan / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kMmFull, x, off));
  return x;
}

// Thread `slot` (all 128 threads of the block take part) stages its
// slot of cluster c from its rows q = [v0, e1, e2]: the 16 coefficients
// into sh.coef, and with the other lanes of its span the span's padded
// box into sh.box (ops/traverse.py `mm_coefficients`, ops/cluster.py
// `span_boxes` over the slots with a nonzero edge).
__device__ __forceinline__ void mm_stage(const float q[kMmRows], float ccx,
                                         float ccy, float ccz, int slot,
                                         MmShared& sh) {
  const float v0x = q[0] - ccx;
  const float v0y = q[1] - ccy;
  const float v0z = q[2] - ccz;
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float c0 = v0x * nx + v0y * ny + v0z * nz;
  const float c1x = e2y * v0z - e2z * v0y;
  const float c1y = e2z * v0x - e2x * v0z;
  const float c1z = e2x * v0y - e2y * v0x;
  const float c2x = v0y * e1z - v0z * e1y;
  const float c2y = v0z * e1x - v0x * e1z;
  const float c2z = v0x * e1y - v0y * e1x;
  sh.coef[slot * 4 + 0] = make_float4(nx, ny, nz, c1x);
  sh.coef[slot * 4 + 1] = make_float4(c1y, c1z, c2x, c2y);
  sh.coef[slot * 4 + 2] = make_float4(c2z, e1x, e1y, e1z);
  sh.coef[slot * 4 + 3] = make_float4(e2x, e2y, e2z, c0);

  const bool real = e1x != 0.f || e1y != 0.f || e1z != 0.f || e2x != 0.f ||
                    e2y != 0.f || e2z != 0.f;
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v0 = q[a], v1 = q[a] + q[3 + a], v2 = q[a] + q[6 + a];
    const float l = fminf(fminf(v0, v1), v2);
    const float h = fmaxf(fmaxf(v0, v1), v2);
    lo[a] = span_min(real && l == l ? l : CUDART_INF_F);
    hi[a] = span_max(real && h == h ? h : -CUDART_INF_F);
  }
  const unsigned reals = __ballot_sync(kMmFull, real) >> (slot & 16);
  if ((slot & (kMmSpan - 1)) == 0) {
    const bool empty = (reals & 0xffffu) == 0u;
    const bool whole = !(isfinite(lo[0]) && isfinite(lo[1]) && isfinite(lo[2]) &&
                         isfinite(hi[0]) && isfinite(hi[1]) && isfinite(hi[2]));
    float* bx = sh.box + 6 * (slot / kMmSpan);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l = empty ? kMmFar : whole ? -kMmWhole : lo[a];
      const float h = empty ? kMmFar : whole ? kMmWhole : hi[a];
      pad_axis(l, h, bx + a, bx + 3 + a);
    }
  }
}

// tn_c of the rule: the ray's padded entry distance of cluster c's box
// (cluster_walk.cuh `cluster_entry`), +inf where it does not enter it.
__device__ __forceinline__ float mm_cluster_tn(const float* __restrict__ cmin,
                                               const float* __restrict__ cmax,
                                               int c, const MmRay& r) {
  float tn;
  return cluster_entry(cmin, cmax, c, r, &tn) ? tn : CUDART_INF_F;
}

// One ray against the staged cluster c: the hit of lowest t in
// (kMmTMin, t_max) among the admissible pairs of the spans entered at
// or below t_cur, the lowest slot among equal t (ops/traverse.py
// `mm_span_mask` and `mm_chunk_test_plain`). tn_c: `mm_cluster_tn`.
// With any_hit the result is (t 0, slot c * 128) where any slot is hit.
// Every lane of the warp must call it (it votes).
__device__ __forceinline__ MmBest mm_chunk_test(const MmShared& sh, int c,
                                                float ccx, float ccy,
                                                float ccz, const MmRay& r,
                                                float tn_c, float t_cur,
                                                bool any_hit) {
  MmBest b{kMmInf, -1, 0.f, 0.f};
  bool live = r.t_max > kMmTMin;
  const float opx = r.ox - ccx;
  const float opy = r.oy - ccy;
  const float opz = r.oz - ccz;
  const float wpx = r.wx - (ccy * r.dz - ccz * r.dy);
  const float wpy = r.wy - (ccz * r.dx - ccx * r.dz);
  const float wpz = r.wz - (ccx * r.dy - ccy * r.dx);
  for (int s = 0; s < kMmSpans; ++s) {
    float lim = CUDART_INF_F;  // the least admissible t in span s
    float tn;
    if (live && padded_entry(sh.box + 6 * s, r, &tn)) lim = fmaxf(tn_c, tn);
    const bool in = lim <= t_cur;
    if (!__any_sync(kMmFull, in)) continue;
    if (!in) continue;
    for (int k = s * kMmSpan; k < (s + 1) * kMmSpan; ++k) {
      const float4 q0 = sh.coef[k * 4 + 0];
      const float4 q1 = sh.coef[k * 4 + 1];
      const float4 q2 = sh.coef[k * 4 + 2];
      const float4 q3 = sh.coef[k * 4 + 3];
      const float nx = q0.x, ny = q0.y, nz = q0.z;
      const float c1x = q0.w, c1y = q1.x, c1z = q1.y;
      const float c2x = q1.z, c2y = q1.w, c2z = q2.x;
      const float e1x = q2.y, e1y = q2.z, e1z = q2.w;
      const float e2x = q3.x, e2y = q3.y, e2z = q3.z, c0 = q3.w;
      const float det = -(r.dx * nx + r.dy * ny + r.dz * nz);
      const float un = (wpx * e2x + wpy * e2y + wpz * e2z) -
                       (r.dx * c1x + r.dy * c1y + r.dz * c1z);
      const float vn = -((wpx * e1x + wpy * e1y + wpz * e1z) +
                         (r.dx * c2x + r.dy * c2y + r.dz * c2z));
      // det * sg, un * sg, vn * sg with sg = +-1 are exact negations
      const bool pos = det >= 0.f;
      const float adet = pos ? det : -det;
      const float us = pos ? un : -un;
      const float vs = pos ? vn : -vn;
      if (!(adet > kMmEps && us >= 0.f && vs >= 0.f && us + vs <= adet))
        continue;
      const float tn = (opx * nx + opy * ny + opz * nz) - c0;
      const float inv_det = 1.0f / det;
      const float tt = tn * inv_det;
      if (!(tt > kMmTMin && tt < r.t_max && lim <= tt)) continue;
      if (any_hit) {  // blocked: no later span or slot can change it
        b.t = 0.f;
        b.tri = c * kMmSlots;
        live = false;
        break;
      }
      if (tt < b.t) {
        b.t = tt;
        b.tri = c * kMmSlots + k;
        b.u = un * inv_det;
        b.v = vn * inv_det;
      }
    }
  }
  return b;
}

// The lexicographic (t, slot) minimum of the running best and a
// cluster's result: brute force's tie order whatever order the clusters
// come in.
__device__ __forceinline__ void mm_merge(MmBest& acc, const MmBest& nw) {
  const bool take =
      nw.t < acc.t ||
      (nw.t == acc.t && nw.tri >= 0 && (nw.tri < acc.tri || acc.tri < 0));
  if (take) acc = nw;
}

// t_cur of the span skip: the best t where the ray has a hit (closest
// hit), else its t_max.
__device__ __forceinline__ float mm_t_cur(const MmBest& acc, const MmRay& r,
                                          bool any_hit) {
  return !any_hit && acc.tri >= 0 ? acc.t : r.t_max;
}

}  // namespace hala
