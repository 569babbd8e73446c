// Device code shared by the grouped walk (grouped_walk.cu) and the
// wavefront walk (wavefront_walk.cu): the test of one 128-ray group
// against one cluster's 128 triangle slots by the factored
// Moller-Trumbore of the JAX package's `_mm_chunk_test`
// (hala_tpu/ops/traverse.py), and the lexicographic (t, slot) merge.
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
// (16,128) matrix product; here each thread owns one ray and runs the 19
// products in fp32 on the CUDA cores, every three-term dot product
// summed left to right, as `mm_chunk_test_plain` of ops/traverse.py
// does (compiled with --fmad=false, so both round alike). The block
// forms the cluster's 16 coefficients per slot once per entry in shared
// memory from its `tri_packed` block, so no coefficient table is built
// or read: the work per (ray, slot) pair is arithmetic on registers and
// four 16-byte broadcast reads of shared memory.

#pragma once

#include <cuda_runtime.h>

namespace hala {

constexpr int kMmGroup = 128;   // rays per group = threads per block
constexpr int kMmSlots = 128;   // triangle slots per cluster
constexpr int kMmBlock = 16 * kMmSlots;  // floats per packed cluster block
constexpr float kMmEps = 1.0e-7f;
constexpr float kMmTMin = 1.0e-4f;
constexpr float kMmInf = 3.0e38f;

struct MmRay {
  float ox, oy, oz, dx, dy, dz;
  float wx, wy, wz;  // o x d
  float t_max;
};

struct MmBest {
  float t;  // kMmInf while there is no hit
  int tri;  // global slot, -1 while there is none
  float u, v;
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
  r.wx = r.oy * r.dz - r.oz * r.dy;
  r.wy = r.oz * r.dx - r.ox * r.dz;
  r.wz = r.ox * r.dy - r.oy * r.dx;
  r.t_max = tmax[i];
  return r;
}

// Thread `slot` writes the 16 coefficients of its triangle slot of
// cluster c to coef[slot * 4 .. slot * 4 + 3]:
//   [n.xyz, c1.x] [c1.yz, c2.xy] [c2.z, e1.xyz] [e2.xyz, c0]
__device__ __forceinline__ void mm_stage(const float* __restrict__ tri_packed,
                                         int c, float ccx, float ccy,
                                         float ccz, int slot, float4* coef) {
  const float* blk = tri_packed + static_cast<size_t>(c) * kMmBlock + slot;
  const float v0x = __ldg(blk + 0 * kMmSlots) - ccx;
  const float v0y = __ldg(blk + 1 * kMmSlots) - ccy;
  const float v0z = __ldg(blk + 2 * kMmSlots) - ccz;
  const float e1x = __ldg(blk + 3 * kMmSlots);
  const float e1y = __ldg(blk + 4 * kMmSlots);
  const float e1z = __ldg(blk + 5 * kMmSlots);
  const float e2x = __ldg(blk + 6 * kMmSlots);
  const float e2y = __ldg(blk + 7 * kMmSlots);
  const float e2z = __ldg(blk + 8 * kMmSlots);
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
  coef[slot * 4 + 0] = make_float4(nx, ny, nz, c1x);
  coef[slot * 4 + 1] = make_float4(c1y, c1z, c2x, c2y);
  coef[slot * 4 + 2] = make_float4(c2z, e1x, e1y, e1z);
  coef[slot * 4 + 3] = make_float4(e2x, e2y, e2z, c0);
}

// One ray against the staged cluster c: the hit of lowest t in
// (kMmTMin, t_max), the lowest slot among equal t. With any_hit the
// result is (t 0, slot c * 128) where any slot is hit. A ray whose
// range ends at or below kMmTMin can hit nothing and skips the loop.
__device__ __forceinline__ MmBest mm_chunk_test(const float4* coef, int c,
                                                float ccx, float ccy,
                                                float ccz, const MmRay& r,
                                                bool any_hit) {
  MmBest b{kMmInf, -1, 0.f, 0.f};
  if (!(r.t_max > kMmTMin)) return b;
  const float opx = r.ox - ccx;
  const float opy = r.oy - ccy;
  const float opz = r.oz - ccz;
  const float wpx = r.wx - (ccy * r.dz - ccz * r.dy);
  const float wpy = r.wy - (ccz * r.dx - ccx * r.dz);
  const float wpz = r.wz - (ccx * r.dy - ccy * r.dx);
  for (int k = 0; k < kMmSlots; ++k) {
    const float4 q0 = coef[k * 4 + 0];
    const float4 q1 = coef[k * 4 + 1];
    const float4 q2 = coef[k * 4 + 2];
    const float4 q3 = coef[k * 4 + 3];
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
    const float tn = (opx * nx + opy * ny + opz * nz) - c0;
    const float sg = det >= 0.f ? 1.0f : -1.0f;
    const float adet = det * sg;
    const float us = un * sg;
    const float vs = vn * sg;
    const float inv_det = 1.0f / (adet > kMmEps ? det : 1.0f);
    const float tt = tn * inv_det;
    const bool valid = adet > kMmEps && us >= 0.f && vs >= 0.f &&
                       us + vs <= adet && tt > kMmTMin && tt < r.t_max;
    if (valid) {
      if (any_hit) {
        b.t = 0.f;
        b.tri = c * kMmSlots;
        return b;
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

}  // namespace hala
