// Device code shared by the cluster kernels (matrix_traverse.cu,
// cluster_stream.cu, traverse_candidates.cu): the conservative slab test
// of a ray against a cluster AABB or a row-9 sub-box, one slot's
// Moller-Trumbore, and the lexicographic (t, slot) merge. All three
// kernels meet the clusters out of ascending id order (K2 front to
// back, K5 a ray's candidate list, K6 a warp's 32 boxes at a time).
//
// The arithmetic is written in the order of the plain PyTorch versions
// (ops/cluster.py `slab_entry`, ops/intersect.py `mt_components`); the
// kernels are compiled with --fmad=false, so both round alike.
//
// The slab test must be conservative (never skip a cluster whose
// triangles Moller-Trumbore would accept):
//   * every box is padded by 1e-5 of its coordinates' magnitude plus
//     1e-6, which covers the zero-thickness boxes of axis-aligned walls
//     and Moller-Trumbore's acceptance slack at triangle edges;
//   * direction components below 1e-20 in magnitude are treated as
//     parallel (inside-the-padded-slab test), which avoids 0 * inf;
//   * entry/exit distances are widened by a relative 1e-6 without
//     producing NaN from infinities, so rounding of (lo - o) * (1 / d)
//     cannot exclude a hit at the box boundary;
//   * empty clusters carry far point boxes at 3e37 whose slots have
//     zero edges: they may pass the test but never produce a hit;
//   * rays whose range ends at or below t_min (dead rays with t_max 0,
//     resolved rays with t_max -inf) do no work at all.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hala {

constexpr int kSlots = 128;            // triangle slots per cluster
constexpr int kBlock = 16 * kSlots;    // floats per packed cluster block
constexpr float kEps = 1.0e-7f;
constexpr float kTMin = 1.0e-4f;
constexpr float kPadRel = 1.0e-5f;
constexpr float kPadAbs = 1.0e-6f;
constexpr float kTinyDir = 1.0e-20f;
constexpr float kWiden = 1.0e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz;
};

struct Best {
  float t;   // best hit distance so far (t_max while there is none)
  int tri;   // its global slot, -1 while there is none
  float u, v;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int i) {
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.invx = 1.0f / r.dx;
  r.invy = 1.0f / r.dy;
  r.invz = 1.0f / r.dz;
  return r;
}

__device__ __forceinline__ float widen_down(float t) {
  return t < 0.f ? t * (1.0f + kWiden) : t * (1.0f - kWiden);
}

__device__ __forceinline__ float widen_up(float t) {
  return t > 0.f ? t * (1.0f + kWiden) : t * (1.0f - kWiden);
}

// --- the out-of-order walks ---------------------------------------------------
//
// K2 visits clusters front to back, K5 splits a cluster over half a
// warp and K6 a warp over 32 boxes at a time, so none meets the slots
// in ascending order. Each keeps the lexicographic (t, slot) minimum
// instead (`lex_better`), and tests a box with `tn <= t_best`, not `<`:
// a box entered exactly at the best t may still hold a lower slot at
// that t.

constexpr int kPretestTris = 16;  // slots per row-9 sub-box
constexpr int kPretestBoxes = kSlots / kPretestTris;

// One axis of the padded slab test in two halves: the padded corners of
// a box, which depend on the box alone, and the test of one ray against
// them (false when the ray is parallel to the axis outside the slab).
__device__ __forceinline__ void pad_axis(float lo, float hi, float* lo_p,
                                         float* hi_p) {
  const float pad = kPadRel * (fabsf(lo) + fabsf(hi)) + kPadAbs;
  *lo_p = lo - pad;
  *hi_p = hi + pad;
}

__device__ __forceinline__ bool padded_axis(float lo_p, float hi_p, float o,
                                            float d, float inv, float* tn,
                                            float* tf) {
  if (fabsf(d) < kTinyDir) {
    *tn = -CUDART_INF_F;
    *tf = CUDART_INF_F;
    return lo_p <= o && o <= hi_p;
  }
  const float t0 = (lo_p - o) * inv;
  const float t1 = (hi_p - o) * inv;
  *tn = fminf(t0, t1);
  *tf = fmaxf(t0, t1);
  return true;
}

// The conservative slab test of a ray against an already padded box
// p = [lo_p.xyz | hi_p.xyz]: the widened-down entry distance in *tn, and
// true where the ray enters the box at all.
__device__ __forceinline__ bool padded_entry(const float* p, const Ray& r,
                                             float* tn) {
  float tnx, tfx, tny, tfy, tnz, tfz;
  const bool in_x = padded_axis(p[0], p[3], r.ox, r.dx, r.invx, &tnx, &tfx);
  const bool in_y = padded_axis(p[1], p[4], r.oy, r.dy, r.invy, &tny, &tfy);
  const bool in_z = padded_axis(p[2], p[5], r.oz, r.dz, r.invz, &tnz, &tfz);
  *tn = widen_down(fmaxf(fmaxf(tnx, tny), tnz));
  const float tf = widen_up(fminf(fminf(tfx, tfy), tfz));
  return in_x && in_y && in_z && *tn <= tf && tf > 0.f;
}

// The same test of a box given by its corners (ops/cluster.py
// `slab_entry`).
__device__ __forceinline__ bool slab_entry(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           const Ray& r, float* tn) {
  float p[6];
  pad_axis(lox, hix, p + 0, p + 3);
  pad_axis(loy, hiy, p + 1, p + 4);
  pad_axis(loz, hiz, p + 2, p + 5);
  return padded_entry(p, r, tn);
}

// slab_entry of cluster c's AABB.
__device__ __forceinline__ bool cluster_entry(const float* __restrict__ cmin,
                                              const float* __restrict__ cmax,
                                              int c, const Ray& r, float* tn) {
  return slab_entry(__ldg(cmin + 3 * c), __ldg(cmin + 3 * c + 1),
                    __ldg(cmin + 3 * c + 2), __ldg(cmax + 3 * c),
                    __ldg(cmax + 3 * c + 1), __ldg(cmax + 3 * c + 2), r, tn);
}

// slab_entry of sub-box s of a cluster block's row 9 ([min.xyz | max.xyz]
// x 8, lanes 0-47): the span of slots 16 s .. 16 s + 15.
__device__ __forceinline__ bool pretest_entry(const float* row9, int s,
                                              const Ray& r, float* tn) {
  const float* bx = row9 + 6 * s;
  return slab_entry(bx[0], bx[1], bx[2], bx[3], bx[4], bx[5], r, tn);
}

// Moller-Trumbore of one slot, in mt_components' operations and order:
// true where the slot is hit in (1e-4, inf), with t, u, v.
__device__ __forceinline__ bool mt_slot(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, float* t, float* u,
                                        float* v) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = px * e1x + py * e1y + pz * e1z;
  const bool ok_det = fabsf(det) > kEps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  *u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  *v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  *t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok_det && *u >= 0.f && *v >= 0.f && *u + *v <= 1.f && *t > kTMin;
}

// The lexicographic rule: a hit at global slot `slot` replaces the best
// when nearer, or at an equal t when the best is a hit of a higher slot.
__device__ __forceinline__ bool lex_better(float t, int slot, const Best& b) {
  return t < b.t || (t == b.t && b.tri >= 0 && slot < b.tri);
}

}  // namespace hala
