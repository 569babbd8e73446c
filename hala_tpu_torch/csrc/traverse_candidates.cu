// Per-ray walk of the K candidate clusters nearest first, with early exit.
//
// Replaces the TPU kernel `_traverse_kernel_body` of hala_tpu/ops/traverse.py
// (`_traverse_core`, pallas_call :463; run by intersect_traversed and
// traverse_query): given each ray's K nearest slab-entered clusters in
// ascending entry distance (ids, BIG_CLUSTER-padded; tns, lower bounds of
// the entry distances; ovf, whether the list was truncated), it returns
// the closest hit over those clusters, an "unresolved" flag
// (ovf && t > tns[K-1]: a truncated cluster could still hold a closer
// hit, so the exact fallback K6 reruns the ray) and the number of
// clusters the ray visited.
//
// The walk of one ray: its list in order, stopping at the padding or
// once the next entry distance is greater than its best t (every later
// candidate enters farther still). A visited cluster's pairs count by
// the admissibility rule (cluster_walk.cuh `admissible`, ops/cluster.py):
// Moller-Trumbore accepts the pair at t, and the ray enters the
// cluster's padded box (K4's entry distances are of the unpadded box)
// and the lane's span box at entry distances <= t. The lanes' pass over
// their slots is the classic one; the rule is tested once a visit, on
// the visit's least pair, and only where that pair would improve the
// best: if no pair of the visit could, no admissible one could, and if
// the least is admissible, it is the least admissible one. Where it
// fails (rare), every lane passes over its slots again with the whole
// rule. On the H100 the cluster box on every visit cost 13 %, the rule
// inside the unrolled pass 6-7 % (two compares on each slot's ~45
// instructions), on each lane's least pair 4 %.
// Skipping a span box entered beyond the best t is exact (its
// admissible pairs lie beyond the best). The stop on
// K4's unpadded entry distance is the one step outside the rule: a
// pair admissible only inside the padding of a cluster the ray enters
// beyond its best t (or one K4 never lists) is not searched, the
// reference's own cull (ROADMAP Queue 3, kept on purpose). Tie order: the TPU kernel's strict `<`
// in its visit order can keep a different triangle than brute force when
// two clusters hold hits at the exact same t; this kernel keeps the
// lexicographic (t, slot) minimum instead, so the result equals brute
// force over the visited clusters whatever the visit order, and it stops
// only at tn > t_best (not >=), so a cluster entered exactly at the best
// t is still searched for a lower slot.
//
// What bounds it on an H100: per visit, the pretest of the eight row-9
// sub-boxes and Moller-Trumbore (~45 flops) on the real triangles of the
// spans the ray enters before its hit (chip_smoke.py `k5_work` counts
// these for its bound), and the reads of the visited slot blocks (up to
// 4.6 KB each, from L2: atrium_big's 15 MB of blocks stay there). With a
// thread per ray the lanes of a warp read nine scalars per slot each
// from its own cluster, up to 32 sectors per load, tested all 128 slots,
// padding included, and waited for the warp's longest walk. This kernel
// reads each visited block in whole rows, skips the spans its pretest
// rules out, and is left with the L2 reads and the arithmetic of the
// spans that pass.
//
// Design: half a warp takes one ray (a whole warp a ray measured
// slower), and each lane 8 consecutive slots of the visited cluster:
//  * Loads: rows 0-8 as float4s, two per lane and row, so the half
//    warp reads a row's 512 bytes coalesced in two load instructions.
//  * Pretest: a lane first tests its slots' 16-slot row-9 sub-box with
//    the padded slab test against the ray's best t, and loads nothing
//    where that fails (all-padding spans are far point boxes).
//  * Reduce: each lane keeps the lowest (t, slot) hit of its slots;
//    shuffles reduce them to the ray's, u and v come from the winning
//    lane, and `lex_better` merges it into the best. The
//    lexicographic minimum does not depend on the order, so this equals
//    the sequential walk bit for bit.
// Walks of uneven length cost little across rays: a warp holds two. A
// block-shared walk as K2's does not fit here: the rays of a block list
// different clusters in different orders, and a shared order would
// change `runs` (and which clusters a truncated list leaves out).
//
// Compiled with --fmad=false: rounds exactly as the plain PyTorch
// version in ops/traverse.py.

#include <climits>

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;  // half a warp a ray: ops/traverse.K5_LANES
constexpr int kBigCluster = 0x3FFFFFFF;  // ops/traverse.BIG_CLUSTER

// The lexicographic (t, slot) minimum over the 16 lanes of a ray, the
// same on each of them.
__device__ __forceinline__ void half_min(unsigned mask, float* wt, int* ws) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, *wt, off, kLanes);
    const int os = __shfl_xor_sync(mask, *ws, off, kLanes);
    if (ot < *wt || (ot == *wt && os < *ws)) {
      *wt = ot;
      *ws = os;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
traverse_candidates_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const int* __restrict__ ids,
    const float* __restrict__ tns, const unsigned char* __restrict__ ovf,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed, int n, int k,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ unres_out, int* __restrict__ runs_out) {
  constexpr int kPer = hala::kSlots / kLanes;  // slots a lane: 8
  const int i = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);  // this half warp
  if (i >= n) return;
  const hala::Ray r = hala::load_ray(o, d, i);
  const int* row_ids = ids + static_cast<size_t>(i) * k;
  const float* row_tn = tns + static_cast<size_t>(i) * k;
  hala::Best b{tmax[i], -1, 0.f, 0.f};
  const int first = lane * kPer;  // this lane's first slot
  const int span = first / hala::kPretestTris;
  int runs = 0;
  for (int j = 0; j < k; ++j) {
    const int c = row_ids[j];
    if (c == kBigCluster || row_tn[j] > b.t) break;
    ++runs;
    const float* blk = tri_packed + static_cast<size_t>(c) * hala::kBlock;
    // this lane's lowest (t, slot) hit; slot INT_MAX: none
    float lt = CUDART_INF_F, lu = 0.f, lv = 0.f;
    int ls = INT_MAX;
    // The pass over the slots is the classic one. The rule (the lane's
    // span box, and the padded cluster box: K4's tns are of the
    // unpadded box) is tested on the visit's least pair, once it would
    // improve the best.
    float tn_s;
    const bool pre =
        hala::pretest_entry(blk + 9 * hala::kSlots, span, r, &tn_s) &&
        tn_s <= b.t;
    if (pre) {
      for (int h = 0; h < kPer; h += 4) {
        float4 q[9];
#pragma unroll
        for (int row = 0; row < 9; ++row) {
          q[row] = __ldg(reinterpret_cast<const float4*>(
              blk + row * hala::kSlots + first + h));
        }
        const float* f = reinterpret_cast<const float*>(q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float tt, uu, vv;
          if (hala::mt_slot(r, f[e], f[4 + e], f[8 + e], f[12 + e],
                            f[16 + e], f[20 + e], f[24 + e], f[28 + e],
                            f[32 + e], &tt, &uu, &vv) &&
              tt < lt) {  // ascending slots: the lowest wins a tie
            lt = tt;
            ls = first + h + e;
            lu = uu;
            lv = vv;
          }
        }
      }
    }
    float wt = lt;
    int ws = ls;
    half_min(mask, &wt, &ws);
    // the same on every lane of the ray from here
    if (ws == INT_MAX || !hala::lex_better(wt, c * hala::kSlots + ws, b)) {
      continue;  // no pair of the visit, admissible or not, can win
    }
    float tn_c;
    if (!hala::cluster_entry(cmin, cmax, c, r, &tn_c)) tn_c = CUDART_INF_F;
    if (!hala::admissible(tn_c, __shfl_sync(mask, tn_s, ws / kPer, kLanes),
                          wt)) {
      // the least pair is not admissible (rare): every lane again over
      // its slots with the whole rule
      lt = CUDART_INF_F;
      ls = INT_MAX;
      if (pre) {
#pragma unroll 1
        for (int q = first; q < first + kPer; ++q) {
          float tt, uu, vv;
          if (hala::mt_slot(r, blk[q], blk[hala::kSlots + q],
                            blk[2 * hala::kSlots + q], blk[3 * hala::kSlots + q],
                            blk[4 * hala::kSlots + q], blk[5 * hala::kSlots + q],
                            blk[6 * hala::kSlots + q], blk[7 * hala::kSlots + q],
                            blk[8 * hala::kSlots + q], &tt, &uu, &vv) &&
              hala::admissible(tn_c, tn_s, tt) && tt < lt) {
            lt = tt;
            ls = q;
            lu = uu;
            lv = vv;
          }
        }
      }
      wt = lt;
      ws = ls;
      half_min(mask, &wt, &ws);
      if (ws == INT_MAX || !hala::lex_better(wt, c * hala::kSlots + ws, b)) {
        continue;
      }
    }
    b.t = wt;
    b.tri = c * hala::kSlots + ws;
    b.u = __shfl_sync(mask, lu, ws / kPer, kLanes);
    b.v = __shfl_sync(mask, lv, ws / kPer, kLanes);
  }
  if (lane == 0) {
    t_out[i] = b.t;
    tri_out[i] = b.tri;
    u_out[i] = b.u;
    v_out[i] = b.v;
    unres_out[i] = (ovf[i] != 0 && b.t > row_tn[k - 1]) ? 1 : 0;
    runs_out[i] = runs;
  }
}

}  // namespace

extern "C" int hala_traverse_candidates(
    const void* o, const void* d, const void* tmax, const void* ids,
    const void* tns, const void* ovf, const void* cmin, const void* cmax,
    const void* tri_packed, int n, int k,
    void* t_out, void* tri_out, void* u_out, void* v_out, void* unres_out,
    void* runs_out, void* stream) {
  if (n <= 0) return 0;
  const long long threads = static_cast<long long>(n) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  traverse_candidates_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const int*>(ids),
      static_cast<const float*>(tns), static_cast<const unsigned char*>(ovf),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax),
      static_cast<const float*>(tri_packed), n, k, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(unres_out),
      static_cast<int*>(runs_out));
  return static_cast<int>(cudaGetLastError());
}
