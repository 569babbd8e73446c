// Exact closest hit over every cluster: the "cluster" engine and the
// exact fallback of the candidate traversal (K5).
//
// Replaces the TPU kernel `_stream_kernel_body` of hala_tpu/ops/cluster.py
// (intersect_clustered, pallas_call :285): for each ray, every cluster's
// AABB is slab-tested and the clusters it enters get Moller-Trumbore over
// their 128 slots; closest hit, ties to the lowest slot. No cap on the
// cluster count (ids are plain ints, no packed keys).
//
// Design: a warp per ray, drawn from a work queue.
//  * Queue. ops/cluster.py `live_queue` lists, on the device and in
//    ascending order, the rays whose t_max is above t_min (1e-4), with
//    their count and a pop counter at the head. The grid is fixed (the
//    SMs times the resident blocks), so the launch never waits for the
//    count: the traverse engine sends every query here, its resolved
//    rays with t_max = -inf (not 0: a ray whose origin lies inside a
//    box has a negative entry distance), and an empty queue is a launch
//    whose warps pop once and leave. The "cluster" engine sends all its
//    rays, every one of them live.
//  * Rays off the queue keep t_max and miss: the grid writes them first,
//    and no warp writes a queued ray's outputs but the one that pops it.
//  * Unions. Each group of 16 consecutive clusters has a union of their
//    padded boxes (ops/cluster.py `stream_unions`, built on the device
//    once per geometry). Lane l tests the union of groups l, l + 32, ...
//    with the padded test's second half (`padded_entry`) against the
//    warp's best t, and a ballot collects the 32 results. The padded
//    slab arithmetic is monotone in the corners (subtraction,
//    multiplication, min / max and the widening all round
//    monotonically), so a member's widened entry distance is at least
//    its union's and its exit at most, and a parallel axis inside a
//    member's slab lies inside the union's: a ray that misses the union
//    at best t misses every member. Members with a NaN, infinite or
//    3e37 corner are left out of the union and tested on their own (the
//    padded test drops NaN, so it may enter such a box).
//  * Boxes. For each group entered, in ascending order, lanes 0-15 test
//    its members with the conservative padded slab test
//    (cluster_walk.cuh `cluster_entry`, the one `stream_plain` runs)
//    against the best t, and a ballot collects them.
//  * Slots. For each cluster entered, in ascending order, the warp
//    re-checks its entry distance against the best t (which earlier
//    clusters may have lowered), then runs Moller-Trumbore
//    over its 128 slots, 4 a lane as float4 loads of rows 0-8 (512
//    bytes a row, coalesced), each lane first testing its 16-slot span's
//    row-9 sub-box and loading nothing where that fails.
//  * Reduce. Each lane keeps its lowest (t, slot) hit; shuffles reduce
//    them to the cluster's, u and v come from the winning lane, and
//    `lex_better` merges it into the ray's best, the same on every lane.
// Tie rule: the warp meets the clusters a ray enters in ascending id
// order, but it keeps the lexicographic (t, slot) minimum and enters a
// box with tn <= best t, not <, so the result does not rest on the
// order: a box entered exactly at the best t may still hold a lower
// slot at that t. With the conservative tests (a union, a cluster or a
// 16-slot span holding a hit at t is entered at a widened-down distance
// <= t) the result equals the brute force over all slots, ties to the
// lowest slot, as `stream_plain`; the unions and the pretest only prune
// boxes and spans with no hit that could win.
//
// What bounds it on an H100: per ray the function needs the slab tests
// of the cluster boxes (a union per 16 boxes and the members of the
// groups entered before the hit, as K2's plain model counts them) and
// Moller-Trumbore on the real triangles of the spans entered before the
// hit (chip_smoke.py `k2_work`). The kernel tests every union of every
// queued ray, the members of every union entered before the hit (half
// the warp idle), and for each cluster entered pays the pretest and
// four slots a lane, whether or not the lane's span holds real
// triangles. The thread-per-ray stream it replaces kept a whole warp
// waiting while its one unresolved lane walked every box.
//
// Compiled with --fmad=false: rounds exactly as the plain PyTorch
// version in ops/cluster.py.

#include <climits>

#include "cluster_walk.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = hala::kSlots / 32;  // slots a lane: 4
constexpr int kGroup = 16;  // clusters under one union: ops/cull.CULL_GROUP
constexpr unsigned kFull = 0xffffffffu;

// Moller-Trumbore over cluster c's 128 slots, 4 a lane (float4 loads
// of rows 0-8) behind the lane's row-9 span pretest; the warp's lowest
// (t, slot) hit merged into b by `lex_better`, the same on every lane.
__device__ __forceinline__ void walk_cluster(const float* __restrict__ tri_packed,
                                             int c, const hala::Ray& r,
                                             int lane, hala::Best& b) {
  const int first = kPer * lane;  // this lane's first slot
  const float* blk = tri_packed + static_cast<size_t>(c) * hala::kBlock;
  // this lane's lowest (t, slot) hit; slot INT_MAX: none
  float lt = CUDART_INF_F, lu = 0.f, lv = 0.f;
  int ls = INT_MAX;
  float stn;
  if (hala::pretest_entry(blk + 9 * hala::kSlots, first / hala::kPretestTris, r,
                          &stn) &&
      stn <= b.t) {
    float4 f4[9];
#pragma unroll
    for (int row = 0; row < 9; ++row) {
      f4[row] = __ldg(reinterpret_cast<const float4*>(
          blk + row * hala::kSlots + first));
    }
    const float* f = reinterpret_cast<const float*>(f4);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      float tt, uu, vv;
      if (hala::mt_slot(r, f[e], f[4 + e], f[8 + e], f[12 + e], f[16 + e],
                        f[20 + e], f[24 + e], f[28 + e], f[32 + e], &tt, &uu,
                        &vv) &&
          tt < lt) {  // ascending slots: the lowest wins a tie
        lt = tt;
        ls = first + e;
        lu = uu;
        lv = vv;
      }
    }
  }
  float wt = lt;
  int ws = ls;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, wt, off);
    const int os = __shfl_xor_sync(kFull, ws, off);
    if (ot < wt || (ot == wt && os < ws)) {
      wt = ot;
      ws = os;
    }
  }
  if (ws == INT_MAX) return;  // the same on every lane
  const float wu = __shfl_sync(kFull, lu, ws / kPer);
  const float wv = __shfl_sync(kFull, lv, ws / kPer);
  const int slot = c * hala::kSlots + ws;
  if (hala::lex_better(wt, slot, b)) {
    b.t = wt;
    b.tri = slot;
    b.u = wu;
    b.v = wv;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float4* __restrict__ unions, const float* __restrict__ tri_packed,
    int* __restrict__ queue, int n, int n_clusters,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  // rays off the queue: t_max and no hit
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float tm = tmax[i];
    if (!(tm > hala::kTMin)) {
      t_out[i] = tm;
      tri_out[i] = -1;
      u_out[i] = 0.f;
      v_out[i] = 0.f;
    }
  }
  const int lane = threadIdx.x & 31;
  const int count = queue[0];
  const int* ids = queue + 2;
  const int n_groups = (n_clusters + kGroup - 1) / kGroup;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(queue + 1, 1);
    j = __shfl_sync(kFull, j, 0);
    if (j >= count) break;
    const int i = ids[j];
    const hala::Ray r = hala::load_ray(o, d, i);
    hala::Best b{tmax[i], -1, 0.f, 0.f};
    for (int gbase = 0; gbase < n_groups; gbase += 32) {
      // lane l tests the union of group gbase + l
      const int g_lane = gbase + lane;
      float utn = CUDART_INF_F;
      unsigned far = 0u;
      bool near_in = false;
      if (g_lane < n_groups) {
        const float4 lo = __ldg(unions + 2 * g_lane);
        const float4 hi = __ldg(unions + 2 * g_lane + 1);
        const float p[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
        near_in = hala::padded_entry(p, r, &utn) && utn <= b.t;
        far = __float_as_uint(lo.w);
      }
      unsigned groups = __ballot_sync(kFull, near_in || far != 0u);
      while (groups != 0u) {
        const int q = __ffs(groups) - 1;
        groups &= groups - 1u;
        // b is warp-uniform: re-check the union against the best t so far
        const bool g_in = __shfl_sync(kFull, near_in, q) &&
                          __shfl_sync(kFull, utn, q) <= b.t;
        const unsigned want = g_in ? 0xFFFFu : __shfl_sync(kFull, far, q);
        if (want == 0u) continue;
        // lanes 0-15 test the members it asks for
        const int c0 = (gbase + q) * kGroup;
        float tn = CUDART_INF_F;
        const bool in = lane < kGroup && ((want >> lane) & 1u) &&
                        c0 + lane < n_clusters &&
                        hala::cluster_entry(cmin, cmax, c0 + lane, r, &tn) &&
                        tn <= b.t;
        unsigned entered = __ballot_sync(kFull, in);
        while (entered != 0u) {
          const int m = __ffs(entered) - 1;
          entered &= entered - 1u;
          if (__shfl_sync(kFull, tn, m) > b.t) continue;
          walk_cluster(tri_packed, c0 + m, r, lane, b);
        }
      }
    }
    if (lane == 0) {
      t_out[i] = b.t;
      tri_out[i] = b.tri;
      u_out[i] = b.u;
      v_out[i] = b.v;
    }
  }
}

}  // namespace

// unions: (ceil(n_clusters / 16), 8) floats, 16-byte aligned
// (ops/cluster.py `stream_unions`); queue: [count, 0, ids...] int32
// (`live_queue`), whose pop counter, queue[1], the launch advances.
extern "C" int hala_cluster_stream(
    const void* o, const void* d, const void* tmax, const void* cmin,
    const void* cmax, const void* unions, const void* tri_packed, void* queue,
    int n,
    int n_clusters, void* t_out, void* tri_out, void* u_out, void* v_out,
    void* stream) {
  if (n <= 0) return 0;
  static int resident = 0;  // blocks of the whole card at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cluster_stream_kernel, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = min(resident, (n + kThreads - 1) / kThreads);
  cluster_stream_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(cmin),
      static_cast<const float*>(cmax), static_cast<const float4*>(unions),
      static_cast<const float*>(tri_packed), static_cast<int*>(queue), n,
      n_clusters, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}
