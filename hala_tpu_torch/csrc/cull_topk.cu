// Per-ray ordered top-K cluster cull.
//
// Replaces the TPU kernel `_cull_kernel_body` of hala_tpu/ops/cull.py
// (`_cull_single`, pallas_call :237; via cull_topk :164): for each ray,
// the K nearest cluster AABBs its slab test enters, as ascending packed
// keys (bits(max(tn, 0)) & ~0x1FFF) | id, INF_KEY-padded, plus the ray's
// total candidate count (count > K: the list was truncated). Keys are
// unique per ray (the id is in the low bits), so ties in the rounded
// entry distance go to the smaller id, as on the TPU.
//
// The slab test is the reference's own (cull.py:87-124), not the padded
// test of cluster_walk.cuh, so pk and cnt equal the JAX kernel's bit for
// bit:
//   inv = |d| < 1e-12 ? 1e12 : 1 / d,
//   tn = max over axes of min(t0, t1), tf = min over axes of max(t0, t1),
//   hit = tn <= tf && tf > 0 && tn < t_max && t_max > 0.
// jnp.minimum / jnp.maximum propagate NaN where fminf / fmaxf drop it,
// so the min and max here do too (a NaN component fails the hit test,
// as in the reference). A zero direction component is caught by the
// 1e-12 test, so the products stay finite or +-inf, never 0 * inf.
//
// Design: one thread per ray, a warp per 32 consecutive rays (the
// traverse engine's queries come coherence-sorted), the boxes staged
// through shared memory 1024 at a time. Each group of 16 consecutive
// boxes has a union box (ops/cull.py `group_unions`, built on the
// device once per geometry): each lane first runs the same slab test
// on the union, and the warp skips the group's boxes where no lane
// enters it. Otherwise the lanes that enter it test every member,
// lanes that do not test none. A key entered goes into the ray's K
// smallest, kept in registers, sorted ascending, with one min/max
// bubble pass (K is a template parameter). The TPU's per-chunk merge
// (CULL_VMEM_CLUSTER_CAP) existed for its VMEM budget and is exact, so
// it is not needed here.
//
// Why the skip changes neither pk nor cnt. For one ray, o and inv are
// fixed, and x -> fl(fl(x - o) * inv) is monotone in x (non-decreasing
// for inv > 0, non-increasing for inv < 0): subtraction and
// multiplication round to nearest, and rounding is monotone, overflow
// to +-inf included. The union's corners are, per axis, the least and
// the greatest corner coordinate of its near members, so each member's
// t0 and t1 lie between the union's two values on that axis: the
// member's min(t0, t1) is at least the union's and its max(t0, t1) at
// most. Max and min over the axes are monotone too, so the member's tn
// is at least the union's tn and its tf at most the union's tf. If the
// member is entered (tn <= tf, tf > 0, tn < t_max, t_max > 0), then
// union tn <= member tn <= member tf <= union tf, union tf > 0 and
// union tn < t_max: the union is entered. So a lane that misses the
// union misses every near member, in the reference's own arithmetic.
// The members left out of the union are exact too: a member with a NaN
// coordinate has NaN t0 or t1 on that axis, so its tn or tf is NaN and
// it is never entered; a far member (|coordinate| >= 1e30: the 3e37
// point boxes of empty clusters, which a ray can enter, or +-inf) is
// tested by every live lane whether or not the union is entered, so a
// group that mixes real boxes and a sentinel keeps a tight union. Rays
// with NaN components or t_max <= 0 enter no union and no box.
//
// What bounds it on an H100: per live ray the function needs the slab
// test (~26 fp32 operations) of each group's union and of the members
// of the groups the ray itself enters (chip_smoke.py `k4_work` counts
// these). The kernel pays the member tests of every group some lane of
// its warp enters, for all 32 lanes, and issues the NaN-propagating
// min/max as compare-and-select.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;   // cluster boxes staged per step (24 KB)
constexpr int kGroup = 16;    // boxes per union: ops/cull.CULL_GROUP
constexpr int kTileGroups = kTile / kGroup;
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kInfKey = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1.0e-12f ? 1.0e12f : 1.0f / d;
}

struct CullRay {
  float ox, oy, oz, invx, invy, invz, tm;
};

// The reference's slab test of box [lo, hi]: true where the ray enters
// it; the entry distance in *tn.
__device__ __forceinline__ bool ref_slab(const CullRay& r, float lox,
                                         float loy, float loz, float hix,
                                         float hiy, float hiz, float* tn) {
  const float t0x = (lox - r.ox) * r.invx;
  const float t1x = (hix - r.ox) * r.invx;
  const float t0y = (loy - r.oy) * r.invy;
  const float t1y = (hiy - r.oy) * r.invy;
  const float t0z = (loz - r.oz) * r.invz;
  const float t1z = (hiz - r.oz) * r.invz;
  *tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                           nan_max(t0z, t1z));
  return *tn <= tf && tf > 0.f && *tn < r.tm && r.tm > 0.f;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cull_topk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax,
                 const float* __restrict__ cmin,
                 const float* __restrict__ cmax,
                 const float4* __restrict__ unions, int n, int n_clusters,
                 int* __restrict__ pk, int* __restrict__ cnt) {
  __shared__ float box[6][kTile];
  __shared__ float4 uni[2 * kTileGroups];  // [lo.xyz | far], [hi.xyz | 0]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  CullRay r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f};  // t_max 0: enters nothing
  if (live) {
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.invx = inv_dir(d[3 * i]);
    r.invy = inv_dir(d[3 * i + 1]);
    r.invz = inv_dir(d[3 * i + 2]);
    r.tm = tmax[i];
  }
  int list[K];
#pragma unroll
  for (int q = 0; q < K; ++q) list[q] = kInfKey;
  int count = 0;
  for (int base = 0; base < n_clusters; base += kTile) {
    const int m = min(kTile, n_clusters - base);
    const int groups = (m + kGroup - 1) / kGroup;
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int c = base + j;
      box[0][j] = cmin[3 * c];
      box[1][j] = cmin[3 * c + 1];
      box[2][j] = cmin[3 * c + 2];
      box[3][j] = cmax[3 * c];
      box[4][j] = cmax[3 * c + 1];
      box[5][j] = cmax[3 * c + 2];
    }
    for (int j = threadIdx.x; j < 2 * groups; j += kThreads) {
      uni[j] = unions[2 * (base / kGroup) + j];
    }
    __syncthreads();
    for (int g = 0; g < groups; ++g) {
      const float4 lo = uni[2 * g];
      const float4 hi = uni[2 * g + 1];
      float tn;
      const bool near =
          ref_slab(r, lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, &tn);
      const unsigned far = __float_as_uint(lo.w);
      // the members this lane tests; the warp walks the union of them
      const unsigned mine = near ? 0xFFFFu : (live ? far : 0u);
      unsigned want = __reduce_or_sync(kFull, mine);
      const int g0 = g * kGroup;
      while (want != 0u) {
        const int q = __ffs(want) - 1;
        want &= want - 1u;
        const int j = g0 + q;
        if (j >= m || !((mine >> q) & 1u)) continue;
        if (ref_slab(r, box[0][j], box[1][j], box[2][j], box[3][j],
                     box[4][j], box[5][j], &tn)) {
          ++count;
          // max(tn, 0) as jnp.maximum gives it: +0 for tn = -0
          const int key =
              (__float_as_int(tn > 0.f ? tn : 0.f) & ~kIdMask) | (base + j);
          if (key < list[K - 1]) {
            int x = key;
#pragma unroll
            for (int s = 0; s < K; ++s) {
              const int lo_key = min(list[s], x);
              x = max(list[s], x);
              list[s] = lo_key;
            }
          }
        }
      }
    }
  }
  if (!live) return;
  int* row = pk + static_cast<size_t>(i) * K;
#pragma unroll
  for (int q = 0; q < K; ++q) row[q] = list[q];
  cnt[i] = count;
}

template <int K>
void launch(const float* o, const float* d, const float* tmax,
            const float* cmin, const float* cmax, const float4* unions, int n,
            int n_clusters, int* pk, int* cnt, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cull_topk_kernel<K><<<blocks, kThreads, 0, stream>>>(
      o, d, tmax, cmin, cmax, unions, n, n_clusters, pk, cnt);
}

}  // namespace

// unions: (ceil(n_clusters / 16), 8) floats, 16-byte aligned
// (ops/cull.py `group_unions`).
extern "C" int hala_cull_topk(const void* o, const void* d, const void* tmax,
                              const void* cmin, const void* cmax,
                              const void* unions, int n, int n_clusters,
                              int k, void* pk, void* cnt, void* stream) {
  if (n <= 0) return 0;
  const float* o_ = static_cast<const float*>(o);
  const float* d_ = static_cast<const float*>(d);
  const float* t_ = static_cast<const float*>(tmax);
  const float* lo = static_cast<const float*>(cmin);
  const float* hi = static_cast<const float*>(cmax);
  const float4* u_ = static_cast<const float4*>(unions);
  int* pk_ = static_cast<int*>(pk);
  int* cnt_ = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HALA_CULL_K(KK) \
  case KK:              \
    launch<KK>(o_, d_, t_, lo, hi, u_, n, n_clusters, pk_, cnt_, s); \
    break;
    HALA_CULL_K(1) HALA_CULL_K(2) HALA_CULL_K(3) HALA_CULL_K(4)
    HALA_CULL_K(5) HALA_CULL_K(6) HALA_CULL_K(7) HALA_CULL_K(8)
    HALA_CULL_K(9) HALA_CULL_K(10) HALA_CULL_K(11) HALA_CULL_K(12)
    HALA_CULL_K(13) HALA_CULL_K(14) HALA_CULL_K(15) HALA_CULL_K(16)
#undef HALA_CULL_K
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
