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
// Design: one thread per ray; the block stages the cluster boxes through
// shared memory a tile at a time (every thread reads the same box: a
// broadcast); each thread keeps its K smallest keys in registers, sorted
// ascending, and inserts a new key with one min/max bubble pass (K is a
// template parameter, so the list never leaves registers). The TPU's
// per-chunk merge (CULL_VMEM_CLUSTER_CAP) existed for its VMEM budget
// and is exact, so it is not needed here.
//
// What bounds it on an H100: the slab arithmetic, ~26 fp32 operations
// per (ray, cluster) pair; the keys never touch device memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // cluster boxes staged per step (24 KB)
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kInfKey = 0x7FFFFFFF;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1.0e-12f ? 1.0e12f : 1.0f / d;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cull_topk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax,
                 const float* __restrict__ cmin,
                 const float* __restrict__ cmax, int n, int n_clusters,
                 int* __restrict__ pk, int* __restrict__ cnt) {
  __shared__ float box[6][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, invx = 1.f, invy = 1.f, invz = 1.f;
  float tm = 0.f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    invx = inv_dir(d[3 * i]);
    invy = inv_dir(d[3 * i + 1]);
    invz = inv_dir(d[3 * i + 2]);
    tm = tmax[i];
  }
  int list[K];
#pragma unroll
  for (int q = 0; q < K; ++q) list[q] = kInfKey;
  int count = 0;
  for (int base = 0; base < n_clusters; base += kTile) {
    const int m = min(kTile, n_clusters - base);
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
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const float t0x = (box[0][j] - ox) * invx;
      const float t1x = (box[3][j] - ox) * invx;
      const float t0y = (box[1][j] - oy) * invy;
      const float t1y = (box[4][j] - oy) * invy;
      const float t0z = (box[2][j] - oz) * invz;
      const float t1z = (box[5][j] - oz) * invz;
      const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
      const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      if (tn <= tf && tf > 0.f && tn < tm && tm > 0.f) {
        ++count;
        // max(tn, 0) as jnp.maximum gives it: +0 for tn = -0
        const int key =
            (__float_as_int(tn > 0.f ? tn : 0.f) & ~kIdMask) | (base + j);
        if (key < list[K - 1]) {
          int x = key;
#pragma unroll
          for (int q = 0; q < K; ++q) {
            const int lo = min(list[q], x);
            x = max(list[q], x);
            list[q] = lo;
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
            const float* cmin, const float* cmax, int n, int n_clusters,
            int* pk, int* cnt, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cull_topk_kernel<K><<<blocks, kThreads, 0, stream>>>(
      o, d, tmax, cmin, cmax, n, n_clusters, pk, cnt);
}

}  // namespace

extern "C" int hala_cull_topk(const void* o, const void* d, const void* tmax,
                              const void* cmin, const void* cmax, int n,
                              int n_clusters, int k, void* pk, void* cnt,
                              void* stream) {
  if (n <= 0) return 0;
  const float* o_ = static_cast<const float*>(o);
  const float* d_ = static_cast<const float*>(d);
  const float* t_ = static_cast<const float*>(tmax);
  const float* lo = static_cast<const float*>(cmin);
  const float* hi = static_cast<const float*>(cmax);
  int* pk_ = static_cast<int*>(pk);
  int* cnt_ = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HALA_CULL_K(KK) \
  case KK:              \
    launch<KK>(o_, d_, t_, lo, hi, n, n_clusters, pk_, cnt_, s); \
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
