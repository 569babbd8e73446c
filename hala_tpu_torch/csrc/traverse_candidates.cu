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
// Design (simple first): one thread per ray walks its own list in order
// and stops at the padding or once the next entry distance is greater
// than its best t (every later candidate enters farther still). Each
// visited cluster gets Moller-Trumbore over its 128 slots straight from
// tri_packed rows 0-8, with the arithmetic of K1 and K2
// (cluster_walk.cuh). The TPU's 4096-ray tiles, the tile-wide min-tn
// selection and the SMEM copy of one cluster for the whole tile are how
// the TPU shares one fetch; threads here fetch through L1/L2 instead.
//
// Tie order: the TPU kernel's strict `<` in its visit order can keep a
// different triangle than brute force when two clusters hold hits at the
// exact same t. This kernel keeps the lexicographic (t, slot) minimum
// instead, so the result equals brute force over the visited clusters
// whatever the visit order, and it stops only at tn > t_best (not >=), so
// a cluster entered exactly at the best t is still searched for a lower
// slot.
//
// What bounds it on an H100: the Moller-Trumbore arithmetic of the
// visited clusters (~45 flops a slot) and the scattered L2 reads of
// their slot blocks (each lane of a warp may read a different cluster).
//
// Compiled with --fmad=false: rounds exactly as the plain PyTorch
// version in ops/traverse.py.

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBigCluster = 0x3FFFFFFF;  // ops/traverse.BIG_CLUSTER

__global__ void __launch_bounds__(kThreads)
traverse_candidates_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const int* __restrict__ ids,
    const float* __restrict__ tns, const unsigned char* __restrict__ ovf,
    const float* __restrict__ tri_packed, int n, int k,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ unres_out, int* __restrict__ runs_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const hala::Ray r = hala::load_ray(o, d, i);
  const int* row_ids = ids + static_cast<size_t>(i) * k;
  const float* row_tn = tns + static_cast<size_t>(i) * k;
  hala::Best b{tmax[i], -1, 0.f, 0.f};
  int runs = 0;
  for (int j = 0; j < k; ++j) {
    const int c = row_ids[j];
    if (c == kBigCluster || row_tn[j] > b.t) break;
    hala::mt_cluster<true>(tri_packed, c, r, b, false);
    ++runs;
  }
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  unres_out[i] = (ovf[i] != 0 && b.t > row_tn[k - 1]) ? 1 : 0;
  runs_out[i] = runs;
}

}  // namespace

extern "C" int hala_traverse_candidates(
    const void* o, const void* d, const void* tmax, const void* ids,
    const void* tns, const void* ovf, const void* tri_packed, int n, int k,
    void* t_out, void* tri_out, void* u_out, void* v_out, void* unres_out,
    void* runs_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  traverse_candidates_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const int*>(ids),
      static_cast<const float*>(tns), static_cast<const unsigned char*>(ovf),
      static_cast<const float*>(tri_packed), n, k, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(unres_out),
      static_cast<int*>(runs_out));
  return static_cast<int>(cudaGetLastError());
}
