// Exact closest hit streaming every cluster: the "cluster" engine and the
// exact fallback of the candidate traversal (K5).
//
// Replaces the TPU kernel `_stream_kernel_body` of hala_tpu/ops/cluster.py
// (intersect_clustered, pallas_call :285): for each ray, every cluster's
// AABB is slab-tested and the clusters it enters get Moller-Trumbore over
// their 128 slots; closest hit, ties to the lowest slot. No cap on the
// cluster count (ids are plain ints, no packed keys).
//
// What changed from the TPU design, and why:
//   * the TPU kernel tests a 1024-ray block's UNION of slab hits and runs
//     every lane of the block on a cluster some lane enters, so a lane's
//     own unpadded slab test never decides alone. Here one thread walks
//     one ray, so its own test decides; it is therefore the conservative
//     (padded, widened) test of K2 (cluster_walk.cuh), which keeps the
//     result equal to brute force;
//   * ascending cluster order with a strict `<` is brute force's tie
//     order, as in the TPU kernel's cluster loop;
//   * rays whose t_max is at or below t_min exit at once. The traverse
//     engine sends its resolved rays here with t_max = -inf (not 0: a ray
//     whose origin lies inside a box has a negative entry distance, so 0
//     would still enter it) and they return t_max and no hit untouched.
//     The launch is made for every query, without a host sync to skip it.
//
// What bounds it on an H100: like K2's closest-hit walk, arithmetic
// (32 flops per slab test, ~45 per slot tested) and L1/L2 traffic for
// the slot blocks; as the traverse fallback only the unresolved rays do
// work, and a warp costs its slowest lane.
//
// Compiled with --fmad=false: rounds exactly as the plain PyTorch
// version in ops/cluster.py.

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
cluster_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed, int n, int n_clusters,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const hala::Ray r = hala::load_ray(o, d, i);
  hala::Best b{tmax[i], -1, 0.f, 0.f};
  hala::walk_all_clusters(cmin, cmax, tri_packed, n_clusters, r, false, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

extern "C" int hala_cluster_stream(
    const void* o, const void* d, const void* tmax, const void* cmin,
    const void* cmax, const void* tri_packed, int n, int n_clusters,
    void* t_out, void* tri_out, void* u_out, void* v_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_stream_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(cmin),
      static_cast<const float*>(cmax), static_cast<const float*>(tri_packed),
      n, n_clusters, static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}
