// Exact closest-hit / any-hit traversal of the binned-SAH cluster layout.
//
// Replaces the TPU kernel `_matrix_kernel_body` / `_matrix_traverse` of
// hala_tpu/ops/traverse.py (intersect_matrix, occluded_matrix, run
// under matrix_query): the exact hit of N rays over C <= 8191 clusters
// of 128 triangle slots, each with an AABB.
//
// Design (simple and exact first): one thread per ray walks the
// clusters in ascending id order, slab-tests each AABB against its
// current best t, and runs Moller-Trumbore over the cluster's 128 slots
// when the test passes (cluster_walk.cuh, shared with K6, whose plain
// version is also this kernel's). The result equals the brute force
// over all slots. The TPU kernel's front-to-back visit order, the row-9
// 16-triangle pretest and the coherence sort of matrix_query change no
// output and are left to later work.
//
// What bounds it on an H100: with ascending (not front-to-back) order
// a closest-hit ray runs Moller-Trumbore on every cluster its shrinking
// range still reaches, so time is arithmetic (~40 flops per ray and
// slot) plus L1/L2 traffic for the slot data. Lanes of a warp that
// test the same cluster read the same addresses (a broadcast), which is
// why coherent batches (camera rays) run far faster than bounce rays.
// With any_hit set a ray stops at its first hit.
//
// Compiled with --fmad=false: the slab test and Moller-Trumbore round
// exactly as the plain PyTorch version in ops/cluster.py.

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
matrix_traverse_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed,
    int n, int n_clusters, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const hala::Ray r = hala::load_ray(o, d, i);
  hala::Best b{tmax[i], -1, 0.f, 0.f};
  hala::walk_all_clusters(cmin, cmax, tri_packed, n_clusters, r,
                          any_hit != 0, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

extern "C" int hala_matrix_traverse(
    const void* o, const void* d, const void* tmax, const void* cmin,
    const void* cmax, const void* tri_packed, int n, int n_clusters,
    int any_hit, void* t_out, void* tri_out, void* u_out, void* v_out,
    void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  matrix_traverse_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(cmin),
      static_cast<const float*>(cmax), static_cast<const float*>(tri_packed),
      n, n_clusters, any_hit, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}
