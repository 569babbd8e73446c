// Closest-hit / any-hit walk of per-group candidate cluster lists.
//
// Replaces the TPU kernel `_grouped_kernel_body` / `grouped_pallas_call`
// of hala_tpu/ops/traverse.py (intersect_grouped, occluded_grouped, run
// under matrix_query(kernel="grouped")): each group of 128 rays walks
// its `counts[g]` candidate clusters in ascending group entry distance,
// tests each ray against the cluster's slots in the 16-slot spans the
// ray enters, by the admissibility rule (mm_chunk_test.cuh), keeps the
// lexicographic (t, slot) minimum per ray, and stops once no ray's best
// t lies beyond the next entry distance (compared as int32 bit
// patterns, monotonic for the non-negative floats involved).
//
// Design: one block per group, one thread per ray. The TPU kernel's
// scalar-prefetch tables, its two-slot DMA ring and its (16,512)
// coefficient table become: the block reads its own list entries, forms
// the entry's coefficients and span boxes in shared memory from rows
// 0-8 of the cluster's `tri_packed` block, and `__syncthreads_or` takes
// the group-wide exit decision (it is also the barrier that frees the
// shared block for the next entry).
//
// What bounds it on an H100: issuing CUDA-core instructions, 46 per
// (ray, slot) pair of the spans a warp runs (mm_chunk_test.cuh), and
// per walked entry the staging and each lane's 8 span-box tests.
// A warp runs a span of an entry only where one of its lanes enters the
// span's padded box, so the cost follows the spans the rays of a warp
// share, not the group's whole list; the cluster blocks stay in L2
// (atrium_big's are 15 MB).
// In a warp that runs a span about one lane in six enters it (the lane
// fill chip_smoke.py prints for atrium_big), so most issued pairs are
// lanes masked off.

#include "mm_chunk_test.cuh"

namespace {

__global__ void __launch_bounds__(hala::kMmGroup)
grouped_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const int* __restrict__ counts,
    const int* __restrict__ ids, const int* __restrict__ tnb,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed, int k, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ walked_out) {
  __shared__ hala::MmShared sh;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int i = g * hala::kMmGroup + lane;
  const hala::MmRay r = hala::mm_load_ray(o, d, tmax, i);
  hala::MmBest acc{hala::kMmInf, -1, 0.f, 0.f};
  const int kg = counts[g];
  const int* g_ids = ids + static_cast<size_t>(g) * k;
  const int* g_tnb = tnb + static_cast<size_t>(g) * k;
  int j = 0;
  while (true) {
    const bool alive = j < kg && __float_as_int(acc.t) > g_tnb[j];
    if (!__syncthreads_or(alive)) break;
    const int c = g_ids[j];
    const float ccx = 0.5f * (__ldg(cmin + 3 * c) + __ldg(cmax + 3 * c));
    const float ccy = 0.5f * (__ldg(cmin + 3 * c + 1) + __ldg(cmax + 3 * c + 1));
    const float ccz = 0.5f * (__ldg(cmin + 3 * c + 2) + __ldg(cmax + 3 * c + 2));
    float q[hala::kMmRows];
    hala::mm_load_rows(tri_packed, c, lane, q);
    hala::mm_stage(q, ccx, ccy, ccz, lane, sh);
    __syncthreads();
    const float tn_c = hala::mm_cluster_tn(cmin, cmax, c, r);
    hala::mm_merge(acc, hala::mm_chunk_test(sh, c, ccx, ccy, ccz, r, tn_c,
                                            hala::mm_t_cur(acc, r, any_hit != 0),
                                            any_hit != 0));
    ++j;
  }
  t_out[i] = acc.t;
  tri_out[i] = acc.tri;
  u_out[i] = acc.u;
  v_out[i] = acc.v;
  if (lane == 0) walked_out[g] = j;
}

}  // namespace

extern "C" int hala_grouped_walk(
    const void* o, const void* d, const void* tmax, const void* counts,
    const void* ids, const void* tnb, const void* cmin, const void* cmax,
    const void* tri_packed, int n_groups, int k, int any_hit, void* t_out,
    void* tri_out, void* u_out, void* v_out, void* walked_out, void* stream) {
  if (n_groups <= 0) return 0;
  grouped_walk_kernel<<<n_groups, hala::kMmGroup, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const int*>(counts),
      static_cast<const int*>(ids), static_cast<const int*>(tnb),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax),
      static_cast<const float*>(tri_packed), k, any_hit,
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(walked_out));
  return static_cast<int>(cudaGetLastError());
}
