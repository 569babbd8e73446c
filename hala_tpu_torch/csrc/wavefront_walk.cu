// Closest-hit / any-hit walk of merged per-group (tn|id) key lists.
//
// Replaces the TPU kernel `_wf_kernel_body` / `_wf_pallas_call` of
// hala_tpu/ops/wavefront.py (intersect_wavefront, occluded_wavefront,
// run under matrix_query(kernel="wavefront")): each group of 128 rays
// walks a merged, deduplicated, ascending list of at most m <= 32
// packed keys (entry distance bits above a 13-bit cluster id, padded
// with 0x7FFFFFFF). Per entry:
//   * the walk goes on only while some ray's best t lies beyond the
//     entry's key AND the entry is at or inside that ray's own last
//     candidate key (`own_last`); the padding ends it;
//   * the entry is tested only if some ray that ranks it among its OWN
//     candidates (bit j of the ray's `want` word) can still improve;
//   * a tested entry runs all 128 rays against the cluster's 128
//     triangle slots (mm_chunk_test.cuh) and keeps the lexicographic
//     (t, slot) minimum per ray.
// It also counts the walked and the tested entries of each group.
//
// Design: one block per group, one thread per ray, as grouped_walk.cu.
// The TPU kernel's (m, 128)-lane padded key and want blocks, its
// feature row carrying `own_last` as a bitcast float and its four-slot
// DMA ring become a (G, m) key list, one 32-bit want word and one int
// per ray, and two `__syncthreads_or` votes per entry.
//
// What bounds it on an H100: arithmetic, about 50 fp32 operations per
// (ray, slot) pair of every tested entry; skipped entries cost two
// block-wide votes.

#include "mm_chunk_test.cuh"

namespace {

__global__ void __launch_bounds__(hala::kMmGroup)
wavefront_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const int* __restrict__ pkl,
    const int* __restrict__ want, const int* __restrict__ own_last,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed, int m, int n_clusters,
    int id_mask, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ stats_out) {
  __shared__ float4 coef[hala::kMmSlots * 4];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int i = g * hala::kMmGroup + lane;
  const hala::MmRay r = hala::mm_load_ray(o, d, tmax, i);
  const unsigned want_bits = static_cast<unsigned>(want[i]);
  const int last = own_last[i];
  hala::MmBest acc{hala::kMmInf, -1, 0.f, 0.f};
  const int* g_pkl = pkl + static_cast<size_t>(g) * m;
  int j = 0;
  int tested = 0;
  while (j < m) {
    const int kj = g_pkl[j];
    const bool beyond = __float_as_int(acc.t) > kj;
    if (!__syncthreads_or(beyond && last >= kj)) break;
    if (__syncthreads_or(beyond && ((want_bits >> j) & 1u))) {
      const int c = min(kj & id_mask, n_clusters - 1);
      const float ccx = 0.5f * (__ldg(cmin + 3 * c) + __ldg(cmax + 3 * c));
      const float ccy = 0.5f * (__ldg(cmin + 3 * c + 1) + __ldg(cmax + 3 * c + 1));
      const float ccz = 0.5f * (__ldg(cmin + 3 * c + 2) + __ldg(cmax + 3 * c + 2));
      hala::mm_stage(tri_packed, c, ccx, ccy, ccz, lane, coef);
      __syncthreads();
      hala::mm_merge(acc, hala::mm_chunk_test(coef, c, ccx, ccy, ccz, r,
                                              any_hit != 0));
      ++tested;
    }
    ++j;
  }
  t_out[i] = acc.t;
  tri_out[i] = acc.tri;
  u_out[i] = acc.u;
  v_out[i] = acc.v;
  if (lane == 0) {
    stats_out[2 * g] = j;
    stats_out[2 * g + 1] = tested;
  }
}

}  // namespace

extern "C" int hala_wavefront_walk(
    const void* o, const void* d, const void* tmax, const void* pkl,
    const void* want, const void* own_last, const void* cmin,
    const void* cmax, const void* tri_packed, int n_groups, int m,
    int n_clusters, int id_mask, int any_hit, void* t_out, void* tri_out,
    void* u_out, void* v_out, void* stats_out, void* stream) {
  if (n_groups <= 0) return 0;
  wavefront_walk_kernel<<<n_groups, hala::kMmGroup, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const int*>(pkl),
      static_cast<const int*>(want), static_cast<const int*>(own_last),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax),
      static_cast<const float*>(tri_packed), m, n_clusters, id_mask, any_hit,
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(stats_out));
  return static_cast<int>(cudaGetLastError());
}
