// Exact closest-hit / any-hit traversal of the binned-SAH cluster layout.
//
// Replaces the TPU kernel `_matrix_traverse` of hala_tpu/ops/traverse.py
// (`_make_matrix_kernel` / `_make_matrix_occluded_kernel`, pallas_call
// :1591; intersect_matrix, occluded_matrix, run under matrix_query): the
// exact hit of N rays over C <= 8191 clusters of 128 triangle slots, each
// with an AABB and, in tri_packed row 9, eight 16-slot sub-AABBs.
//
// What bounds it on an H100. Per ray the function needs one slab test
// (~32 flops) of each 16-box group's union, the member tests of the
// groups whose boxes it enters, the eight row-9 sub-box tests of each
// cluster it enters before its closest hit, and Moller-Trumbore (~45
// flops) on the real triangles of the 16-slot spans it enters there
// (chip_smoke.py `k2_work` counts these for its bound). A thread per ray
// walking the clusters in id order ran Moller-Trumbore on all 128 slots
// of every cluster its shrinking range still reached, most of them
// behind its hit, and read each slot from L2 with scalar loads. This
// walk is bound by issuing CUDA-core instructions instead: a warp tests
// all 16 members for every lane once one lane enters their union, and
// per lane visit it runs the box test, the sub-box tests and
// Moller-Trumbore on every span some lane of the warp wants; it visits
// about a third more clusters per block than the fewest some lane must
// enter.
//
// Design: the TPU kernel's front-to-back walk, per block of 128
// consecutive rays of the batch matrix_query has coherence-sorted (rays
// with t_max <= 1e-4, sorted last, leave whole blocks at once):
//  1. Keys. Each lane slab-tests every cluster with the conservative
//     padded test (cluster_walk.cuh) against its t_max, reading the
//     padded boxes of 128 clusters at a time from shared memory (each
//     computed once per block, by one thread). A warp first tests the
//     union of 16 consecutive padded boxes and skips all 16 where no
//     lane enters it: the union's entry distance is at most each
//     member's and its exit at least (the rounded slab arithmetic is
//     monotonic in the corners), so a lane that misses the union misses
//     every member and the keys are the same. The block keeps
//     per cluster the least (max(tn, 0) bits & ~0x1FFF) | id over its
//     lanes (__reduce_min_sync per warp, a shared atomicMin across
//     warps), 0x7FFFFFFF where no lane enters: next_pow2(C) words of
//     shared memory.
//  2. Order. The live keys are compacted in place and bitonic-sorted in
//     shared memory.
//  3. Walk. Keys in ascending order; the block stops at the first key
//     whose (rounded-down) entry distance exceeds every lane's best t
//     (__syncthreads_or of "this lane could still improve"). A key's
//     distance is a lower bound of every lane's padded entry distance,
//     and later keys are farther still, so the stop is exact.
//  4. Stage. Rows 0-9 of the next key's slot block (5 KB) are copied to
//     shared memory with cp.async while the current block is tested
//     (two buffers); every lane then reads the same slot, a broadcast.
//  5. Test. A lane re-runs its own slab test of the cluster against its
//     current best, then the eight row-9 sub-boxes, and runs
//     Moller-Trumbore on the 16-slot spans that pass (empty sub-chunks
//     are far point boxes whose slots have zero edges: no hit). A warp
//     with no live lane skips the cluster.
// Tie rule: clusters no longer come in id order, so a lane keeps the
// lexicographic (t, slot) minimum and tests boxes with tn <= best t (a
// box entered exactly at the best t may hold a lower slot at that t):
// the result equals the brute force over all slots, ties to the lowest
// slot, as `stream_plain`. With any_hit a lane is done at its first hit
// (the lowest hit slot of the first cluster that has one).
// `runs_out`, when given, receives the clusters each block visited (the
// TPU kernel's runs_out); ops/traverse.py `matrix_walk_runs_plain` is
// the plain model of this schedule.
//
// Compiled with --fmad=false: the slab tests and Moller-Trumbore round
// exactly as the plain PyTorch versions in ops/cluster.py.

#include "cluster_walk.cuh"

namespace {

constexpr unsigned kIdMask = 0x1FFFu;        // 13 id bits: C <= 8191
constexpr unsigned kInfKey = 0x7FFFFFFFu;    // no lane enters the cluster
constexpr int kStage = 10 * hala::kSlots;    // rows 0-9 of a block, floats
constexpr int kGroup = 16;  // consecutive clusters under one union box
constexpr int kWarps = 4;   // a block walks kRays = 128 rays
constexpr int kRays = kWarps * 32;  // == ops/traverse.MATRIX_BLOCK_RAYS

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kRays)
matrix_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    const float* __restrict__ tri_packed,
    int n, int n_clusters, int key_cap, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ runs_out) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                                          // 2 x kStage
  unsigned* keys = reinterpret_cast<unsigned*>(smem + 2 * kStage);  // key_cap
  __shared__ int warp_count[kWarps];
  __shared__ float boxes[6 * kRays];  // padded cluster boxes of the keys pass
  __shared__ float unions[6 * (kRays / kGroup)];  // and their groups' unions

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = blockIdx.x * kRays + tid;
  const bool in = i < n;
  hala::Ray r{};
  hala::Best b{0.f, -1, 0.f, 0.f};
  if (in) {
    r = hala::load_ray(o, d, i);
    b.t = tmax[i];
  }
  const bool live = in && b.t > hala::kTMin;
  bool done = false;  // any_hit: this lane has its hit
  int runs = 0;

  if (__syncthreads_or(live)) {
    // 1. one key per cluster: the block's least entry distance and the
    // id; the padded boxes of kRays clusters at a time in shared memory
    for (int c = tid; c < key_cap; c += kRays) keys[c] = kInfKey;
    for (int base = 0; base < n_clusters; base += kRays) {
      const int m = min(kRays, n_clusters - base);
      if (tid < m) {
        const int c = base + tid;
        for (int ax = 0; ax < 3; ++ax) {
          hala::pad_axis(__ldg(cmin + 3 * c + ax), __ldg(cmax + 3 * c + ax),
                         boxes + 6 * tid + ax, boxes + 6 * tid + 3 + ax);
        }
      }
      __syncthreads();
      if (tid * kGroup < m) {
        for (int ax = 0; ax < 6; ++ax) {
          float e = boxes[6 * tid * kGroup + ax];
          for (int q = tid * kGroup + 1; q < min(m, (tid + 1) * kGroup); ++q) {
            e = ax < 3 ? fminf(e, boxes[6 * q + ax]) : fmaxf(e, boxes[6 * q + ax]);
          }
          unions[6 * tid + ax] = e;
        }
      }
      __syncthreads();
      for (int g = 0; g * kGroup < m; ++g) {
        float tn;
        const bool near =
            live && hala::padded_entry(unions + 6 * g, r, &tn) && tn < b.t;
        if (!__any_sync(0xffffffffu, near)) continue;  // no lane enters any
        for (int q = g * kGroup; q < min(m, (g + 1) * kGroup); ++q) {
          unsigned key = kInfKey;
          if (near && hala::padded_entry(boxes + 6 * q, r, &tn) && tn < b.t) {
            key = (__float_as_uint(tn > 0.f ? tn : 0.f) & ~kIdMask) |
                  static_cast<unsigned>(base + q);
          }
          key = __reduce_min_sync(0xffffffffu, key);
          if (lane == 0 && key != kInfKey) atomicMin(keys + base + q, key);
        }
      }
      __syncthreads();
    }

    // 2. compact the live keys in place, chunk by chunk (every position
    // written is at or below one this chunk has already read), then sort
    int count = 0;
    for (int base = 0; base < n_clusters; base += kRays) {
      const int c = base + tid;
      const unsigned key = c < n_clusters ? keys[c] : kInfKey;
      const bool keep = key != kInfKey;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int at = count, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += warp_count[w];
        total += warp_count[w];
      }
      if (keep) keys[at + __popc(ballot & ((1u << lane) - 1u))] = key;
      count += total;
      __syncthreads();
    }
    int p2 = 1;
    while (p2 < count) p2 <<= 1;
    for (int c = count + tid; c < p2; c += kRays) keys[c] = kInfKey;
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = tid; q < p2 / 2; q += kRays) {
          const int x = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int y = x | j;
          const unsigned a = keys[x], e = keys[y];
          if ((a > e) == ((x & k) == 0)) {
            keys[x] = e;
            keys[y] = a;
          }
        }
        __syncthreads();
      }
    }

    // 3-5. walk the keys nearest first, one staged block ahead
    auto fetch = [&](int j) {
      const float* src = tri_packed +
                         static_cast<size_t>(keys[j] & kIdMask) * hala::kBlock;
      float* dst = stage + (j & 1) * kStage;
      for (int q = tid; q < kStage / 4; q += kRays) {
        cp_async16(dst + 4 * q, src + 4 * q);
      }
      cp_async_commit();
    };
    if (count > 0) fetch(0);
    for (int j = 0; j < count; ++j) {
      const unsigned key = keys[j];
      const float key_tn = __uint_as_float(key & ~kIdMask);
      const bool want = live && !done && key_tn <= b.t;
      cp_async_wait_all();
      if (!__syncthreads_or(want)) break;  // also: block j is staged
      ++runs;
      if (j + 1 < count) fetch(j + 1);
      const int c = static_cast<int>(key & kIdMask);
      const float* blk = stage + (j & 1) * kStage;
      float tn;
      if (!want || !hala::cluster_entry(cmin, cmax, c, r, &tn) || tn > b.t) {
        continue;
      }
      unsigned spans = 0;
      for (int s = 0; s < hala::kPretestBoxes; ++s) {
        if (hala::pretest_entry(blk + 9 * hala::kSlots, s, r, &tn) &&
            tn <= b.t) {
          spans |= 1u << s;
        }
      }
      for (int s = 0; s < hala::kPretestBoxes && !done; ++s) {
        if (!((spans >> s) & 1u)) continue;
        for (int k = s * hala::kPretestTris;
             k < (s + 1) * hala::kPretestTris; ++k) {
          float tt, uu, vv;
          if (!hala::mt_slot(r, blk[k], blk[hala::kSlots + k],
                             blk[2 * hala::kSlots + k], blk[3 * hala::kSlots + k],
                             blk[4 * hala::kSlots + k], blk[5 * hala::kSlots + k],
                             blk[6 * hala::kSlots + k], blk[7 * hala::kSlots + k],
                             blk[8 * hala::kSlots + k], &tt, &uu, &vv)) {
            continue;
          }
          const int slot = c * hala::kSlots + k;
          if (!hala::lex_better(tt, slot, b)) continue;
          b.t = tt;
          b.tri = slot;
          b.u = uu;
          b.v = vv;
          if (any_hit) {
            done = true;
            break;
          }
        }
      }
    }
  }
  if (in) {
    t_out[i] = b.t;
    tri_out[i] = b.tri;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
  if (runs_out != nullptr && tid == 0) runs_out[blockIdx.x] = runs;
}

}  // namespace

// runs_out may be null, else it receives ceil(n / 128) counts.
extern "C" int hala_matrix_traverse(
    const void* o, const void* d, const void* tmax, const void* cmin,
    const void* cmax, const void* tri_packed, int n, int n_clusters,
    int any_hit, void* t_out, void* tri_out, void* u_out, void* v_out,
    void* runs_out, void* stream) {
  if (n <= 0) return 0;
  if (n_clusters < 1 || n_clusters > static_cast<int>(kIdMask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int key_cap = 1;
  while (key_cap < n_clusters) key_cap <<= 1;
  const size_t shmem = (2 * kStage + key_cap) * sizeof(float);
  const int blocks = (n + kRays - 1) / kRays;
  matrix_walk_kernel<<<blocks, kRays, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(cmin),
      static_cast<const float*>(cmax), static_cast<const float*>(tri_packed),
      n, n_clusters, key_cap, any_hit, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(runs_out));
  return static_cast<int>(cudaGetLastError());
}
