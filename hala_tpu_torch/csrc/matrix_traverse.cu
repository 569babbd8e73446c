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
// all 16 members for every lane once one lane enters their union, per
// lane visit it runs the box test and the sub-box tests, and it visits
// about a third more clusters per block than the fewest some lane must
// enter. Moller-Trumbore runs on the (ray, span) pairs the lanes enter,
// packed two spans a step: a warp whose lanes each ran the spans of the
// union of its lanes issued 16 iterations for every span any lane
// entered, and on incoherent bounce rays 6.6-11 % of its lanes did work.
// On those rays a warp now queues about one pair a visit, so the
// visits themselves (a block walks ~140 keys there while each lane
// needs a few) and the keys pass's member tests are what is left.
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
//  5. Test, against each lane's best t at the visit's start. A warp none
//     of whose lanes could improve skips the cluster. a. Queue: the
//     warp pads the visit's nine boxes (the eight row-9 spans and the
//     cluster's AABB) once, one axis a lane, into shared memory; a lane
//     re-runs its own slab test of the cluster (entry tn_c), then span
//     by span that of the span, and for each span it enters writes
//     (lane, span) to its warp's queue in shared memory, in span-then-
//     lane order, placed by a ballot and a prefix count (at most 32 x 8
//     one-byte entries). A warp none of whose lanes enters the cluster
//     skips it. b. Packed Moller-Trumbore: the warp drains its queue two
//     entries a step, lanes 0-15 on the 16 slots of one entry's span and
//     lanes 16-31 on the next entry's, the ray's o, d, tn_c and best t at
//     the start from two float4 a ray in shared memory (the keys pass's
//     box array). Neighbouring lanes read neighbouring slots of the
//     staged block, or the same ones, so the loads are free of bank
//     conflicts wherever the two entries share a span or their spans
//     differ in parity (empty sub-chunks are far point boxes whose slots
//     have zero edges: no hit). A lane that finds a hit recomputes its
//     span's tn_s from the padded box for the pair rule (the same
//     arithmetic on the same inputs as the queue's test). c. Reduction:
//     a lane whose hit is admissible and better than its ray's current
//     key posts a 64-bit shared atomicMin of (t bits << 32) | global
//     slot on it; t > 1e-4, so the bits order like t and the least key
//     is the lexicographic (t, slot) minimum, ties across spans and lanes
//     included. The key starts at (best t, max(best slot, 0)), so below
//     it lies exactly what lex_better accepts: a hit at t_max with no hit
//     before it stays out. With any_hit the key is the slot alone, among
//     hits with t below the best. After __syncwarp each lane reads its
//     key back into its t and slot; u and v (and an any-hit's t) are
//     recomputed once, at the end of the walk, by the ray's own lane
//     with mt_slot on the winning slot: the same function on the same
//     inputs under --fmad=false, the same bits.
// The function (cluster_walk.cuh `admissible`, ops/cluster.py): a pair
// Moller-Trumbore accepts at t counts only where tn_c <= t and
// tn_s <= t, two compares on the accepted pairs alone. Every skip is
// exact under it: a key, a cluster or a span entered beyond the best t
// holds only admissible pairs with t above the best, which cannot win,
// ties included; hence the tests stay `tn <= best`.
// Testing the spans against the best at the visit's start, not the best
// so far within it, queues more pairs but changes no result: a span
// entered beyond the visit's final best holds no pair that can win.
// Tie rule: clusters no longer come in id order, so a lane keeps the
// lexicographic (t, slot) minimum and tests boxes with tn <= best t (a
// box entered exactly at the best t may hold a lower slot at that t):
// the result is the lexicographic minimum over the admissible pairs,
// as `stream_plain`. With any_hit a lane is done at its first cluster
// with an admissible hit (the lowest such slot there).
// `runs_out`, when given, receives the clusters each block visited (the
// TPU kernel's runs_out), and `work_out` the entries queued and the
// packed steps; ops/traverse.py `matrix_walk_runs_plain` is the plain
// model of this schedule.
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
constexpr int kQueue = 32 * hala::kPretestBoxes;  // (lane, span) entries a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoSlot = ~0ull;  // any hit: none found

// A closest-hit candidate as one 64-bit key: t > 1e-4, so its float bits
// order like t, and the lowest key is the lexicographic (t, slot) minimum.
__device__ __forceinline__ unsigned long long pack_hit(float t, int slot) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(slot);
}

// Moller-Trumbore of slot k of a block's rows 0-8 (staged or in memory).
__device__ __forceinline__ bool mt_row(const float* blk, int k,
                                       const hala::Ray& r, float* t, float* u,
                                       float* v) {
  return hala::mt_slot(r, blk[k], blk[hala::kSlots + k],
                       blk[2 * hala::kSlots + k], blk[3 * hala::kSlots + k],
                       blk[4 * hala::kSlots + k], blk[5 * hala::kSlots + k],
                       blk[6 * hala::kSlots + k], blk[7 * hala::kSlots + k],
                       blk[8 * hala::kSlots + k], t, u, v);
}

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
    int* __restrict__ runs_out, int* __restrict__ work_out) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                                          // 2 x kStage
  unsigned* keys = reinterpret_cast<unsigned*>(smem + 2 * kStage);  // key_cap
  __shared__ int warp_count[kWarps];
  // the padded cluster boxes of the keys pass; then, per ray, o and d.x
  // and (d.y, d.z, the visit's tn_c, the best t at the visit's start)
  __shared__ float4 boxes4[2 * kRays];
  __shared__ float unions[6 * (kRays / kGroup)];  // and their groups' unions
  __shared__ float vbox[kWarps * 64];  // a visit's padded boxes: 8 spans, cluster
  __shared__ unsigned char queues[kWarps * kQueue];  // lane | span << 5
  __shared__ unsigned long long best_key[kRays];     // per visit
  float* boxes = reinterpret_cast<float*>(boxes4);

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
  int pairs = 0, steps = 0;  // this warp's queued entries and MT steps
  unsigned char* queue = queues + warp * kQueue;
  float4* rays = boxes4;
  float* wbox = vbox + warp * 64;

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

    rays[2 * tid] = make_float4(r.ox, r.oy, r.oz, r.dx);
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
      // 5a. the warp pads the visit's boxes, one axis a lane: spans 0-7
      // from the staged row 9, then the cluster's box
      if (!__any_sync(kFull, want)) continue;
      if (lane < 3 * (hala::kPretestBoxes + 1)) {
        const int bx = lane / 3, ax = lane - 3 * bx;
        const bool span = bx < hala::kPretestBoxes;
        hala::pad_axis(span ? blk[9 * hala::kSlots + 6 * bx + ax] : __ldg(cmin + 3 * c + ax),
                       span ? blk[9 * hala::kSlots + 6 * bx + 3 + ax] : __ldg(cmax + 3 * c + ax),
                       wbox + 6 * bx + ax, wbox + 6 * bx + 3 + ax);
      }
      __syncwarp();
      // and queues (lane, span) for each span a lane enters at or
      // before its best t at the visit's start
      float tn_c;
      const bool enter =
          want && hala::padded_entry(wbox + 6 * hala::kPretestBoxes, r, &tn_c) &&
          tn_c <= b.t;
      if (!__any_sync(kFull, enter)) continue;
      int n_q = 0;
      for (int s = 0; s < hala::kPretestBoxes; ++s) {
        float tn_s;
        const bool pass =
            enter && hala::padded_entry(wbox + 6 * s, r, &tn_s) && tn_s <= b.t;
        const unsigned ballot = __ballot_sync(kFull, pass);
        if (pass) {
          const int at = n_q + __popc(ballot & ((1u << lane) - 1u));
          queue[at] = static_cast<unsigned char>(lane | (s << 5));
        }
        n_q += __popc(ballot);
      }
      if (n_q == 0) continue;
      pairs += n_q;
      steps += (n_q + 1) >> 1;
      unsigned long long key0 = 0;
      if (enter) {
        key0 = any_hit ? kNoSlot : pack_hit(b.t, max(b.tri, 0));
        best_key[tid] = key0;
        rays[2 * tid + 1] = make_float4(r.dy, r.dz, tn_c, b.t);
      }
      __syncwarp();
      // 5b. Moller-Trumbore two entries a step: lanes 0-15 on the slots
      // of one entry's span, lanes 16-31 on the next entry's
      for (int e = lane >> 4; e < n_q; e += 2) {
        const unsigned id = queue[e];
        const int ray = (warp << 5) | static_cast<int>(id & 31u);
        const int span = static_cast<int>(id >> 5);
        const int k = span * hala::kPretestTris + (lane & 15);
        const float4 a = rays[2 * ray], w = rays[2 * ray + 1];
        hala::Ray q{};
        q.ox = a.x;
        q.oy = a.y;
        q.oz = a.z;
        q.dx = a.w;
        q.dy = w.x;
        q.dz = w.y;
        float tt, uu, vv;
        if (!mt_row(blk, k, q, &tt, &uu, &vv)) continue;
        q.invx = 1.0f / q.dx;  // as load_ray: the queue's test, repeated
        q.invy = 1.0f / q.dy;
        q.invz = 1.0f / q.dz;
        float tn_s;
        hala::padded_entry(wbox + 6 * span, q, &tn_s);
        if (!hala::admissible(w.z, tn_s, tt)) continue;
        const unsigned slot = static_cast<unsigned>(c * hala::kSlots + k);
        if (any_hit) {
          if (tt < w.w) atomicMin(best_key + ray, static_cast<unsigned long long>(slot));
        } else {
          const unsigned long long hit = pack_hit(tt, slot);
          if (hit < best_key[ray]) atomicMin(best_key + ray, hit);
        }
      }
      __syncwarp();
      // 5c. the lexicographic minimum of the hits better than key0
      if (enter) {
        const unsigned long long got = best_key[tid];
        if (got < key0) {
          b.tri = static_cast<int>(got & 0xFFFFFFFFu);
          if (any_hit) {
            done = true;
          } else {
            b.t = __uint_as_float(static_cast<unsigned>(got >> 32));
          }
        }
      }
    }
  }
  // t (any hit), u and v of the winning slot, from its block in memory
  if (b.tri >= 0) {
    const float* blk = tri_packed +
                       static_cast<size_t>(b.tri / hala::kSlots) * hala::kBlock;
    mt_row(blk, b.tri % hala::kSlots, r, &b.t, &b.u, &b.v);
  }
  if (in) {
    t_out[i] = b.t;
    tri_out[i] = b.tri;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
  if (runs_out != nullptr && tid == 0) runs_out[blockIdx.x] = runs;
  if (work_out != nullptr && lane == 0 && pairs > 0) {
    atomicAdd(work_out + 2 * blockIdx.x, pairs);
    atomicAdd(work_out + 2 * blockIdx.x + 1, steps);
  }
}

}  // namespace

// runs_out may be null, else it receives ceil(n / 128) counts; work_out
// may be null, else it holds 2 ceil(n / 128) zeros and receives per
// block the (lane, span) entries queued and the Moller-Trumbore steps.
extern "C" int hala_matrix_traverse(
    const void* o, const void* d, const void* tmax, const void* cmin,
    const void* cmax, const void* tri_packed, int n, int n_clusters,
    int any_hit, void* t_out, void* tri_out, void* u_out, void* v_out,
    void* runs_out, void* work_out, void* stream) {
  if (n <= 0) return 0;
  if (n_clusters < 1 || n_clusters > static_cast<int>(kIdMask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int key_cap = 1;
  while (key_cap < n_clusters) key_cap <<= 1;
  const size_t shmem = (2 * kStage + key_cap) * sizeof(float);
  // with the static arrays, above the default 48 KB from 4097 clusters
  static size_t shmem_set = 0;
  if (shmem > shmem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        matrix_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    shmem_set = shmem;
  }
  const int blocks = (n + kRays - 1) / kRays;
  matrix_walk_kernel<<<blocks, kRays, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(cmin),
      static_cast<const float*>(cmax), static_cast<const float*>(tri_packed),
      n, n_clusters, key_cap, any_hit, static_cast<float*>(t_out),
      static_cast<int*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(runs_out),
      static_cast<int*>(work_out));
  return static_cast<int>(cudaGetLastError());
}
