// Brute-force closest-hit / any-hit ray-triangle intersection.
//
// Replaces the TPU kernel `_kernel_body` of
// hala_tpu/ops/pallas/intersect_kernel.py (intersect_pallas /
// occluded_pallas): the exact closest hit of N rays against the first
// `num_real` of T triangles by Moller-Trumbore.
//
// Contract (intersect_kernel.py:99-111): det eps 1e-7, hits need
// t > 1e-4 and t < t_cur with t_cur starting at t_max, and the strict
// `<` in ascending slot order makes the lowest slot win ties. With
// any_hit set, a ray stops at its first hit in (1e-4, t_max) — the
// same boolean `tri >= 0` as the closest hit gives (the caller passes
// t_max = t_far * (1 - 1e-4)).
//
// What bounds it on an H100: arithmetic. Every live ray runs 45 float
// ops against every triangle (the reciprocal counted as one), and the
// triangle table is read once per block, not once per ray. The bound
// counts them at 67 TFLOP/s, which takes an FMA as two operations;
// compiled with --fmad=false every multiply and add is an instruction of
// its own, so half that rate is the reachable one, and the kernel
// issues ~60 instructions a pair (the IEEE reciprocal takes several,
// the tests and the loop the rest): about 4.4 ms for 524,288 rays x
// 4096 triangles at one instruction a clock on every scheduler.
// Design ("auto" sends it every scene of up to 4096 triangles):
// - a block of 1024 threads carries 2 rays a thread, so one triangle
//   read from shared memory serves 2 pairs; the triangle is three float4
//   (v0, e1, e2, each padded; ops/pallas/intersect_kernel.pack_triangles),
//   three vector loads that every thread issues at once (a broadcast, no
//   bank conflicts);
// - the block's 2048 rays load coalesced through shared memory; ray r of
//   thread t is ray blockIdx * 2048 + r * 1024 + t, so t_max and the
//   outputs are coalesced too (`ray_slots` in the wrapper's module);
// - then the whole table (4096 triangles: 192 KB) takes the rays' place
//   in dynamic shared memory, staged once with cp.async; a longer table
//   is walked in stages of the size the wrapper passes
//   (`stage_triangles`). One block an SM, 32 warps: on an H100, with
//   524,288 rays and 4096 triangles, 256 threads x 4 rays (8 warps an
//   SM) took 8.6 ms and 1024 x 1 5.7, against 5.6 here;
// - a ray skips the division where !ok_det (its pair cannot be valid);
// - any-hit (a template argument, so the closest hit carries none of
//   it): a ray ignores the table once it is blocked, a warp leaves when
//   all its rays are, and a block after a stage once all its rays are
//   (__syncthreads_or).
// Every expression rounds exactly as the plain PyTorch version in
// ops/pallas/intersect_kernel.py, whose three-term dot products are
// summed in the same left-to-right order; no test is moved ahead of the
// product by inv_det it depends on. The lowest slot keeps equal-t ties:
// each ray meets the slots in ascending order with a strict `<`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;                // threads per block, one block an SM
constexpr int kRays = 2;                      // rays a thread
constexpr int kBlockRays = kThreads * kRays;  // == intersect_kernel.BLOCK_RAYS
constexpr float kEps = 1.0e-7f;
constexpr float kTMin = 1.0e-4f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
intersect_bruteforce_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const float4* __restrict__ tris,
    int n, int num_real, int stage,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  // the rays' o and d pass through shared memory, then the table takes
  // their place
  extern __shared__ float4 smem[];
  float* ray_s = reinterpret_cast<float*>(smem);
  float4* tri_s = smem;
  const int base = blockIdx.x * kBlockRays;
  const int here = min(kBlockRays, n - base);
  for (int i = threadIdx.x; i < 3 * here; i += kThreads) {
    ray_s[i] = o[3LL * base + i];
    ray_s[3 * kBlockRays + i] = d[3LL * base + i];
  }
  __syncthreads();

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float t_cur[kRays], bu[kRays], bv[kRays];
  int best[kRays];
  bool done[kRays];
  bool all_done = true;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int k = r * kThreads + threadIdx.x;
    const bool in_range = k < here;
    ox[r] = ray_s[3 * k];
    oy[r] = ray_s[3 * k + 1];
    oz[r] = ray_s[3 * k + 2];
    dx[r] = ray_s[3 * kBlockRays + 3 * k];
    dy[r] = ray_s[3 * kBlockRays + 3 * k + 1];
    dz[r] = ray_s[3 * kBlockRays + 3 * k + 2];
    t_cur[r] = in_range ? tmax[base + k] : 0.f;
    best[r] = -1;
    bu[r] = 0.f;
    bv[r] = 0.f;
    // A ray whose range ends at or below t_min can never hit.
    done[r] = !in_range || !(t_cur[r] > kTMin);
    all_done = all_done && done[r];
  }

  for (int s0 = 0; s0 < num_real; s0 += stage) {
    const int count = min(stage, num_real - s0);
    __syncthreads();  // the rays, or the previous stage, are no longer read
    for (int i = threadIdx.x; i < 3 * count; i += kThreads) {
      cp_async16(tri_s + i, tris + 3LL * s0 + i);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < count; ++j) {
      if (kAnyHit && (j & 31) == 0 && __all_sync(0xffffffffu, all_done)) break;
      const float4 A = tri_s[3 * j], B = tri_s[3 * j + 1], C = tri_s[3 * j + 2];
      const float v0x = A.x, v0y = A.y, v0z = A.z;
      const float e1x = B.x, e1y = B.y, e1z = B.z;
      const float e2x = C.x, e2y = C.y, e2z = C.z;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        // pvec = d x e2
        const float px = dy[r] * e2z - dz[r] * e2y;
        const float py = dz[r] * e2x - dx[r] * e2z;
        const float pz = dx[r] * e2y - dy[r] * e2x;
        const float det = px * e1x + py * e1y + pz * e1z;
        const bool ok_det = fabsf(det) > kEps;
        float inv_det = 0.0f;
        if (ok_det) inv_det = 1.0f / det;
        const float tx = ox[r] - v0x, ty = oy[r] - v0y, tz = oz[r] - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        // qvec = tvec x e1
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx[r] * qx + dy[r] * qy + dz[r] * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        if (ok_det && u >= 0.f && v >= 0.f && u + v <= 1.f && tt > kTMin &&
            tt < t_cur[r] && !(kAnyHit && done[r])) {
          t_cur[r] = tt;
          best[r] = s0 + j;
          bu[r] = u;
          bv[r] = v;
          done[r] = kAnyHit;
        }
      }
      if (kAnyHit) {
        all_done = true;
#pragma unroll
        for (int r = 0; r < kRays; ++r) all_done = all_done && done[r];
      }
    }
    // every thread reaches this barrier; leave once no ray needs more
    if (!__syncthreads_or(!all_done)) break;
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int k = r * kThreads + threadIdx.x;
    if (k < here) {
      t_out[base + k] = t_cur[r];
      tri_out[base + k] = best[r];
      u_out[base + k] = bu[r];
      v_out[base + k] = bv[r];
    }
  }
}

}  // namespace

// tris: (num_real or more, 12) f32, rows v0 e1 e2 each padded to a
// float4, 16-byte aligned; stage: triangles a block stages at once
// (intersect_kernel.stage_triangles).
extern "C" int hala_intersect_bruteforce(
    const void* o, const void* d, const void* tmax, const void* tris, int n,
    int num_real, int stage, int any_hit, void* t_out, void* tri_out,
    void* u_out, void* v_out, void* stream) {
  if (n <= 0) return 0;
  if (stage <= 0) stage = 1;
  // intersect_kernel.smem_bytes
  const int smem = max(6 * kBlockRays * 4, stage * 48);
  static int smem_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        intersect_bruteforce_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(intersect_bruteforce_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const int blocks = (n + kBlockRays - 1) / kBlockRays;
  auto kernel = any_hit ? intersect_bruteforce_kernel<true>
                        : intersect_bruteforce_kernel<false>;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float4*>(tris), n,
      num_real, stage, static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out));
  return static_cast<int>(cudaGetLastError());
}
