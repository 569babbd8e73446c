// Exact tile-segment rasterization (reverse-Z, strict GREATER).
//
// Replaces the TPU kernel `_raster_kernel_body` of
// hala_tpu/ops/raster_kernel.py:53 (pallas_call :309,
// rasterize_tiled_exact): every output tile walks its own segment
// [starts[t], starts[t + 1]) of the packed candidate table in id order
// and depth-tests each candidate against each of its pixels, writing
// depth, triangle id and the un-divided perspective weights uw, vw, iw.
//
// Contract: the result equals the plain version
// (ops/raster_kernel.raster_segments_plain) bit for bit, and so the
// full O(pixels x triangles) scan of ops/raster.rasterize, except where
// the full scan's winner is a sliver whose rounded edge functions accept
// a pixel centre outside its box in another tile (the binning, of the
// JAX package too, is by box). What carries that:
// - the plain version's chunk rule: a tile's segment is taken in
//   128-candidate chunks from its start; within a chunk the first
//   candidate of largest z wins a pixel, and it replaces the carried
//   winner only where its z is strictly greater (depth starts at 0 and
//   tri at -1), so among the candidates of largest z the lowest id
//   wins, the full scan's first-column rule. A candidate that covers a
//   pixel with a NaN z makes the chunk's maximum NaN there, and the
//   plain version then keeps the carried winner for that chunk (a
//   triangle with an infinite corner gives such z). The kernel keeps
//   each pixel's chunk winner apart from the carried one and poisons
//   it on a NaN z, so it follows the same rule. No atomics on depth and
//   no reordering: each pixel's candidates are visited by one thread,
//   in order.
// - the full scan's arithmetic, operation for operation, with
//   `inv_area` read from the table (not recomputed). The JAX package's
//   full scan, as XLA compiles it for the CPU (where the raster goldens
//   were made), rounds with fused multiply-adds in fixed places: each
//   edge function is fma(dx, ry, -(dy * rx)) and each three-term sum
//   fma(a2, b2, fma(a0, b0, a1 * b1)). This kernel computes exactly those
//   FMAs (__fmaf_rn) and is compiled with --fmad=false, so nothing else
//   is contracted; the plain version (ops/raster.chunk_step) emulates
//   the same FMAs exactly, so the two agree bit for bit. A lane's
//   pixels share one column, so -(dy * (px - x)) is computed once a
//   candidate for all of them: the same operations on the same values.
// Pixel centres are exact: float(tx0 + idx % tile) + 0.5. The id is
// stored as a float, exact below 2^24 (the wrapper asserts T < 2^20).
//
// Table layout: row-major (N, 16) f32, one 64-byte row per candidate:
// x0 y0 x1 y1 x2 y2 | z0 z1 z2 | iw0 iw1 iw2 | sign | inv_area | id | pad.
//
// Design. The unit of work is a 16x16-pixel sub-tile of a tile (16
// units a 64x64 tile; at tile 16 the unit is the tile), walked by one
// warp over the tile's whole segment, 8 pixels a lane (one column, rows
// 2k + lane / 16), so a staged candidate serves 8 pairs a lane. Units
// are taken from a counter in the order of a bucket sort of the segment
// lengths, longest first (`order_tiles_kernel`, one block, before the
// walk): the 16 units of the longest tile start first, on 16 SMs, where
// one block used to walk all of its pixels. Each warp double-buffers its
// segment's 128-row chunks in shared memory of its own with cp.async
// (the next chunk flies while one is walked); when a chunk lands, lane l
// computes the skip boxes of rows l, l + 32, l + 64, l + 96, and a
// ballot lists the rows whose box reaches the sub-tile, in order; the
// warp walks only those. A walked row is tested in two passes: the
// inside flags of the lane's 8 pixels without a branch, then the depth
// test of the flagged ones only. One block of 4 warps an SM: a long
// unit's warp then has a scheduler to itself (on an H100 at the
// atrium_big bench shape, 0.261 ms against 0.292 and 0.309 with two and
// three blocks an SM).

// The sub-tile skip. When a chunk is staged each candidate gets a skip
// box, its screen bounding box widened by a margin m; a warp passes over
// a candidate whose box lies wholly beyond its sub-tile's pixel centres
// (it is left off the walk list). The skip must never drop a pixel that the
// rounded inside test (all three w * sgn >= 0) accepts. Argument, with
// u = 2^-24 and W = the box's larger extent:
// - Exact barycentrics: a point p at distance D > 0 beyond the box along
//   an axis has sum(lambda_i) = 1 and, along that axis, p = sum(lambda_i
//   v_i), so the negative lambdas sum to at most -D/W and one of them is
//   <= -D/(2W): its exact edge function has the wrong sign by at least
//   D |2A| / (2W), 2A the exact twice-area.
// - Rounding: an edge function fma(ex, ry, -(ey * rx)) with rounded
//   differences errs by at most 4.01u (|ex ry| + |ey rx|) plus 2^-148
//   (subnormals), where |ex|, |ey| <= W and |rx|, |ry| <= W + D: at most
//   8.02u W (W + D) + 2^-148. The twice-area computed as the plain
//   version does (`area`, the same fma) is within 8.02u W^2 + 2^-148 of 2A.
// - So where sgn = +-1 agrees with area's sign, |area| >= 2^-10 W^2,
//   2^-16 <= W and every corner lies within 2^22 of the origin, the
//   wrong-signed edge function stays wrong-signed (nonzero) after
//   rounding once D > 9.81e-4 W + 2^-100; the margin
//   m = W * 2^-9 + 1 exceeds that by 0.97e-3 W + 1, and the rounding of
//   m and of the box's ends (round to nearest; coordinates below 2^22
//   err by at most a quarter pixel) takes less than 0.26 of it.
// - Every other candidate (slivers, tiny or huge extents, non-finite or
//   +-0 signs, NaN or infinite corners: the tests are written so NaN
//   makes them false) gets an infinite box and is never skipped: all
//   its pairs are tested. ops/raster_kernel.skip_boxes computes the
//   same boxes on tensors, and the CPU tests hold the decision against
//   every pair the inside test accepts.
//
// What bounds it on an H100: operations. Each candidate-pixel pair costs
// 18 fp32 operations, counting an FMA as two (edge functions 15, signs
// 3), and a pair whose pixel is inside 8 more (barycentrics 3, depth
// 5), against 67 TFLOP/s outside the tensor cores; --fmad=false leaves
// every multiply and add a separate instruction, so that peak is half
// reachable. The bytes are only the table (64 B per candidate, read once
// per unit) and 5 output planes, against 3.35 TB/s. The skip leaves the
// pairs of the walked rows only (15 % of them at the bench camera).
// What bounds the time now: the longest walks, each one warp's chain of
// dependent shared loads and edge functions (at the bench camera up to
// 991 walked rows of a 4105-row segment, and 40 chunks of box tests in
// the 5037-row tile); the whole frame's walked pairs would take a tenth
// of the time spread evenly. Smaller units for the longest tiles would
// cut that chain; they are left to a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;            // candidates per stage: the plain version's chunk
constexpr int kWarps = 4;              // warps per block, each walks its own units
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = 64;          // one packed candidate row
constexpr int kSmem = kWarps * 2 * kChunk * kRowBytes  // two row buffers a warp
                      + kWarps * kChunk * 2;           // the walk lists
constexpr int kSub = 16;               // a unit is a kSub x kSub sub-tile
constexpr int kPix = kSub * kSub / 32; // pixels a lane, one column, rows 2k + lane / 16
constexpr int kBuckets = 33;           // __clz of a segment length, 0..32
constexpr int kPoisoned = -2;          // a chunk winner that a NaN z cancelled

// the skip box's bounds (see the header)
constexpr float kMaxCoord = 4194304.0f;          // 2^22
constexpr float kMinExtent = 1.52587890625e-05f; // 2^-16
constexpr float kSliver = 9.765625e-04f;         // 2^-10
constexpr float kMarginScale = 1.953125e-03f;    // 2^-9

// The candidate's skip box (x_lo, x_hi, y_lo, y_hi), or an infinite
// one where the argument of the header does not hold. fminf / fmaxf
// drop NaN corners; such a row's area is NaN and fails `ok`.
__device__ __forceinline__ float4 skip_box(float4 a, float4 b, float sgn) {
  const float x0 = a.x, y0 = a.y, x1 = a.z, y1 = a.w, x2 = b.x, y2 = b.y;
  const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
  const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
  const float w = fmaxf(xmax - xmin, ymax - ymin);
  // ops/raster.signed_area: edge(b - a, c - a)
  const float area = __fmaf_rn(x1 - x0, y2 - y0, -((y1 - y0) * (x2 - x0)));
  const bool ok = (sgn == 1.0f || sgn == -1.0f) && xmin >= -kMaxCoord &&
                  xmax <= kMaxCoord && ymin >= -kMaxCoord &&
                  ymax <= kMaxCoord && w >= kMinExtent &&
                  sgn * area >= (w * w) * kSliver;
  if (!ok) return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const float m = w * kMarginScale + 1.0f;
  return make_float4(xmin - m, xmax + m, ymin - m, ymax + m);
}

struct Pixels {
  float cz[kPix], cuw[kPix], cvw[kPix], ciw[kPix];  // this chunk's winner
  int ctri[kPix];                                   // -1 none, kPoisoned
};

// One candidate against a lane's pixels, in two passes: the inside
// flags first (no branch), then, only for the flagged pixels, the edge
// functions again (the same operations on the same values) and the
// depth test. kMode 1: sgn == 1, 2: sgn == -1 (w * sgn >= 0 as a plain
// compare, the same truth value), 0: any sign.
template <int kMode>
__device__ __forceinline__ void test_candidate(float4 a, float4 b, float4 c,
                                                      float4 e, float px,
                                                      const float (&py)[kPix],
                                                      Pixels& p) {
  const float x0 = a.x, y0 = a.y, x1 = a.z, y1 = a.w, x2 = b.x, y2 = b.y;
  const float sgn = e.x;
  const float ex0 = x2 - x1, ey0 = y2 - y1;
  const float ex1 = x0 - x2, ey1 = y0 - y2;
  const float ex2 = x1 - x0, ey2 = y1 - y0;
  const float n0 = -(ey0 * (px - x1));
  const float n1 = -(ey1 * (px - x2));
  const float n2 = -(ey2 * (px - x0));
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float w0 = __fmaf_rn(ex0, py[k] - y1, n0);
    const float w1 = __fmaf_rn(ex1, py[k] - y2, n1);
    const float w2 = __fmaf_rn(ex2, py[k] - y0, n2);
    bool inside;
    if (kMode == 1) {
      inside = w0 >= 0.f && w1 >= 0.f && w2 >= 0.f;
    } else if (kMode == 2) {
      inside = w0 <= 0.f && w1 <= 0.f && w2 <= 0.f;
    } else {
      inside = w0 * sgn >= 0.f && w1 * sgn >= 0.f && w2 * sgn >= 0.f;
    }
    mask |= static_cast<unsigned>(inside) << k;
  }
  if (mask == 0) return;
  const float z0 = b.z, z1 = b.w, z2 = c.x;
  const float iw0 = c.y, iw1 = c.z, iw2 = c.w;
  const float inv_area = e.y;
  const int gid = static_cast<int>(e.z);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (mask & (1u << k)) {
      const float w0 = __fmaf_rn(ex0, py[k] - y1, n0);
      const float w1 = __fmaf_rn(ex1, py[k] - y2, n1);
      const float w2 = __fmaf_rn(ex2, py[k] - y0, n2);
      const float l0 = w0 * inv_area;
      const float l1 = w1 * inv_area;
      const float l2 = w2 * inv_area;
      const float z = __fmaf_rn(l2, z2, __fmaf_rn(l0, z0, l1 * z1));
      if (z > p.cz[k]) {  // reverse-Z GREATER (rz_renderer.rs:494)
        const float u_w = l1 * iw1;
        p.cz[k] = z;
        p.ctri[k] = gid;
        p.cuw[k] = u_w;
        p.cvw[k] = l2 * iw2;
        p.ciw[k] = __fmaf_rn(l2, iw2, __fmaf_rn(l0, iw0, u_w));
      } else if (isnan(z)) {  // nothing is greater than +inf: stays poisoned
        p.cz[k] = INFINITY;
        p.ctri[k] = kPoisoned;
      }
    }
  }
}

// Tiles in descending order of segment length, by buckets of equal
// __clz (order within a bucket is free: it changes only the schedule),
// and the walk's unit counter set to 0.
__global__ void __launch_bounds__(1024)
order_tiles_kernel(const int* __restrict__ starts, int n_tiles,
                   int* __restrict__ order, int* __restrict__ counter) {
  __shared__ int slot[kBuckets];
  if (threadIdx.x < kBuckets) slot[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    atomicAdd(&slot[__clz(starts[t + 1] - starts[t])], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      const int c = slot[b];
      slot[b] = sum;
      sum += c;
    }
    *counter = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    order[atomicAdd(&slot[__clz(starts[t + 1] - starts[t])], 1)] = t;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Each lane copies its share of `count` rows from global to shared
// memory, as one cp.async group.
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src,
                                           int count, int lane) {
  for (int q = lane; q < 4 * count; q += 32) cp_async16(dst + q, src + q);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 1)
raster_tiled_kernel(const int* __restrict__ starts,
                    const float4* __restrict__ data,
                    const int* __restrict__ order, int* __restrict__ counter,
                    int n_units, int tw, int tile,
                    float* __restrict__ depth_out, int* __restrict__ tri_out,
                    float* __restrict__ uw_out, float* __restrict__ vw_out,
                    float* __restrict__ iw_out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4* bufs = smem + warp * 2 * kChunk * 4;  // two chunks of rows
  unsigned short* walk = reinterpret_cast<unsigned short*>(
                             smem + kWarps * 2 * kChunk * 4) + warp * kChunk;
  const int spt = tile / kSub;  // sub-tiles along a tile side
  const int upt = spt * spt;    // units a tile
  const int n_pix = tile * tile;

  while (true) {
    int unit = 0;
    if (lane == 0) unit = atomicAdd(counter, 1);
    unit = __shfl_sync(0xffffffffu, unit, 0);
    if (unit >= n_units) break;
    const int t = order[unit / upt];
    const int s = unit % upt;
    const int sx = (s % spt) * kSub;  // sub-tile origin within the tile
    const int sy = (s / spt) * kSub;
    const int tx0 = (t % tw) * tile;
    const int ty0 = (t / tw) * tile;
    const int start = starts[t];
    const int end = starts[t + 1];
    const int lx = sx + lane % 16;
    const int ly = sy + lane / 16;
    const float px = static_cast<float>(tx0 + lx) + 0.5f;
    float py[kPix], depth[kPix], uw[kPix], vw[kPix], iw[kPix];
    int tri[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      py[k] = static_cast<float>(ty0 + ly + 2 * k) + 0.5f;
      depth[k] = 0.f;
      tri[k] = -1;
      uw[k] = 0.f;
      vw[k] = 0.f;
      iw[k] = 0.f;
    }
    // the sub-tile's first and last pixel centres
    const float cx0 = static_cast<float>(tx0 + sx) + 0.5f;
    const float cx1 = static_cast<float>(tx0 + sx + kSub - 1) + 0.5f;
    const float cy0 = static_cast<float>(ty0 + sy) + 0.5f;
    const float cy1 = static_cast<float>(ty0 + sy + kSub - 1) + 0.5f;

    __syncwarp();  // the previous unit's last chunk is no longer read
    if (start < end) {
      stage_rows(bufs, data + 4LL * start, min(kChunk, end - start), lane);
    }
    for (int c0 = start, b = 0; c0 < end; c0 += kChunk, b ^= 1) {
      const int count = min(kChunk, end - c0);
      const float4* rows = bufs + b * kChunk * 4;
      // the next chunk flies while this one is walked
      if (c0 + kChunk < end) {
        stage_rows(bufs + (b ^ 1) * kChunk * 4, data + 4LL * (c0 + kChunk),
                   min(kChunk, end - c0 - kChunk), lane);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      // Lane l tests rows l, l + 32, l + 64 and l + 96 against the
      // sub-tile; the rows the warp walks go to `walk`, in order.
      int n_walk = 0;
#pragma unroll
      for (int m = 0; m < kChunk / 32; ++m) {
        const int r = lane + 32 * m;
        bool keep = false;
        if (r < count) {
          const float4 bx = skip_box(rows[4 * r], rows[4 * r + 1], rows[4 * r + 3].x);
          // skip only where provably outside (false on NaN)
          keep = !(bx.y < cx0 || bx.x > cx1 || bx.w < cy0 || bx.z > cy1);
        }
        const unsigned bits = __ballot_sync(0xffffffffu, keep);
        if (keep) walk[n_walk + __popc(bits & ((1u << lane) - 1))] = r;
        n_walk += __popc(bits);
      }
      __syncwarp();
      Pixels p;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        p.cz[k] = depth[k];
        p.ctri[k] = -1;
        p.cuw[k] = 0.f;
        p.cvw[k] = 0.f;
        p.ciw[k] = 0.f;
      }
      for (int i = 0; i < n_walk; ++i) {
        const int j = walk[i];
        const float4 a = rows[4 * j], b4 = rows[4 * j + 1];
        const float4 c = rows[4 * j + 2], e = rows[4 * j + 3];
        if (e.x == 1.0f) {
          test_candidate<1>(a, b4, c, e, px, py, p);
        } else if (e.x == -1.0f) {
          test_candidate<2>(a, b4, c, e, px, py, p);
        } else {
          test_candidate<0>(a, b4, c, e, px, py, p);
        }
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (p.ctri[k] >= 0) {  // the chunk's winner beat the carried one
          depth[k] = p.cz[k];
          tri[k] = p.ctri[k];
          uw[k] = p.cuw[k];
          vw[k] = p.cvw[k];
          iw[k] = p.ciw[k];
        }
      }
      __syncwarp();  // this buffer and the walk list are no longer read
    }
    const long long out_base = static_cast<long long>(t) * n_pix + lx;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const long long o = out_base + static_cast<long long>(ly + 2 * k) * tile;
      depth_out[o] = depth[k];
      tri_out[o] = tri[k];
      uw_out[o] = uw[k];
      vw_out[o] = vw[k];
      iw_out[o] = iw[k];
    }
  }
}

}  // namespace

// order: n_tiles int32 and counter: 1 int32 of scratch, written here.
extern "C" int hala_raster_tiled(const void* starts, const void* data,
                                 int n_tiles, int tw, int tile, void* depth,
                                 void* tri, void* uw, void* vw, void* iw,
                                 void* order, void* counter, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile % kSub != 0) return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaFuncSetAttribute(
        raster_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units = n_tiles * (tile / kSub) * (tile / kSub);
  order_tiles_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(starts),
                                        n_tiles, static_cast<int*>(order),
                                        static_cast<int*>(counter));
  // one block an SM: a warp a scheduler (see the header)
  const int blocks = min(sms, (units + kWarps - 1) / kWarps);
  raster_tiled_kernel<<<blocks, kThreads, kSmem, s>>>(
      static_cast<const int*>(starts), static_cast<const float4*>(data),
      static_cast<const int*>(order), static_cast<int*>(counter), units, tw,
      tile, static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(uw), static_cast<float*>(vw),
      static_cast<float*>(iw));
  return static_cast<int>(cudaGetLastError());
}
