// Exact tile-segment rasterization (reverse-Z, strict GREATER).
//
// Replaces the TPU kernel `_raster_kernel_body` of
// hala_tpu/ops/raster_kernel.py:53 (pallas_call :309,
// rasterize_tiled_exact): every output tile walks its own segment
// [starts[t], starts[t + 1]) of the packed candidate table in id order
// and depth-tests each candidate against each of its pixels, writing
// depth, triangle id and the un-divided perspective weights uw, vw, iw.
//
// Contract: the result equals the full O(pixels x triangles) scan of
// ops/raster.rasterize bit for bit. Two things carry that:
// - the strict `z > depth` over an id-ordered segment, with depth
//   starting at 0 and tri at -1: among the candidates of largest z the
//   lowest id wins, the full scan's first-column rule. No atomics and no
//   parallel reduction over candidates: each pixel's candidates are
//   visited by one thread, in order.
// - the full scan's arithmetic, operation for operation, with
//   `inv_area` read from the table (not recomputed). The JAX package's
//   full scan, as XLA compiles it for the CPU (where the raster goldens
//   were made), rounds with fused multiply-adds in fixed places: each
//   edge function is fma(dx, ry, -(dy * rx)) and each three-term sum
//   fma(a2, b2, fma(a0, b0, a1 * b1)). This kernel computes exactly those
//   FMAs (__fmaf_rn) and is compiled with --fmad=false, so nothing else
//   is contracted; the plain version (ops/raster.chunk_step) emulates
//   the same FMAs exactly, so the two agree bit for bit.
// Pixel centres are exact: float(tx0 + idx % tile) + 0.5. The id is
// stored as a float, exact below 2^24 (the wrapper asserts T < 2^20).
//
// Table layout: row-major (N, 16) f32, one 64-byte row per candidate:
// x0 y0 x1 y1 x2 y2 | z0 z1 z2 | iw0 iw1 iw2 | sign | inv_area | id | pad.
//
// What bounds it on an H100: operations. Each candidate-pixel pair costs
// 18 fp32 operations, counting an FMA as two (edge functions 15, signs
// 3), and a pair whose pixel is inside 8 more (barycentrics 3, depth
// 5), against 67 TFLOP/s outside the tensor cores; the bytes are only
// the table (64 B per candidate, read once per block) and 5 output
// planes, against 3.35 TB/s. Design: one block per output tile; the block stages its
// segment 128 candidates at a time in shared memory (8 KB, loaded
// coalesced, 16 floats per row) and every thread then reads the same
// candidate at once (a broadcast, no bank conflicts) and tests it
// against the pixels it owns, whose running best stays in registers.
// Known limit: per-tile segments are very skewed (at the atrium_big bench
// camera p50 8, p99 2662, max 5130 candidates; raster_kernel.py:5-7 of
// the JAX package), so the block of the longest tile sets the kernel's
// time while most SMs idle. Splitting long segments across blocks with a
// second merge pass is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block (one block per tile)
constexpr int kChunk = 128;    // candidates per shared-memory stage
constexpr int kRow = 16;       // floats per packed candidate row

template <int kPix>
__global__ void __launch_bounds__(kThreads)
raster_tiled_kernel(const int* __restrict__ starts,
                    const float* __restrict__ data, int tw, int tile,
                    float* __restrict__ depth_out, int* __restrict__ tri_out,
                    float* __restrict__ uw_out, float* __restrict__ vw_out,
                    float* __restrict__ iw_out) {
  __shared__ float cand[kChunk * kRow];
  const int t = blockIdx.x;
  const int n_pix = tile * tile;
  const int tx0 = (t % tw) * tile;
  const int ty0 = (t / tw) * tile;
  const int start = starts[t];
  const int end = starts[t + 1];
  const long long out_base = static_cast<long long>(t) * n_pix;

  // Pixels of this tile in passes of kThreads * kPix; a 64x64 tile
  // (kPix = 16) takes one pass.
  for (int p0 = 0; p0 < n_pix; p0 += kThreads * kPix) {
    float px[kPix], py[kPix], depth[kPix], uw[kPix], vw[kPix], iw[kPix];
    int tri[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int idx = p0 + threadIdx.x + k * kThreads;
      px[k] = static_cast<float>(tx0 + idx % tile) + 0.5f;
      py[k] = static_cast<float>(ty0 + idx / tile) + 0.5f;
      depth[k] = 0.f;
      tri[k] = -1;
      uw[k] = 0.f;
      vw[k] = 0.f;
      iw[k] = 0.f;
    }
    for (int c0 = start; c0 < end; c0 += kChunk) {
      const int count = min(kChunk, end - c0);
      __syncthreads();  // the previous chunk is no longer read
      const float* src = data + static_cast<long long>(c0) * kRow;
      for (int i = threadIdx.x; i < count * kRow; i += kThreads) {
        cand[i] = src[i];
      }
      __syncthreads();
      for (int j = 0; j < count; ++j) {
        const float* r = cand + j * kRow;
        const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
        const float x2 = r[4], y2 = r[5];
        const float z0 = r[6], z1 = r[7], z2 = r[8];
        const float iw0 = r[9], iw1 = r[10], iw2 = r[11];
        const float sgn = r[12], inv_area = r[13];
        const int gid = static_cast<int>(r[14]);
        // ops/raster.rasterize edge functions: w0 = edge(b, c),
        // w1 = edge(c, a), w2 = edge(a, b),
        // e(p) = fma(d.x, py - p0.y, -(d.y * (px - p0.x)))
        const float ex0 = x2 - x1, ey0 = y2 - y1;
        const float ex1 = x0 - x2, ey1 = y0 - y2;
        const float ex2 = x1 - x0, ey2 = y1 - y0;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float w0 = __fmaf_rn(ex0, py[k] - y1, -(ey0 * (px[k] - x1)));
          const float w1 = __fmaf_rn(ex1, py[k] - y2, -(ey1 * (px[k] - x2)));
          const float w2 = __fmaf_rn(ex2, py[k] - y0, -(ey2 * (px[k] - x0)));
          if (w0 * sgn >= 0.f && w1 * sgn >= 0.f && w2 * sgn >= 0.f) {
            const float l0 = w0 * inv_area;
            const float l1 = w1 * inv_area;
            const float l2 = w2 * inv_area;
            const float z = __fmaf_rn(l2, z2, __fmaf_rn(l0, z0, l1 * z1));
            if (z > depth[k]) {  // reverse-Z GREATER (rz_renderer.rs:494)
              const float u_w = l1 * iw1;
              const float v_w = l2 * iw2;
              depth[k] = z;
              tri[k] = gid;
              uw[k] = u_w;
              vw[k] = v_w;
              iw[k] = __fmaf_rn(l2, iw2, __fmaf_rn(l0, iw0, u_w));
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int idx = p0 + threadIdx.x + k * kThreads;
      if (idx < n_pix) {
        depth_out[out_base + idx] = depth[k];
        tri_out[out_base + idx] = tri[k];
        uw_out[out_base + idx] = uw[k];
        vw_out[out_base + idx] = vw[k];
        iw_out[out_base + idx] = iw[k];
      }
    }
  }
}

template <int kPix>
void launch(const void* starts, const void* data, int n_tiles, int tw,
            int tile, void* depth, void* tri, void* uw, void* vw, void* iw,
            cudaStream_t stream) {
  raster_tiled_kernel<kPix><<<n_tiles, kThreads, 0, stream>>>(
      static_cast<const int*>(starts), static_cast<const float*>(data), tw,
      tile, static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(uw), static_cast<float*>(vw),
      static_cast<float*>(iw));
}

}  // namespace

extern "C" int hala_raster_tiled(const void* starts, const void* data,
                                 int n_tiles, int tw, int tile, void* depth,
                                 void* tri, void* uw, void* vw, void* iw,
                                 void* stream) {
  if (n_tiles <= 0) return 0;
  const int n_pix = tile * tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // pixels per thread: as many as a tile needs, up to 16 (64x64 tiles)
  if (n_pix >= 16 * kThreads) {
    launch<16>(starts, data, n_tiles, tw, tile, depth, tri, uw, vw, iw, s);
  } else if (n_pix >= 4 * kThreads) {
    launch<4>(starts, data, n_tiles, tw, tile, depth, tri, uw, vw, iw, s);
  } else {
    launch<1>(starts, data, n_tiles, tw, tile, depth, tri, uw, vw, iw, s);
  }
  return static_cast<int>(cudaGetLastError());
}
