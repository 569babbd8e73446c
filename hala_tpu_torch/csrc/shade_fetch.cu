// K9: the shading point's surface fetch, one launch per bounce and tile.
//
// Replaces no TPU kernel: in the JAX package the fetch is plain JAX
// inside `bounce_pre` (hala_tpu/models/integrator.py), which XLA fuses
// into a few loops. Written eagerly in PyTorch (ops/shade_fetch.py
// `shade_fetch_plain`, its plain version here) the same fetch is ~35
// row and texel gathers and ~400 elementwise passes a bounce and tile,
// and PyTorch's gather of 16-byte rows runs a block per index: a
// 2^20-row texel gather took ~0.6 ms, bound by the rate blocks are
// dispatched, not by bytes (PERF.md, K9).
//
// What it computes, for each lane i of a batch of hits (tri, u, v) and
// path lengths, formula for formula as `shade_fetch_plain`:
// * the shade row at clamp(tri, 0, rows - 1) (32 or 48 columns), or
//   row i of rows already fetched a lane (the rows of a geometry
//   sharded across ranks, which come back through a collective),
//   interpolated with w0 = (1 - u) - v into the normalized shading
//   normal ns, the uv, the tangent; the geometric normal oriented along
//   ns; the material id; the vertex colour of a 48-column row;
// * on a procedural sphere hit (tri >= PROC_BASE, ops/prims.py) the
//   sphere's analytic attributes instead: ns = ng = the normalized
//   offset of the hit point from the centre, uv = (u, v), the sphere's
//   material, vertex colour 1, tangent 0 and uv density
//   1 / max(2 pi r, 1e-6);
// * the material's packed row (ops/bsdf.py `gather_materials`), its
//   base colour times the vertex colour, its id columns as int32;
// * KHR_texture_transform of uv where the scene has one;
// * where the scene has textures: the mip LOD from the path length,
//   the pixel's cone angle and the row's uv density, and each map's
//   sample (ops/texture.py `sample_texture`): base colour,
//   metallic-roughness and emission trilinear at the LOD, the normal
//   map at level 0 where the scene has one; REPEAT wrap and the packed
//   pyramid's row offsets. A map index below 0 yields 1.0 without
//   reading a texel, which is what `torch.where` keeps there.
// The expressions are PyTorch's, one rounding per operation in the
// same order (--fmad=false, IEEE division and square root; log2f,
// sinf, cosf as PyTorch's CUDA kernels call them), and torch.clamp's
// NaN rule, so every output equals the plain version's bit for bit.
// Table ids past a table (a material or texture index the plain
// version would fault on) are clamped to its last row.
//
// Outputs: one float32 buffer of segments, each n x width, in the
// order of ops/shade_fetch.py `SEGMENTS` (the `kSeg*` offsets below);
// a segment of width w holds lane i's values at [i * w, i * w + w),
// so the wrapper's views are contiguous (n,) and (n, w) tensors, and
// int32 segments are read through an int32 view of the same buffer.
//
// What bounds it on an H100: bytes. A lane reads its hit (16 B) and
// its shade row (128 or 192 B) from device memory, and the material
// row, the uv transform, a sphere's row and up to 28 texels from
// tables that stay in L2 (atrium_big's texture stack is 1 MiB); it writes 216 B, 232 B
// with four maps. Design: one thread per lane, 256 a block; the shade
// and material rows come in as float4 loads; each lane's chain of
// dependent reads (hit, row, material, texture size, texels) is hidden
// by the other lanes in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// ops/prims.py PROC_BASE: procedural ids live above every triangle slot.
constexpr int kProcBase = 1 << 24;

// Segment offsets, in units of n floats (ops/shade_fetch.py SEGMENTS).
constexpr int kSegNs = 0;          // (n, 3)
constexpr int kSegUv = 3;          // (n, 2)
constexpr int kSegNg = 5;          // (n, 3)
constexpr int kSegTan = 8;         // (n, 3)
constexpr int kSegMatIdx = 11;     // (n,) int32
constexpr int kSegBase = 12;       // (n, 3)
constexpr int kSegEmission = 15;   // (n, 3)
constexpr int kSegScalars = 18;    // (n,) each: packed columns 3, 7-14
constexpr int kSegCoatTint = 27;   // (n, 3)
constexpr int kSegScalars2 = 30;   // (n,) each: packed columns 18-21
constexpr int kSegMatType = 34;    // (n,) int32
constexpr int kSegSigma = 35;      // (n, 3)
constexpr int kSegMaps = 38;       // 4 x (n,) int32: packed columns 23-26
constexpr int kSegTexels = 42;     // 3 or 4 x (n, 4)

struct Stack {
  const float4* data;  // (count, height, width) texels
  const int* sizes;    // (count, 2) level-0 height, width
  int count;
  int height;          // 2H: the canvas with its packed pyramid
  int width;
  int levels;
};

struct FetchArgs {
  const int* tri;
  const float* u;
  const float* v;
  const float* path_dist;
  const float* pixel_angle;  // 0-d
  const float* shade;        // (rows, cols)
  int rows;
  bool per_lane;             // shade holds row i of lane i (rows == n)
  const float* mats;         // (n_mats, 32)
  int n_mats;
  const float* uvt;          // (n_mats, 5), null without a uv transform
  Stack stack;
  int n_maps;                // 0 (no textures), 3, or 4 with normal maps
  const float* hit_p;        // (n, 3) hit points, null without spheres
  const float* proc;         // (n_proc, 8) [cx cy cz r mat 0 0 0]
  int n_proc;
  int n;
  float* out;
};

// torch.clamp on floats: NaN passes through, else max then min.
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_lo_hi(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// w0[:, None] * a + u[:, None] * b + v[:, None] * c
__device__ __forceinline__ float bary(float w0, float u, float v, float a,
                                      float b, float c) {
  return (w0 * a + u * b) + v * c;
}

// ops/sampling.py `normalize`: v / max(sqrt(dot(v, v)), 1e-12)
__device__ __forceinline__ void normalize3(float* x) {
  const float len = clamp_lo(sqrtf((x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]),
                             static_cast<float>(1e-12));
  x[0] = x[0] / len;
  x[1] = x[1] / len;
  x[2] = x[2] / len;
}

// torch.remainder(c.to(int32), clamp(n, min=1)): floor-mod.
__device__ __forceinline__ int wrap(float c, int n) {
  const int a = __float2int_rz(c);
  const int b = max(n, 1);
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// ops/texture.py `_bilinear` at one mip level.
__device__ float4 bilinear(const Stack& s, int idx, int h0, int w0, float u0,
                           float u1, int level) {
  const int max_h = s.height / 2;
  const int lh = max(h0 >> level, 1);
  const int lw = max(w0 >> level, 1);
  const int row_off = 2 * max_h - ((2 * max_h) >> level);
  const float h = static_cast<float>(lh);
  const float w = static_cast<float>(lw);
  const float uu = u0 - floorf(u0);
  const float vv = u1 - floorf(u1);
  const float x = uu * w - 0.5f;
  const float y = vv * h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int x0i = wrap(x0, lw);
  const int x1i = wrap(x0 + 1.0f, lw);
  const int y0i = wrap(y0, lh) + row_off;
  const int y1i = wrap(y0 + 1.0f, lh) + row_off;
  const float4* t = s.data + static_cast<long long>(idx) * s.height * s.width;
  const float4 c00 = __ldg(t + y0i * s.width + x0i);
  const float4 c01 = __ldg(t + y0i * s.width + x1i);
  const float4 c10 = __ldg(t + y1i * s.width + x0i);
  const float4 c11 = __ldg(t + y1i * s.width + x1i);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  // _lerp2: c00 (1-fx)(1-fy) + c01 fx (1-fy) + c10 (1-fx) fy + c11 fx fy
#define HALA_LERP2(k) \
  (((c00.k * gx * gy + c01.k * fx * gy) + c10.k * gx * fy) + c11.k * fx * fy)
  return make_float4(HALA_LERP2(x), HALA_LERP2(y), HALA_LERP2(z), HALA_LERP2(w));
#undef HALA_LERP2
}

// ops/texture.py `sample_texture`: trilinear at the lod where `lod` is
// set and the stack has levels, else bilinear at level 0; 1.0 for tex < 0.
__device__ float4 sample_map(const Stack& s, int tex, float u0, float u1,
                             bool lod, float lod_uv) {
  if (tex < 0) return make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const int idx = min(tex, s.count - 1);
  const int h0 = __ldg(s.sizes + 2 * idx);
  const int w0 = __ldg(s.sizes + 2 * idx + 1);
  if (!lod || s.levels <= 1) return bilinear(s, idx, h0, w0, u0, u1, 0);
  // _lod_levels
  const float level = clamp_lo_hi(
      lod_uv + log2f(clamp_lo(static_cast<float>(w0), 1.0f)), 0.0f,
      static_cast<float>(s.levels - 1));
  const int l0 = __float2int_rz(floorf(level));
  const int l1 = min(l0 + 1, s.levels - 1);
  const float fl = level - static_cast<float>(l0);
  const float4 b0 = bilinear(s, idx, h0, w0, u0, u1, l0);
  const float4 b1 = bilinear(s, idx, h0, w0, u0, u1, l1);
  const float gl = 1.0f - fl;
  return make_float4(b0.x * gl + b1.x * fl, b0.y * gl + b1.y * fl,
                     b0.z * gl + b1.z * fl, b0.w * gl + b1.w * fl);
}

template <int kCols>
__global__ void __launch_bounds__(kBlock) shade_fetch_kernel(FetchArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  float* out = a.out;
  int* outi = reinterpret_cast<int*>(a.out);
  auto put = [&](int seg, int w, int j, float x) {
    out[seg * n + static_cast<long long>(i) * w + j] = x;
  };
  auto put_int = [&](int seg, int x) { outi[seg * n + i] = x; };

  const float u = a.u[i];
  const float v = a.v[i];
  const int tri = a.tri[i];
  const int t = a.per_lane ? i : min(max(tri, 0), a.rows - 1);
  // The row's columns up to 41 (vertex colours end there): 8 or 11 float4.
  constexpr int kQuads = kCols > 32 ? 11 : 8;
  float row[kQuads * 4];
  const float4* r4 =
      reinterpret_cast<const float4*>(a.shade + static_cast<long long>(t) * kCols);
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const float4 q = __ldg(r4 + k);
    row[4 * k] = q.x;
    row[4 * k + 1] = q.y;
    row[4 * k + 2] = q.z;
    row[4 * k + 3] = q.w;
  }
  const float w0 = (1.0f - u) - v;

  float ns[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) ns[j] = bary(w0, u, v, row[j], row[3 + j], row[6 + j]);
  normalize3(ns);
  float uv0 = bary(w0, u, v, row[9], row[11], row[13]);
  float uv1 = bary(w0, u, v, row[10], row[12], row[14]);
  float ng[3] = {row[15], row[16], row[17]};
  if ((ng[0] * ns[0] + ng[1] * ns[1]) + ng[2] * ns[2] < 0.0f) {
    ng[0] = -ng[0];
    ng[1] = -ng[1];
    ng[2] = -ng[2];
  }
  int mat_idx = __float2int_rz(row[18]);
  float uv_dens = row[29];
  const bool is_proc = a.proc != nullptr && tri >= kProcBase;
  if (is_proc) {
    const int p = min(max(tri - kProcBase, 0), a.n_proc - 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(a.proc + p * 8));
    const float pmat = __ldg(a.proc + p * 8 + 4);
    ns[0] = a.hit_p[3 * i] - c.x;
    ns[1] = a.hit_p[3 * i + 1] - c.y;
    ns[2] = a.hit_p[3 * i + 2] - c.z;
    normalize3(ns);
    ng[0] = ns[0];
    ng[1] = ns[1];
    ng[2] = ns[2];
    uv0 = u;
    uv1 = v;
    mat_idx = __float2int_rz(pmat);
    // (2.0 * np.pi) * radius, the Python double rounded to float as
    // PyTorch rounds a scalar operand; 1.0 / x as reciprocal(x) * 1.0
    uv_dens = 1.0f / clamp_lo(static_cast<float>(2.0 * 3.141592653589793) * c.w,
                              static_cast<float>(1e-6));
  }
  const int m = min(max(mat_idx, 0), a.n_mats - 1);

  float mrow[32];
  const float4* m4 = reinterpret_cast<const float4*>(a.mats + m * 32);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 q = __ldg(m4 + k);
    mrow[4 * k] = q.x;
    mrow[4 * k + 1] = q.y;
    mrow[4 * k + 2] = q.z;
    mrow[4 * k + 3] = q.w;
  }
  float base[3] = {mrow[0], mrow[1], mrow[2]};
  if (kCols > 32 && !is_proc) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      base[j] = base[j] * bary(w0, u, v, row[32 + j], row[35 + j], row[38 + j]);
  }
  if (a.uvt != nullptr) {
    const float* q = a.uvt + m * 5;
    const float su = uv0 * __ldg(q + 3);
    const float sv = uv1 * __ldg(q + 4);
    const float cr = cosf(__ldg(q + 2));
    const float sr = sinf(__ldg(q + 2));
    const float tu = (__ldg(q) + cr * su) + sr * sv;
    const float tv = (__ldg(q + 1) - sr * su) + cr * sv;
    uv0 = tu;
    uv1 = tv;
  }

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    put(kSegNs, 3, j, ns[j]);
    put(kSegNg, 3, j, ng[j]);
    put(kSegTan, 3, j,
        is_proc ? 0.0f : bary(w0, u, v, row[20 + j], row[23 + j], row[26 + j]));
    put(kSegBase, 3, j, base[j]);
    put(kSegEmission, 3, j, mrow[4 + j]);
    put(kSegCoatTint, 3, j, mrow[15 + j]);
    put(kSegSigma, 3, j, mrow[28 + j]);
  }
  put(kSegUv, 2, 0, uv0);
  put(kSegUv, 2, 1, uv1);
  put_int(kSegMatIdx, mat_idx);
  // opacity, metallic, roughness, subsurface, specular_tint, sheen,
  // sheen_tint, clearcoat, clearcoat_roughness
  put(kSegScalars, 1, 0, mrow[3]);
#pragma unroll
  for (int k = 1; k < 9; ++k) put(kSegScalars + k, 1, 0, mrow[6 + k]);
  // specular_transmission, ior, ax, ay
#pragma unroll
  for (int k = 0; k < 4; ++k) put(kSegScalars2 + k, 1, 0, mrow[18 + k]);
  put_int(kSegMatType, __float2int_rz(mrow[22]));
  int maps[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    maps[k] = __float2int_rz(mrow[23 + k]);
    put_int(kSegMaps + k, maps[k]);
  }

  if (a.n_maps > 0) {
    const float lod_uv = log2f(clamp_lo_hi(
        a.path_dist[i] * __ldg(a.pixel_angle) * uv_dens,
        static_cast<float>(1e-6), static_cast<float>(1e6)));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= a.n_maps) break;
      // base colour, metallic-roughness and emission at the lod; the
      // normal map (the fourth) at level 0
      const float4 c = sample_map(a.stack, maps[k], uv0, uv1, k < 3, lod_uv);
      put(kSegTexels + 4 * k, 4, 0, c.x);
      put(kSegTexels + 4 * k, 4, 1, c.y);
      put(kSegTexels + 4 * k, 4, 2, c.z);
      put(kSegTexels + 4 * k, 4, 3, c.w);
    }
  }
}

}  // namespace

extern "C" int hala_shade_fetch(const void* tri, const void* u, const void* v,
                                const void* path_dist, const void* pixel_angle,
                                const void* shade, int rows, int cols,
                                int per_lane, const void* mats, int n_mats, const void* uvt,
                                const void* tex, const void* tex_sizes,
                                int n_tex, int tex_height, int tex_width,
                                int levels, int n_maps, const void* hit_p,
                                const void* proc, int n_proc, int n, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  if ((cols != 32 && cols != 48) || rows <= 0 || n_mats <= 0 ||
      (n_maps != 0 && n_maps != 3 && n_maps != 4) ||
      (n_maps > 0 && (tex == nullptr || n_tex <= 0 || levels <= 0)) ||
      (per_lane && rows != n) ||
      (proc != nullptr && (hit_p == nullptr || n_proc <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  FetchArgs a;
  a.tri = static_cast<const int*>(tri);
  a.u = static_cast<const float*>(u);
  a.v = static_cast<const float*>(v);
  a.path_dist = static_cast<const float*>(path_dist);
  a.pixel_angle = static_cast<const float*>(pixel_angle);
  a.shade = static_cast<const float*>(shade);
  a.rows = rows;
  a.per_lane = per_lane != 0;
  a.mats = static_cast<const float*>(mats);
  a.n_mats = n_mats;
  a.uvt = static_cast<const float*>(uvt);
  a.stack.data = static_cast<const float4*>(tex);
  a.stack.sizes = static_cast<const int*>(tex_sizes);
  a.stack.count = n_tex;
  a.stack.height = tex_height;
  a.stack.width = tex_width;
  a.stack.levels = levels;
  a.n_maps = n_maps;
  a.hit_p = static_cast<const float*>(hit_p);
  a.proc = static_cast<const float*>(proc);
  a.n_proc = n_proc;
  a.n = n;
  a.out = static_cast<float*>(out);
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols == 48)
    shade_fetch_kernel<48><<<grid, kBlock, 0, s>>>(a);
  else
    shade_fetch_kernel<32><<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
