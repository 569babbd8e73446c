// K10: a bounce's shading after the surface fetch, one launch per bounce
// and tile (and, where the fetch needs the path length or the hit point,
// one short pass before it).
//
// Replaces no TPU kernel: in the JAX package this is plain JAX inside
// `bounce_pre` (hala_tpu/models/integrator.py), which XLA fuses into a
// few loops. Written eagerly in PyTorch (models/integrator.py
// `bounce_pre`, the plain version here) it is ~1,000 elementwise
// launches a bounce and tile, each paid for by the host.
//
// What it computes, for each lane i of a tile, formula for formula as
// the plain version:
// * the light-set hit along the ray (ops/lights.py `intersect_lights`:
//   quad and sphere lights, MIS against the previous bounce's pdf), the
//   free flight of a scattering medium, and the sky or the environment
//   map where the ray misses (ops/env.py `sky_radiance`, `env_eval`);
// * from the surface fetch (K9's outputs, or the plain fetch's): normal
//   mapping, the two-sided frame, the tangent frame, the textured
//   material parameters and the relative ior; Beer-Lambert absorption,
//   emissive media; the first hit's albedo and normal; surface emission;
//   the alpha test;
// * next-event estimation over the analytic lights (ops/lights.py
//   `sample_one_light`, the five light types) and the environment map
//   (ops/env.py `env_sample`), each with the BSDF's value and pdf;
// * the BSDF sample (ops/bsdf.py: Oren-Nayar, and Disney with its
//   diffuse, specular, clearcoat and transmission lobes), the medium's
//   Henyey-Greenstein continuation and boundary tracking, and Russian
//   roulette;
// * the random numbers of ops/rng.py: PCG4D keyed on the global pixel,
//   or the blue-noise texture under a PCG4D rotation.
// The expressions are PyTorch's, one rounding per operation in the same
// order (--fmad=false, IEEE division and square root; expf, logf,
// sinf, cosf, atan2f, acosf and powf as PyTorch's CUDA kernels call
// them), torch.clamp's and torch.maximum's NaN rules, a division by a
// Python number as PyTorch's CUDA kernel does it (times the float
// reciprocal) and `1.0 / x` as reciprocal(x) times 1.0, so every output
// equals the plain version's bit for bit.
//
// Specialisation: the Disney model, its transmission lobe and the
// environment map are template arguments (the diffuse-only instance
// holds no Disney code); media, textures, normal maps, blue noise, the
// first bounce's AOVs and Russian roulette are uniform branches.
//
// Outputs: one float32 buffer of segments at the offsets the wrapper
// gives (ops/shade_bounce.py `layout`). The query segments hold the
// extension rays, then the light's shadow rays, then the environment
// map's, as the rows of the batched visibility query; a mask segment
// holds bytes, read through a bool view. The first bounce's albedo and
// normal go to a buffer of their own, which the film keeps to the end
// of the tile without keeping the rest.
//
// What bounds it on an H100: bytes. A lane reads its state (~100 B)
// and its surface fetch (~200-260 B) and writes ~120-200 B; the light,
// medium and environment tables stay in L2. One thread per lane, 256 a
// block.

#include <cuda_runtime.h>
#include <math.h>

// Segments of the output buffer (ops/shade_bounce.py SEGMENTS).
enum Seg {
  kQO, kQD, kQT, kRadiance, kNextTp, kNextPdf, kPathDist, kNeeContrib,
  kRAlpha, kDensity, kG, kColor, kEnvContrib, kMasks, kNumSegs
};

// The seam passes' output (ops/shade_bounce.py RAY_SEAMS, HIT_SEAMS):
// segment k starts at float k * n, a lane's values side by side.
enum SeamSeg {
  // before the intersection and miss kernels: the light-set hit, the
  // radiance of a ray that leaves the scene
  kSeamLhT = 0, kSeamLhPdf = 1, kSeamLhRad = 2, kSeamEnvRad = 5, kRaySeamEnd = 8,
  // before the closest-hit and any-hit kernels: the hit's context, the
  // textured material, the alpha test's draw, on_surface as bytes
  kSeamP = 0, kSeamNs = 3, kSeamNg = 6, kSeamBase = 9, kSeamEmission = 12,
  kSeamMetallic = 15, kSeamRoughness = 16, kSeamAx = 17, kSeamAy = 18, kSeamIor = 19,
  kSeamRAlpha = 20, kSeamOnSurface = 24, kHitSeamEnd = 25
};

struct HalaBounceArgs {
  // bounce state, n lanes
  const float* o;
  const float* d;
  const float* hit_t;
  const int* hit_tri;
  const float* throughput;
  const float* radiance;
  const unsigned char* active;
  const float* prev_pdf;
  const float* path_dist;
  const float* med_density;
  const float* med_g;
  const float* med_color;
  const float* albedo;
  const float* normal;
  const long long* pixel;   // global pixel ids
  const long long* frame;   // a frame index a lane, or null: frame0
  long long frame0;
  // the surface fetch (ops/shade_fetch.py SurfaceFetch)
  const float* ns;
  const float* ng;
  const float* tan;
  const int* mat_idx;
  const float* base_color;
  const float* emission;
  const float* opacity;
  const float* metallic;
  const float* roughness;
  const float* subsurface;
  const float* specular_tint;
  const float* sheen;
  const float* sheen_tint;
  const float* clearcoat;
  const float* clearcoat_roughness;
  const float* clearcoat_tint;
  const float* specular_transmission;
  const float* ior;
  const float* ax;
  const float* ay;
  const int* mat_type;
  const float* medium_sigma;
  const int* mr_map;
  const int* normal_map;
  const float* base_t;
  const float* mr_t;
  const float* em_t;
  const float* n_tex;
  // lights (ops/lights.py)
  const float* l_intensity;
  const float* l_position;
  const float* l_u;
  const float* l_v;
  const float* l_radius;
  const float* l_area;
  const int* l_type;
  int n_lights;
  float light_div;   // x / float(nl): x * (1.0f / nl)
  float light_sel;   // x * (1.0 / nl)
  // media (DeviceMaterials)
  const int* medium_type;
  const float* medium_color;
  const float* medium_density;
  const float* medium_anisotropy;
  int n_mats;
  // environment map (envmap.py EnvMap)
  const float* env_image;
  const float* env_marginal;
  const float* env_conditional;
  const float* env_luminance;
  const float* env_total;
  const float* env_sin_theta;
  const float* env_cos_theta;
  const float* env_cos_phi;
  const float* env_sin_phi;
  int env_w;
  int env_h;
  // uniforms (0-d or (3,) device tensors)
  const float* ground;
  const float* sky;
  const float* env_intensity;
  const float* env_rotation;
  // blue noise (H, W, C)
  const float* bn;
  int bn_h;
  int bn_w;
  int bn_c;
  int width;         // the film's width: screen x, y of a pixel id
  // the bounce and the scene's capabilities
  int n;
  int bounce;
  int rr;            // bounce >= rr_depth
  int aov;           // bounce == 0
  int scatter;
  int absorb;
  int emissive;
  int textures;
  int normal_maps;
  int q;             // query rows a lane: 2, or 3 with the environment map
  long long off[kNumSegs];
  float* out;
  float* aov_out;        // the first hit's albedo, then normal: (2, n, 3)
  float* pre_path_dist;  // the pass before the fetch: path length
  float* pre_hit_p;      // and hit point
  // the seams a pushed kernel overrides (models/integrator.py
  // KernelHooks), each null where K10 computes its own
  const float* lh_t;     // intersection: the light-set hit's t,
  const float* lh_rad;   // radiance (n, 3)
  const float* lh_pdf;   // and pdf
  const float* env_in;   // miss: the radiance of a ray leaving (n, 3)
  const unsigned char* pass_in;  // any hit: the pass-through decision
  int mat_final;         // closest hit: the material as given, no maps, no ior flip
  float* seam_out;       // the seam passes' output (SeamSeg)
};

namespace {

using BounceArgs = HalaBounceArgs;

constexpr int kBlock = 256;

#define F(x) static_cast<float>(x)

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 2.0 * kPi;
constexpr double kInvPi = 1.0 / kPi;
constexpr float kTMax = F(3.0e38);   // ops/intersect.py T_MAX
constexpr float kTMin = F(1.0e-4);   // ops/intersect.py T_MIN
constexpr float kIsectEps = F(1.0e-7);
constexpr float kEps = F(1e-6);      // ops/bsdf.py, ops/lights.py, ops/env.py _EPS
constexpr float kRayEps = F(1e-4);   // models/integrator.py _RAY_EPS

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 muls(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 divs(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return v3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}
// the first three of a row of four (a texel)
__device__ __forceinline__ V3 load3v4(const float* p, long long i) {
  return v3(__ldg(p + 4 * i), __ldg(p + 4 * i + 1), __ldg(p + 4 * i + 2));
}

// torch.clamp on floats: NaN passes through, else max then min.
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// torch.maximum / torch.minimum: NaN propagates.
__device__ __forceinline__ float tmaximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tminimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// ops/sampling.py normalize: v / max(sqrt(dot(v, v)), 1e-12)
__device__ __forceinline__ V3 normalize(V3 a) {
  return divs(a, clamp_lo(sqrtf(dot(a, a)), F(1e-12)));
}
// 1.0 / x, as Python's float over a tensor: reciprocal(x) * 1.0
__device__ __forceinline__ float rcp(float x) { return (1.0f / x) * 1.0f; }
// x ** 5 with a Python int exponent: powf
__device__ __forceinline__ float pow5(float x) { return powf(x, 5.0f); }
// ops/sampling.py power_heuristic
__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  return a2 / clamp_lo(a2 + b * b, F(1e-12));
}
// torch.remainder of int64s: floor-mod
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ long long clampi(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ops/sampling.py build_basis (Duff et al. 2017)
__device__ __forceinline__ void build_basis(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = rcp(sign + n.z) * -1.0f;
  const float bb = n.x * n.y * a;
  t = v3(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
  b = v3(bb, sign + n.y * n.y * a, -n.y);
}
__device__ __forceinline__ V3 to_world(V3 l, V3 t, V3 b, V3 n) {
  return add(add(muls(t, l.x), muls(b, l.y)), muls(n, l.z));
}
__device__ __forceinline__ V3 to_local(V3 w, V3 t, V3 b, V3 n) {
  return v3(dot(w, t), dot(w, b), dot(w, n));
}
__device__ __forceinline__ V3 cosine_sample_hemisphere(float u1, float u2) {
  const float r = sqrtf(u1);
  const float phi = u2 * F(kTwoPi);
  return v3(r * cosf(phi), r * sinf(phi), sqrtf(clamp_lo(1.0f - u1, 0.0f)));
}
__device__ __forceinline__ V3 uniform_sample_cone(float u1, float u2, float cos_max) {
  const float ct = 1.0f - u1 * (1.0f - cos_max);
  const float st = sqrtf(clamp_lo(1.0f - ct * ct, 0.0f));
  const float phi = u2 * F(kTwoPi);
  return v3(st * cosf(phi), st * sinf(phi), ct);
}

// ---------------------------------------------------------------------------
// ops/rng.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 pcg4d(uint4 v) {
  v.x = v.x * 1664525u + 1013904223u;
  v.y = v.y * 1664525u + 1013904223u;
  v.z = v.z * 1664525u + 1013904223u;
  v.w = v.w * 1664525u + 1013904223u;
  unsigned x = v.x + v.y * v.w;
  unsigned y = v.y + v.z * x;
  unsigned z = v.z + x * y;
  unsigned w = v.w + y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x = x + y * w;
  y = y + z * x;
  z = z + x * y;
  w = w + y * z;
  return make_uint4(x, y, z, w);
}

__device__ __forceinline__ float u24(unsigned b) {
  return static_cast<float>(b >> 8) * F(1.0 / (1 << 24));
}

struct Sampler {
  unsigned pix;
  unsigned frame;
  long long px, py;
};

// rng.sample4 (pixel, frame, bounce, seed), or rng.bn_sample4 where a
// blue-noise texture is given
__device__ float4 s4(const BounceArgs& a, const Sampler& s, unsigned seed) {
  const unsigned bounce = static_cast<unsigned>(a.bounce);
  if (a.bn == nullptr) {
    const uint4 b = pcg4d(make_uint4(s.pix, s.frame, bounce, seed));
    return make_float4(u24(b.x), u24(b.y), u24(b.z), u24(b.w));
  }
  const uint4 h = pcg4d(make_uint4(bounce, seed, 0x9E3779B9u, 0x85EBCA6Bu));
  const long long tx = (s.px + static_cast<long long>(h.x) % a.bn_w) % a.bn_w;
  const long long ty = (s.py + static_cast<long long>(h.y) % a.bn_h) % a.bn_h;
  const float* t = a.bn + (ty * a.bn_w + tx) * a.bn_c;
  const uint4 b = pcg4d(make_uint4(0u, s.frame, bounce, seed));
  float r[4] = {__ldg(t) + u24(b.x), __ldg(t + 1) + u24(b.y), __ldg(t + 2) + u24(b.z),
                __ldg(t + 3) + u24(b.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // torch.remainder(x, 1.0)
    float m = fmodf(r[k], 1.0f);
    if (m != 0.0f && (m < 0.0f)) m += 1.0f;
    r[k] = m;
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

// ---------------------------------------------------------------------------
// ops/lights.py
// ---------------------------------------------------------------------------

struct LightHit {
  float t;
  float pdf;
  int li;  // -1: no hit
};

__device__ __forceinline__ V3 light3(const float* p, int l) { return load3(p, l); }

// intersect_lights: the closest quad (through its emitting face) or
// sphere light along (o, d); the index of the first of equal t, NaN first
// (torch.min's rule)
__device__ LightHit intersect_lights(const BounceArgs& a, V3 o, V3 d) {
  LightHit h{kTMax, 0.0f, -1};
  if (a.n_lights == 0) return h;
  float best = 0.0f;
  int li = 0;
  for (int l = 0; l < a.n_lights; ++l) {
    const V3 pos = light3(a.l_position, l);
    const V3 eu = light3(a.l_u, l);
    const V3 ev = light3(a.l_v, l);
    const int lt = __ldg(a.l_type + l);
    // ray_quad
    const V3 n = cross(eu, ev);
    const float denom = dot(d, n);
    const bool safe = fabsf(denom) > kIsectEps;
    const float tq = dot(sub(pos, o), n) / (safe ? denom : 1.0f);
    const V3 p = sub(add(o, muls(d, tq)), pos);
    const float qa = dot(p, eu) / clamp_lo(dot(eu, eu), kIsectEps);
    const float qb = dot(p, ev) / clamp_lo(dot(ev, ev), kIsectEps);
    const bool qvalid = safe && (tq > kTMin) && (qa >= 0.0f) && (qa <= 1.0f) &&
                        (qb >= 0.0f) && (qb <= 1.0f);
    float t_quad = qvalid ? tq : kTMax;
    const V3 nq = normalize(n);
    const bool facing = -dot(d, nq) > 0.0f;
    t_quad = (lt == 3 && facing) ? t_quad : kTMax;
    // ray_sphere
    const float r = __ldg(a.l_radius + l);
    const V3 oc = sub(o, pos);
    const float b = dot(oc, d);
    const float c = dot(oc, oc) - r * r;
    const float disc = b * b - c;
    const float sq = sqrtf(clamp_lo(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float ts = t0 > kTMin ? t0 : t1;
    float t_sph = (disc > 0.0f && ts > kTMin) ? ts : kTMax;
    t_sph = lt == 4 ? t_sph : kTMax;
    const float t = tminimum(t_quad, t_sph);
    if (l == 0) {
      best = t;
    } else if (isnan(t) ? !isnan(best) : (!isnan(best) && t < best)) {
      best = t;
      li = l;
    }
  }
  if (!(best < kTMax)) return h;
  const float area = __ldg(a.l_area + li);
  const float radius = __ldg(a.l_radius + li);
  const V3 pos = light3(a.l_position, li);
  const int lt = __ldg(a.l_type + li);
  const V3 nq = normalize(cross(light3(a.l_u, li), light3(a.l_v, li)));
  const float cos_l = fabsf(dot(nq, d));
  const float pdf_quad = (best * best) / clamp_lo(area * clamp_lo(cos_l, kEps), kEps);
  const V3 to_c = sub(pos, o);
  const float dc2 = clamp_lo(dot(to_c, to_c), kEps);
  const float sin2_max = clamp2(radius * radius / dc2, 0.0f, 1.0f);
  const float cos_max = sqrtf(clamp_lo(1.0f - sin2_max, 0.0f));
  const float pdf_sph = rcp(clamp_lo((1.0f - cos_max) * F(2.0 * kPi), kEps));
  h.t = best;
  h.pdf = (lt == 3 ? pdf_quad : pdf_sph) * a.light_div;
  h.li = li;
  return h;
}

struct LightSample {
  V3 wi;
  float dist;
  V3 radiance;
  float pdf;
  bool is_delta;
};

// sample_one_light: the computations of the lane's light type only
__device__ LightSample sample_one_light(const BounceArgs& a, V3 p, float r0, float u1,
                                        float u2) {
  const int nl = a.n_lights;
  long long li = static_cast<long long>(r0 * static_cast<float>(nl));
  li = li > nl - 1 ? nl - 1 : li;
  const V3 I = light3(a.l_intensity, li);
  const V3 pos = light3(a.l_position, li);
  const V3 u = light3(a.l_u, li);
  const V3 v = light3(a.l_v, li);
  const float radius = __ldg(a.l_radius + li);
  const float area = __ldg(a.l_area + li);
  const int lt = __ldg(a.l_type + li);
  LightSample s{v3(0, 0, 0), 0.0f, v3(0, 0, 0), 0.0f, false};
  if (lt == 0 || lt == 2) {
    const V3 to_l = sub(pos, p);
    const float d2 = clamp_lo(dot(to_l, to_l), kEps);
    const float dist_p = sqrtf(d2);
    const V3 wi_p = divs(to_l, dist_p);
    V3 rad = divs(I, d2);
    if (lt == 2) {
      const float cos_s = dot(u, neg(wi_p));
      const float t = clamp2((cos_s - v.y) / clamp_lo(v.x - v.y, kEps), 0.0f, 1.0f);
      const float falloff = t * t * (3.0f - t * 2.0f);
      rad = muls(rad, falloff);
    }
    s.wi = wi_p;
    s.dist = dist_p;
    s.radiance = rad;
    s.pdf = 1.0f;
    s.is_delta = true;
  } else if (lt == 1) {
    const float cos_max = clamp2(v.x, -1.0f, 1.0f);
    const V3 axis = normalize(neg(u));
    V3 tb, bb;
    build_basis(axis, tb, bb);
    s.wi = to_world(uniform_sample_cone(u1, u2, cos_max), tb, bb, axis);
    s.dist = F(1.0e7);
    s.radiance = I;
    const bool narrow = cos_max >= F(1.0 - 1e-7);
    s.pdf = narrow ? 1.0f : rcp(clamp_lo((1.0f - cos_max) * F(2.0 * kPi), kEps));
    s.is_delta = narrow;
  } else if (lt == 3) {
    const V3 sample_q = add(add(pos, muls(u, u1)), muls(v, u2));
    const V3 n_q = normalize(cross(u, v));
    const V3 to_q = sub(sample_q, p);
    const float d2 = clamp_lo(dot(to_q, to_q), kEps);
    const float dist_q = sqrtf(d2);
    const V3 wi_q = divs(to_q, dist_q);
    const float cos_l = dot(n_q, neg(wi_q));
    s.wi = wi_q;
    s.dist = dist_q;
    s.pdf = d2 / clamp_lo(area * clamp_lo(cos_l, 0.0f), kEps);
    s.radiance = cos_l > 0.0f ? I : v3(0.0f, 0.0f, 0.0f);
  } else if (lt == 4) {
    const V3 to_c = sub(pos, p);
    const float dc2 = clamp_lo(dot(to_c, to_c), kEps);
    const float dc = sqrtf(dc2);
    const float sin2_max = clamp2(radius * radius / dc2, 0.0f, 1.0f);
    const float cos_max = sqrtf(clamp_lo(1.0f - sin2_max, 0.0f));
    const V3 axis = divs(to_c, dc);
    V3 ts, bs;
    build_basis(axis, ts, bs);
    const V3 wi = to_world(uniform_sample_cone(u1, u2, cos_max), ts, bs, axis);
    const float b_q = dot(wi, neg(to_c));
    const float disc = clamp_lo(b_q * b_q - (dc2 - radius * radius), 0.0f);
    s.wi = wi;
    s.dist = clamp_lo(-b_q - sqrtf(disc), kEps);
    s.radiance = I;
    s.pdf = rcp(clamp_lo((1.0f - cos_max) * F(2.0 * kPi), kEps));
  }
  s.pdf = s.pdf * a.light_sel;
  return s;
}

// ---------------------------------------------------------------------------
// ops/env.py
// ---------------------------------------------------------------------------

// _texel_pdf
__device__ __forceinline__ float texel_pdf(const BounceArgs& a, float lum, float sin_t) {
  const float p = lum / clamp_lo(__ldg(a.env_total), kEps);
  return (p * static_cast<float>(a.env_w * a.env_h)) / (sin_t * F(2.0 * kPi * kPi));
}

// env_eval: the radiance along d and the pdf of env_sample there
__device__ void env_eval(const BounceArgs& a, V3 d, V3& rad, float& pdf) {
  const float rot = __ldg(a.env_rotation);
  const float inten = __ldg(a.env_intensity);
  float u = atan2f(d.z, d.x) * (1.0f / F(kTwoPi)) + 0.5f + rot;
  u = u - floorf(u);
  const float v = acosf(clamp2(d.y, -1.0f, 1.0f)) * (1.0f / F(kPi));
  const int h = a.env_h, w = a.env_w;
  // _bilinear: wrap in u, clamp in v
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const long long x0i = floor_mod(static_cast<long long>(x0), w);
  const long long x1i = floor_mod(x0i + 1, w);
  const long long y0i = clampi(static_cast<long long>(y0), 0, h - 1);
  const long long y1i = clampi(y0i + 1, 0, h - 1);
  const V3 c00 = load3(a.env_image, y0i * w + x0i);
  const V3 c01 = load3(a.env_image, y0i * w + x1i);
  const V3 c10 = load3(a.env_image, y1i * w + x0i);
  const V3 c11 = load3(a.env_image, y1i * w + x1i);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  rad = add(add(add(muls(muls(c00, gx), gy), muls(muls(c01, fx), gy)), muls(muls(c10, gx), fy)),
            muls(muls(c11, fx), fy));
  rad = muls(rad, inten);
  const float sin_t = clamp_lo(sinf(v * F(kPi)), kEps);
  const long long xi = clampi(static_cast<long long>(u * static_cast<float>(w)), 0, w - 1);
  const long long yi = clampi(static_cast<long long>(v * static_cast<float>(h)), 0, h - 1);
  pdf = texel_pdf(a, __ldg(a.env_luminance + yi * w + xi), sin_t);
}

// env_sample: the two-fetch inverted CDF
__device__ void env_sample(const BounceArgs& a, float r0, float r1, V3& wi, V3& rad,
                           float& pdf) {
  const int h = a.env_h, w = a.env_w;
  const long long vi = clampi(static_cast<long long>(r0 * static_cast<float>(h)), 0, h - 1);
  const long long ui = clampi(static_cast<long long>(r1 * static_cast<float>(w)), 0, w - 1);
  const float v = __ldg(a.env_marginal + vi);
  const long long yi = clampi(static_cast<long long>(v * static_cast<float>(h)), 0, h - 1);
  const float u = __ldg(a.env_conditional + yi * w + ui);
  const long long xi = clampi(static_cast<long long>(u * static_cast<float>(w)), 0, w - 1);
  const float sin_t = __ldg(a.env_sin_theta + yi);
  const float x0 = sin_t * __ldg(a.env_cos_phi + xi);
  const float y0 = __ldg(a.env_cos_theta + yi);
  const float z0 = sin_t * __ldg(a.env_sin_phi + xi);
  const float delta = __ldg(a.env_rotation) * F(kTwoPi);
  const float c = cosf(delta), s = sinf(delta);
  wi = v3(x0 * c + z0 * s, y0, z0 * c - x0 * s);
  rad = muls(load3(a.env_image, yi * w + xi), __ldg(a.env_intensity));
  pdf = texel_pdf(a, __ldg(a.env_luminance + yi * w + xi), clamp_lo(sin_t, kEps));
}

// ---------------------------------------------------------------------------
// ops/sampling.py microfacet terms, ops/bsdf.py
// ---------------------------------------------------------------------------

struct Mat {
  V3 base, emission, cc_tint;
  float opacity, metallic, roughness, subsurface, spec_tint, sheen, sheen_tint, clearcoat,
      cc_rough, spec_trans, ior, ax, ay;
  int type;
};

struct Eval {
  V3 f;
  float pdf;
};

__device__ __forceinline__ float ggx_d(V3 h, float ax, float ay) {
  const float k = h.x * h.x / (ax * ax) + h.y * h.y / (ay * ay) + h.z * h.z;
  return rcp(clamp_lo(ax * F(kPi) * ay * k * k, F(1e-12)));
}
__device__ __forceinline__ float ggx_lambda(V3 w, float ax, float ay) {
  const float wz = fabsf(w.z) < F(1e-6) ? F(1e-6) : w.z;
  const float px = w.x * ax, py = w.y * ay;
  const float a2 = px * px + py * py;
  return (sqrtf(a2 / (wz * wz) + 1.0f) + -1.0f) * 0.5f;
}
__device__ __forceinline__ float ggx_g1(V3 w, float ax, float ay) {
  return rcp(ggx_lambda(w, ax, ay) + 1.0f);
}
__device__ __forceinline__ float ggx_g2(V3 wo, V3 wi, float ax, float ay) {
  return rcp(ggx_lambda(wo, ax, ay) + 1.0f + ggx_lambda(wi, ax, ay));
}
__device__ __forceinline__ float gtr1_d(float hz, float a) {
  const float a2 = a * a;
  const float t = (a2 - 1.0f) * hz * hz + 1.0f;
  return (a2 - 1.0f) / clamp_lo(logf(a2) * F(kPi) * t, F(1e-12));
}
__device__ __forceinline__ V3 sample_ggx_vndf(V3 wo, float ax, float ay, float u1, float u2) {
  const V3 v = normalize(v3(wo.x * ax, wo.y * ay, wo.z));
  const float lensq = v.x * v.x + v.y * v.y;
  const float inv_len = rcp(sqrtf(clamp_lo(lensq, F(1e-20))));
  const V3 t1 = lensq > F(1e-12) ? v3(-v.y * inv_len, v.x * inv_len, 0.0f * inv_len)
                                 : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(v, t1);
  const float r = sqrtf(u1);
  const float phi = u2 * F(kTwoPi);
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = (v.z + 1.0f) * 0.5f;
  p2 = (1.0f - s) * sqrtf(clamp_lo(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(clamp_lo(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = add(add(muls(t1, p1), muls(t2, p2)), muls(v, p3));
  return normalize(v3(ax * nh.x, ay * nh.y, clamp_lo(nh.z, F(1e-6))));
}
__device__ __forceinline__ V3 sample_gtr1(float a, float u1, float u2) {
  const float a2 = a * a;
  const float cos2 = (1.0f - powf(a2, 1.0f - u1)) / (1.0f - a2);
  const float ct = sqrtf(clamp2(cos2, 0.0f, 1.0f));
  const float st = sqrtf(clamp_lo(1.0f - cos2, 0.0f));
  const float phi = u2 * F(kTwoPi);
  return v3(st * cosf(phi), st * sinf(phi), ct);
}
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clamp2(cos_i, 0.0f, 1.0f);
  const float sin2_t = (1.0f - cos_i * cos_i) / clamp_lo(eta * eta, F(1e-12));
  const float cos_t = sqrtf(clamp_lo(1.0f - sin2_t, 0.0f));
  const float rs = (cos_i - eta * cos_t) / clamp_lo(cos_i + eta * cos_t, F(1e-12));
  const float rp = (eta * cos_i - cos_t) / clamp_lo(eta * cos_i + cos_t, F(1e-12));
  const float fr = (rs * rs + rp * rp) * 0.5f;
  return sin2_t >= 1.0f ? 1.0f : fr;
}

// oren_nayar_eval (DIFFUSE): A = ax, B = ay
__device__ Eval oren_nayar_eval(const Mat& m, V3 wo, V3 wi) {
  const float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  const float sin_o = sqrtf(clamp_lo(1.0f - cos_o * cos_o, 0.0f));
  const float sin_i = sqrtf(clamp_lo(1.0f - cos_i * cos_i, 0.0f));
  const float denom = clamp_lo(sin_o * sin_i, kEps);
  const float cos_dphi = clamp2((wo.x * wi.x + wo.y * wi.y) / denom, -1.0f, 1.0f);
  const float sin_alpha = tmaximum(sin_o, sin_i);
  const float tan_beta = tminimum(sin_o, sin_i) / clamp_lo(tminimum(cos_o, cos_i), kEps);
  const float fs =
      (m.ax + m.ay * clamp_lo(cos_dphi, 0.0f) * sin_alpha * tan_beta) * F(kInvPi);
  const bool valid = (wi.z > 0.0f) && (wo.z > 0.0f);
  Eval e;
  e.f = valid ? muls(m.base, fs) : v3(0.0f, 0.0f, 0.0f);
  e.pdf = valid ? cos_i * F(kInvPi) : 0.0f;
  return e;
}

__device__ __forceinline__ V3 tint_color(V3 b) {
  const float lum = b.x * F(0.212671) + b.y * F(0.715160) + b.z * F(0.072169);
  return lum > 0.0f ? divs(b, clamp_lo(lum, kEps)) : v3(1.0f, 1.0f, 1.0f);
}

struct Lobes {
  float d, s, c, t;
};

__device__ __forceinline__ Lobes lobe_weights(const Mat& m) {
  const float trans = (1.0f - m.metallic) * m.spec_trans;
  const float w_d = (1.0f - m.metallic) * (1.0f - m.spec_trans);
  const float w_c = m.clearcoat * 0.25f;
  const float total = w_d + 1.0f + w_c + trans;
  return Lobes{w_d / total, rcp(total), w_c / total, trans / total};
}

__device__ __forceinline__ float clearcoat_alpha(const Mat& m) {
  return clamp2(m.cc_rough * F(0.099) + F(0.001), F(0.001), F(0.1));
}

__device__ Eval disney_diffuse_eval(const Mat& m, V3 wo, V3 wi) {
  const float cos_o = fabsf(wo.z), cos_i = fabsf(wi.z);
  const V3 h = normalize(add(wo, wi));
  const float cos_d = fabsf(dot(wi, h));
  const float fl = pow5(1.0f - cos_i);
  const float fv = pow5(1.0f - cos_o);
  const float rough = sqrtf(clamp2(m.roughness, F(1e-4), 1.0f));
  const float fd90 = rough * 2.0f * cos_d * cos_d + 0.5f;
  const float fd = ((fd90 - 1.0f) * fl + 1.0f) * ((fd90 - 1.0f) * fv + 1.0f);
  const float fss90 = rough * cos_d * cos_d;
  const float fss = ((fss90 - 1.0f) * fl + 1.0f) * ((fss90 - 1.0f) * fv + 1.0f);
  const float ss = (fss * (rcp(clamp_lo(cos_i + cos_o, kEps)) - 0.5f) + 0.5f) * 1.25f;
  const float dscalar =
      ((1.0f - m.subsurface) * fd + m.subsurface * ss) * F(kInvPi);
  const V3 tint = tint_color(m.base);
  const float st = m.sheen_tint;
  const V3 sheen_color = v3((1.0f - st) + st * tint.x, (1.0f - st) + st * tint.y,
                            (1.0f - st) + st * tint.z);
  const float fh = pow5(1.0f - cos_d);
  const V3 sheen = muls(muls(sheen_color, m.sheen), fh);
  // m.sheen * sheen_color: the scalar broadcast on the left
  const float weight = (1.0f - m.metallic) * (1.0f - m.spec_trans);
  const V3 f = muls(add(muls(m.base, dscalar), sheen), weight);
  const bool valid = (wi.z > 0.0f) && (wo.z > 0.0f);
  Eval e;
  e.f = valid ? f : v3(0.0f, 0.0f, 0.0f);
  e.pdf = valid ? cos_i * F(kInvPi) : 0.0f;
  return e;
}

__device__ __forceinline__ V3 spec_f0(const Mat& m) {
  const float q = (m.ior - 1.0f) / (m.ior + 1.0f);
  const float f0s = q * q;
  const V3 tint = tint_color(m.base);
  const float st = m.spec_tint;
  const V3 diel = v3(f0s * ((1.0f - st) + st * tint.x), f0s * ((1.0f - st) + st * tint.y),
                     f0s * ((1.0f - st) + st * tint.z));
  const float km = 1.0f - m.metallic;
  return v3(km * diel.x + m.metallic * m.base.x, km * diel.y + m.metallic * m.base.y,
            km * diel.z + m.metallic * m.base.z);
}

__device__ Eval disney_specular_eval(const Mat& m, V3 wo, V3 wi) {
  const bool valid = (wi.z > 0.0f) && (wo.z > 0.0f);
  const V3 h = normalize(add(wo, wi));
  const float d = ggx_d(h, m.ax, m.ay);
  const float g2 = ggx_g2(wo, wi, m.ax, m.ay);
  const float g1 = ggx_g1(wo, m.ax, m.ay);
  const float cos_d = fabsf(dot(wo, h));
  const V3 f0 = spec_f0(m);
  const float mm = clamp2(1.0f - cos_d, 0.0f, 1.0f);
  const float m4 = (mm * mm) * (mm * mm);
  const V3 fr = v3(f0.x + (1.0f - f0.x) * m4 * mm, f0.y + (1.0f - f0.y) * m4 * mm,
                   f0.z + (1.0f - f0.z) * m4 * mm);
  const float cos_o = clamp_lo(fabsf(wo.z), kEps);
  const float cos_i = clamp_lo(fabsf(wi.z), kEps);
  const float s = d * g2 / (4.0f * cos_o * cos_i);
  Eval e;
  e.f = valid ? muls(fr, s) : v3(0.0f, 0.0f, 0.0f);
  e.pdf = valid ? d * g1 / clamp_lo(4.0f * cos_o, kEps) : 0.0f;
  return e;
}

__device__ Eval disney_clearcoat_eval(const Mat& m, V3 wo, V3 wi) {
  const bool valid = (wi.z > 0.0f) && (wo.z > 0.0f);
  const V3 h = normalize(add(wo, wi));
  const float a = clearcoat_alpha(m);
  const float d = gtr1_d(h.z, a);
  const float cos_d = fabsf(dot(wo, h));
  const float fr = pow5(1.0f - cos_d) * F(0.96) + F(0.04);
  const float g = ggx_g2(wo, wi, 0.25f, 0.25f);
  const float cos_o = clamp_lo(fabsf(wo.z), kEps);
  const float cos_i = clamp_lo(fabsf(wi.z), kEps);
  const float scalar = m.clearcoat * 0.25f * fr * d * g / (4.0f * cos_o * cos_i);
  Eval e;
  e.f = valid ? muls(m.cc_tint, scalar) : v3(0.0f, 0.0f, 0.0f);
  e.pdf = valid ? d * fabsf(h.z) / clamp_lo(4.0f * cos_d, kEps) : 0.0f;
  return e;
}

// _refract: wi about h with relative ior eta
__device__ __forceinline__ V3 refract(V3 wi, V3 h, float eta, bool& ok) {
  const float cos_i = dot(wi, h);
  const float sin2_t = eta * eta * clamp_lo(1.0f - cos_i * cos_i, 0.0f);
  const float cos_t = sqrtf(clamp_lo(1.0f - sin2_t, 0.0f));
  const float k = eta * cos_i - cos_t;
  ok = sin2_t < 1.0f;
  return normalize(add(muls(neg(wi), eta), muls(h, k)));
}

__device__ Eval disney_transmission_eval(const Mat& m, V3 wo, V3 wi) {
  const float eta = wo.z > 0.0f ? rcp(m.ior) : m.ior;
  const bool reflect = wi.z * wo.z > 0.0f;
  const float ce = clamp_lo(eta, kEps);
  const V3 h_refl = normalize(add(wo, wi));
  const V3 h_refr = normalize(add(wo, divs(wi, ce)));
  V3 h = reflect ? h_refl : h_refr;
  h = h.z < 0.0f ? neg(h) : h;
  const float cos_oh = dot(wo, h);
  const float fr = fresnel_dielectric(fabsf(cos_oh), rcp(ce));
  const float d = ggx_d(h, m.ax, m.ay);
  const float g2 = ggx_g2(wo, wi, m.ax, m.ay);
  const float g1 = ggx_g1(wo, m.ax, m.ay);
  const float cos_o = clamp_lo(fabsf(wo.z), kEps);
  const float cos_i = clamp_lo(fabsf(wi.z), kEps);
  const float f_refl = fr * d * g2 / (4.0f * cos_o * cos_i);
  const float pdf_refl = fr * d * g1 / clamp_lo(4.0f * cos_o, kEps);
  const float cos_ih = dot(wi, h);
  const float sdn = cos_oh + cos_ih / ce;
  const float denom = clamp_lo(sdn * sdn, kEps);
  const float jac = fabsf(cos_ih) / denom / (ce * ce);
  const float f_trans = (1.0f - fr) * d * g2 * fabsf(cos_oh) * jac / (cos_o * cos_i);
  const float pdf_trans = (1.0f - fr) * d * g1 * fabsf(cos_oh) / cos_o * jac;
  const float weight = (1.0f - m.metallic) * m.spec_trans;
  const V3 color = v3(sqrtf(clamp2(m.base.x, 0.0f, 1.0f)), sqrtf(clamp2(m.base.y, 0.0f, 1.0f)),
                      sqrtf(clamp2(m.base.z, 0.0f, 1.0f)));
  const float scalar = reflect ? f_refl : f_trans;
  Eval e;
  e.f = muls(color, scalar * weight);
  e.pdf = clamp_lo(reflect ? pdf_refl : pdf_trans, 0.0f);
  return e;
}

template <bool kTrans>
__device__ Eval disney_eval(const Mat& m, V3 wo, V3 wi) {
  const Lobes w = lobe_weights(m);
  const Eval fd = disney_diffuse_eval(m, wo, wi);
  const Eval fs = disney_specular_eval(m, wo, wi);
  const Eval fc = disney_clearcoat_eval(m, wo, wi);
  Eval e;
  e.f = add(add(fd.f, fs.f), fc.f);
  e.pdf = w.d * fd.pdf + w.s * fs.pdf + w.c * fc.pdf;
  if (kTrans) {
    const Eval ft = disney_transmission_eval(m, wo, wi);
    const bool has_trans = m.spec_trans > 0.0f;
    e.f = add(e.f, has_trans ? ft.f : v3(0.0f, 0.0f, 0.0f));
    e.pdf = e.pdf + (has_trans ? w.t * ft.pdf : 0.0f);
  }
  return e;
}

// bsdf_eval: DIFFUSE (0) or DISNEY (1)
template <bool kDisney, bool kTrans>
__device__ __forceinline__ Eval bsdf_eval(const Mat& m, V3 wo, V3 wi) {
  if (kDisney && m.type == 1) return disney_eval<kTrans>(m, wo, wi);
  return oren_nayar_eval(m, wo, wi);
}

// bsdf_sample: wi in the local frame, and bsdf_eval there
template <bool kDisney, bool kTrans>
__device__ Eval bsdf_sample(const Mat& m, V3 wo, float4 r, V3& wi) {
  if (!kDisney || m.type != 1) {
    wi = cosine_sample_hemisphere(r.y, r.z);
    return oren_nayar_eval(m, wo, wi);
  }
  const Lobes w = lobe_weights(m);
  const float u = r.x, u1 = r.y, u2 = r.z;
  const float c1 = w.d;
  const float c2 = c1 + w.s;
  const float c3 = c2 + w.c;
  const bool sel_d = u < c1;
  const bool sel_s = (u >= c1) && (u < c2);
  const bool sel_c = (u >= c2) && (u < c3);
  if (sel_d) {
    wi = cosine_sample_hemisphere(u1, u2);
  } else if (sel_s || (!sel_c && !kTrans)) {
    const V3 h = sample_ggx_vndf(wo, m.ax, m.ay, u1, u2);
    wi = normalize(sub(muls(h, dot(wo, h) * 2.0f), wo));
  } else if (sel_c) {
    const V3 h = sample_gtr1(clearcoat_alpha(m), u1, u2);
    wi = normalize(sub(muls(h, dot(wo, h) * 2.0f), wo));
  } else {
    const float eta = wo.z > 0.0f ? rcp(m.ior) : m.ior;
    const V3 h = sample_ggx_vndf(wo, m.ax, m.ay, u1, u2);
    const float cos_oh = dot(wo, h);
    const float fr = fresnel_dielectric(fabsf(cos_oh), rcp(clamp_lo(eta, kEps)));
    bool can_refract;
    const V3 wt = refract(wo, h, eta, can_refract);
    const bool choose_refl = (r.w < fr) || !can_refract;
    wi = choose_refl ? normalize(sub(muls(h, cos_oh * 2.0f), wo)) : wt;
  }
  return disney_eval<kTrans>(m, wo, wi);
}

// ---------------------------------------------------------------------------
// the bounce
// ---------------------------------------------------------------------------

// What precedes the surface fetch: the light hit, the medium's free
// flight, the miss, the path length and the hit point.
struct Front {
  LightHit lhit;
  V3 lrad;          // the light hit's radiance
  float4 r_med;
  bool scatter;
  float effective_t;
  bool light_first;
  bool miss;
  bool active;      // after the miss and the light hit
  bool on_surface;
  float path_dist;
  V3 hit_p;
};

__device__ __forceinline__ Front front(const BounceArgs& a, long long i, const Sampler& smp,
                                       V3 o, V3 d) {
  Front f;
  const float hit_t = __ldg(a.hit_t + i);
  if (a.lh_t != nullptr) {
    f.lhit = LightHit{__ldg(a.lh_t + i), __ldg(a.lh_pdf + i), -1};
    f.lrad = load3(a.lh_rad, i);
  } else {
    f.lhit = intersect_lights(a, o, d);
    f.lrad = f.lhit.li >= 0 ? light3(a.l_intensity, f.lhit.li) : v3(0.0f, 0.0f, 0.0f);
  }
  const bool active0 = a.active[i] != 0;
  if (a.scatter) {
    f.r_med = s4(a, smp, 29u);
    const float dens = __ldg(a.med_density + i);
    const float t_free = -logf(clamp_lo(1.0f - f.r_med.x, F(1e-7))) / clamp_lo(dens, F(1e-7));
    f.scatter = active0 && (dens > 0.0f) && (t_free < hit_t);
    f.effective_t = f.scatter ? t_free : hit_t;
  } else {
    f.r_med = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    f.scatter = false;
    f.effective_t = hit_t;
  }
  f.light_first = f.lhit.t < f.effective_t;
  f.miss = (__ldg(a.hit_tri + i) < 0) && !f.scatter;
  f.active = active0 && !f.miss && !f.light_first;
  f.on_surface = f.active && !f.scatter;
  f.hit_p = add(o, muls(d, hit_t));
  f.path_dist = __ldg(a.path_dist + i) + f.effective_t * (f.active ? 1.0f : 0.0f);
  return f;
}

__device__ __forceinline__ Sampler sampler(const BounceArgs& a, long long i) {
  Sampler s;
  const long long pix = a.pixel[i];
  s.pix = static_cast<unsigned>(pix & 0xFFFFFFFFll);
  s.frame = static_cast<unsigned>((a.frame != nullptr ? a.frame[i] : a.frame0) & 0xFFFFFFFFll);
  s.px = pix % a.width;
  s.py = pix / a.width;
  return s;
}

// The radiance of a ray that leaves the scene: the environment map's,
// with the pdf of sampling it there, or the sky's
template <bool kEnv>
__device__ __forceinline__ V3 env_radiance(const BounceArgs& a, V3 d, float& pdf) {
  if (kEnv) {
    V3 rad;
    env_eval(a, d, rad, pdf);
    return rad;
  }
  pdf = 0.0f;
  const float t = clamp2((d.z * 0.0f + d.y + 1.0f) * 0.5f, 0.0f, 1.0f);
  const float gt = 1.0f - t;
  const float inten = __ldg(a.env_intensity);
  return v3((__ldg(a.ground) * gt + __ldg(a.sky) * t) * inten,
            (__ldg(a.ground + 1) * gt + __ldg(a.sky + 1) * t) * inten,
            (__ldg(a.ground + 2) * gt + __ldg(a.sky + 2) * t) * inten);
}

// The shading frame at the hit: the normal map, the two-sided normals,
// the tangent frame and the outgoing direction in it.
struct Surf {
  V3 ns;  // after the normal map
  V3 ns_f;
  V3 ng_f;
  V3 t_b;
  V3 b_b;
  V3 wo_l;
  bool entering;
};

__device__ __forceinline__ Surf surface(const BounceArgs& a, long long i, V3 d) {
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  V3 ns = load3(a.ns, i);
  const V3 ng = load3(a.ng, i);
  const V3 tan_raw = load3(a.tan, i);
  // normal mapping, the interpolated tangent Gram-Schmidt'd against ns
  if (a.textures && a.normal_maps) {
    const V3 tan_proj = sub(tan_raw, muls(ns, dot(tan_raw, ns)));
    const float tan_len = sqrtf(dot(tan_proj, tan_proj));
    const bool has_tan = tan_len > F(1e-4);
    const V3 n_t = load3v4(a.n_tex, i);
    const V3 n_ts = normalize(v3(n_t.x * 2.0f - 1.0f, n_t.y * 2.0f - 1.0f, n_t.z * 2.0f - 1.0f));
    const V3 tb0 = has_tan ? divs(tan_proj, clamp_lo(tan_len, F(1e-12))) : zero3;
    const V3 bt0 = cross(ns, tb0);
    const V3 mapped = normalize(add(add(muls(tb0, n_ts.x), muls(bt0, n_ts.y)), muls(ns, n_ts.z)));
    const bool use_map = has_tan && (__ldg(a.normal_map + i) >= 0);
    ns = use_map ? mapped : ns;
  }
  Surf s;
  s.ns = ns;
  s.entering = dot(ns, neg(d)) >= 0.0f;
  s.ns_f = s.entering ? ns : neg(ns);
  s.ng_f = s.entering ? ng : neg(ng);
  V3 t_fb, b_fb;
  build_basis(s.ns_f, t_fb, b_fb);
  const V3 tan_f = sub(tan_raw, muls(s.ns_f, dot(tan_raw, s.ns_f)));
  const float tan_fl = sqrtf(dot(tan_f, tan_f));
  const bool has_tan_f = tan_fl > F(1e-4);
  s.t_b = has_tan_f ? divs(tan_f, clamp_lo(tan_fl, F(1e-12))) : t_fb;
  s.b_b = has_tan_f ? cross(s.ns_f, s.t_b) : b_fb;
  s.wo_l = to_local(neg(d), s.t_b, s.b_b, s.ns_f);
  s.wo_l.z = clamp_lo(s.wo_l.z, F(1e-5));
  return s;
}

// The material at the hit: the fetch's parameters under the texture
// maps, the ior relative to the side the ray comes from; under a pushed
// closest-hit kernel, its parameters as they are
template <bool kDisney>
__device__ __forceinline__ Mat material(const BounceArgs& a, long long i, bool entering) {
  Mat m;
  m.base = load3(a.base_color, i);
  m.emission = load3(a.emission, i);
  m.cc_tint = load3(a.clearcoat_tint, i);
  m.opacity = __ldg(a.opacity + i);
  m.metallic = __ldg(a.metallic + i);
  m.roughness = __ldg(a.roughness + i);
  m.ax = __ldg(a.ax + i);
  m.ay = __ldg(a.ay + i);
  m.ior = __ldg(a.ior + i);
  m.type = __ldg(a.mat_type + i);
  if (kDisney) {
    m.subsurface = __ldg(a.subsurface + i);
    m.spec_tint = __ldg(a.specular_tint + i);
    m.sheen = __ldg(a.sheen + i);
    m.sheen_tint = __ldg(a.sheen_tint + i);
    m.clearcoat = __ldg(a.clearcoat + i);
    m.cc_rough = __ldg(a.clearcoat_roughness + i);
    m.spec_trans = __ldg(a.specular_transmission + i);
  } else {
    m.subsurface = m.spec_tint = m.sheen = m.sheen_tint = m.clearcoat = m.cc_rough =
        m.spec_trans = 0.0f;
  }
  if (a.mat_final) return m;
  if (a.textures) {
    const V3 mr = load3v4(a.mr_t, i);
    const V3 bt = load3v4(a.base_t, i);
    const V3 et = load3v4(a.em_t, i);
    const bool has_mr = __ldg(a.mr_map + i) >= 0;
    const float alpha = clamp2(mr.y * mr.y, F(1e-4), 1.0f);
    m.base = mul(m.base, bt);
    m.emission = mul(m.emission, et);
    const float new_metal = m.metallic * mr.z;
    m.metallic = has_mr ? new_metal : m.metallic;
    m.roughness = has_mr ? alpha : m.roughness;
    m.ax = has_mr ? clamp_lo(alpha, F(1e-3)) : m.ax;
    m.ay = has_mr ? clamp_lo(alpha, F(1e-3)) : m.ay;
  }
  m.ior = entering ? m.ior : rcp(clamp_lo(m.ior, F(1e-3)));
  return m;
}

__global__ void __launch_bounds__(kBlock) shade_bounce_pre_kernel(BounceArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Sampler smp = sampler(a, i);
  const Front f = front(a, i, smp, load3(a.o, i), load3(a.d, i));
  a.pre_path_dist[i] = f.path_dist;
  if (a.pre_hit_p != nullptr) {
    a.pre_hit_p[3 * i] = f.hit_p.x;
    a.pre_hit_p[3 * i + 1] = f.hit_p.y;
    a.pre_hit_p[3 * i + 2] = f.hit_p.z;
  }
}

// What a pushed kernel reads at its seam, into `seam_out`. Phase 0,
// before the intersection and miss kernels: K10's light-set hit and the
// radiance of a ray that leaves the scene. Phase 1, before the
// closest-hit and any-hit kernels: the hit's point, two-sided normals
// and on_surface, the textured material with its relative ior, and the
// alpha test's draw.
__global__ void __launch_bounds__(kBlock) shade_bounce_seam_kernel(BounceArgs a, int phase) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  float* out = a.seam_out;
  auto put = [&](int seg, int w, int j, float x) { out[seg * n + i * w + j] = x; };
  auto put3 = [&](int seg, V3 x) {
    put(seg, 3, 0, x.x);
    put(seg, 3, 1, x.y);
    put(seg, 3, 2, x.z);
  };
  const V3 o = load3(a.o, i);
  const V3 d = load3(a.d, i);
  if (phase == 0) {
    const LightHit h = intersect_lights(a, o, d);
    put(kSeamLhT, 1, 0, h.t);
    put(kSeamLhPdf, 1, 0, h.pdf);
    put3(kSeamLhRad, h.li >= 0 ? light3(a.l_intensity, h.li) : v3(0.0f, 0.0f, 0.0f));
    float pdf;
    put3(kSeamEnvRad, a.q == 3 ? env_radiance<true>(a, d, pdf) : env_radiance<false>(a, d, pdf));
    return;
  }
  const Sampler smp = sampler(a, i);
  const Front fr = front(a, i, smp, o, d);
  const Surf sf = surface(a, i, d);
  const Mat m = material<false>(a, i, sf.entering);
  put3(kSeamP, fr.hit_p);
  put3(kSeamNs, sf.ns_f);
  put3(kSeamNg, sf.ng_f);
  put3(kSeamBase, m.base);
  put3(kSeamEmission, m.emission);
  put(kSeamMetallic, 1, 0, m.metallic);
  put(kSeamRoughness, 1, 0, m.roughness);
  put(kSeamAx, 1, 0, m.ax);
  put(kSeamAy, 1, 0, m.ay);
  put(kSeamIor, 1, 0, m.ior);
  const float4 r = s4(a, smp, 11u);
  put(kSeamRAlpha, 4, 0, r.x);
  put(kSeamRAlpha, 4, 1, r.y);
  put(kSeamRAlpha, 4, 2, r.z);
  put(kSeamRAlpha, 4, 3, r.w);
  reinterpret_cast<unsigned char*>(out + kSeamOnSurface * n)[i] = fr.on_surface;
}

template <bool kDisney, bool kTrans, bool kEnv>
__global__ void __launch_bounds__(kBlock) shade_bounce_kernel(BounceArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  float* out = a.out;
  auto put = [&](int seg, int w, int j, float x) { out[a.off[seg] + i * w + j] = x; };
  auto put3 = [&](int seg, V3 x) {
    put(seg, 3, 0, x.x);
    put(seg, 3, 1, x.y);
    put(seg, 3, 2, x.z);
  };
  // query rows: extension, the light's shadow ray, the environment's
  auto put_q3 = [&](int seg, int row, V3 x) {
    float* p = out + a.off[seg] + 3 * (row * n + i);
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
  };
  auto put_q = [&](int row, float x) { out[a.off[kQT] + row * n + i] = x; };
  unsigned char* masks = reinterpret_cast<unsigned char*>(out + a.off[kMasks]);

  const Sampler smp = sampler(a, i);
  const V3 o = load3(a.o, i);
  const V3 d = load3(a.d, i);
  const float hit_t = __ldg(a.hit_t + i);
  V3 throughput = load3(a.throughput, i);
  V3 radiance = load3(a.radiance, i);
  const float prev_pdf = __ldg(a.prev_pdf + i);
  const Front fr = front(a, i, smp, o, d);
  const bool scatter = fr.scatter;
  const bool on_surface = fr.on_surface;
  bool active = fr.active;
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);

  // --- emissive light hit (MIS vs the NEE strategy) ---
  {
    const float w_light = prev_pdf > 0.0f ? power_heuristic(prev_pdf, fr.lhit.pdf) : 1.0f;
    const bool take = (a.active[i] != 0) && fr.light_first;
    radiance = add(radiance, take ? muls(mul(throughput, fr.lrad), w_light) : zero3);
  }
  // --- miss: environment ---
  {
    float pdf_e;
    V3 env_rad = env_radiance<kEnv>(a, d, pdf_e);
    const float w_env = (kEnv && prev_pdf > 0.0f) ? power_heuristic(prev_pdf, pdf_e) : 1.0f;
    if (a.env_in != nullptr) env_rad = load3(a.env_in, i);
    const bool take = (a.active[i] != 0) && fr.miss && !fr.light_first;
    radiance = add(radiance, take ? muls(mul(throughput, env_rad), w_env) : zero3);
  }

  // --- shading point ---
  const V3 hit_p = fr.hit_p;
  const Surf sf = surface(a, i, d);
  const V3 ns = sf.ns;
  const V3 ns_f = sf.ns_f;
  const V3 ng_f = sf.ng_f;
  const V3 t_b = sf.t_b;
  const V3 b_b = sf.b_b;
  const V3 wo_l = sf.wo_l;
  const bool entering = sf.entering;
  const int mat_idx = __ldg(a.mat_idx + i);
  const Mat m = material<kDisney>(a, i, entering);

  // Beer-Lambert absorption along an interior segment
  if (a.absorb) {
    const bool interior = !entering && on_surface;
    const V3 sg = load3(a.medium_sigma, i);
    const V3 atten = v3(expf(-sg.x * hit_t), expf(-sg.y * hit_t), expf(-sg.z * hit_t));
    throughput = interior ? mul(throughput, atten) : throughput;
  }
  const int safe_mat = min(max(mat_idx, 0), a.n_mats - 1);
  if (a.emissive) {
    const bool em_medium = __ldg(a.medium_type + safe_mat) == 3;
    const V3 em_color = load3(a.medium_color, safe_mat);
    const float em_density = __ldg(a.medium_density + safe_mat);
    const bool interior_e = !entering && on_surface && em_medium;
    radiance = add(radiance, interior_e ? muls(mul(throughput, em_color), em_density * hit_t)
                                        : zero3);
  }
  if (a.aov) {
    const V3 alb = on_surface ? m.base : load3(a.albedo, i);
    const V3 nrm = on_surface ? ns : load3(a.normal, i);
    float* p = a.aov_out + 3 * i;
    p[0] = alb.x;
    p[1] = alb.y;
    p[2] = alb.z;
    p[3 * n] = nrm.x;
    p[3 * n + 1] = nrm.y;
    p[3 * n + 2] = nrm.z;
  }
  radiance = add(radiance, on_surface ? mul(throughput, m.emission) : zero3);

  // opacity: the alpha test ([0]) and Russian roulette ([1])
  const float4 r_alpha = s4(a, smp, 11u);
  const bool pass_through =
      on_surface && (a.pass_in != nullptr ? a.pass_in[i] != 0 : r_alpha.x > m.opacity);

  // --- NEE: analytic lights ---
  const float4 r_nee = s4(a, smp, 13u);
  const V3 shadow_o = add(hit_p, muls(ng_f, kRayEps));
  bool candidate = false;
  V3 nee_contrib = zero3;
  V3 nee_dir = ns_f;
  float nee_tmax = 0.0f;
  if (a.n_lights > 0) {
    const LightSample ls = sample_one_light(a, hit_p, r_nee.x, r_nee.y, r_nee.z);
    const V3 wi_l = to_local(ls.wi, t_b, b_b, ns_f);
    const Eval fl = bsdf_eval<kDisney, kTrans>(m, wo_l, wi_l);
    const float cos_l = fabsf(wi_l.z);
    candidate = on_surface && !pass_through && (ls.pdf > 0.0f) && (cos_l > F(1e-6));
    const float w_mis = ls.is_delta ? 1.0f : power_heuristic(ls.pdf, fl.pdf);
    const float s = cos_l / clamp_lo(ls.pdf, F(1e-12)) * w_mis;
    nee_contrib = mul(muls(mul(throughput, fl.f), s), ls.radiance);
    nee_dir = ls.wi;
    nee_tmax = candidate ? ls.dist * F(1.0 - 1e-4) : 0.0f;
  }
  // --- NEE: environment map ---
  if (kEnv) {
    const float4 r_env = s4(a, smp, 17u);
    V3 wi_e, rad_e;
    float pdf_e;
    env_sample(a, r_env.x, r_env.y, wi_e, rad_e, pdf_e);
    const V3 wi_el = to_local(wi_e, t_b, b_b, ns_f);
    const Eval fe = bsdf_eval<kDisney, kTrans>(m, wo_l, wi_el);
    const float cos_e = fabsf(wi_el.z);
    const bool cand_e = on_surface && !pass_through && (pdf_e > 0.0f) && (cos_e > F(1e-6));
    const float w_mis_e = power_heuristic(pdf_e, fe.pdf);
    const float s = cos_e / clamp_lo(pdf_e, F(1e-12)) * w_mis_e;
    put3(kEnvContrib, mul(muls(mul(throughput, fe.f), s), rad_e));
    put_q3(kQO, 2, shadow_o);
    put_q3(kQD, 2, wi_e);
    put_q(2, cand_e ? F(1.0e7) : 0.0f);
    masks[2 * n + i] = cand_e;
  }

  // --- BSDF sampling / continuation ---
  const float4 r_bsdf = s4(a, smp, 19u);
  V3 wi_s;
  const Eval fs = bsdf_sample<kDisney, kTrans>(m, wo_l, r_bsdf, wi_s);
  const V3 wi_w = to_world(wi_s, t_b, b_b, ns_f);
  const float cos_s = fabsf(wi_s.z);
  const bool valid_s = fs.pdf > F(1e-9);
  const V3 new_tp = muls(mul(throughput, fs.f), cos_s / clamp_lo(fs.pdf, F(1e-9)));
  V3 next_d = pass_through ? d : wi_w;
  const V3 offset_n = dot(next_d, ng_f) >= 0.0f ? ng_f : neg(ng_f);
  V3 next_o = add(add(hit_p, muls(offset_n, kRayEps)), muls(next_d, kRayEps));
  V3 next_tp = pass_through ? throughput : new_tp;
  float next_pdf = pass_through ? 0.0f : fs.pdf;
  active = active && (pass_through || valid_s || scatter);

  // --- SCATTER continuation + medium boundary tracking ---
  if (a.scatter) {
    const float g = clamp2(__ldg(a.med_g + i), F(-0.999), F(0.999));
    const bool iso = fabsf(g) < F(1e-3);
    const float sg = iso ? F(1e-3) : g;
    const float u1 = fr.r_med.y;
    const float sq = (1.0f - sg * sg) / (1.0f - sg + sg * 2.0f * u1);
    const float cos_hg = (sg * sg + 1.0f - sq * sq) / (sg * 2.0f);
    float cos_t = iso ? 1.0f - u1 * 2.0f : cos_hg;
    cos_t = clamp2(cos_t, -1.0f, 1.0f);
    const float sin_t = sqrtf(clamp_lo(1.0f - cos_t * cos_t, 0.0f));
    const float phi = fr.r_med.z * F(kTwoPi);
    V3 tb, bb;
    build_basis(d, tb, bb);
    const V3 wi_hg = normalize(
        add(add(muls(tb, sin_t * cosf(phi)), muls(bb, sin_t * sinf(phi))), muls(d, cos_t)));
    const V3 scat_o = add(add(o, muls(d, fr.effective_t)), muls(wi_hg, kRayEps));
    next_d = scatter ? wi_hg : next_d;
    next_o = scatter ? scat_o : next_o;
    next_tp = scatter ? mul(throughput, load3(a.med_color, i)) : next_tp;
    next_pdf = scatter ? 0.0f : next_pdf;
    const int mm_type = __ldg(a.medium_type + safe_mat);
    const float mm_density = __ldg(a.medium_density + safe_mat);
    const float mm_g = __ldg(a.medium_anisotropy + safe_mat);
    const V3 mm_color = load3(a.medium_color, safe_mat);
    const bool crossed = on_surface && !pass_through && (dot(next_d, ng_f) < 0.0f);
    const bool enter_med = crossed && entering && (mm_type == 2) && (mm_density > 0.0f);
    const bool exit_med = crossed && !entering;
    put(kDensity, 1, 0,
        enter_med ? mm_density : (exit_med ? 0.0f : __ldg(a.med_density + i)));
    put(kG, 1, 0, enter_med ? mm_g : (exit_med ? 0.0f : __ldg(a.med_g + i)));
    put3(kColor, enter_med ? mm_color : (exit_med ? zero3 : load3(a.med_color, i)));
  }

  // --- Russian roulette ---
  if (a.rr) {
    const float q = clamp2(tmaximum(tmaximum(next_tp.x, next_tp.y), next_tp.z), F(0.05),
                           F(0.95));
    next_tp = divs(next_tp, q);
    active = active && (r_alpha.y < q);
  }

  put_q3(kQO, 0, next_o);
  put_q3(kQO, 1, shadow_o);
  put_q3(kQD, 0, next_d);
  put_q3(kQD, 1, nee_dir);
  put_q(0, active ? kTMax : 0.0f);
  put_q(1, nee_tmax);
  put3(kRadiance, radiance);
  put3(kNextTp, next_tp);
  put(kNextPdf, 1, 0, next_pdf);
  put(kPathDist, 1, 0, fr.path_dist);
  put3(kNeeContrib, nee_contrib);
  put(kRAlpha, 4, 0, r_alpha.x);
  put(kRAlpha, 4, 1, r_alpha.y);
  put(kRAlpha, 4, 2, r_alpha.z);
  put(kRAlpha, 4, 3, r_alpha.w);
  masks[i] = active;
  masks[n + i] = candidate;
}

template <bool kDisney, bool kTrans, bool kEnv>
cudaError_t launch(const BounceArgs& a, int grid, cudaStream_t s) {
  shade_bounce_kernel<kDisney, kTrans, kEnv><<<grid, kBlock, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The pass before the fetch: path lengths (and hit points, where
// `pre_hit_p` is given) into `pre_path_dist`.
extern "C" int hala_shade_bounce_pre(const HalaBounceArgs* args, void* stream) {
  const HalaBounceArgs& a = *args;
  if (a.n <= 0) return 0;
  if (a.pre_path_dist == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.n + kBlock - 1) / kBlock;
  shade_bounce_pre_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A seam pass (0: before the intersection and miss kernels, 1: before
// the closest-hit and any-hit kernels) into `seam_out`.
extern "C" int hala_shade_bounce_seam(const HalaBounceArgs* args, int phase, void* stream) {
  const HalaBounceArgs& a = *args;
  if (a.n <= 0) return 0;
  if (a.seam_out == nullptr || (phase != 0 && phase != 1) || (a.q != 2 && a.q != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.n + kBlock - 1) / kBlock;
  shade_bounce_seam_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a, phase);
  return static_cast<int>(cudaGetLastError());
}

// The bounce: instance (disney, transmission, env map), a BounceArgs
// the wrapper filled.
extern "C" int hala_shade_bounce(const HalaBounceArgs* args, int disney, int transmission,
                                 int env_map, void* stream) {
  const HalaBounceArgs& a = *args;
  if (a.n <= 0) return 0;
  if (a.out == nullptr || (a.aov && a.aov_out == nullptr) || a.n_mats <= 0 ||
      (a.q != 2 && a.q != 3) || ((a.q == 3) != (env_map != 0)) ||
      (a.n_lights > 0 && a.l_type == nullptr) || (a.lh_t != nullptr && a.lh_rad == nullptr) ||
      (a.bn != nullptr && (a.bn_c < 4 || a.width <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (disney ? 4 : 0) | (transmission ? 2 : 0) | (env_map ? 1 : 0);
  switch (key) {
    case 0: return static_cast<int>(launch<false, false, false>(a, grid, s));
    case 1: return static_cast<int>(launch<false, false, true>(a, grid, s));
    case 4: return static_cast<int>(launch<true, false, false>(a, grid, s));
    case 5: return static_cast<int>(launch<true, false, true>(a, grid, s));
    case 6: return static_cast<int>(launch<true, true, false>(a, grid, s));
    case 7: return static_cast<int>(launch<true, true, true>(a, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
