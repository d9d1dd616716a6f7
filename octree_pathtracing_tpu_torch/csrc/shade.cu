// Kernel K4: hit resolve and shade, forward and backward, one thread per
// lane.
//
// Replaces: octree_pathtracing_tpu/render/pathtracer.py `_shade` (:1294)
// without its sun and emitter next-event estimates, with `lobe_scatter`
// (:1194) and `sky_radiance` (:1180); render/hit.py `resolve_hit` (:323);
// ops/texture.py `sample_atlas` (:116); models/materials.py `gather_rows`
// (:85); ops/shading.py `diffuse_dir_and_weight` (:110),
// `specular_reflect_dir` (:92), `refract_dir` (:231) and `fresnel_schlick`
// (:241); models/sun.py `sun_disk_factor`, `add_sun_color` and
// `add_sun_color_diffuse` (:159-202).  The backward replaces the VJP that
// `_bounce_skip` (:773-830) takes by rematerialising `_shade` (:785, :804).
// The JAX version is XLA-fused jnp over the whole lane batch; the port's
// plain-torch twin (ops/shade.py `shade_reference`) runs it as a few
// hundred eager launches per bounce.  Here one launch shades a bounce.
//
// The forward, per lane: the hit's material, uv, normal and t (the leaf's
// material, a block model's face material, a quad model's quad from
// K2q's mode 1, or K7's primitive where it is nearer); the material row and
// the nearest texel (clamp, v-flip, per-layer sizes); on a miss the sky and
// the sun disk; on a hit that may scatter one lobe (metal, specular,
// diffuse with the sun-importance warp: the cap, its 8-step remap, the
// annular segment and 4 redraws; refraction with Fresnel and total internal
// reflection; transmission), emission, and the masked update of the seven
// state fields; the hand-off to the next-event code (albedo, hit point,
// normal, material, the diffuse mask); and, when a gradient is taken, a
// 24-byte residual (the texel's index, the material, a lane code, and the
// sky colour or the diffuse weight).
//
// The backward, per lane: the gradients of the incoming throughput and of
// the albedo from the cotangents of the new throughput, the new radiance
// and the hand-off albedo; the albedo gradient is atomicAdd-ed into the
// texel the lane read, the emission gradient into its material's emittance.
// Float atomics make those sums' order depend on the schedule, as the
// twin's index_put with accumulate does on the card.
//
// What bounds it: bytes.  Per lane the forward reads about 170 bytes (the
// state, 21 uniforms, the hit) and a texel and a material row from tables
// that stay in L2, and writes about 120 (the state, the hand-off, the
// residual); its arithmetic (a few dozen transcendental calls on the
// importance path) is far below the card's float32 rate.  Both kernels are
// written for one launch in place of hundreds, not yet for that bound.
//
// ptxas reports a 32-byte stack frame for the forward: the local buffer of
// the Payne-Hanek argument reduction inside libdevice's sinf and cosf (the
// SASS's only local loads and stores sit in those calls), a path taken
// only for |x| > 105615; every angle here is within a few multiples of pi.
// PyTorch's own sin and cos kernels carry the same buffer.
//
// Parity with the twin on the card: built with -fmad=false, every
// operation in the twin's order, with the same libdevice functions that
// PyTorch's CUDA kernels call (sinf, cosf, sqrtf, asinf, acosf, atan2f,
// hypotf, fmodf) and PyTorch's own rules where they are not IEEE
// arithmetic: a sum over a last axis of 3 is (a0 + a2) + a1 (its reduction
// splits the axis over two threads); a division by a Python number is a
// multiply by the reciprocal rounded to float; a comparison with a Python
// number rounds it to float; `%` is fmodf with torch.remainder's sign rule;
// `.to(torch.int32)` truncates.  The hit point is the float64 multiply-add
// of ops/geometry.fma.  The sun disk's three dot products are matrix-vector
// products on the card (cuBLAS), taken here as the chain of fused
// multiply-adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EPS_F 5e-8f        // Ray::EPSILON
#define OFFSET_F 1e-6f     // Ray::OFFSET
// numpy's pi and the twin's Python constants, each rounded from its double
#define PI_F ((float)3.141592653589793)
#define TWO_PI_F ((float)6.283185307179586)   // 2.0 * PI
#define HALF_PI_F ((float)1.5707963267948966)  // PI / 2.0
#define INV_PI_F (1.0f / PI_F)                 // a division by PI on the card
#define MAX_CHANCE_F 0.9f              // MAX_IMPORTANCE_SAMPLE_CHANCE
#define FLAG_REFRACTIVE 0x04

// uniform slots (ops/shading.py)
#define U_METAL 0
#define U_SPECULAR 1
#define U_DIFFUSE 2
#define U_FRESNEL 3
#define U_X1 4
#define U_X2 5
#define U_IMPORTANCE 6
#define U_REDRAW0 8

// the residual's lane code (ops/shade.py)
#define CODE_MISS 1
#define CODE_EMIT 2
#define LOBE_SHIFT 2
#define LOBE_NONE 0
#define LOBE_METAL 1
#define LOBE_DIFFUSE 2
#define LOBE_ENTERS 3

constexpr int kThreads = 128;

struct SunParams {  // device pointers into the Sun's float32 tensors
  const float* azimuth;
  const float* altitude;
  const float* radius;
  const float* color;  // (4,)
  const float* luminosity;
  const float* chance;         // importance_sample_chance
  const float* sample_radius;  // importance_sample_radius
  const float* sw;             // (3,)
  const float* su;
  const float* sv;
  const float* apparent;  // apparent_texture_brightness (3,)
};

struct ShadeTables {
  const int* leaf_material;
  int n_leaf;
  const int* leaf_model;  // null without block models
  int n_leaf_model;
  const int* face_material;  // (Mm, 6)
  const float* ior;
  const float* specular;
  const float* emittance;
  const float* roughness;
  const float* metalness;
  const int* flags;
  const int* texture_index;
  const float* atlas;  // (T, H, W, 4)
  const int* sizes;    // (T, 2) per-layer (h, w), or null for a uniform atlas
  int atlas_h, atlas_w;
  SunParams sun;
};

struct ShadeLanes {
  const float* origin;
  const float* dir;
  const float* throughput;
  const float* radiance;
  long long origin_stride, dir_stride, throughput_stride, radiance_stride;
  const uint8_t* active;
  const uint8_t* specular;
  const int* cur_mat;
  const float* u;
  long long u_stride;
  const uint8_t* hit;
  const float* t;
  const int* face_id;
  const float* uv;
  const int* leaf_value;
  const uint8_t* q_found;  // the quad surfaces: null without quad models
  const int* q_mat;
  const float* q_uv;
  const float* q_normal;
  const float* q_t;
  const uint8_t* p_hit;  // the primitive hit: null without primitives
  const float* p_t;
  const int* p_mat;
  const float* p_uv;
  const float* p_normal;
};

struct ShadeOutputs {
  float* origin;
  float* dir;
  float* throughput;
  float* radiance;
  uint8_t* active;
  uint8_t* specular;
  int* cur_mat;
  float* albedo;
  float* hitpoint;
  float* normal;
  int* mat;
  uint8_t* diffuse_on;
  int* resid_i;    // (B, 3): texel, material, lane code; null without a gradient
  float* resid_f;  // (B, 3)
};

struct ShadeFlags {
  int is_first, may_scatter, importance, diffuse_sun, draw_texture, emission;
};

// ---- PyTorch's rounding rules on the card

// torch.sum over a last axis of 3: its reduction gives elements 0 and 2 to
// one thread and element 1 to another, then adds the two
__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return (a0 + a2) + a1; }

__device__ __forceinline__ float tdot(const float a[3], const float b[3]) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// a (B, 3) @ (3,) matrix-vector product (cuBLAS): a chain of fused multiply-adds
__device__ __forceinline__ float mv3(const float a[3], const float* b) {
  return fmaf(a[2], __ldg(b + 2), fmaf(a[1], __ldg(b + 1), a[0] * __ldg(b)));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

__device__ __forceinline__ float sgnf(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

__device__ __forceinline__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize(float x[3]) {
  float s = sqrtf(tdot(x, x));
  x[0] = x[0] / s;
  x[1] = x[1] / s;
  x[2] = x[2] / s;
}

// u = normalize(helper x n), the helper (0, 1, 0) where |n.x| > 0.1
__device__ __forceinline__ void frame_u(const float n[3], float tu[3]) {
  bool big_x = fabsf(n[0]) > 0.1f;
  const float h[3] = {big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f};
  cross(h, n, tu);
  normalize(tu);
}

// ops/shading._opposite_side_correction
__device__ void opposite_side(float nd[3], const float n[3], const float d[3]) {
  float s_out = sgnf(tdot(n, nd));
  float s_in = sgnf(tdot(n, d));
  if (s_out != s_in) return;
  float factor = s_in * (-EPS_F) - tdot(nd, n);
  for (int c = 0; c < 3; ++c) nd[c] = nd[c] + factor * n[c];
  normalize(nd);
}

// ops/shading.specular_reflect_dir
__device__ void specular_dir(const float d[3], const float n[3], float rough, const float* u,
                             float out[3]) {
  float two_dn = 2.0f * tdot(d, n);
  float mirror[3];
  for (int c = 0; c < 3; ++c) mirror[c] = d[c] - two_dn * n[c];
  if (rough > EPS_F) {
    float x1 = u[U_X1], x2 = u[U_X2];
    float r = sqrtf(x1);
    float theta = x2 * TWO_PI_F;
    float tx = r * cosf(theta), ty = r * sinf(theta), tz = sqrtf(1.0f - x1);
    float tu[3], tv[3];
    frame_u(n, tu);
    cross(n, tu, tv);
    for (int c = 0; c < 3; ++c) {
      float lobe = (tu[c] * tx + tv[c] * ty) + n[c] * tz;
      out[c] = lobe * rough + mirror[c] * (1.0f - rough);
    }
    normalize(out);
  } else {
    for (int c = 0; c < 3; ++c) out[c] = mirror[c];
  }
  opposite_side(out, n, d);
}

// ops/shading._ang_dist: torch.remainder by 2 pi, then the shorter way round
__device__ __forceinline__ float ang_dist(float a, float b) {
  float diff = fmodf(fabsf(a - b), TWO_PI_F);
  return diff > PI_F ? TWO_PI_F - diff : diff;
}

// ops/shading.diffuse_dir_and_weight: the cosine sample in the tangent
// plane (tx, ty), warped toward the sun's cap on the importance path;
// returns the weight
__device__ float diffuse_dir(const float n[3], const SunParams& sun, const float* u,
                             bool importance, float out[3]) {
  float x1 = u[U_X1], x2 = u[U_X2];
  float r = sqrtf(x1);
  float theta = x2 * TWO_PI_F;
  float tx = r * cosf(theta);
  float ty = r * sinf(theta);
  float weight = 1.0f;

  if (importance) {
    float alt_f = __ldg(sun.altitude), az = __ldg(sun.azimuth);
    float sun_alt = fabsf(alt_f) > HALF_PI_F ? sgnf(alt_f) * PI_F - alt_f : alt_f;
    float sdx = cosf(az) * cosf(sun_alt);
    float sdy = sinf(sun_alt);
    float sdz = sinf(az) * cosf(sun_alt);
    float nx = n[0], ny = n[1], nz = n[2];
    float sun_tz = (sdx * nx + sdy * ny) + sdz * nz;
    bool big_x = fabsf(nx) > 0.1f;
    float sun_tx, sun_ty, hyp;
    if (big_x) {
      sun_tx = sdx * nz - sdz * nx;
      sun_ty = (sdx * nx * ny - sdy * (nx * nx + nz * nz)) + sdz * ny * nz;
      hyp = hypotf(nx, nz);
    } else {
      sun_tx = sdz * ny - sdy * nz;
      sun_ty = (sdy * nx * ny - sdx * (ny * ny + nz * nz)) + sdz * nx * nz;
      hyp = hypotf(nz, ny);
    }
    sun_tx = sun_tx / hyp;
    sun_ty = sun_ty / hyp;

    float cr = __ldg(sun.radius) * __ldg(sun.sample_radius);
    float chance = __ldg(sun.chance);
    float sun_alt_rel = asinf(clampf(sun_tz, -1.0f, 1.0f));
    bool visible = sun_alt_rel + cr > EPS_F;
    if (visible) {
      bool cap_inside = (hypotf(sun_tx, sun_ty) + cr) + EPS_F < 1.0f;
      float w_tx, w_ty, w_w;
      if (cap_inside) {  // the circular cap
        if (u[U_IMPORTANCE] < chance) {
          w_tx = sun_tx + tx * cr;
          w_ty = sun_ty + ty * cr;
          w_w = cr * cr / chance;
        } else {  // the deterministic remap out of the cap (bounded fixpoint)
          float otx = tx, oty = ty;
          for (int k = 0; k < 8; ++k) {
            bool inside = hypotf(otx - sun_tx, oty - sun_ty) < cr;
            float ntx = (otx - sun_tx) / cr;
            float nty = (oty - sun_ty) / cr;
            otx = inside ? ntx : otx;
            oty = inside ? nty : oty;
          }
          w_tx = otx;
          w_ty = oty;
          w_w = (1.0f - cr * cr) / (1.0f - chance);
        }
      } else {  // the shallow-angle annular segment
        float min_r = cosf(sun_alt_rel + cr);
        float max_r = cosf(clamp_min(sun_alt_rel - cr, 0.0f));
        float sun_theta = atan2f(sun_ty, sun_tx);
        float seg = ((max_r * max_r - min_r * min_r) * cr) * INV_PI_F;
        float s_chance = clamp_max(chance * seg / (cr * cr), MAX_CHANCE_F);
        if (u[U_IMPORTANCE] < s_chance) {
          float seg_r = sqrtf(min_r * min_r * x1 + max_r * max_r * (1.0f - x1));
          float seg_theta = sun_theta + (2.0f * x2 - 1.0f) * cr;
          w_tx = seg_r * cosf(seg_theta);
          w_ty = seg_r * sinf(seg_theta);
          w_w = seg / s_chance;
        } else {  // rejection with fresh redraw pairs
          float rr = r, rtheta = theta;
          for (int k = 0; k < 4; ++k) {
            bool bad = rr > min_r && rr < max_r && ang_dist(rtheta, sun_theta) < cr;
            if (bad) {
              rr = sqrtf(u[U_REDRAW0 + 2 * k]);
              rtheta = u[U_REDRAW0 + 2 * k + 1] * TWO_PI_F;
            }
          }
          w_tx = rr * cosf(rtheta);
          w_ty = rr * sinf(rtheta);
          w_w = (1.0f - seg) / (1.0f - s_chance);
        }
      }
      tx = w_tx;
      ty = w_ty;
      weight = w_w;
    }
  }

  float tz = sqrtf(clamp_min(1.0f - tx * tx - ty * ty, 0.0f));
  float tu[3], tv[3];
  frame_u(n, tu);
  cross(tu, n, tv);
  for (int c = 0; c < 3; ++c) out[c] = (tu[c] * tx + tv[c] * ty) + n[c] * tz;
  return weight;
}

// ops/shading.refract_dir
__device__ void refract(const float d[3], const float n[3], float ratio, float cos_theta,
                        float radicand, float out[3]) {
  float t2 = sqrtf(clamp_min(radicand, 0.0f));
  if (cos_theta > 0.0f) {
    float k = ratio * cos_theta - t2;
    for (int c = 0; c < 3; ++c) out[c] = ratio * d[c] + k * n[c];
  } else {
    float k = -ratio * cos_theta - t2;
    for (int c = 0; c < 3; ++c) out[c] = ratio * d[c] - k * n[c];
  }
  normalize(out);
  opposite_side(out, n, d);
}

// models/sun.sun_disk_factor's window test
__device__ bool in_sun_disk(const SunParams& sun, const float d[3]) {
  float cos_sw = mv3(d, sun.sw);
  float width = __ldg(sun.radius) * 4.0f;
  float width2 = width * 2.0f;
  float a = (HALF_PI_F - acosf(clampf(mv3(d, sun.su), -1.0f, 1.0f))) + width;
  float b = (HALF_PI_F - acosf(clampf(mv3(d, sun.sv), -1.0f, 1.0f))) + width;
  return cos_sw >= 0.5f && a >= 0.0f && a < width2 && b >= 0.0f && b < width2;
}

// pathtracer.sky_radiance: the specular path's sun (add_sun_color) on the
// primary bounce and after a specular one, the diffuse path's otherwise
__device__ void sky_radiance(const SunParams& sun, const ShadeFlags& fl, const float d[3],
                             bool specular_path, float out[3]) {
  const float sky[3] = {0.5f, 0.7f, 1.0f};
  for (int c = 0; c < 3; ++c) out[c] = sky[c];
  if (specular_path) {
    if (fl.draw_texture && in_sun_disk(sun, d))
      for (int c = 0; c < 3; ++c) out[c] = sky[c] + __ldg(sun.apparent + c) * 10.0f;
  } else if (fl.diffuse_sun && in_sun_disk(sun, d)) {
    float lum = __ldg(sun.luminosity);
    for (int c = 0; c < 3; ++c) out[c] = sky[c] + (__ldg(sun.color + c) * 10.0f) * lum;
  }
}

__global__ void __launch_bounds__(kThreads)
    shade_forward_kernel(int n, ShadeTables tb, ShadeLanes ln, ShadeOutputs out, ShadeFlags fl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], tp[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = ln.origin[i * ln.origin_stride + c];
    d[c] = ln.dir[i * ln.dir_stride + c];
    tp[c] = ln.throughput[i * ln.throughput_stride + c];
    rad[c] = ln.radiance[i * ln.radiance_stride + c];
  }
  bool active = ln.active[i] != 0, specular = ln.specular[i] != 0;
  int cur_mat = ln.cur_mat[i];
  const float* u = ln.u + i * ln.u_stride;
  bool oct_hit = ln.hit[i] != 0;
  bool p_hit = ln.p_hit != nullptr && ln.p_hit[i] != 0;
  bool any_hit = oct_hit || p_hit;
  bool miss = active && !any_hit;
  bool can_scatter = fl.may_scatter && active && any_hit;

  // the sky on a miss
  float sky[3] = {0.0f, 0.0f, 0.0f};
  if (miss) sky_radiance(tb.sun, fl, d, fl.is_first || specular, sky);
  for (int c = 0; c < 3; ++c) rad[c] = rad[c] + (miss ? tp[c] * sky[c] : 0.0f);

  // resolve: the entry face's normal, uv and t; the leaf's or the model's
  // material; a quad model's quad; the nearer primitive
  int face = min(max(ln.face_id[i], 0), 5);
  float sgn = (face & 1) ? 1.0f : -1.0f;  // selects: no register array indexed at run time
  float nrm[3] = {face >> 1 == 0 ? sgn : 0.0f, face >> 1 == 1 ? sgn : 0.0f, face >> 1 == 2 ? sgn : 0.0f};
  float huv[2] = {ln.uv[2 * i], ln.uv[2 * i + 1]};
  float t_hit = ln.t[i];
  int leaf = ln.leaf_value[i];
  int mat;
  if (tb.leaf_model == nullptr) {
    mat = __ldg(tb.leaf_material + min(max(leaf, 0), tb.n_leaf - 1));
  } else {
    int model = __ldg(tb.leaf_model + min(max(leaf, 0), tb.n_leaf_model - 1));
    mat = __ldg(tb.face_material + 6 * model + face);
    if (ln.q_found != nullptr && ln.q_found[i]) {
      mat = ln.q_mat[i];
      huv[0] = ln.q_uv[2 * i];
      huv[1] = ln.q_uv[2 * i + 1];
      for (int c = 0; c < 3; ++c) nrm[c] = ln.q_normal[3 * i + c];
      t_hit = ln.q_t[i];
    }
  }
  if (p_hit) {
    float p_t = ln.p_t[i];
    if (p_t < (oct_hit ? t_hit : __int_as_float(0x7f800000))) {
      mat = ln.p_mat[i];
      huv[0] = ln.p_uv[2 * i];
      huv[1] = ln.p_uv[2 * i + 1];
      for (int c = 0; c < 3; ++c) nrm[c] = ln.p_normal[3 * i + c];
      t_hit = p_t;
    }
  }

  // the material row and the nearest texel
  float ior1 = __ldg(tb.ior + mat), spec = __ldg(tb.specular + mat), emit = __ldg(tb.emittance + mat);
  float rough = __ldg(tb.roughness + mat), metal = __ldg(tb.metalness + mat);
  int mflags = __ldg(tb.flags + mat), layer = __ldg(tb.texture_index + mat);
  int t_h = tb.atlas_h, t_w = tb.atlas_w;
  if (tb.sizes != nullptr) {
    t_h = __ldg(tb.sizes + 2 * layer);
    t_w = __ldg(tb.sizes + 2 * layer + 1);
  }
  float uu = clampf(huv[0], 0.0f, 1.0f);
  float vv = 1.0f - clampf(huv[1], 0.0f, 1.0f);
  int ti = max((int)(uu * (float)t_w), 0);
  int tj = max((int)(vv * (float)t_h), 0);
  ti = ti > t_w - 1 ? t_w - 1 : ti;
  tj = tj > t_h - 1 ? t_h - 1 : tj;
  int texel = (layer * tb.atlas_h + tj) * tb.atlas_w + ti;
  float4 alb = __ldg(reinterpret_cast<const float4*>(tb.atlas) + texel);
  float a[4] = {alb.x, alb.y, alb.z, alb.w};
  float hp[3];
  for (int c = 0; c < 3; ++c) hp[c] = (float)((double)d[c] * (double)t_hit + (double)o[c]);

  // the lobe
  float ior2 = __ldg(tb.ior + cur_mat);
  bool do_metal = metal > EPS_F && u[U_METAL] < metal;
  bool do_spec = !do_metal && spec > EPS_F && u[U_SPECULAR] < spec;
  bool do_diff = !do_metal && !do_spec && u[U_DIFFUSE] < a[3];
  bool do_refr = !do_metal && !do_spec && !do_diff && fabsf(ior1 - ior2) >= EPS_F;
  bool emit_on = can_scatter && fl.emission && do_diff && emit > EPS_F;
  for (int c = 0; c < 3; ++c) {
    float emit_rgb = emit_on ? a[c] * a[c] * emit : 0.0f;
    rad[c] = rad[c] + (can_scatter ? tp[c] * emit_rgb : 0.0f);
  }

  float nd[3] = {d[0], d[1], d[2]};
  float mult[3] = {1.0f, 1.0f, 1.0f};
  float diff_w = 0.0f;
  int lobe = LOBE_NONE;
  if (can_scatter) {
    if (do_metal || do_spec) {
      specular_dir(d, nrm, rough, u, nd);
      if (do_metal) {
        lobe = LOBE_METAL;
        for (int c = 0; c < 3; ++c) mult[c] = a[c];
      }
    } else if (do_diff) {
      diff_w = diffuse_dir(nrm, tb.sun, u, fl.importance, nd);
      lobe = LOBE_DIFFUSE;
      for (int c = 0; c < 3; ++c) mult[c] = a[c] * diff_w;
    } else {
      bool enters = true;
      if (do_refr) {
        bool refractive = (mflags & FLAG_REFRACTIVE) != 0;
        float ratio = ior1 / ior2;
        float cos_theta = -tdot(d, nrm);
        float radicand = 1.0f - ratio * ratio * (1.0f - cos_theta * cos_theta);
        bool tir = refractive && radicand < EPS_F;
        // fresnel_schlick(ior1, ior2, cos_theta)
        float fr = ior1 / ior2;
        float fa = fr - 1.0f, fb = fr + 1.0f;
        float r0 = (fa * fa) / (fb * fb);
        float cc = 1.0f - cos_theta;
        float c2 = cc * cc;
        float refl_p = r0 + (1.0f - r0) * (cc * (c2 * c2));
        if (tir || u[U_FRESNEL] < refl_p) {  // reflects
          specular_dir(d, nrm, rough, u, nd);
          enters = false;
        } else if (refractive) {
          refract(d, nrm, ratio, cos_theta, radicand, nd);
        }  // else passes straight through
      }
      if (enters) {
        lobe = LOBE_ENTERS;
        for (int c = 0; c < 3; ++c) mult[c] = a[c] * a[3];
        cur_mat = mat;
      }
    }
    for (int c = 0; c < 3; ++c) {
      o[c] = hp[c] + nd[c] * OFFSET_F;
      d[c] = nd[c];
      tp[c] = tp[c] * mult[c];
    }
    if (do_diff) specular = false;
  }

  for (int c = 0; c < 3; ++c) {
    out.origin[3 * i + c] = o[c];
    out.dir[3 * i + c] = d[c];
    out.throughput[3 * i + c] = tp[c];
    out.radiance[3 * i + c] = rad[c];
    out.hitpoint[3 * i + c] = hp[c];
    out.normal[3 * i + c] = nrm[c];
  }
  out.active[i] = can_scatter;
  out.specular[i] = specular;
  out.cur_mat[i] = cur_mat;
  reinterpret_cast<float4*>(out.albedo)[i] = alb;
  out.mat[i] = mat;
  out.diffuse_on[i] = can_scatter && do_diff;
  if (out.resid_i != nullptr) {
    out.resid_i[3 * i] = texel;
    out.resid_i[3 * i + 1] = mat;
    out.resid_i[3 * i + 2] = (miss ? CODE_MISS : 0) | (emit_on ? CODE_EMIT : 0) | (lobe << LOBE_SHIFT);
    out.resid_f[3 * i] = miss ? sky[0] : diff_w;
    out.resid_f[3 * i + 1] = sky[1];
    out.resid_f[3 * i + 2] = sky[2];
  }
}

// The backward of one bounce's base shading, per lane (ops/shade.py
// `shade_backward_reference` written out): a null cotangent is zero, a
// null gradient is not wanted.
__global__ void __launch_bounds__(kThreads)
    shade_backward_kernel(int n, const float* __restrict__ g_tp, const float* __restrict__ g_rad,
                          const float* __restrict__ g_alb, const float* __restrict__ albedo,
                          const float* __restrict__ throughput, const int* __restrict__ resid_i,
                          const float* __restrict__ resid_f, const float* __restrict__ emittance,
                          float* __restrict__ d_tp, float* __restrict__ d_atlas, float* __restrict__ d_emit) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int texel = resid_i[3 * i], mat = resid_i[3 * i + 1], code = resid_i[3 * i + 2];
  bool miss = (code & CODE_MISS) != 0, emit_on = (code & CODE_EMIT) != 0;
  int lobe = code >> LOBE_SHIFT;
  float4 alb = reinterpret_cast<const float4*>(albedo)[i];
  float a[4] = {alb.x, alb.y, alb.z, alb.w};
  float tp[3], dt[3] = {0.0f, 0.0f, 0.0f};
  float da[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) tp[c] = throughput[3 * i + c];
  if (g_alb != nullptr)
    for (int c = 0; c < 4; ++c) da[c] = g_alb[4 * i + c];
  float de = 0.0f;
  if (g_rad != nullptr) {
    float e = emit_on ? __ldg(emittance + mat) : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float g = g_rad[3 * i + c];
      if (miss) dt[c] = dt[c] + g * resid_f[3 * i + c];
      if (emit_on) {
        dt[c] = dt[c] + g * (a[c] * a[c] * e);
        float ge = g * tp[c];
        da[c] = da[c] + 2.0f * (ge * e) * a[c];
        de = de + ge * (a[c] * a[c]);
      }
    }
  }
  if (g_tp != nullptr) {
    float dw = resid_f[3 * i];
    for (int c = 0; c < 3; ++c) {
      float g = g_tp[3 * i + c];
      float m = lobe == LOBE_METAL ? a[c] : lobe == LOBE_DIFFUSE ? a[c] * dw : lobe == LOBE_ENTERS ? a[c] * a[3] : 1.0f;
      dt[c] = dt[c] + g * m;
      float gm = g * tp[c];
      if (lobe == LOBE_METAL) da[c] = da[c] + gm;
      if (lobe == LOBE_DIFFUSE) da[c] = da[c] + gm * dw;
      if (lobe == LOBE_ENTERS) {
        da[c] = da[c] + gm * a[3];
        da[3] = da[3] + gm * a[c];
      }
    }
  }
  if (d_tp != nullptr)
    for (int c = 0; c < 3; ++c) d_tp[3 * i + c] = dt[c];
  if (d_atlas != nullptr)
    for (int c = 0; c < 4; ++c)
      if (da[c] != 0.0f) atomicAdd(d_atlas + 4 * (long long)texel + c, da[c]);
  if (d_emit != nullptr && emit_on) atomicAdd(d_emit + mat, de);
}

extern "C" int shade_forward(int n, const ShadeTables* tables, const ShadeLanes* lanes,
                             const ShadeOutputs* outputs, const ShadeFlags* flags, void* stream) {
  if (n == 0) return 0;
  shade_forward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, *tables, *lanes, *outputs, *flags);
  return (int)cudaGetLastError();
}

extern "C" int shade_backward(int n, const void* g_tp, const void* g_rad, const void* g_alb,
                              const void* albedo, const void* throughput, const void* resid_i,
                              const void* resid_f, const void* emittance, void* d_tp, void* d_atlas,
                              void* d_emit, void* stream) {
  if (n == 0) return 0;
  shade_backward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const float*)g_tp, (const float*)g_rad, (const float*)g_alb, (const float*)albedo,
      (const float*)throughput, (const int*)resid_i, (const float*)resid_f, (const float*)emittance,
      (float*)d_tp, (float*)d_atlas, (float*)d_emit);
  return (int)cudaGetLastError();
}

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
