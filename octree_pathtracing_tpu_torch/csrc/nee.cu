// Kernel K4's next-event half and kernel K6, the emitter pick: the sun and
// emitter next-event estimates of one bounce with the shadow-attenuation
// recompute, forward (nee_setup, nee_resolve) and backward (nee_backward),
// one thread per lane.
//
// Replaces: octree_pathtracing_tpu/render/pathtracer.py `_shade` :1361-1504
// (the sun NEE and the emitter NEE with `em_face_contrib`), with
// `shadow_attenuation` (:148) and its recompute (:195, :226, :255);
// models/emitters.py `_spatial_pick` (:161), `sample_emitter_point` (:201)
// and `toward_face_sample` (:270), kernel K6; models/sun.py
// `random_sun_direction`.  The backward replaces the part of the VJP that
// `_bounce_skip` (:772-843) takes through these terms.  The JAX version is
// XLA-fused jnp; the port's plain versions (ops/nee.py) run it as eager
// torch, thousands of launches a bounce with autograd replaying them.
//
// A bounce casts F shadow rays per lane, one per face: face 0 toward the
// sun where the scene samples it, then the emitter faces (ONE: one point of
// one spatially picked emitter; ONE_BLOCK: the 3 toward faces of one
// uniformly picked emitter; ALL: the 3 toward faces of each of E <= 64
// emitters).  Rays are face-major: row f * B + i is lane i's face f.
//
// nee_setup, per lane: the sun direction (a cone sample), the front and
// subsurface tests and the shadow origin; K6's pick (the supercell row read
// here, the K-wide CDF walk, the exact membership pdf) and the point on the
// emitter, or the uniform pick and its toward faces; per face to_q, dist
// (its EPSILON^2 clamp), wi, the two cosines, whether it is cast, max_t and
// the geometry scale; the emitter point's texel.  It writes the rays the
// walks read (origin, direction, active, medium) and what nee_resolve reads.
//
// The walks between the two are the existing kernels, one call each for
// all faces: K1 / K2 on shadow_binary scenes, K3s (mode 3 of traversal.cu,
// with K2q's model variant) otherwise, K7 for the primitives.
//
// nee_resolve, per lane and face: the attenuation from the walk's records
// (up to K_SURFACES texels under the alpha budget w, the strict-IOR zero,
// the ts[k] < max_t cut; or the binary walk's one surface), the nearest
// primitive's factor, then the sun term or the emitter's area-form term;
// it adds throughput * (sun + emitters) to the radiance K4 wrote.  With a
// gradient it writes 36 bytes per face and lane: a code (cast; the slots'
// strict zeros), the texel each attenuating slot read, the emitter's texel
// and material, and the geometry scale (written by nee_setup).
//
// nee_backward, per lane: from the radiance cotangent, the throughput's
// and the shading point's albedo's gradients (the albedo's reach the atlas
// through K4's backward); the blockers' rgba and the emitter's rgb are
// atomicAdd-ed into the one dense atlas gradient, the emitter's emission
// into the emittance's.  It re-reads the texels the residual names and
// walks nothing again.  The two sums are float64: under ALL a bounce adds
// 3 E terms per lane, ~10^7 onto one material, and a float32 sum in the
// schedule's order drifts from any other order by ~1e-4 relative; in
// float64 every order agrees to the float32 result.
//
// What bounds them: bytes.  Per lane and face nee_setup writes 41 bytes of
// rays and reads a few words of the hand-off, the uniforms and tables that
// stay in L2 (the supercell row, 64 bytes); nee_resolve reads the walk's
// record (up to 65 bytes) and 1-6 texels; the arithmetic is a few dozen
// operations per face (sinf / cosf and two sqrtf on the sun face), far
// below the card's float32 rate.  They are written for a few launches in
// place of thousands, not yet for that bound.
//
// Parity with the plain versions on the card: built with -fmad=false, every
// operation in the plain version's order, with PyTorch's rounding rules on
// the card: a sum over a last axis of 3 is (a0 + a2) + a1; a division by a
// Python number is a multiply by the reciprocal rounded to float (so the
// pick's scalars come from the wrapper, rounded as torch rounds them); a
// Python scalar operand is rounded to float; `.to(torch.int32)` truncates.
// The cumulative sums are left-to-right folds, as the plain version writes
// them; a sum with one nonzero term (the pdf's membership row, the face
// weight, the hi test) is that term in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_rounding.cuh"

#define EPS_F 5e-8f                          // Ray::EPSILON
#define EPS2_F ((float)(5e-8 * 5e-8))        // EPSILON * EPSILON as Python computes it
#define OFFSET_F 1e-6f                       // Ray::OFFSET
#define TWO_PI_F ((float)6.283185307179586)  // 2.0 * numpy's pi
#define INV_PI_F (1.0f / (float)3.141592653589793)  // a division by math.pi on the card
#define MAX_T_FRAC ((float)(1.0 - 1e-3))     // max_t = dist * (1 - 1e-3)
#define PICK_MAX ((float)(1.0 - 1e-7))       // the pick's clamp below 1
#define FLAG_SUBSURFACE 0x02

// uniform slots (ops/shading.py)
#define U_SUBSURFACE 7
#define U_SUN1 16
#define U_SUN2 17
#define U_EM_PICK 18
#define U_EM1 19
#define U_EM2 20

#define K_SURF 4                 // K_SURFACES
#define N_SLOTS (K_SURF + 1)     // the surfaces, then the primitive
#define RESID_INTS (3 + N_SLOTS)  // code, the slots' texels, the emitter's texel and material
#define CODE_ON 1
#define ZERO_SHIFT 1

#define EM_NONE 0
#define EM_ONE 1
#define EM_ONE_BLOCK 2
#define EM_ALL 3

constexpr int kThreads = 128;

struct NeeTables {
  const float* ior;
  const float* emittance;
  const int* flags;
  const int* texture_index;
  const float* atlas;  // (T, H, W, 4)
  const int* sizes;    // (T, 2) per-layer (h, w), or null for a uniform atlas
  int atlas_h, atlas_w;
  const int* leaf_material;  // the binary walk's hit material
  int n_leaf;
  const int* leaf_model;  // null without block models
  int n_leaf_model;
  const int* face_material;  // (Mm, 6)
  const float* su;           // the sun's basis (3,) each
  const float* sv;
  const float* sw;
  const float* radius_cos;
  const float* sun_emittance;  // (4,)
  const float* luminosity;
  const float* e_pos;  // (E, 3); null without emitter sampling
  const float* e_size;
  const int* e_mat;
  const int* grid_idx;  // (C, K) supercell rows; null: the uniform pick
  const float* grid_w;
  int n_emit, grid_k, grid_side;
  // the pick's Python scalars, rounded as the card's torch rounds them
  float cell_offset;    // 0.01 * cell_size
  float inv_cell;       // 1 / cell_size
  float lam;            // the uniform floor
  float inv_lam;        // 1 / lam
  float inv_one_m_lam;  // 1 / (1 - lam)
  float one_m_lam;      // 1 - lam
  float lam_over_e;     // lam / E
};

struct NeeFlags {
  int sun, em_mode, faces, strict, sun_luminosity, binary;
  float f_sub;  // the subsurface chance
};

struct SetupIn {  // K4's hand-off and the lane's state
  const float* hitpoint;
  const float* normal;
  const int* mat;
  const uint8_t* diffuse_on;
  const int* cur_mat;
  const float* u;
  long long u_stride;
};

struct Rays {  // ops/nee.NeeRays, (F * B) rows
  float* origin;
  float* dir;
  float* max_t;
  float* scale;
  uint8_t* active;
  int* cur_mat;
  int* e_texel;
  int* e_mat;
};

struct Walk {  // the binary walk's first hit or the stateful walk's record, and K7's hit
  const uint8_t* hit;
  const float* t;
  const int* face_id;
  const float* uv;
  const int* leaf_value;
  const int* count;  // the stateful record: count (F*B), mats / uu / vv / ts (K, F*B)
  const int* mats;
  const float* uu;
  const float* vv;
  const float* ts;  // null: no max_t cut
  const uint8_t* p_hit;  // null without primitives
  const float* p_t;
  const int* p_mat;
  const float* p_uv;
};

struct ResolveIn {
  const float* albedo;  // (B, 4) the shading point's texel
  const float* throughput;
  const float* radiance;  // what K4 wrote
  const int* cur_mat;
  long long throughput_stride, radiance_stride;
};

// ops/texture.texel_index: nearest texel with the clamp and the v-flip
__device__ __forceinline__ int texel_of(const NeeTables& tb, int mat, float u, float v) {
  int layer = __ldg(tb.texture_index + mat);
  int t_h = tb.atlas_h, t_w = tb.atlas_w;
  if (tb.sizes != nullptr) {
    t_h = __ldg(tb.sizes + 2 * layer);
    t_w = __ldg(tb.sizes + 2 * layer + 1);
  }
  float uu = clampf(u, 0.0f, 1.0f);
  float vv = 1.0f - clampf(v, 0.0f, 1.0f);
  int ti = max((int)(uu * (float)t_w), 0);
  int tj = max((int)(vv * (float)t_h), 0);
  ti = ti > t_w - 1 ? t_w - 1 : ti;
  tj = tj > t_h - 1 ? t_h - 1 : tj;
  return (layer * tb.atlas_h + tj) * tb.atlas_w + ti;
}

__device__ __forceinline__ float4 texel_rgba(const NeeTables& tb, int texel) {
  return __ldg(reinterpret_cast<const float4*>(tb.atlas) + texel);
}

__device__ __forceinline__ void put_ray(const Rays& out, long long r, const float o[3], const float d[3],
                                        float max_t, float scale, bool on, int cm, int e_texel, int e_mat) {
  for (int c = 0; c < 3; ++c) {
    out.origin[3 * r + c] = o[c];
    out.dir[3 * r + c] = d[c];
  }
  out.max_t[r] = max_t;
  out.scale[r] = scale;
  out.active[r] = on;
  out.cur_mat[r] = cm;
  out.e_texel[r] = e_texel;
  out.e_mat[r] = e_mat;
}

// ops/nee.nee_setup_reference's emitter face: the shadow ray from the
// (masked) shading point p toward the point q of outward normal ne
__device__ void emitter_face(const NeeTables& tb, const Rays& out, long long r, const float p[3],
                             const float n[3], bool don, int cm, const float q[3], const float ne[3],
                             int mat_e, float eu, float ev, float inv_pdf) {
  float to_q[3], wi[3], o[3];
  for (int c = 0; c < 3; ++c) to_q[c] = q[c] - p[c];
  float dist = sqrtf(clamp_min(sum3(to_q[0] * to_q[0], to_q[1] * to_q[1], to_q[2] * to_q[2]), EPS2_F));
  for (int c = 0; c < 3; ++c) wi[c] = to_q[c] / dist;
  float cos_s = sum3(wi[0] * n[0], wi[1] * n[1], wi[2] * n[2]);
  float cos_e = sum3(-wi[0] * ne[0], -wi[1] * ne[1], -wi[2] * ne[2]);
  bool on = don && cos_s > 0.0f && cos_e > 0.0f;
  float geom = ((cos_s * cos_e) / clamp_min(dist * dist, EPS_F)) * INV_PI_F;
  for (int c = 0; c < 3; ++c) o[c] = p[c] + wi[c] * OFFSET_F;
  put_ray(out, r, o, wi, dist * MAX_T_FRAC, geom * inv_pdf, on, cm, texel_of(tb, mat_e, eu, ev), mat_e);
}

// models/emitters._spatial_pick: (idx, 1 / p_pick) for the point pc
__device__ int spatial_pick(const NeeTables& tb, const float pc[3], float u_pick, float* pick_inv) {
  int e = tb.n_emit;
  if (tb.grid_idx == nullptr) {
    *pick_inv = (float)e;
    return min((int)(u_pick * (float)e), e - 1);
  }
  int g = tb.grid_side, k = tb.grid_k;
  int cell[3];
  for (int c = 0; c < 3; ++c) cell[c] = min(max((int)(pc[c] * tb.inv_cell), 0), g - 1);
  long long row = (long long)((cell[0] * g + cell[1]) * g + cell[2]) * k;
  const int* gi = tb.grid_idx + row;
  const float* gw = tb.grid_w + row;
  bool uni = u_pick < tb.lam;
  float u_u = clampf(u_pick * tb.inv_lam, 0.0f, PICK_MAX);
  int idx_u = min((int)(u_u * (float)e), e - 1);
  float u_s = clampf((u_pick - tb.lam) * tb.inv_one_m_lam, 0.0f, PICK_MAX);
  // (u_s > cdf).sum over the left-to-right fold of the row's weights
  float cdf = 0.0f;
  int j = 0;
  for (int m = 0; m < k; ++m) {
    float w = __ldg(gw + m);
    cdf = m == 0 ? w : cdf + w;
    j += u_s > cdf ? 1 : 0;
  }
  j = min(j, k - 1);
  int idx = uni ? idx_u : __ldg(gi + j);
  float w_match = 0.0f;  // the row's weight of idx: at most one entry matches
  for (int m = 0; m < k; ++m)
    if (__ldg(gi + m) == idx) w_match = w_match + __ldg(gw + m);
  float p_pick = w_match * tb.one_m_lam + tb.lam_over_e;
  *pick_inv = 1.0f / p_pick;
  return idx;
}

__global__ void __launch_bounds__(kThreads)
    nee_setup_kernel(int n, NeeTables tb, SetupIn in, Rays out, NeeFlags fl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float hp[3], nrm[3];
  for (int c = 0; c < 3; ++c) {
    hp[c] = in.hitpoint[3 * i + c];
    nrm[c] = in.normal[3 * i + c];
  }
  bool don = in.diffuse_on[i] != 0;
  int cm = in.cur_mat[i];
  const float* u = in.u + i * in.u_stride;
  long long f = 0;

  if (fl.sun) {  // models/sun.random_sun_direction, then the front and subsurface tests
    float u1 = u[U_SUN1], u2 = u[U_SUN2];
    float cos_a = (1.0f - u1) + u1 * __ldg(tb.radius_cos);
    float sin_a = sqrtf(1.0f - cos_a * cos_a);
    float phi = u2 * TWO_PI_F;
    float cp = cosf(phi) * sin_a, sp = sinf(phi) * sin_a;
    float sd[3], o[3];
    for (int c = 0; c < 3; ++c) sd[c] = (__ldg(tb.su + c) * cp + __ldg(tb.sv + c) * sp) + __ldg(tb.sw + c) * cos_a;
    float cos_sun = sum3(sd[0] * nrm[0], sd[1] * nrm[1], sd[2] * nrm[2]);
    bool front = cos_sun > 0.0f;
    bool sss = (__ldg(tb.flags + in.mat[i]) & FLAG_SUBSURFACE) != 0 && u[U_SUBSURFACE] < fl.f_sub;
    bool on = don && (front || sss);
    for (int c = 0; c < 3; ++c) {
      float so = front ? hp[c] : hp[c] - nrm[c] * OFFSET_F;
      o[c] = so + sd[c] * OFFSET_F;
    }
    float lum = fl.sun_luminosity ? 1.0f / __ldg(tb.luminosity) : 1.0f;
    put_ray(out, i, o, sd, __int_as_float(0x7f800000), fabsf(cos_sun) * lum, on, cm, -1, -1);
    f = 1;
  }
  if (fl.em_mode == EM_NONE) return;

  // a lane off the diffuse lobe samples from a finite stand-in point
  float p[3];
  for (int c = 0; c < 3; ++c) p[c] = don ? hp[c] : 0.0f;
  float u_pick = u[U_EM_PICK], u1 = u[U_EM1], u2 = u[U_EM2];
  if (fl.em_mode == EM_ONE) {  // models/emitters.sample_emitter_point
    float pc[3], pick_inv;
    for (int c = 0; c < 3; ++c) pc[c] = p[c] + nrm[c] * tb.cell_offset;
    int idx = spatial_pick(tb, pc, u_pick, &pick_inv);
    float size = __ldg(tb.e_size + idx);
    int mat_e = __ldg(tb.e_mat + idx);
    float pos[3], dpc[3], w[3];
    for (int c = 0; c < 3; ++c) {
      pos[c] = __ldg(tb.e_pos + 3 * idx + c);
      dpc[c] = p[c] - (pos[c] + size * 0.5f);
    }
    float dn = sqrtf(clamp_min((dpc[0] * dpc[0] + dpc[1] * dpc[1]) + dpc[2] * dpc[2], 1e-12f));
    for (int c = 0; c < 3; ++c) w[c] = fabsf(dpc[c]) / dn + 1e-6f;
    float c0 = w[0], c1 = c0 + w[1], total = c1 + w[2];
    float r = u1 * total;
    int axis = r < c0 ? 0 : (r < c1 ? 1 : 2);
    float w_a = axis == 0 ? w[0] : (axis == 1 ? w[1] : w[2]);
    float lo = axis == 0 ? 0.0f : (axis == 1 ? c0 : c1);
    float a = clampf((r - lo) / w_a, 0.0f, 1.0f);
    float d_ax = axis == 0 ? dpc[0] : (axis == 1 ? dpc[1] : dpc[2]);
    float hi = d_ax > 0.0f ? 1.0f : 0.0f;
    float q[3], ne[3];
    for (int c = 0; c < 3; ++c) {
      int rel = (c - axis + 3) % 3;  // 0: the face's axis, 1: (axis + 1) % 3, 2: (axis + 2) % 3
      float coord = rel == 0 ? hi * size : (rel == 1 ? a * size : u2 * size);
      q[c] = pos[c] + coord;
      ne[c] = rel == 0 ? 2.0f * hi - 1.0f : 0.0f;
    }
    float inv_pdf = (((pick_inv * size) * size) * total) / w_a;
    emitter_face(tb, out, f * n + i, p, nrm, don, cm, q, ne, mat_e, a, u2, inv_pdf);
    return;
  }
  // ONE_BLOCK: one uniformly picked emitter; ALL: every emitter.  Each sums
  // its 3 toward faces (models/emitters.toward_face_sample)
  int first = 0, last = tb.n_emit;
  if (fl.em_mode == EM_ONE_BLOCK) {
    first = min((int)(u_pick * (float)tb.n_emit), tb.n_emit - 1);
    last = first + 1;
  }
  for (int e = first; e < last; ++e) {
    float size = __ldg(tb.e_size + e);
    int mat_e = __ldg(tb.e_mat + e);
    float inv_pdf = fl.em_mode == EM_ONE_BLOCK ? ((float)tb.n_emit * size) * size : size * size;
    float pos[3];
    for (int c = 0; c < 3; ++c) pos[c] = __ldg(tb.e_pos + 3 * e + c);
    for (int axis = 0; axis < 3; ++axis, ++f) {
      float p_ax = axis == 0 ? p[0] : (axis == 1 ? p[1] : p[2]);
      float pos_ax = axis == 0 ? pos[0] : (axis == 1 ? pos[1] : pos[2]);
      float hi = p_ax - (pos_ax + size * 0.5f) > 0.0f ? 1.0f : 0.0f;
      float q[3], ne[3];
      for (int c = 0; c < 3; ++c) {
        int rel = (c - axis + 3) % 3;
        float coord = rel == 0 ? hi * size : (rel == 1 ? u1 * size : u2 * size);
        q[c] = pos[c] + coord;
        ne[c] = rel == 0 ? 2.0f * hi - 1.0f : 0.0f;
      }
      emitter_face(tb, out, f * n + i, p, nrm, don, cm, q, ne, mat_e, u1, u2, inv_pdf);
    }
  }
}

// One face's attenuation (ops/nee.attenuation_reference): rgb and w, and
// the slots' texels (-1 where a slot did not attenuate) and strict zeros.
__device__ void attenuation(const NeeTables& tb, const Walk& wk, const NeeFlags& fl, long long r, long long fb,
                            int cur_mat, float max_t, float att[3], float* w_out, int texels[N_SLOTS],
                            int* zeros) {
  float w = 1.0f;
  for (int c = 0; c < 3; ++c) att[c] = 1.0f;
  for (int s = 0; s < N_SLOTS; ++s) texels[s] = -1;
  int zero_bits = 0;
  if (fl.binary) {  // the first hit: one surface, short of max_t
    if (wk.hit[r] && wk.t[r] < max_t) {
      int leaf = wk.leaf_value[r];
      int mat;
      if (tb.leaf_model == nullptr) {
        mat = __ldg(tb.leaf_material + min(max(leaf, 0), tb.n_leaf - 1));
      } else {
        int face = min(max(wk.face_id[r], 0), 5);
        int model = __ldg(tb.leaf_model + min(max(leaf, 0), tb.n_leaf_model - 1));
        mat = __ldg(tb.face_material + 6 * model + face);
      }
      int texel = texel_of(tb, mat, wk.uv[2 * r], wk.uv[2 * r + 1]);
      float4 a = texel_rgba(tb, texel);
      float mult = 1.0f - a.w;
      att[0] = a.x * a.w + mult;
      att[1] = a.y * a.w + mult;
      att[2] = a.z * a.w + mult;
      w = mult;
      if (fl.strict && __ldg(tb.ior + cur_mat) != __ldg(tb.ior + mat)) {
        w = 0.0f;
        zero_bits |= 1;
      }
      texels[0] = texel;
    }
  } else {  // the stateful walk's records, front to back
    int count = wk.count[r];
    int cm = cur_mat;
#pragma unroll
    for (int k = 0; k < K_SURF; ++k) {
      bool upd = k < count && w > 0.0f;
      if (wk.ts != nullptr) upd = upd && wk.ts[k * fb + r] < max_t;
      if (!upd) continue;
      int mat = wk.mats[k * fb + r];
      int texel = texel_of(tb, mat, wk.uu[k * fb + r], wk.vv[k * fb + r]);
      float4 a = texel_rgba(tb, texel);
      float mult = 1.0f - a.w;
      att[0] = att[0] * (a.x * a.w + mult);
      att[1] = att[1] * (a.y * a.w + mult);
      att[2] = att[2] * (a.z * a.w + mult);
      if (fl.strict && __ldg(tb.ior + cm) != __ldg(tb.ior + mat)) {
        w = 0.0f;
        zero_bits |= 1 << k;
      } else {
        w = w * mult;
      }
      cm = mat;
      texels[k] = texel;
    }
  }
  if (wk.p_hit != nullptr && wk.p_hit[r] && wk.p_t[r] < max_t) {  // the nearest primitive
    int p_mat = wk.p_mat[r];
    int texel = texel_of(tb, p_mat, wk.p_uv[2 * r], wk.p_uv[2 * r + 1]);
    float4 a = texel_rgba(tb, texel);
    float mult = 1.0f - a.w;
    att[0] = att[0] * (a.x * a.w + mult);
    att[1] = att[1] * (a.y * a.w + mult);
    att[2] = att[2] * (a.z * a.w + mult);
    if (fl.strict && __ldg(tb.ior + cur_mat) != __ldg(tb.ior + p_mat)) {
      w = 0.0f;
      zero_bits |= 1 << K_SURF;
    } else {
      w = w * mult;
    }
    texels[K_SURF] = texel;
  }
  *w_out = w;
  *zeros = zero_bits;
}

__global__ void __launch_bounds__(kThreads)
    nee_resolve_kernel(int n, NeeTables tb, ResolveIn in, Rays rays, Walk wk, NeeFlags fl, float* out_rad,
                       int* resid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 alb4 = reinterpret_cast<const float4*>(in.albedo)[i];
  float alb[3] = {alb4.x, alb4.y, alb4.z};
  float tp[3], rad[3], acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    tp[c] = in.throughput[i * in.throughput_stride + c];
    rad[c] = in.radiance[i * in.radiance_stride + c];
  }
  int cur_mat = in.cur_mat[i];
  long long fb = (long long)fl.faces * n;
  for (int f = 0; f < fl.faces; ++f) {
    long long r = (long long)f * n + i;
    bool on = rays.active[r] != 0;
    bool sun_face = fl.sun && f == 0;
    float att[3], w;
    int texels[N_SLOTS], zeros = 0;
    float term[3] = {0.0f, 0.0f, 0.0f};
    if (on) {
      attenuation(tb, wk, fl, r, fb, cur_mat, rays.max_t[r], att, &w, texels, &zeros);
      float scale = rays.scale[r];
      if (sun_face) {
        float mult = scale * w;
        for (int c = 0; c < 3; ++c) term[c] = tp[c] * ((alb[c] * (att[c] * mult)) * __ldg(tb.sun_emittance + c));
      } else {
        float4 ae = texel_rgba(tb, rays.e_texel[r]);
        float e = __ldg(tb.emittance + rays.e_mat[r]);
        float s = scale * w;
        float a_e[3] = {ae.x, ae.y, ae.z};
        for (int c = 0; c < 3; ++c) term[c] = ((alb[c] * ((a_e[c] * a_e[c]) * e)) * att[c]) * s;
      }
    } else {
      for (int s = 0; s < N_SLOTS; ++s) texels[s] = -1;
    }
    if (sun_face) {
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + term[c];
    } else if (fl.em_mode == EM_ONE) {
      for (int c = 0; c < 3; ++c) acc[c] = term[c];
    } else {
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + term[c];
    }
    if (resid != nullptr) {
      int* row = resid + ((long long)f * n + i) * RESID_INTS;
      row[0] = (on ? CODE_ON : 0) | (zeros << ZERO_SHIFT);
      for (int s = 0; s < N_SLOTS; ++s) row[1 + s] = texels[s];
      row[1 + N_SLOTS] = rays.e_texel[r];
      row[2 + N_SLOTS] = rays.e_mat[r];
    }
  }
  if (fl.em_mode != EM_NONE)
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + tp[c] * acc[c];
  for (int c = 0; c < 3; ++c) out_rad[3 * i + c] = rad[c];
}

// The backward of one bounce's next-event terms, per lane (ops/nee.py
// `nee_backward_reference` written out): a null gradient is not wanted.
__global__ void __launch_bounds__(kThreads)
    nee_backward_kernel(int n, NeeTables tb, NeeFlags fl, const float* __restrict__ g_rad,
                        const float* __restrict__ albedo, const float* __restrict__ throughput,
                        const int* __restrict__ resid, const float* __restrict__ scales, float* __restrict__ d_tp,
                        float* __restrict__ d_alb, double* __restrict__ d_atlas, double* __restrict__ d_emit) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 alb4 = reinterpret_cast<const float4*>(albedo)[i];
  float alb[3] = {alb4.x, alb4.y, alb4.z};
  float g[3], h[3], dt[3] = {0.0f, 0.0f, 0.0f}, da[3] = {0.0f, 0.0f, 0.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    g[c] = g_rad[3 * i + c];
    h[c] = g[c] * throughput[3 * i + c];
  }
  for (int f = 0; f < fl.faces; ++f) {
    const int* row = resid + ((long long)f * n + i) * RESID_INTS;
    int code = row[0];
    if (!(code & CODE_ON)) continue;
    float scale = scales[(long long)f * n + i];
    // the chain's values before each slot, from the texels it read
    float att_pre[N_SLOTS + 1][3], w_pre[N_SLOTS + 1];
    for (int c = 0; c < 3; ++c) att_pre[0][c] = 1.0f;
    w_pre[0] = 1.0f;
#pragma unroll
    for (int s = 0; s < N_SLOTS; ++s) {
      int texel = row[1 + s];
      for (int c = 0; c < 3; ++c) att_pre[s + 1][c] = att_pre[s][c];
      w_pre[s + 1] = w_pre[s];
      if (texel < 0) continue;
      float4 a = texel_rgba(tb, texel);
      float mult = 1.0f - a.w;
      att_pre[s + 1][0] = att_pre[s][0] * (a.x * a.w + mult);
      att_pre[s + 1][1] = att_pre[s][1] * (a.y * a.w + mult);
      att_pre[s + 1][2] = att_pre[s][2] * (a.z * a.w + mult);
      w_pre[s + 1] = (code >> (ZERO_SHIFT + s)) & 1 ? 0.0f : w_pre[s] * mult;
    }
    const float* att = att_pre[N_SLOTS];
    float w = w_pre[N_SLOTS];
    float d_att[3], d_w;
    if (fl.sun && f == 0) {
      float mult = scale * w;
      float y[3];
      for (int c = 0; c < 3; ++c) {
        float e_c = __ldg(tb.sun_emittance + c);
        y[c] = att[c] * mult;
        dt[c] = dt[c] + g[c] * ((alb[c] * y[c]) * e_c);
        float dx = h[c] * e_c;
        da[c] = da[c] + dx * y[c];
        float dy = dx * alb[c];
        d_att[c] = dy * mult;
        y[c] = dy * att[c];
      }
      d_w = sum3(y[0], y[1], y[2]) * scale;
    } else {
      int e_texel = row[1 + N_SLOTS], e_mat = row[2 + N_SLOTS];
      float4 ae4 = texel_rgba(tb, e_texel);
      float ae[3] = {ae4.x, ae4.y, ae4.z};
      float e = __ldg(tb.emittance + e_mat);
      float s_ = scale * w;
      float hx[3], dle_ae2[3];
      for (int c = 0; c < 3; ++c) {
        float le = (ae[c] * ae[c]) * e;
        float y = alb[c] * le;
        float x = y * att[c];
        float contrib = x * s_;
        acc[c] = fl.em_mode == EM_ONE ? contrib : acc[c] + contrib;
        float dx = h[c] * s_;
        float dy = dx * att[c];
        d_att[c] = dx * y;
        da[c] = da[c] + dy * le;
        float dle = dy * alb[c];
        hx[c] = h[c] * x;
        dle_ae2[c] = dle * (ae[c] * ae[c]);
        if (d_atlas != nullptr) atomicAdd(d_atlas + 4 * (long long)e_texel + c, (double)(2.0f * (dle * e) * ae[c]));
      }
      d_w = sum3(hx[0], hx[1], hx[2]) * scale;
      if (d_emit != nullptr) atomicAdd(d_emit + e_mat, (double)sum3(dle_ae2[0], dle_ae2[1], dle_ae2[2]));
    }
    // back through the slots, last to first
#pragma unroll
    for (int s = N_SLOTS - 1; s >= 0; --s) {
      int texel = row[1 + s];
      if (texel < 0) continue;
      bool zero = (code >> (ZERO_SHIFT + s)) & 1;
      float4 a4 = texel_rgba(tb, texel);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float mult = 1.0f - a[3];
      float d_f[3], fa[3];
      for (int c = 0; c < 3; ++c) {
        d_f[c] = d_att[c] * att_pre[s][c];
        d_att[c] = d_att[c] * (a[c] * a[3] + mult);
        fa[c] = d_f[c] * a[c];
      }
      float d_m = zero ? 0.0f : d_w * w_pre[s];
      d_w = zero ? 0.0f : d_w * mult;
      if (d_atlas != nullptr) {
        for (int c = 0; c < 3; ++c) atomicAdd(d_atlas + 4 * (long long)texel + c, (double)(d_f[c] * a[3]));
        atomicAdd(d_atlas + 4 * (long long)texel + 3,
                  (double)(sum3(fa[0], fa[1], fa[2]) - (sum3(d_f[0], d_f[1], d_f[2]) + d_m)));
      }
    }
  }
  if (fl.em_mode != EM_NONE)
    for (int c = 0; c < 3; ++c) dt[c] = dt[c] + g[c] * acc[c];
  if (d_tp != nullptr)
    for (int c = 0; c < 3; ++c) d_tp[3 * i + c] = dt[c];
  if (d_alb != nullptr) {
    for (int c = 0; c < 3; ++c) d_alb[4 * i + c] = da[c];
    d_alb[4 * i + 3] = 0.0f;
  }
}

extern "C" int nee_setup(int n, const NeeTables* tables, const SetupIn* in, const Rays* rays,
                         const NeeFlags* flags, void* stream) {
  if (n == 0) return 0;
  nee_setup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(n, *tables, *in, *rays,
                                                                                         *flags);
  return (int)cudaGetLastError();
}

extern "C" int nee_resolve(int n, const NeeTables* tables, const ResolveIn* in, const Rays* rays, const Walk* walk,
                           const NeeFlags* flags, void* out_radiance, void* resid, void* stream) {
  if (n == 0) return 0;
  nee_resolve_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, *tables, *in, *rays, *walk, *flags, (float*)out_radiance, (int*)resid);
  return (int)cudaGetLastError();
}

extern "C" int nee_backward(int n, const NeeTables* tables, const NeeFlags* flags, const void* g_rad,
                            const void* albedo, const void* throughput, const void* resid, const void* scales,
                            void* d_tp, void* d_alb, void* d_atlas, void* d_emit, void* stream) {
  if (n == 0) return 0;
  nee_backward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, *tables, *flags, (const float*)g_rad, (const float*)albedo, (const float*)throughput, (const int*)resid,
      (const float*)scales, (float*)d_tp, (float*)d_alb, (double*)d_atlas, (double*)d_emit);
  return (int)cudaGetLastError();
}

extern "C" const char* nee_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
