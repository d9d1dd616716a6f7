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
// K6 reads the lane's supercell row once: one left-to-right pass folds the
// CDF, finds the pick (the first entry the CDF reaches: the row's weights
// are >= 0, so the CDF never falls and that entry is the count of those it
// passed) and the uniform pick's weight, with 16-byte loads where the row
// allows (grid_vec: K a multiple of 4 and both tables 16-byte aligned, as
// the wrapper checks).  A row holds distinct emitters
// (models/emitters.build_spatial_grid), so the pick's own weight is its
// membership weight.  Measured and dropped (PERF.md): the row staged in
// shared memory once for the lanes of a warp that share a supercell
// (__match_any_sync; twice as slow at K = 8), and the rays' 12-byte rows
// staged through shared memory and written as the warp's consecutive
// words (no faster than each lane's own stores).
//
// On a scene with analytic primitives, nee_setup also scans each cast
// ray it writes against them (K7's scan, prims.cuh, folded in; the
// kScan variant) and writes the hit beside the ray: what a K7 launch over
// every ray wrote before, for the cast rays only, a miss beside a ray not
// cast (nee_resolve reads no primitive slot of one).  Built with
// -fmad=false as prims.cu is, the slots equal K7's bit for bit.
//
// The walks between the two are the existing kernels, one call each for
// all faces: K1 / K2 on shadow_binary scenes, K3s (mode 3 of traversal.cu,
// with K2q's model variant) otherwise.
//
// nee_resolve, per lane and face: the attenuation from the walk's records
// (up to K_SURFACES texels under the alpha budget w, the strict-IOR zero,
// the ts[k] < max_t cut; or the binary walk's one surface), the nearest
// primitive's factor, then the sun term or the emitter's area-form term;
// it adds throughput * (sun + emitters) to the radiance K4 wrote.  With a
// gradient it writes 36 bytes per face and lane: a code (cast; the slots'
// strict zeros), the texel each attenuating slot read, the emitter's texel
// and material, and the geometry scale (written by nee_setup).  A cast
// face's texels are a chain of dependent reads (the record, the material's
// layer, the layer's size, the texel) for each of up to five slots, and
// the plain version's fold gates each slot on the budget the slot before
// left; so every slot that can attenuate is read first, each round of the
// chain for all slots at once, and the fold runs in registers after them.
// A face that no lane of a warp casts is skipped by the whole warp, and a
// residual row is written as two 16-byte stores.  On a frame's last bounce
// it writes the frame's final radiance, and stores row i's at row idx[i]
// (the lane's own index, which K5 carries): the unpermute after the bounce
// loop, folded into the store.  Every lane of the batch stores its row,
// whatever its faces, so every output row is written once.
//
// nee_backward, per lane: from the radiance cotangent, the throughput's
// and the shading point's albedo's gradients (the albedo's reach the atlas
// through K4's backward; after a compaction the throughput's is stored at
// row src[i], compact_backward's gather folded into the store; on a frame's
// last bounce the cotangent is read at row idx[i], the unpermute's gather
// folded into the load, and handed on to K4's radiance at row i); the
// blockers' rgba and the emitter's rgb are summed into the atlas gradient,
// the emitter's emission into the emittance's.  It re-reads the texels the residual names and walks
// nothing again.  The two sums are float64: under ALL a bounce adds 3 E
// terms per lane, ~10^7 onto one material, and a float32 sum in the
// schedule's order drifts from any other order by ~1e-4 relative; in
// float64 every order agrees to the float32 result.  One launch per
// bounce: a cooperative grid of at most the card's resident blocks walks
// the lanes; each warp combines its lanes that name the same texel (or
// material) before one float64 atomicAdd per channel into a per-card
// scratch that is zero between calls; after a grid-wide barrier the same
// grid writes the dense float32 gradients from the scratch and zeroes it
// again.  So no fill and no conversion kernel runs around it, and it
// captures in a CUDA graph.  Measured (PERF.md): a grid of one block per SM
// lost to one block per 128 lanes; two plain launches (the sums, then the
// sweep) took 0.0006-0.0013 ms less on the device than the barrier, for a
// second device activity a bounce.
//
// What bounds them: bytes.  Per lane and face nee_setup writes 41 bytes of
// rays and reads a few words of the hand-off, the uniforms and tables that
// stay in L2 (the supercell row, 8 bytes an entry); nee_resolve reads the
// walk's record (up to 65 bytes) and 1-6 texels; nee_backward the residual
// (36 bytes a cast face), the texels and the dense gradients once; the
// arithmetic is a few dozen operations per face (sinf / cosf and two sqrtf
// on the sun face), far below the card's float32 rate.  At 65,536 lanes
// each is a few microseconds, near a launch's floor.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "prims.cuh"
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

#define MAX_GRID_K 64  // the widest supercell row (ops/nee.MAX_GRID_K)

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kBwdThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

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
  int grid_vec;  // the rows read as 16-byte vectors (K % 4 == 0, both tables 16-byte aligned)
  // the pick's Python scalars, rounded as the card's torch rounds them
  float cell_offset;    // 0.01 * cell_size
  float inv_cell;       // 1 / cell_size
  float lam;            // the uniform floor
  float inv_lam;        // 1 / lam
  float inv_one_m_lam;  // 1 / (1 - lam)
  float one_m_lam;      // 1 - lam
  float lam_over_e;     // lam / E
  PrimTables prims;     // the scene's analytic primitives (counts 0 without them)
  float prim_t_max;     // the scan's t_max (models/scene.MAX_DIST)
};

struct NeeFlags {
  int sun, em_mode, faces, strict, sun_luminosity, binary;
  float f_sub;  // the subsurface chance
};

// nee_setup's slot array (ops/nee.SETUP_SLOTS): the hand-off and the lane's
// state, the uniforms' row stride, then the outputs (ops/nee.NeeRays)
enum SetupSlot {
  S_HITPOINT, S_NORMAL, S_MAT, S_DIFFUSE_ON, S_CUR_MAT, S_U, S_U_STRIDE,
  S_ORIGIN, S_DIR, S_MAX_T, S_SCALE, S_ACTIVE, S_OUT_CUR_MAT, S_E_TEXEL, S_E_MAT,
  S_P_HIT, S_P_T, S_P_MAT, S_P_UV,  // K7's hit of each ray: null without primitives
  N_SETUP_SLOTS
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
  uint8_t* p_hit;  // the nearest primitive of a cast ray (a miss on a ray not cast)
  float* p_t;
  int* p_mat;
  float* p_uv;
};

struct SetupParams {
  NeeTables tb;
  NeeFlags fl;
  const float* hitpoint;
  const float* normal;
  const int* mat;
  const uint8_t* diffuse_on;
  const int* cur_mat;
  const float* u;
  long long u_stride;
  Rays out;
  int n;
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

// nee_resolve's slot array (ops/nee.RESOLVE_SLOTS): the lane's inputs,
// the rays' fields it reads, the walks' records, the outputs, then the two
// row strides as integers; a null pointer is a record the walk did not
// make, and a null residual is not wanted
enum ResolveSlot {
  R_ALBEDO, R_THROUGHPUT, R_RADIANCE, R_CUR_MAT, R_ON, R_MAX_T, R_SCALE, R_E_TEXEL, R_E_MAT,
  R_HIT, R_T, R_FACE_ID, R_UV, R_LEAF_VALUE, R_COUNT, R_MATS, R_UU, R_VV, R_TS, R_P_HIT, R_P_T, R_P_MAT, R_P_UV,
  R_IDX,  // the final bounce's lane order: row i's radiance is stored at row idx[i]; null: at row i
  R_OUT_RADIANCE, R_RESID, R_THROUGHPUT_STRIDE, R_RADIANCE_STRIDE, N_RESOLVE_SLOTS
};

struct ResolveParams {
  NeeTables tb;
  NeeFlags fl;
  const float* albedo;  // (B, 4) the shading point's texel, 16-byte rows
  const float* throughput;
  const float* radiance;  // what K4 wrote
  const int* cur_mat;
  const uint8_t* on;  // the rays' fields (F * B rows)
  const float* max_t;
  const float* scale;
  const int* e_texel;
  const int* e_mat;
  Walk wk;
  const int* idx;  // null: row i's radiance goes to row i
  float* out_rad;
  int* resid;  // (F * B, RESID_INTS), 16-byte aligned; null: not wanted
  long long throughput_stride, radiance_stride;
  int n;
};

// nee_backward's slot array (ops/nee.BACKWARD_SLOTS): a null gradient is
// not wanted, and neither is its scratch
enum BackwardSlot {
  B_ATLAS, B_EMITTANCE, B_SUN_EMITTANCE, B_G_RADIANCE, B_ALBEDO, B_THROUGHPUT, B_RESID, B_SCALE,
  B_D_THROUGHPUT, B_D_ALBEDO, B_D_ATLAS, B_D_EMITTANCE, B_SUM_ATLAS, B_SUM_EMITTANCE,
  B_SRC,  // after a compaction: lane i's throughput gradient goes to row src[i]; null: to row i
  // a frame's last bounce: row i's radiance cotangent is read at row
  // idx[i] (null: at row i) and, where wanted, written to row i of d_rad
  B_IDX, B_D_RADIANCE,
  N_BACKWARD_SLOTS
};

struct BackwardParams {
  const float* atlas;
  const float* emittance;
  const float* sun_emittance;
  const float* g_rad;
  const float* albedo;
  const float* throughput;
  const int* resid;
  const float* scales;
  float* d_tp;
  float* d_alb;
  float* d_atlas;  // (T * H * W * 4) float32, written whole
  float* d_emit;   // (M,)
  double* sum_atlas;  // the per-card scratch: zero on entry, zero again on exit
  double* sum_emit;
  const int* src;     // null: the throughput gradient of lane i goes to row i
  const int* idx;     // null: the radiance cotangent of lane i is read at row i
  float* d_rad;       // the cotangent read through idx, in row order (null: not wanted, or no idx)
  long long n_texels;
  int n_emit, n, sun, em_mode, faces;
};

// ops/texture.texel_index: nearest texel with the clamp and the v-flip, in
// a layer of t_h x t_w texels
__device__ __forceinline__ int texel_at(const NeeTables& tb, int layer, int t_h, int t_w, float u, float v) {
  float uu = clampf(u, 0.0f, 1.0f);
  float vv = 1.0f - clampf(v, 0.0f, 1.0f);
  int ti = max((int)(uu * (float)t_w), 0);
  int tj = max((int)(vv * (float)t_h), 0);
  ti = ti > t_w - 1 ? t_w - 1 : ti;
  tj = tj > t_h - 1 ? t_h - 1 : tj;
  return (layer * tb.atlas_h + tj) * tb.atlas_w + ti;
}

__device__ __forceinline__ int texel_of(const NeeTables& tb, int mat, float u, float v) {
  int layer = __ldg(tb.texture_index + mat);
  int t_h = tb.atlas_h, t_w = tb.atlas_w;
  if (tb.sizes != nullptr) {
    t_h = __ldg(tb.sizes + 2 * layer);
    t_w = __ldg(tb.sizes + 2 * layer + 1);
  }
  return texel_at(tb, layer, t_h, t_w, u, v);
}

__device__ __forceinline__ float4 texel4(const float* atlas, int texel) {
  return __ldg(reinterpret_cast<const float4*>(atlas) + texel);
}

__device__ __forceinline__ float4 texel_rgba(const NeeTables& tb, int texel) { return texel4(tb.atlas, texel); }

// ---- nee_setup

// Where a lane stands: its index, and whether it is in the batch.  Every
// lane of a warp runs the whole kernel; one past the batch reads lane 0's
// inputs and stores nothing (measured faster than returning early: PERF.md).
struct Lane {
  long long i;
  bool valid;
};

// Writes row f * B + i; kScan: with K7's scan of the ray where it is cast
// (what the walks' K7 launch wrote before it was folded in here), a miss
// where it is not (nee_resolve reads no primitive slot of a ray not cast).
template <bool kScan>
__device__ __forceinline__ void put_ray(const SetupParams& p, const Lane& ln, long long f, const float o[3],
                                        const float d[3], float max_t, float scale, bool on, int cm, int e_texel,
                                        int e_mat) {
  if (!ln.valid) return;
  const long long r = f * p.n + ln.i;
  if (kScan) {
    PrimHit h;
    if (on) prim_scan(p.tb.prims, o, d, p.tb.prim_t_max, h);
    else prim_miss(h);
    p.out.p_hit[r] = h.t != __int_as_float(0x7f800000);
    p.out.p_t[r] = h.t;
    p.out.p_mat[r] = h.mat;
    p.out.p_uv[2 * r] = h.u;
    p.out.p_uv[2 * r + 1] = h.v;
  }
  for (int c = 0; c < 3; ++c) p.out.origin[3 * r + c] = o[c];
  for (int c = 0; c < 3; ++c) p.out.dir[3 * r + c] = d[c];
  p.out.max_t[r] = max_t;
  p.out.scale[r] = scale;
  p.out.active[r] = on;
  p.out.cur_mat[r] = cm;
  p.out.e_texel[r] = e_texel;
  p.out.e_mat[r] = e_mat;
}

// ops/nee.nee_setup_reference's emitter face: the shadow ray from the
// (masked) shading point p toward the point q of outward normal ne
template <bool kScan>
__device__ void emitter_face(const SetupParams& p, const Lane& ln, long long f, const float pt[3], const float n[3],
                             bool don, int cm, const float q[3], const float ne[3], int mat_e, float eu, float ev,
                             float inv_pdf) {
  float to_q[3], wi[3], o[3];
  for (int c = 0; c < 3; ++c) to_q[c] = q[c] - pt[c];
  float dist = sqrtf(clamp_min(sum3(to_q[0] * to_q[0], to_q[1] * to_q[1], to_q[2] * to_q[2]), EPS2_F));
  for (int c = 0; c < 3; ++c) wi[c] = to_q[c] / dist;
  float cos_s = sum3(wi[0] * n[0], wi[1] * n[1], wi[2] * n[2]);
  float cos_e = sum3(-wi[0] * ne[0], -wi[1] * ne[1], -wi[2] * ne[2]);
  bool on = don && cos_s > 0.0f && cos_e > 0.0f;
  float geom = ((cos_s * cos_e) / clamp_min(dist * dist, EPS_F)) * INV_PI_F;
  for (int c = 0; c < 3; ++c) o[c] = pt[c] + wi[c] * OFFSET_F;
  put_ray<kScan>(p, ln, f, o, wi, dist * MAX_T_FRAC, geom * inv_pdf, on, cm, texel_of(p.tb, mat_e, eu, ev), mat_e);
}

// One row's pass, left to right: the CDF fold, the first entry it reaches
// (the pick), and the weight of the uniform pick idx_u.
struct RowFold {
  float cdf, w_u, w_s, last_w;
  int idx_s, last_id;
  bool found;
};

__device__ __forceinline__ void fold_entry(RowFold& r, int m, int id, float w, float u_s, int idx_u) {
  r.cdf = m == 0 ? w : r.cdf + w;
  if (!(u_s > r.cdf) && !r.found) {
    r.found = true;
    r.idx_s = id;
    r.w_s = 0.0f + w;
  }
  if (id == idx_u) r.w_u = r.w_u + w;
  r.last_id = id;
  r.last_w = w;
}

__device__ __forceinline__ void fold_row(RowFold& r, const int* gi, const float* gw, int k, bool vec, float u_s,
                                         int idx_u) {
  if (vec) {
    for (int m = 0; m < k; m += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(gi + m));
      const float4 w = __ldg(reinterpret_cast<const float4*>(gw + m));
      fold_entry(r, m, a.x, w.x, u_s, idx_u);
      fold_entry(r, m + 1, a.y, w.y, u_s, idx_u);
      fold_entry(r, m + 2, a.z, w.z, u_s, idx_u);
      fold_entry(r, m + 3, a.w, w.w, u_s, idx_u);
    }
  } else {
    for (int m = 0; m < k; ++m) fold_entry(r, m, __ldg(gi + m), __ldg(gw + m), u_s, idx_u);
  }
}

// models/emitters._spatial_pick: (idx, 1 / p_pick) for the point pc
__device__ int spatial_pick(const NeeTables& tb, bool valid, const float pc[3], float u_pick, float* pick_inv) {
  const int e = tb.n_emit;
  if (tb.grid_idx == nullptr) {
    *pick_inv = (float)e;
    return min((int)(u_pick * (float)e), e - 1);
  }
  const int g = tb.grid_side, k = tb.grid_k;
  int cell[3];
  for (int c = 0; c < 3; ++c) cell[c] = min(max((int)(pc[c] * tb.inv_cell), 0), g - 1);
  const long long base = (long long)((cell[0] * g + cell[1]) * g + cell[2]) * k;
  const bool uni = u_pick < tb.lam;
  const float u_u = clampf(u_pick * tb.inv_lam, 0.0f, PICK_MAX);
  const int idx_u = min((int)(u_u * (float)e), e - 1);
  const float u_s = clampf((u_pick - tb.lam) * tb.inv_one_m_lam, 0.0f, PICK_MAX);
  RowFold r{0.0f, 0.0f, 0.0f, 0.0f, 0, 0, false};
  if (valid) fold_row(r, tb.grid_idx + base, tb.grid_w + base, k, tb.grid_vec != 0, u_s, idx_u);
  if (!r.found) {  // the CDF never reached u_s: the row's last entry
    r.idx_s = r.last_id;
    r.w_s = 0.0f + r.last_w;
  }
  const int idx = uni ? idx_u : r.idx_s;
  const float w_match = uni ? r.w_u : r.w_s;  // the row's weight of idx: at most one entry matches
  const float p_pick = w_match * tb.one_m_lam + tb.lam_over_e;
  *pick_inv = 1.0f / p_pick;
  return idx;
}

// kScan: the variant with K7's scan of each cast ray folded in (a scene
// with primitives).
template <bool kScan>
__global__ void __launch_bounds__(kThreads) nee_setup_kernel(const __grid_constant__ SetupParams p) {
  const NeeTables& tb = p.tb;
  const NeeFlags& fl = p.fl;
  Lane ln;
  ln.i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  ln.valid = ln.i < p.n;
  if (ln.i - (threadIdx.x & 31) >= p.n) return;  // the whole warp lies past the batch
  const long long li = ln.valid ? ln.i : 0;
  float hp[3], nrm[3];
  for (int c = 0; c < 3; ++c) {
    hp[c] = p.hitpoint[3 * li + c];
    nrm[c] = p.normal[3 * li + c];
  }
  const bool don = p.diffuse_on[li] != 0;
  const int cm = p.cur_mat[li];
  const float* u = p.u + li * p.u_stride;
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
    bool sss = (__ldg(tb.flags + p.mat[li]) & FLAG_SUBSURFACE) != 0 && u[U_SUBSURFACE] < fl.f_sub;
    bool on = don && (front || sss);
    for (int c = 0; c < 3; ++c) {
      float so = front ? hp[c] : hp[c] - nrm[c] * OFFSET_F;
      o[c] = so + sd[c] * OFFSET_F;
    }
    float lum = fl.sun_luminosity ? 1.0f / __ldg(tb.luminosity) : 1.0f;
    put_ray<kScan>(p, ln, 0, o, sd, __int_as_float(0x7f800000), fabsf(cos_sun) * lum, on, cm, -1, -1);
    f = 1;
  }
  if (fl.em_mode == EM_NONE) return;

  // a lane off the diffuse lobe samples from a finite stand-in point
  float pt[3];
  for (int c = 0; c < 3; ++c) pt[c] = don ? hp[c] : 0.0f;
  float u_pick = u[U_EM_PICK], u1 = u[U_EM1], u2 = u[U_EM2];
  if (fl.em_mode == EM_ONE) {  // models/emitters.sample_emitter_point
    float pc[3], pick_inv;
    for (int c = 0; c < 3; ++c) pc[c] = pt[c] + nrm[c] * tb.cell_offset;
    int idx = spatial_pick(tb, ln.valid, pc, u_pick, &pick_inv);
    float size = __ldg(tb.e_size + idx);
    int mat_e = __ldg(tb.e_mat + idx);
    float pos[3], dpc[3], w[3];
    for (int c = 0; c < 3; ++c) {
      pos[c] = __ldg(tb.e_pos + 3 * idx + c);
      dpc[c] = pt[c] - (pos[c] + size * 0.5f);
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
    emitter_face<kScan>(p, ln, f, pt, nrm, don, cm, q, ne, mat_e, a, u2, inv_pdf);
    return;
  }
  // ONE_BLOCK: one uniformly picked emitter; ALL: every emitter.  Each sums
  // its 3 toward faces (models/emitters.toward_face_sample); every lane of
  // a warp runs the same number of faces
  const int picks = fl.em_mode == EM_ONE_BLOCK ? 1 : tb.n_emit;
  const int chosen = min((int)(u_pick * (float)tb.n_emit), tb.n_emit - 1);
  for (int k = 0; k < picks; ++k) {
    const int e = fl.em_mode == EM_ONE_BLOCK ? chosen : k;
    float size = __ldg(tb.e_size + e);
    int mat_e = __ldg(tb.e_mat + e);
    float inv_pdf = fl.em_mode == EM_ONE_BLOCK ? ((float)tb.n_emit * size) * size : size * size;
    float pos[3];
    for (int c = 0; c < 3; ++c) pos[c] = __ldg(tb.e_pos + 3 * e + c);
    for (int axis = 0; axis < 3; ++axis, ++f) {
      float p_ax = axis == 0 ? pt[0] : (axis == 1 ? pt[1] : pt[2]);
      float pos_ax = axis == 0 ? pos[0] : (axis == 1 ? pos[1] : pos[2]);
      float hi = p_ax - (pos_ax + size * 0.5f) > 0.0f ? 1.0f : 0.0f;
      float q[3], ne[3];
      for (int c = 0; c < 3; ++c) {
        int rel = (c - axis + 3) % 3;
        float coord = rel == 0 ? hi * size : (rel == 1 ? u1 * size : u2 * size);
        q[c] = pos[c] + coord;
        ne[c] = rel == 0 ? 2.0f * hi - 1.0f : 0.0f;
      }
      emitter_face<kScan>(p, ln, f, pt, nrm, don, cm, q, ne, mat_e, u1, u2, inv_pdf);
    }
  }
}

// ---- nee_resolve

// One texel read in rounds, so that a lane's independent reads go out
// together: the material's layer (and, under strict IOR, its ior), the
// layer's size, then the texel.  Nothing is read where `on` is false.
struct TexelRead {
  bool on;
  int mat, layer, t_h, t_w, texel;
  float u, v, ior;
  float4 rgba;
};

__device__ __forceinline__ void read_layer(const NeeTables& tb, bool strict, TexelRead& x) {
  if (!x.on) return;
  x.layer = __ldg(tb.texture_index + x.mat);
  if (strict) x.ior = __ldg(tb.ior + x.mat);
}

__device__ __forceinline__ void read_size(const NeeTables& tb, TexelRead& x) {
  x.t_h = tb.atlas_h;
  x.t_w = tb.atlas_w;
  if (x.on && tb.sizes != nullptr) {
    x.t_h = __ldg(tb.sizes + 2 * x.layer);
    x.t_w = __ldg(tb.sizes + 2 * x.layer + 1);
  }
}

__device__ __forceinline__ void read_texel(const NeeTables& tb, TexelRead& x) {
  if (!x.on) return;
  x.texel = texel_at(tb, x.layer, x.t_h, x.t_w, x.u, x.v);
  x.rgba = texel_rgba(tb, x.texel);
}

// What one face of a lane reads: its ray's fields, the walk's record, and
// the texels and table entries they name.  Slot k < K_SURF is the walk's
// k-th surface (the binary walk's one hit in slot 0), slot K_SURF the
// nearest primitive.
struct FaceRead {
  bool on;
  float max_t, scale;
  int e_texel, e_mat;
  int count;  // the stateful walk's surfaces
  float ts[K_SURF];
  bool hit;   // the binary walk's hit and what names its material
  float t;
  int leaf, face;
  float ior_cur;  // the lane's medium's ior (strict IOR only)
  bool p_hit;
  float p_t;
  TexelRead s[N_SLOTS];
  float4 e_rgba;
  float e_emit;
};

// Every read of face f of lane i, round by round: a round's reads are
// independent of each other, so they are in flight together (the texels
// of every slot at once, in place of one slot's chain after another), and
// the attenuation is then folded in registers.  A slot is read where the
// plain version can attenuate with it, whatever the budget w: a surface
// within the walk's count and short of max_t, the primitive's hit short of
// max_t.  A face that no lane of the warp casts skips its reads as a
// whole.  (Two faces' reads at once took 216 registers a thread and lost:
// PERF.md.)
__device__ __forceinline__ void read_face(const ResolveParams& p, bool valid, long long i, int f, int cur_mat,
                                          FaceRead& x) {
  const NeeTables& tb = p.tb;
  const NeeFlags& fl = p.fl;
  const Walk& wk = p.wk;
  const long long n = p.n, fb = (long long)fl.faces * n, r = (long long)f * n + i;
  const bool strict = fl.strict != 0, prim = wk.p_hit != nullptr, sun_face = fl.sun && f == 0;
  x.on = valid && p.on[r] != 0;
  const bool any = __any_sync(kFullMask, x.on);
  for (int s = 0; s < N_SLOTS; ++s) {
    x.s[s].on = false;
    x.s[s].texel = -1;
  }
  x.e_texel = x.e_mat = -1;
  if (valid && (p.resid != nullptr || (x.on && !sun_face))) {
    x.e_texel = p.e_texel[r];  // the residual keeps them on every row
    x.e_mat = p.e_mat[r];
  }
  if (!any || !x.on) return;
  // the ray's fields, the records, the medium's ior
  x.max_t = p.max_t[r];
  x.scale = p.scale[r];
  if (strict) x.ior_cur = __ldg(tb.ior + cur_mat);
  if (fl.binary) {
    x.hit = wk.hit[r] != 0;
    x.t = wk.t[r];
    x.leaf = wk.leaf_value[r];
    if (tb.leaf_model != nullptr) x.face = wk.face_id[r];
    x.s[0].u = wk.uv[2 * r];
    x.s[0].v = wk.uv[2 * r + 1];
  } else {
    x.count = wk.count[r];
#pragma unroll
    for (int k = 0; k < K_SURF; ++k) {
      x.s[k].mat = wk.mats[k * fb + r];
      x.s[k].u = wk.uu[k * fb + r];
      x.s[k].v = wk.vv[k * fb + r];
      x.ts[k] = wk.ts != nullptr ? wk.ts[k * fb + r] : 0.0f;
    }
  }
  if (prim) {
    x.p_hit = wk.p_hit[r] != 0;
    x.p_t = wk.p_t[r];
    x.s[K_SURF].mat = wk.p_mat[r];
    x.s[K_SURF].u = wk.p_uv[2 * r];
    x.s[K_SURF].v = wk.p_uv[2 * r + 1];
  }
  // which slots attenuate (but for the budget); the binary hit's material
  if (fl.binary) {
    x.s[0].on = x.hit && x.t < x.max_t;
    if (x.s[0].on) {
      if (tb.leaf_model == nullptr) {
        x.s[0].mat = __ldg(tb.leaf_material + min(max(x.leaf, 0), tb.n_leaf - 1));
      } else {
        const int model = __ldg(tb.leaf_model + min(max(x.leaf, 0), tb.n_leaf_model - 1));
        x.s[0].mat = __ldg(tb.face_material + 6 * model + min(max(x.face, 0), 5));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K_SURF; ++k) x.s[k].on = k < x.count && (wk.ts == nullptr || x.ts[k] < x.max_t);
  }
  if (prim) x.s[K_SURF].on = x.p_hit && x.p_t < x.max_t;
#pragma unroll
  for (int s = 0; s < N_SLOTS; ++s) read_layer(tb, strict, x.s[s]);
#pragma unroll
  for (int s = 0; s < N_SLOTS; ++s) read_size(tb, x.s[s]);
  // the texels, and the emitter's texel and emission
#pragma unroll
  for (int s = 0; s < N_SLOTS; ++s) read_texel(tb, x.s[s]);
  if (!sun_face) {
    x.e_rgba = texel_rgba(tb, x.e_texel);
    x.e_emit = __ldg(tb.emittance + x.e_mat);
  }
}

// One face's attenuation (ops/nee.attenuation_reference) from its reads,
// folded front to back: rgb and w, and the slots' texels (-1 where a slot
// did not attenuate) and strict zeros.
__device__ __forceinline__ void attenuation(const NeeFlags& fl, const FaceRead& x, float att[3], float* w_out,
                                            int texels[N_SLOTS], int* zeros) {
  const bool strict = fl.strict != 0;
  float w = 1.0f;
  for (int c = 0; c < 3; ++c) att[c] = 1.0f;
  for (int s = 0; s < N_SLOTS; ++s) texels[s] = -1;
  int zero_bits = 0;
  float ior_cm = x.ior_cur;  // the medium's ior: the lane's, then each attenuating surface's
#pragma unroll
  for (int k = 0; k < K_SURF; ++k) {
    const TexelRead& sl = x.s[k];
    // the binary walk's one surface takes no budget test; the records' each
    // surface only while w > 0
    if (!sl.on || (!fl.binary && !(w > 0.0f))) continue;
    const float4 a = sl.rgba;
    const float mult = 1.0f - a.w;
    if (fl.binary) {
      att[0] = a.x * a.w + mult;
      att[1] = a.y * a.w + mult;
      att[2] = a.z * a.w + mult;
    } else {
      att[0] = att[0] * (a.x * a.w + mult);
      att[1] = att[1] * (a.y * a.w + mult);
      att[2] = att[2] * (a.z * a.w + mult);
    }
    if (strict && ior_cm != sl.ior) {
      w = 0.0f;
      zero_bits |= 1 << k;
    } else {
      w = fl.binary ? mult : w * mult;
    }
    ior_cm = sl.ior;
    texels[k] = sl.texel;
  }
  const TexelRead& pr = x.s[K_SURF];
  if (pr.on) {  // the nearest primitive
    const float4 a = pr.rgba;
    const float mult = 1.0f - a.w;
    att[0] = att[0] * (a.x * a.w + mult);
    att[1] = att[1] * (a.y * a.w + mult);
    att[2] = att[2] * (a.z * a.w + mult);
    if (strict && x.ior_cur != pr.ior) {
      w = 0.0f;
      zero_bits |= 1 << K_SURF;
    } else {
      w = w * mult;
    }
    texels[K_SURF] = pr.texel;
  }
  *w_out = w;
  *zeros = zero_bits;
}

__global__ void __launch_bounds__(kThreads) nee_resolve_kernel(const __grid_constant__ ResolveParams p) {
  const NeeTables& tb = p.tb;
  const NeeFlags& fl = p.fl;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 - (threadIdx.x & 31) >= p.n) return;  // the whole warp lies past the batch
  const bool valid = i0 < p.n;
  const long long i = valid ? i0 : 0, n = p.n;
  const long long out_row = p.idx != nullptr ? (long long)__ldg(p.idx + i) : i;
  const float4 alb4 = reinterpret_cast<const float4*>(p.albedo)[i];
  const float alb[3] = {alb4.x, alb4.y, alb4.z};
  float tp[3], rad[3], acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    tp[c] = p.throughput[i * p.throughput_stride + c];
    rad[c] = p.radiance[i * p.radiance_stride + c];
  }
  const int cur_mat = p.cur_mat[i];
  for (int f = 0; f < fl.faces; ++f) {
    FaceRead x;
    read_face(p, valid, i, f, cur_mat, x);
    const bool sun_face = fl.sun && f == 0;
    float att[3], w;
    int texels[N_SLOTS], zeros = 0;
    float term[3] = {0.0f, 0.0f, 0.0f};
    if (x.on) {
      attenuation(fl, x, att, &w, texels, &zeros);
      if (sun_face) {
        float mult = x.scale * w;
        for (int c = 0; c < 3; ++c) term[c] = tp[c] * ((alb[c] * (att[c] * mult)) * __ldg(tb.sun_emittance + c));
      } else {
        float s = x.scale * w;
        float a_e[3] = {x.e_rgba.x, x.e_rgba.y, x.e_rgba.z};
        for (int c = 0; c < 3; ++c) term[c] = ((alb[c] * ((a_e[c] * a_e[c]) * x.e_emit)) * att[c]) * s;
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
    if (p.resid != nullptr && valid) {  // the row's 32 bytes as two 16-byte stores
      int4* row = reinterpret_cast<int4*>(p.resid + ((long long)f * n + i) * RESID_INTS);
      static_assert(RESID_INTS == 8, "a residual row is two 16-byte stores");
      row[0] = make_int4((x.on ? CODE_ON : 0) | (zeros << ZERO_SHIFT), texels[0], texels[1], texels[2]);
      row[1] = make_int4(texels[3], texels[4], x.e_texel, x.e_mat);
    }
  }
  if (!valid) return;
  if (fl.em_mode != EM_NONE)
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + tp[c] * acc[c];
  for (int c = 0; c < 3; ++c) p.out_rad[3 * out_row + c] = rad[c];
}

// ---- nee_backward

// The warp's lanes that hold one key (>= 0), summed by the first of them
// in lane order, in float64, and added once per nonzero channel to
// dst[STRIDE * key + c].  Every lane of the warp calls it; `vals` is the
// warp's 128 words of shared memory.  A warp with no key skips it whole.
template <int W, int STRIDE>
__device__ __forceinline__ void warp_combined_add(int key, const float (&v)[W], double* dst, float* vals, int lane) {
  if (__ballot_sync(kFullMask, key >= 0) == 0) return;
  const unsigned peers = __match_any_sync(kFullMask, key);
  for (int c = 0; c < W; ++c) vals[W * lane + c] = v[c];
  __syncwarp();
  if (key >= 0 && lane == __ffs(peers) - 1) {
    double acc[W];
    for (int c = 0; c < W; ++c) acc[c] = 0.0;
    for (unsigned m = peers; m != 0; m &= m - 1) {
      const int k = __ffs(m) - 1;
      for (int c = 0; c < W; ++c) acc[c] += (double)vals[W * k + c];
    }
    for (int c = 0; c < W; ++c)
      if (acc[c] != 0.0) atomicAdd(dst + (long long)STRIDE * key + c, acc[c]);
  }
  __syncwarp();
}

// One lane's gradients (ops/nee.py `nee_backward_reference` written out),
// with the atlas's and the emittance's sums combined across the warp.
// Every lane of the warp calls it; `valid` says whether lane i is in the batch.
__device__ void backward_lane(const BackwardParams& p, long long i, bool valid, float* vals, int lane) {
  float alb[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f}, h[3] = {0.0f, 0.0f, 0.0f};
  float dt[3] = {0.0f, 0.0f, 0.0f}, da[3] = {0.0f, 0.0f, 0.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const float4 alb4 = reinterpret_cast<const float4*>(p.albedo)[i];
    alb[0] = alb4.x;
    alb[1] = alb4.y;
    alb[2] = alb4.z;
    const long long gi = p.idx != nullptr ? (long long)__ldg(p.idx + i) : i;
    for (int c = 0; c < 3; ++c) {
      g[c] = p.g_rad[3 * gi + c];
      h[c] = g[c] * p.throughput[3 * i + c];
    }
  }
  for (int f = 0; f < p.faces; ++f) {
    const int* row = p.resid + ((long long)f * p.n + i) * RESID_INTS;
    const int code = valid ? row[0] : 0;
    const bool on = (code & CODE_ON) != 0;
    if (__ballot_sync(kFullMask, on) == 0) continue;  // no lane of the warp casts this face
    int texels[N_SLOTS];
    for (int s = 0; s < N_SLOTS; ++s) texels[s] = on ? row[1 + s] : -1;
    const float scale = on ? p.scales[(long long)f * p.n + i] : 0.0f;
    // the chain's values before each slot, from the texels it read
    float att_pre[N_SLOTS + 1][3], w_pre[N_SLOTS + 1];
    for (int c = 0; c < 3; ++c) att_pre[0][c] = 1.0f;
    w_pre[0] = 1.0f;
#pragma unroll
    for (int s = 0; s < N_SLOTS; ++s) {
      for (int c = 0; c < 3; ++c) att_pre[s + 1][c] = att_pre[s][c];
      w_pre[s + 1] = w_pre[s];
      if (texels[s] < 0) continue;
      const float4 a = texel4(p.atlas, texels[s]);
      const float mult = 1.0f - a.w;
      att_pre[s + 1][0] = att_pre[s][0] * (a.x * a.w + mult);
      att_pre[s + 1][1] = att_pre[s][1] * (a.y * a.w + mult);
      att_pre[s + 1][2] = att_pre[s][2] * (a.z * a.w + mult);
      w_pre[s + 1] = (code >> (ZERO_SHIFT + s)) & 1 ? 0.0f : w_pre[s] * mult;
    }
    const float* att = att_pre[N_SLOTS];
    const float w = w_pre[N_SLOTS];
    float d_att[3] = {0.0f, 0.0f, 0.0f}, d_w = 0.0f;
    if (p.sun && f == 0) {
      if (on) {
        const float mult = scale * w;
        float y[3];
        for (int c = 0; c < 3; ++c) {
          const float e_c = __ldg(p.sun_emittance + c);
          y[c] = att[c] * mult;
          dt[c] = dt[c] + g[c] * ((alb[c] * y[c]) * e_c);
          const float dx = h[c] * e_c;
          da[c] = da[c] + dx * y[c];
          const float dy = dx * alb[c];
          d_att[c] = dy * mult;
          y[c] = dy * att[c];
        }
        d_w = sum3(y[0], y[1], y[2]) * scale;
      }
    } else {
      const int e_texel = on ? row[1 + N_SLOTS] : -1, e_mat = on ? row[2 + N_SLOTS] : -1;
      float d_ae[3] = {0.0f, 0.0f, 0.0f}, d_e[1] = {0.0f};
      if (on) {
        const float4 ae4 = texel4(p.atlas, e_texel);
        const float ae[3] = {ae4.x, ae4.y, ae4.z};
        const float e = __ldg(p.emittance + e_mat);
        const float s_ = scale * w;
        float hx[3], dle_ae2[3];
        for (int c = 0; c < 3; ++c) {
          const float le = (ae[c] * ae[c]) * e;
          const float y = alb[c] * le;
          const float x = y * att[c];
          const float contrib = x * s_;
          acc[c] = p.em_mode == EM_ONE ? contrib : acc[c] + contrib;
          const float dx = h[c] * s_;
          const float dy = dx * att[c];
          d_att[c] = dx * y;
          da[c] = da[c] + dy * le;
          const float dle = dy * alb[c];
          hx[c] = h[c] * x;
          dle_ae2[c] = dle * (ae[c] * ae[c]);
          d_ae[c] = 2.0f * (dle * e) * ae[c];
        }
        d_w = sum3(hx[0], hx[1], hx[2]) * scale;
        d_e[0] = sum3(dle_ae2[0], dle_ae2[1], dle_ae2[2]);
      }
      if (p.sum_atlas != nullptr) warp_combined_add<3, 4>(e_texel, d_ae, p.sum_atlas, vals, lane);
      if (p.sum_emit != nullptr) warp_combined_add<1, 1>(e_mat, d_e, p.sum_emit, vals, lane);
    }
    // back through the slots, last to first
#pragma unroll
    for (int s = N_SLOTS - 1; s >= 0; --s) {
      const int texel = texels[s];
      float d_a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (texel >= 0) {
        const bool zero = (code >> (ZERO_SHIFT + s)) & 1;
        const float4 a4 = texel4(p.atlas, texel);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float mult = 1.0f - a[3];
        float d_f[3], fa[3];
        for (int c = 0; c < 3; ++c) {
          d_f[c] = d_att[c] * att_pre[s][c];
          d_att[c] = d_att[c] * (a[c] * a[3] + mult);
          fa[c] = d_f[c] * a[c];
        }
        const float d_m = zero ? 0.0f : d_w * w_pre[s];
        d_w = zero ? 0.0f : d_w * mult;
        for (int c = 0; c < 3; ++c) d_a[c] = d_f[c] * a[3];
        d_a[3] = sum3(fa[0], fa[1], fa[2]) - (sum3(d_f[0], d_f[1], d_f[2]) + d_m);
      }
      if (p.sum_atlas != nullptr) warp_combined_add<4, 4>(texel, d_a, p.sum_atlas, vals, lane);
    }
  }
  if (!valid) return;
  if (p.em_mode != EM_NONE)
    for (int c = 0; c < 3; ++c) dt[c] = dt[c] + g[c] * acc[c];
  if (p.d_tp != nullptr) {  // after a compaction, to the row the lane came from
    const long long o = p.src != nullptr ? (long long)__ldg(p.src + i) : i;
    for (int c = 0; c < 3; ++c) p.d_tp[3 * o + c] = dt[c];
  }
  if (p.d_alb != nullptr)
    reinterpret_cast<float4*>(p.d_alb)[i] = make_float4(da[0], da[1], da[2], 0.0f);
  if (p.d_rad != nullptr)  // the radiance's pass-through, in the rows K4 wrote it
    for (int c = 0; c < 3; ++c) p.d_rad[3 * i + c] = g[c];
}

// The lanes, grid-stride (every lane of a block in every round, so the
// warps stay whole).
__device__ __forceinline__ void backward_lanes(const BackwardParams& p, float* vals) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < p.n; base += stride) {
    const long long i = base + threadIdx.x;
    backward_lane(p, i, i < p.n, vals, lane);
  }
}

// The dense float32 gradients from the float64 scratch, which is zeroed
// behind them.
__device__ __forceinline__ void backward_sweep(const BackwardParams& p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p.sum_atlas != nullptr) {
    double2* sum = reinterpret_cast<double2*>(p.sum_atlas);
    for (long long k = t; k < p.n_texels; k += stride) {
      const double2 lo = __ldcg(sum + 2 * k), hi = __ldcg(sum + 2 * k + 1);
      reinterpret_cast<float4*>(p.d_atlas)[k] = make_float4((float)lo.x, (float)lo.y, (float)hi.x, (float)hi.y);
      sum[2 * k] = make_double2(0.0, 0.0);
      sum[2 * k + 1] = make_double2(0.0, 0.0);
    }
  }
  if (p.sum_emit != nullptr) {
    for (long long k = t; k < p.n_emit; k += stride) {
      p.d_emit[k] = (float)__ldcg(p.sum_emit + k);
      p.sum_emit[k] = 0.0;
    }
  }
}

// The backward of one bounce's next-event terms: the lanes, a grid-wide
// barrier, then the sweep.  Launched cooperatively: the grid is at most the
// card's resident blocks.
__global__ void __launch_bounds__(kBwdThreads) nee_backward_kernel(const __grid_constant__ BackwardParams p) {
  __shared__ float vals[kBwdThreads / 32][32 * 4];
  backward_lanes(p, vals[threadIdx.x >> 5]);
  if (p.sum_atlas == nullptr && p.sum_emit == nullptr) return;  // uniform over the grid
  cg::this_grid().sync();
  backward_sweep(p);
}

// ---- launch configuration

static int card_sms(int dev, int* sms) {
  static int per_device[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&per_device[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = per_device[dev];
  return 0;
}

// nee_backward's cooperative grid on the current card: one block per
// kBwdThreads lanes or texels, at most SMs x resident blocks.  `out`:
// threads, blocks, resident blocks per SM, SMs.
static int backward_config(int n, long long n_texels, int n_emit, int* out) {
  static int resident[kMaxDevices];
  static std::mutex mu;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int rc = card_sms(dev, &sms);
  if (rc != 0) return rc;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (resident[dev] == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], nee_backward_kernel, kBwdThreads, 0);
      if (e != cudaSuccess) return (int)e;
      if (resident[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    }
  }
  long long work = n;
  if (n_texels > work) work = n_texels;
  if (n_emit > work) work = n_emit;
  const long long cap = (long long)sms * resident[dev];
  long long blocks = (work + kBwdThreads - 1) / kBwdThreads;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  out[0] = kBwdThreads;
  out[1] = (int)blocks;
  out[2] = resident[dev];
  out[3] = sms;
  return 0;
}

// ---- entry points; each returns a cudaError_t

// `slots`: the N_SETUP_SLOTS words of SetupSlot's order (pointers, the
// uniforms' row stride).
extern "C" int nee_setup(int n, const NeeTables* tables, const NeeFlags* flags, const void* const* slots,
                         int n_slots, void* stream) {
  if (n_slots != N_SETUP_SLOTS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  SetupParams p;
  p.tb = *tables;
  p.fl = *flags;
  p.hitpoint = (const float*)slots[S_HITPOINT];
  p.normal = (const float*)slots[S_NORMAL];
  p.mat = (const int*)slots[S_MAT];
  p.diffuse_on = (const uint8_t*)slots[S_DIFFUSE_ON];
  p.cur_mat = (const int*)slots[S_CUR_MAT];
  p.u = (const float*)slots[S_U];
  p.u_stride = (long long)(intptr_t)slots[S_U_STRIDE];
  p.out.origin = (float*)slots[S_ORIGIN];
  p.out.dir = (float*)slots[S_DIR];
  p.out.max_t = (float*)slots[S_MAX_T];
  p.out.scale = (float*)slots[S_SCALE];
  p.out.active = (uint8_t*)slots[S_ACTIVE];
  p.out.cur_mat = (int*)slots[S_OUT_CUR_MAT];
  p.out.e_texel = (int*)slots[S_E_TEXEL];
  p.out.e_mat = (int*)slots[S_E_MAT];
  p.out.p_hit = (uint8_t*)slots[S_P_HIT];
  p.out.p_t = (float*)slots[S_P_T];
  p.out.p_mat = (int*)slots[S_P_MAT];
  p.out.p_uv = (float*)slots[S_P_UV];
  p.n = n;
  const bool scan = p.out.p_hit != nullptr;
  if (scan && (p.out.p_t == nullptr || p.out.p_mat == nullptr || p.out.p_uv == nullptr ||
               prim_count(p.tb.prims) == 0))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (scan)
    nee_setup_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    nee_setup_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// `slots`: the N_RESOLVE_SLOTS words of ResolveSlot's order (pointers,
// then the two row strides).
extern "C" int nee_resolve(int n, const NeeTables* tables, const NeeFlags* flags, const void* const* slots,
                           int n_slots, void* stream) {
  if (n_slots != N_RESOLVE_SLOTS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ResolveParams p;
  p.tb = *tables;
  p.fl = *flags;
  p.albedo = (const float*)slots[R_ALBEDO];
  p.throughput = (const float*)slots[R_THROUGHPUT];
  p.radiance = (const float*)slots[R_RADIANCE];
  p.cur_mat = (const int*)slots[R_CUR_MAT];
  p.on = (const uint8_t*)slots[R_ON];
  p.max_t = (const float*)slots[R_MAX_T];
  p.scale = (const float*)slots[R_SCALE];
  p.e_texel = (const int*)slots[R_E_TEXEL];
  p.e_mat = (const int*)slots[R_E_MAT];
  p.wk.hit = (const uint8_t*)slots[R_HIT];
  p.wk.t = (const float*)slots[R_T];
  p.wk.face_id = (const int*)slots[R_FACE_ID];
  p.wk.uv = (const float*)slots[R_UV];
  p.wk.leaf_value = (const int*)slots[R_LEAF_VALUE];
  p.wk.count = (const int*)slots[R_COUNT];
  p.wk.mats = (const int*)slots[R_MATS];
  p.wk.uu = (const float*)slots[R_UU];
  p.wk.vv = (const float*)slots[R_VV];
  p.wk.ts = (const float*)slots[R_TS];
  p.wk.p_hit = (const uint8_t*)slots[R_P_HIT];
  p.wk.p_t = (const float*)slots[R_P_T];
  p.wk.p_mat = (const int*)slots[R_P_MAT];
  p.wk.p_uv = (const float*)slots[R_P_UV];
  p.idx = (const int*)slots[R_IDX];
  p.out_rad = (float*)slots[R_OUT_RADIANCE];
  p.resid = (int*)slots[R_RESID];
  p.throughput_stride = (long long)(intptr_t)slots[R_THROUGHPUT_STRIDE];
  p.radiance_stride = (long long)(intptr_t)slots[R_RADIANCE_STRIDE];
  p.n = n;
  nee_resolve_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// `slots`: the N_BACKWARD_SLOTS pointers of BackwardSlot's order.  The
// scratch sums, where given, are zero and are left zero.
extern "C" int nee_backward(int n, const void* const* slots, int n_slots, long long n_texels, int n_emit, int sun,
                            int em_mode, int faces, void* stream) {
  if (n_slots != N_BACKWARD_SLOTS) return (int)cudaErrorInvalidValue;
  BackwardParams p;
  p.atlas = (const float*)slots[B_ATLAS];
  p.emittance = (const float*)slots[B_EMITTANCE];
  p.sun_emittance = (const float*)slots[B_SUN_EMITTANCE];
  p.g_rad = (const float*)slots[B_G_RADIANCE];
  p.albedo = (const float*)slots[B_ALBEDO];
  p.throughput = (const float*)slots[B_THROUGHPUT];
  p.resid = (const int*)slots[B_RESID];
  p.scales = (const float*)slots[B_SCALE];
  p.d_tp = (float*)slots[B_D_THROUGHPUT];
  p.d_alb = (float*)slots[B_D_ALBEDO];
  p.d_atlas = (float*)slots[B_D_ATLAS];
  p.d_emit = (float*)slots[B_D_EMITTANCE];
  p.sum_atlas = p.d_atlas == nullptr ? nullptr : (double*)slots[B_SUM_ATLAS];
  p.sum_emit = p.d_emit == nullptr ? nullptr : (double*)slots[B_SUM_EMITTANCE];
  p.src = (const int*)slots[B_SRC];
  p.idx = (const int*)slots[B_IDX];
  p.d_rad = (float*)slots[B_D_RADIANCE];
  if (p.d_rad != nullptr && p.idx == nullptr) return (int)cudaErrorInvalidValue;
  p.n_texels = n_texels;
  p.n_emit = n_emit;
  p.n = n;
  p.sun = sun;
  p.em_mode = em_mode;
  p.faces = faces;
  int cfg[4];
  int rc = backward_config(n, n_texels, n_emit, cfg);
  if (rc != 0) return rc;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)nee_backward_kernel, dim3(cfg[1]), dim3(cfg[0]), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `out`: the registers per thread and the stack frame bytes of nee_setup
// without and with K7's scan folded in (four words).
extern "C" int nee_setup_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, nee_setup_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  e = cudaFuncGetAttributes(&attr, nee_setup_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

// `out`: nee_resolve's threads, blocks, registers per thread and resident
// blocks per SM on the current card for `n` lanes.
extern "C" int nee_resolve_config(int n, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, nee_resolve_kernel);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, nee_resolve_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = (n + kThreads - 1) / kThreads;
  out[2] = attr.numRegs;
  out[3] = resident;
  return 0;
}

// `out`: nee_backward's threads, blocks, resident blocks per SM and SMs on
// the current card for `n` lanes and the given gradient sizes.
extern "C" int nee_backward_config(int n, long long n_texels, int n_emit, int* out) {
  return backward_config(n, n_texels, n_emit, out);
}

extern "C" const char* nee_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
