// ESVO first-hit traversal of the packed sparse-voxel octree, in four
// compile-time modes of one kernel body (`template <int MODE>`):
//
//   MODE 0 — kernel K1, no accept: the first leaf candidate is the hit.
//   MODE 1 — kernel K2, the in-loop alpha accept.
//   MODE 2 — kernel K3r, the recording walk: record the first K_SURFACES = 4
//            surfaces per ray, accept the 4th.
//   MODE 3 — kernel K3s, the shadow walk: record each alpha surface the ray
//            crosses (material, uv and, on request, world t) with a running
//            alpha budget w *= 1 - alpha; stop on the 4th surface or when the
//            budget reaches 0 (strict mode zeroes it on an IOR change).
//
// Kernel K2q is the block-model variant of modes 1, 2 and 3 (`template <int
// MODE, bool MODELS>`, its own __global__ and entry point per mode): a
// candidate's material is its model's face material
// face_material[model][clip(face, 0, 5)]; a simple model tests that
// material's texel at the entry face's uv; a quad model tests up to
// MAX_MODEL_QUADS quads in the voxel's frame, o_loc = (origin - voxel_pos) /
// voxel_size, each with Quad::hit (quads.cuh) up to the best t so far, and
// keeps the nearest whose texel alpha is above Ray::EPSILON; none found
// rejects the candidate.  Mode 1 writes the winning quad's material, uv,
// normal and world t (t_local * voxel_size) for render/hit.resolve_hit;
// mode 2 records (material, uv, entry face); mode 3 records (material, uv
// and the voxel entry's t, t_min * inv_scale) under the same alpha budget
// and strict-IOR stop, a binary-class leaf staying a total blocker that
// needs no texel fetch.  The variants without models compile to what they
// were: their kernels take no model argument and every model branch is
// `if constexpr`.
//
// Replaces: octree_pathtracing_tpu/ops/traversal.py `traverse` (:459) with
// its `_init`, `_step`, `_examine` and `_hit_info` (k_examine = 2,
// untiled), and, for the accept modes, the callback protocol of :563-596 —
// MODE 1 with render/hit.py `make_accept_fn` (:104) and
// `_leaf_alpha_classes` (:72), MODE 2 with diff/soft.py
// `_make_recording_accept` (:69) / `record_surfaces` (:96) over
// render/hit.py `_surface_of_candidate` (:155), MODE 3 with render/hit.py
// `make_shadow_accept_fn` (:223) and `shadow_state_init` (:187); K2q adds
// the model branches of those callbacks with render/hit.py `_quad_scan`
// (:39), over the world origins, voxel corner and voxel size that the
// accept protocol passes (:569-578).  The JAX version steps a whole ray batch in lockstep under
// one lax.while_loop; here every thread walks its own ray to an accepted
// leaf, a miss, or MAX_STEPS node fetches, and exits on its own.
//
// What bounds it: dependent node-row fetches.  Each step reads one 32-byte
// row of the (N, 8) int32 node table (two 16-byte __ldg loads) whose
// address comes from the previous step, then runs the PUSH / ADVANCE / POP
// decision on it (twice when the first decision stays inside the same
// parent).  The depth-9 terrain's table is 893,830 rows = 28.6 MB, so it
// stays resident in the H100's 50 MB L2; the cost is L2 latency per step,
// hidden only by the number of rays in flight.  The accept modes add, per
// leaf candidate, one leaf_material and one texture_index word, the
// `rejectable` byte (MODE 1) and one texel's alpha (4 bytes) — far fewer
// bytes than the node rows, since there are far fewer candidates than
// fetches.  The record rows of modes 2 and 3 live in registers (K is a
// compile-time constant and every row index is unrolled).  MODE 3 reads, per
// candidate, the leaf's binary-class byte and, for a non-binary leaf, the
// texel alpha; two IOR words in strict mode.
//
// K2q adds, per candidate of a model scene, the leaf's model id, the
// model's flags, face material, quad start and count, and for a quad model
// up to MAX_MODEL_QUADS quad rows of 84 bytes (21 words) and one texel per
// quad hit; the scene's few models and quads stay in L1/L2.
//
// The design for the H100 (the numbers that chose it: PERF.md):
// - The stack lives in dynamic shared memory, depth + 1 rows of (parent,
//   t_max) per thread, laid out [row][thread] so that the lanes of a warp
//   hit 32 different banks whatever rows they touch (kThreads is a multiple
//   of 32).  It keeps every row the JAX walk's stack keeps, so PUSH and POP
//   fetch the same rows as the reference and `fetches` stays its count.  In
//   local memory (the first version) the 24-row stack was a 312-byte frame
//   per thread that the L1 could not hold at full occupancy: moving it
//   halved K2 and K3r on their 2 M-ray batches.
// - No register array is indexed at run time (hit_info picks its axes with
//   selects), so nothing else lives in local memory either.
// - One thread per ray over a grid that covers the batch, in blocks of 64
//   (up to 2.5% ahead of 128, or level with it, on every measured call;
//   256 behind), one launch per call.  Refilling lanes from a counter over
//   a card-sized grid, and holding the node row while the parent is
//   unchanged, were measured and dropped: refill scattered neighbouring
//   rays over a warp and cost 39-46% on the 2 M-ray batches, the held row
//   up to 6% on all but one call (a compare and its registers on every
//   step, for loads the L1 serves).
//
// Parity with the JAX reference and the plain-torch twin:
// - FMA contraction: `pos * t_coef - t_bias` and `half * t_coef + t_corner`
//   would fuse into one FMA by default, moving t by an ulp and flipping
//   knife-edge PUSH/ADVANCE decisions.  The build passes -fmad=false, so
//   every multiply and add rounds on its own, as in XLA's CPU path, the
//   numpy oracle and eager torch.  No --use_fast_math: `1 / -|rd|` and the
//   uv divisions stay IEEE-rounded.
// - Bit tricks: float bit casts are __float_as_uint / __uint_as_float;
//   lax.clz becomes __clz of max(x, 1); the leaf bit is tested as
//   (uint32)word >> 31; exp2(p_scale - 23) is built in the exponent field;
//   the pop scale is clipped to [scale_base, MAX_SCALE - 1].
// - Tie-breaks: the first axis wins in the face-axis choice, and ADVANCE
//   steps every axis with t_corner <= tc_max.
// - The stack read at the pop scale is a direct index into the lane's
//   column (the select chain of the JAX version was a TPU workaround); a
//   ray's rows start at 0, as the reference's stack does.
// - The epsilon clamp of tiny direction components keeps the sign of rd.
// - An inactive lane starts as MISS and fetches nothing; its outputs are
//   still derived from its initial state, exactly like the reference's.
// - The accept (modes 1, 2) runs after the step in which a lane's status
//   became CANDIDATE, on the hit info of that state.  A rejected lane goes
//   back to ACTIVE with `reject` set: its next examination may neither hit
//   nor push, so it ADVANCEs past the rejected leaf, and clears `reject`.
// - The texel index repeats ops/texture.sample_atlas: clamp u and v to
//   [0, 1], flip v, multiply by the layer's width / height as floats,
//   truncate to int, clip to the layer.
// - MODE 3 follows make_shadow_accept_fn's arithmetic: a binary-class leaf
//   (every texel alpha exactly 1) is a surface of alpha 1 recorded with the
//   entry face's uv and no atlas fetch; the budget is w * (1 - alpha), one
//   rounded subtract then one rounded multiply; t is t_min * inv_scale as
//   the accept protocol passes it (traversal.py:575); the walk stops when
//   the count reaches K_SURFACES or w <= 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quads.cuh"

#define MAX_STEPS 1000
#define MAX_SCALE 23
#define ACTIVE 0
#define CANDIDATE 1
#define MISS 2
#define VALUE_MASK 0x3FFFFFFF
#define EPSILON_F 1.1920929e-7f
#define ALPHA_EPSILON_F 5e-8f  // Ray::EPSILON, ops/shading.EPSILON
#define K_SURFACES 4
#define MAX_MODEL_QUADS 8
#define FLAG_SIMPLE 1

constexpr int kThreads = 64;  // threads per block (PERF.md: 64, 128 and 256 measured)

struct Ray {
  float ro[3], rd[3], t_coef[3], t_bias[3];
  int mirror;
};

// The ray as the caller gave it, in world space (K2q's quad scan; apart
// from Ray, so that the variants without models never hold it).
struct WorldRay {
  float o[3], d[3];
};

struct State {
  float pos[3];
  int index, parent, scale;
  float scale_exp2, t_min, t_max, h;
  int status, cand;
  bool reject;
};

// A lane's column of its block's stack in dynamic shared memory: row k at
// col[k * kThreads], (parent, t_max bits).
using StackCol = int2*;

// The alpha-test tables of modes 1 and 2 (unused by mode 0).
struct AlphaTables {
  const int* leaf_material;  // (L,)
  const int* texture_index;  // (M,)
  const float* atlas;        // (T, H, W, 4)
  const int* sizes;          // (T, 2) per-layer (h, w), or null: all (H, W)
  const uint8_t* rejectable; // (L,), mode 1 only
  const uint8_t* binary;     // (L,), mode 3 only: every texel alpha is exactly 1
  const float* ior;          // (M,), mode 3 only
  int n_leaf, n_mat, n_layer, atlas_h, atlas_w;
};

// What the shadow walk (mode 3) reads besides the tables, and writes besides
// the record.
struct ShadowIO {
  const int* cur_mat;  // (B,) the lane's medium: the strict test's first material
  int strict;
  float* w;            // (B,) the alpha budget left
  int* cm;             // (B,) the medium after the last recorded surface
  float* ts;           // (K, B) world t of each surface, or null
};

// K2q's block-model tables (ops/traversal.AlphaTables' model fields).
struct ModelTables {
  const int* leaf_model;     // (L,) leaf value -> model
  const int* flags;          // (Mm,) FLAG_SIMPLE: a full cube
  const int* face_material;  // (Mm, 6)
  const int* quad_start;     // (Mm,)
  const int* quad_count;     // (Mm,)
  int n_leaf_model, n_model;
  QuadTable quads;           // block-local quads
};

// Where K2q's mode 1 writes the accepted quad surface of each lane.
struct QuadOut {
  uint8_t* found;  // (B,)
  int* mat;        // (B,)
  float* uv;       // (B, 2)
  float* normal;   // (B, 3)
  float* t;        // (B,) world t
};

// The surfaces a lane recorded (modes 2 and 3; w, cm and ts in mode 3 only)
// and, in K2q's mode 1, the quad surface it accepted.
struct Record {
  int count;
  int mat[K_SURFACES], face[K_SURFACES];
  float uu[K_SURFACES], vv[K_SURFACES], ts[K_SURFACES];
  float w;
  int cm;
  bool q_found;
  int q_mat;
  float q_uv[2], q_normal[3], q_t;
};

__device__ __forceinline__ int child_word(int4 lo, int4 hi, int slot) {
  int4 q = (slot & 4) ? hi : lo;
  int s = slot & 3;
  return s == 0 ? q.x : (s == 1 ? q.y : (s == 2 ? q.z : q.w));
}

// One PUSH / ADVANCE / POP / hit decision against a fetched row.  Returns
// true when the lane did a same-parent ADVANCE (the row can be reused).
template <int MODE>
__device__ __forceinline__ bool examine(State& s, StackCol col, int rows, const Ray& r, int4 lo,
                                        int4 hi, int scale_base, float max_dst) {
  bool rejected = false;
  if (MODE != 0) {  // the flag forces this examination's ADVANCE, then clears
    rejected = s.reject;
    s.reject = false;
  }
  if (s.t_min > max_dst) {  // loop-top distance cap
    s.status = MISS;
    return false;
  }
  float t_corner[3];
  for (int a = 0; a < 3; ++a) t_corner[a] = s.pos[a] * r.t_coef[a] - r.t_bias[a];
  float tc_max = fminf(fminf(t_corner[0], t_corner[1]), t_corner[2]);

  int word = child_word(lo, hi, s.index ^ r.mirror);
  int value = word & VALUE_MASK;
  bool present = ((word >> 30) & 1) != 0;
  bool leafb = ((uint32_t)word >> 31) != 0;
  bool valid = present && (s.t_min <= s.t_max);

  if (valid && leafb && s.t_min > 0.0f && !rejected) {  // leaf candidate
    s.status = CANDIDATE;
    s.cand = value;
    return false;
  }
  float half = s.scale_exp2 * 0.5f;
  float tv_max = fminf(s.t_max, tc_max);
  if (valid && !leafb && s.t_min <= tv_max && !rejected) {  // PUSH into the child
    int rel = s.scale - scale_base;  // in [0, depth) on a well-formed tree
    if (tc_max < s.h && rel >= 0 && rel < rows) {
      col[rel * kThreads] = make_int2(s.parent, __float_as_int(s.t_max));
    }
    int idx = 0;
    for (int a = 0; a < 3; ++a) {
      float t_center = half * r.t_coef[a] + t_corner[a];
      if (t_center > s.t_min) {
        idx |= 1 << a;
        s.pos[a] = s.pos[a] + half;
      }
    }
    s.index = idx;
    s.parent = value;
    s.scale -= 1;
    s.scale_exp2 = half;
    s.t_max = tv_max;
    s.h = tc_max;
    return false;
  }
  // ADVANCE to the next sibling along the ray
  int step_mask = 0;
  float adv_pos[3];
  for (int a = 0; a < 3; ++a) {
    bool b = t_corner[a] <= tc_max;
    step_mask |= (int)b << a;
    adv_pos[a] = b ? s.pos[a] - s.scale_exp2 : s.pos[a];
  }
  int adv_index = s.index ^ step_mask;
  s.t_min = tc_max;
  for (int a = 0; a < 3; ++a) s.pos[a] = adv_pos[a];
  s.index = adv_index;
  if ((adv_index & step_mask) == 0) return true;  // same parent

  // POP: climb to the highest scale whose bit changed
  uint32_t differing = 0;
  for (int a = 0; a < 3; ++a) {
    if ((step_mask >> a) & 1) {
      differing |= __float_as_uint(adv_pos[a]) ^ __float_as_uint(adv_pos[a] + s.scale_exp2);
    }
  }
  int p_scale = 31 - __clz((int)max(differing, 1u));
  if (p_scale >= MAX_SCALE) {  // left the root cube
    s.status = MISS;
    return false;
  }
  int p_scale_c = min(max(p_scale, scale_base), MAX_SCALE - 1);
  int p_rel = p_scale_c - scale_base;
  int idx = 0;
  for (int a = 0; a < 3; ++a) {
    uint32_t sh = __float_as_uint(adv_pos[a]) >> p_scale_c;
    s.pos[a] = __uint_as_float(sh << p_scale_c);
    idx |= (int)(sh & 1u) << a;
  }
  int2 row = col[p_rel * kThreads];
  s.index = idx;
  s.parent = row.x;
  s.t_max = __int_as_float(row.y);
  s.scale = p_scale_c;
  s.scale_exp2 = __uint_as_float((uint32_t)(p_scale_c - MAX_SCALE + 127) << 23);
  s.h = 0.0f;
  return false;
}

// v[k] for k in [0, 3) as a select: a run-time index into a register
// array would put the array in local memory.
__device__ __forceinline__ float pick3(const float v[3], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// _hit_info: entry face, uv and the unmirrored voxel corner of a state.
__device__ __forceinline__ void hit_info(const Ray& r, const State& s, int& face,
                                         float& uu, float& vv, float unm[3]) {
  float tch[3];
  for (int a = 0; a < 3; ++a) {
    bool m = (r.mirror >> a) & 1;
    unm[a] = m ? (3.0f - s.scale_exp2) - s.pos[a] : s.pos[a];
    tch[a] = (s.pos[a] + s.scale_exp2) * r.t_coef[a] - r.t_bias[a];
  }
  float tc_min = fmaxf(fmaxf(tch[0], tch[1]), tch[2]);
  int axis = (tch[0] == tc_min) ? 0 : ((tch[1] == tc_min) ? 1 : 2);
  float rd_ax = pick3(r.rd, axis);
  face = axis * 2 + (int)(__float_as_uint(rd_ax) >> 31);
  int a1 = axis == 0 ? 2 : 0;
  int a2 = axis == 1 ? 2 : 1;
  uu = (pick3(r.ro, a1) + pick3(r.rd, a1) * tc_min - pick3(unm, a1)) / s.scale_exp2;
  vv = (pick3(r.ro, a2) + pick3(r.rd, a2) * tc_min - pick3(unm, a2)) / s.scale_exp2;
  bool neg = rd_ax < 0.0f;
  if (neg && axis != 1) uu = 1.0f - uu;
  if (neg && axis == 1) vv = 1.0f - vv;
}

__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// The texel alpha sample_atlas returns for (layer, u, v).
__device__ __forceinline__ float texel_alpha(const AlphaTables& tb, int layer, float u, float v) {
  int th = tb.atlas_h, tw = tb.atlas_w;
  if (tb.sizes != nullptr) {
    th = tb.sizes[2 * layer];
    tw = tb.sizes[2 * layer + 1];
  }
  float uu = clamp01(u);
  float vv = 1.0f - clamp01(v);
  int i = max((int)(uu * (float)tw), 0);
  int j = max((int)(vv * (float)th), 0);
  i = i > tw - 1 ? tw - 1 : i;
  j = j > th - 1 ? th - 1 : j;
  return __ldg(tb.atlas + (((size_t)layer * tb.atlas_h + j) * tb.atlas_w + i) * 4 + 3);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The atlas layer of material `mat` (in [0, n_mat)).
__device__ __forceinline__ int layer_of(const AlphaTables& tb, int mat) {
  return clip(__ldg(tb.texture_index + mat), 0, tb.n_layer - 1);
}

// K2q's quad scan (render/hit.py _quad_scan): the quads of `model` in the
// frame of the voxel (corner vpos, side vs); the nearest hit whose texel
// alpha is above ALPHA_EPSILON.  Returns its index, or -1.
__device__ __forceinline__ int quad_scan(const AlphaTables& tb, const ModelTables& mt,
                                         int model, const WorldRay& w, const float vpos[3], float vs,
                                         float& best_t, float& best_u, float& best_v,
                                         float& best_alpha) {
  float o_loc[3];
  for (int a = 0; a < 3; ++a) o_loc[a] = (w.o[a] - vpos[a]) / vs;
  int start = __ldg(mt.quad_start + model);
  int count = __ldg(mt.quad_count + model);
  int best_q = -1;
  best_t = __int_as_float(0x7f800000);
  for (int k = 0; k < MAX_MODEL_QUADS && k < count; ++k) {
    int q = clip(start + k, 0, mt.quads.count - 1);
    float t, uu, vv;
    if (!quad_hit(mt.quads, q, o_loc, w.d, best_t, t, uu, vv)) continue;
    float alpha = texel_alpha(tb, layer_of(tb, clip(__ldg(mt.quads.material + q), 0, tb.n_mat - 1)), uu, vv);
    if (alpha > ALPHA_EPSILON_F && t < best_t) {
      best_t = t;
      best_u = uu;
      best_v = vv;
      best_alpha = alpha;
      best_q = q;
    }
  }
  return best_q;
}

// The surface of a fresh candidate (render/hit.py _surface_of_candidate):
// false where there is none (a hole, or a quad model whose quads the ray
// misses); else its material, uv and texel alpha (1 for a binary-class
// leaf in mode 3, which needs no texel fetch).  K2q's mode 1 keeps the
// accepted quad's surface in `rec`.
template <int MODE, bool MODELS>
__device__ __forceinline__ bool surface(const State& s, const WorldRay& w, const AlphaTables& tb,
                                        const ModelTables& mt, float inv_scale, int face, int lv,
                                        const float unm[3], float& uu, float& vv, int& mat,
                                        float& alpha, Record& rec) {
  // table indices clip like XLA's gathers (in range on any scene make_scene built)
  if constexpr (MODELS) {
    int model = clip(__ldg(mt.leaf_model + clip(s.cand, 0, mt.n_leaf_model - 1)), 0, mt.n_model - 1);
    mat = clip(__ldg(mt.face_material + 6 * model + clip(face, 0, 5)), 0, tb.n_mat - 1);
    if (MODE == 3 && tb.binary[lv]) return true;  // a total blocker, no texel fetch
    if (__ldg(mt.flags + model) & FLAG_SIMPLE) {
      alpha = texel_alpha(tb, layer_of(tb, mat), uu, vv);
      return alpha > ALPHA_EPSILON_F;
    }
    // a quad model: its nearest quad hit with a texel, in the voxel's frame
    float vpos[3], vs = s.scale_exp2 * inv_scale, best_t;
    for (int a = 0; a < 3; ++a) vpos[a] = (unm[a] - 1.0f) * inv_scale;
    int q = quad_scan(tb, mt, model, w, vpos, vs, best_t, uu, vv, alpha);
    if (q < 0) return false;
    mat = clip(__ldg(mt.quads.material + q), 0, tb.n_mat - 1);
    if (MODE == 1) {
      rec.q_found = true;
      rec.q_mat = mat;
      rec.q_uv[0] = uu;
      rec.q_uv[1] = vv;
      for (int a = 0; a < 3; ++a) rec.q_normal[a] = __ldg(mt.quads.normal + 3 * q + a);
      rec.q_t = best_t * vs;
    }
    return true;
  } else {
    mat = clip(__ldg(tb.leaf_material + lv), 0, tb.n_mat - 1);
    if (MODE == 3 && tb.binary[lv]) return true;  // a total blocker, no texel fetch
    alpha = texel_alpha(tb, layer_of(tb, mat), uu, vv);
    return alpha > ALPHA_EPSILON_F;
  }
}

// The accept of a fresh candidate; false sends the lane back to ACTIVE.
template <int MODE, bool MODELS>
__device__ __forceinline__ bool accept(const State& s, const Ray& r, const WorldRay& w,
                                       const AlphaTables& tb, const ModelTables& mt, int strict,
                                       float inv_scale, Record& rec) {
  int face;
  float uu, vv, unm[3];
  hit_info(r, s, face, uu, vv, unm);
  int lv = clip(s.cand, 0, tb.n_leaf - 1);
  if (MODE == 1 && !tb.rejectable[lv]) return true;  // no texel of it can reject
  int mat;
  float alpha = 1.0f;
  if (!surface<MODE, MODELS>(s, w, tb, mt, inv_scale, face, lv, unm, uu, vv, mat, alpha, rec)) {
    return false;  // walk on
  }
  if constexpr (MODE == 1) {
    return true;
  } else if constexpr (MODE == 3) {
    float budget = rec.w * (1.0f - alpha);
    if (strict) {
      int cm = clip(rec.cm, 0, tb.n_mat - 1);
      if (__ldg(tb.ior + cm) != __ldg(tb.ior + mat)) budget = 0.0f;
    }
    float t_world = s.t_min * inv_scale;  // the voxel entry, also for a quad
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {  // unrolled: the rows stay in registers
      if (k == rec.count) {
        rec.mat[k] = mat;
        rec.uu[k] = uu;
        rec.vv[k] = vv;
        rec.ts[k] = t_world;
      }
    }
    rec.count += 1;
    rec.w = budget;
    rec.cm = mat;
    return rec.count >= K_SURFACES || budget <= 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {  // unrolled: the rows stay in registers
      if (k == rec.count) {
        rec.mat[k] = mat;
        rec.face[k] = face;
        rec.uu[k] = uu;
        rec.vv[k] = vv;
      }
    }
    rec.count += 1;
    return rec.count >= K_SURFACES;
  }
}

// A call's rays and outputs: the kernels' arguments besides the tables.
struct Batch {
  const int4* nodes;
  int root, depth;
  float octree_scale, inv_scale, max_dst;
  const float* origins;   // (B, 3)
  const float* dirs;      // (B, 3)
  const uint8_t* active;  // (B,), or null: every lane active
  int n;
  uint8_t* hit;
  float* t;
  int* face;
  float* uv;
  int* leaf;
  float* vpos;
  float* vsize;
  int* steps;
  int* rec_count;  // modes 2 and 3: the record, (B,) and (K, B)
  int* rec_mats;
  int* rec_face;
  float* rec_uu;
  float* rec_vv;
};

// One lane's walk: _init of its ray (the ray in the [1, 2) cube, mirrored to
// negative directions, at the root; the stack rows and the record zeroed),
// the walk with its accepts, the outputs.  The __global__ kernels below are
// thin shells around it.
template <int MODE, bool MODELS>
__device__ __forceinline__ void walk(const Batch& b, const AlphaTables& tb, const ShadowIO& sh,
                                     const ModelTables& mt, const QuadOut& qo) {
  extern __shared__ int2 stack_rows[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= b.n) return;
  const StackCol col = stack_rows + threadIdx.x;
  const int scale_base = MAX_SCALE - b.depth;
  const int rows = b.depth + 1;

  Ray r;
  WorldRay w;
  int pos_dir = 0;
  for (int a = 0; a < 3; ++a) {
    float o = b.origins[3 * i + a];
    r.ro[a] = o * b.octree_scale + 1.0f;
    float d = b.dirs[3 * i + a];
    if constexpr (MODELS) {
      w.o[a] = o;
      w.d[a] = d;
    }
    if (fabsf(d) < EPSILON_F) {
      d = __uint_as_float(__float_as_uint(EPSILON_F) | (__float_as_uint(d) & 0x80000000u));
    }
    r.rd[a] = d;
    r.t_coef[a] = 1.0f / -fabsf(d);
    r.t_bias[a] = r.t_coef[a] * r.ro[a];
    if (d > 0.0f) {
      pos_dir |= 1 << a;
      r.t_bias[a] = 3.0f * r.t_coef[a] - r.t_bias[a];
    }
  }
  r.mirror = pos_dir;

  State s;
  float t_lo[3], t_hi[3];
  for (int a = 0; a < 3; ++a) {
    t_lo[a] = 2.0f * r.t_coef[a] - r.t_bias[a];
    t_hi[a] = r.t_coef[a] - r.t_bias[a];
  }
  s.t_min = fmaxf(fmaxf(fmaxf(t_lo[0], t_lo[1]), t_lo[2]), 0.0f);
  s.t_max = fminf(fminf(t_hi[0], t_hi[1]), t_hi[2]);
  s.index = 0;
  for (int a = 0; a < 3; ++a) {
    bool upper = (1.5f * r.t_coef[a] - r.t_bias[a]) > s.t_min;
    s.index |= (int)upper << a;
    s.pos[a] = upper ? 1.5f : 1.0f;
  }
  s.parent = b.root;
  s.scale = MAX_SCALE - 1;
  s.scale_exp2 = 0.5f;
  s.h = s.t_max;
  s.status = (b.active == nullptr || b.active[i]) ? ACTIVE : MISS;
  s.cand = 0;
  s.reject = false;
  for (int k = 0; k < rows; ++k) col[k * kThreads] = make_int2(0, 0);
  Record rec;
  rec.count = 0;
  rec.w = 1.0f;
  rec.cm = MODE == 3 ? sh.cur_mat[i] : 0;
#pragma unroll
  for (int k = 0; k < K_SURFACES; ++k) {
    rec.mat[k] = 0;
    rec.face[k] = 0;
    rec.uu[k] = 0.0f;
    rec.vv[k] = 0.0f;
    rec.ts[k] = __int_as_float(0x7f800000);
  }
  if constexpr (MODELS && MODE == 1) {
    rec.q_found = false;
    rec.q_mat = 0;
    rec.q_uv[0] = rec.q_uv[1] = 0.0f;
    rec.q_normal[0] = rec.q_normal[1] = rec.q_normal[2] = 0.0f;
    rec.q_t = __int_as_float(0x7f800000);
  }

  // ---- the walk: one row fetch per step, up to two decisions on it, then
  // the accept of a fresh candidate
  int steps = 0;
  while (s.status == ACTIVE && steps < MAX_STEPS) {
    const int4* row = b.nodes + 2 * (size_t)s.parent;
    int4 lo = __ldg(row);
    int4 hi = __ldg(row + 1);
    if (examine<MODE>(s, col, rows, r, lo, hi, scale_base, b.max_dst)) {
      examine<MODE>(s, col, rows, r, lo, hi, scale_base, b.max_dst);
    }
    if (MODE != 0 && s.status == CANDIDATE &&
        !accept<MODE, MODELS>(s, r, w, tb, mt, sh.strict, b.inv_scale, rec)) {
      s.status = ACTIVE;
      s.reject = true;
    }
    ++steps;
  }

  int face;
  float uu, vv, unm[3];
  hit_info(r, s, face, uu, vv, unm);
  bool hit = s.status == CANDIDATE;
  const int n = b.n;
  b.hit[i] = hit;
  b.t[i] = hit ? s.t_min * b.inv_scale : __int_as_float(0x7f800000);
  b.face[i] = hit ? face : -1;
  b.uv[2 * i] = uu;
  b.uv[2 * i + 1] = vv;
  b.leaf[i] = hit ? s.cand : 0;
  for (int a = 0; a < 3; ++a) b.vpos[3 * i + a] = (unm[a] - 1.0f) * b.inv_scale;
  b.vsize[i] = s.scale_exp2 * b.inv_scale;
  b.steps[i] = steps;
  if constexpr (MODELS && MODE == 1) {
    qo.found[i] = rec.q_found;
    qo.mat[i] = rec.q_mat;
    qo.uv[2 * i] = rec.q_uv[0];
    qo.uv[2 * i + 1] = rec.q_uv[1];
    for (int a = 0; a < 3; ++a) qo.normal[3 * i + a] = rec.q_normal[a];
    qo.t[i] = rec.q_t;
  }
  if (MODE == 2) {
    b.rec_count[i] = rec.count;
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {
      b.rec_mats[k * n + i] = rec.mat[k];
      b.rec_face[k * n + i] = rec.face[k];
      b.rec_uu[k * n + i] = rec.uu[k];
      b.rec_vv[k * n + i] = rec.vv[k];
    }
  }
  if (MODE == 3) {
    b.rec_count[i] = rec.count;
    sh.w[i] = rec.w;
    sh.cm[i] = rec.cm;
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {
      b.rec_mats[k * n + i] = rec.mat[k];
      b.rec_uu[k * n + i] = rec.uu[k];
      b.rec_vv[k * n + i] = rec.vv[k];
      if (sh.ts != nullptr) sh.ts[k * n + i] = rec.ts[k];
    }
  }
}

// Modes 0-3 (K1, K2, K3r, K3s): no model tables.
template <int MODE>
__global__ void __launch_bounds__(kThreads) esvo_traverse_kernel(Batch b, AlphaTables tb, ShadowIO sh) {
  ModelTables mt = {};
  QuadOut qo = {};
  walk<MODE, false>(b, tb, sh, mt, qo);
}

// K2q: modes 1-3 with the block-model tables.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    esvo_traverse_models_kernel(Batch b, AlphaTables tb, ShadowIO sh, ModelTables mt, QuadOut qo) {
  walk<MODE, true>(b, tb, sh, mt, qo);
}

// `mt` null: modes 0-3; else K2q's variant of MODE (1-3), `qo` its mode-1
// output (null otherwise).  One launch, one thread per ray; the stack's
// rows take (depth + 1) * 8 bytes of shared memory per thread (12.3 KB a
// block at depth 23, under the 48 KB a launch may ask for unasked).
template <int MODE>
static int launch(const Batch& b, const AlphaTables& tb, const ShadowIO& sh, const ModelTables* mt,
                  const QuadOut* qo, void* stream) {
  if (b.n == 0) return 0;
  if (b.depth < 1 || b.depth > MAX_SCALE) return (int)cudaErrorInvalidValue;
  const int blocks = (b.n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(b.depth + 1) * kThreads * sizeof(int2);
  cudaStream_t st = (cudaStream_t)stream;
  if (mt == nullptr) {
    esvo_traverse_kernel<MODE><<<blocks, kThreads, smem, st>>>(b, tb, sh);
  } else if constexpr (MODE != 0) {
    QuadOut q = {};
    if (qo != nullptr) q = *qo;
    esvo_traverse_models_kernel<MODE><<<blocks, kThreads, smem, st>>>(b, tb, sh, *mt, q);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define HEAD_ARGS                                                                  \
  const void *nodes, int root, int depth, float octree_scale, float inv_scale,     \
      float max_dst, const void *origins, const void *dirs, const void *active, int n
#define TABLE_ARGS                                                                 \
  const void *leaf_material, int n_leaf, const void *texture_index, int n_mat,     \
      const void *atlas, int n_layer, int atlas_h, int atlas_w, const void *sizes
#define OUT_ARGS                                                                   \
  void *hit, void *t, void *face, void *uv, void *leaf, void *vpos, void *vsize, void *steps
#define HEAD nodes, root, depth, octree_scale, inv_scale, max_dst, origins, dirs, active, n
#define OUTS hit, t, face, uv, leaf, vpos, vsize, steps

static Batch batch(HEAD_ARGS, OUT_ARGS, void* rec_count, void* rec_mats, void* rec_face,
                   void* rec_uu, void* rec_vv) {
  Batch b = {(const int4*)nodes, root, depth, octree_scale, inv_scale, max_dst,
             (const float*)origins, (const float*)dirs, (const uint8_t*)active, n,
             (uint8_t*)hit, (float*)t, (int*)face, (float*)uv, (int*)leaf, (float*)vpos,
             (float*)vsize, (int*)steps, (int*)rec_count, (int*)rec_mats, (int*)rec_face,
             (float*)rec_uu, (float*)rec_vv};
  return b;
}

static AlphaTables alpha_tables(TABLE_ARGS, const void* rejectable, const void* binary,
                                const void* ior) {
  AlphaTables tb = {(const int*)leaf_material, (const int*)texture_index,
                    (const float*)atlas, (const int*)sizes, (const uint8_t*)rejectable,
                    (const uint8_t*)binary, (const float*)ior, n_leaf, n_mat,
                    n_layer, atlas_h, atlas_w};
  return tb;
}
#define TABLES leaf_material, n_leaf, texture_index, n_mat, atlas, n_layer, atlas_h, atlas_w, sizes

static const ShadowIO kNoShadow = {nullptr, 0, nullptr, nullptr, nullptr};

// K1: no accept.
extern "C" int esvo_traverse(HEAD_ARGS, OUT_ARGS, void* stream) {
  AlphaTables tb = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0};
  return launch<0>(batch(HEAD, OUTS, nullptr, nullptr, nullptr, nullptr, nullptr), tb, kNoShadow,
                   nullptr, nullptr, stream);
}

// K2: the in-loop alpha accept.
extern "C" int esvo_traverse_alpha(HEAD_ARGS, TABLE_ARGS, const void* rejectable, OUT_ARGS,
                                   void* stream) {
  return launch<1>(batch(HEAD, OUTS, nullptr, nullptr, nullptr, nullptr, nullptr),
                   alpha_tables(TABLES, rejectable, nullptr, nullptr), kNoShadow, nullptr, nullptr,
                   stream);
}

// K3r: record the first K_SURFACES surfaces, accept the last.
extern "C" int esvo_traverse_record(HEAD_ARGS, TABLE_ARGS, OUT_ARGS, void* rec_count,
                                    void* rec_mats, void* rec_face, void* rec_uu, void* rec_vv,
                                    void* stream) {
  return launch<2>(batch(HEAD, OUTS, rec_count, rec_mats, rec_face, rec_uu, rec_vv),
                   alpha_tables(TABLES, nullptr, nullptr, nullptr), kNoShadow, nullptr, nullptr,
                   stream);
}

// K3s: the shadow walk.  `ts` may be null (the sun walk records no t).
extern "C" int esvo_traverse_shadow(HEAD_ARGS, TABLE_ARGS, const void* binary, const void* ior,
                                    const void* cur_mat, int strict, OUT_ARGS, void* rec_count,
                                    void* rec_mats, void* rec_uu, void* rec_vv, void* w, void* cm,
                                    void* ts, void* stream) {
  ShadowIO sh = {(const int*)cur_mat, strict, (float*)w, (int*)cm, (float*)ts};
  return launch<3>(batch(HEAD, OUTS, rec_count, rec_mats, nullptr, rec_uu, rec_vv),
                   alpha_tables(TABLES, nullptr, binary, ior), sh, nullptr, nullptr, stream);
}

// K2q, mode 1: the alpha accept with block models; `qo` receives the
// accepted quad surfaces.
extern "C" int esvo_traverse_alpha_models(HEAD_ARGS, TABLE_ARGS, const void* rejectable,
                                          const ModelTables* mt, const QuadOut* qo, OUT_ARGS,
                                          void* stream) {
  return launch<1>(batch(HEAD, OUTS, nullptr, nullptr, nullptr, nullptr, nullptr),
                   alpha_tables(TABLES, rejectable, nullptr, nullptr), kNoShadow, mt, qo, stream);
}

// K2q, mode 2: the recording walk with block models.
extern "C" int esvo_traverse_record_models(HEAD_ARGS, TABLE_ARGS, const ModelTables* mt,
                                           OUT_ARGS, void* rec_count, void* rec_mats,
                                           void* rec_face, void* rec_uu, void* rec_vv,
                                           void* stream) {
  return launch<2>(batch(HEAD, OUTS, rec_count, rec_mats, rec_face, rec_uu, rec_vv),
                   alpha_tables(TABLES, nullptr, nullptr, nullptr), kNoShadow, mt, nullptr, stream);
}

// K2q, mode 3: the shadow walk with block models.
extern "C" int esvo_traverse_shadow_models(HEAD_ARGS, TABLE_ARGS, const void* binary,
                                           const void* ior, const void* cur_mat, int strict,
                                           const ModelTables* mt, OUT_ARGS, void* rec_count,
                                           void* rec_mats, void* rec_uu, void* rec_vv, void* w,
                                           void* cm, void* ts, void* stream) {
  ShadowIO sh = {(const int*)cur_mat, strict, (float*)w, (int*)cm, (float*)ts};
  return launch<3>(batch(HEAD, OUTS, rec_count, rec_mats, nullptr, rec_uu, rec_vv),
                   alpha_tables(TABLES, nullptr, binary, ior), sh, mt, nullptr, stream);
}

extern "C" const char* esvo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
