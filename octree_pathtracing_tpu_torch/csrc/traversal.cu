// ESVO first-hit traversal of the packed sparse-voxel octree, one thread per
// ray, in four compile-time modes of one kernel body (`template <int MODE>`):
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
// Replaces: octree_pathtracing_tpu/ops/traversal.py `traverse` (:459) with
// its `_init`, `_step`, `_examine` and `_hit_info` (k_examine = 2,
// untiled), and, for the accept modes, the callback protocol of :563-596 —
// MODE 1 with render/hit.py `make_accept_fn` (:104) and
// `_leaf_alpha_classes` (:72), MODE 2 with diff/soft.py
// `_make_recording_accept` (:69) / `record_surfaces` (:96) over
// render/hit.py `_surface_of_candidate` (:155), MODE 3 with render/hit.py
// `make_shadow_accept_fn` (:223) and `shadow_state_init` (:187), all for
// scenes without block models.  The JAX version steps a whole ray batch in lockstep under
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
// This first version is simple and right; making it fast (stack in
// registers or shared memory, ray sorting, persistent threads) is later work.
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
// - The stack read at the pop scale is a direct local-array index (the
//   select chain of the JAX version was a TPU workaround).
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

#define MAX_STEPS 1000
#define MAX_SCALE 23
#define STACK_ROWS (MAX_SCALE + 1)
#define ACTIVE 0
#define CANDIDATE 1
#define MISS 2
#define VALUE_MASK 0x3FFFFFFF
#define EPSILON_F 1.1920929e-7f
#define ALPHA_EPSILON_F 5e-8f  // Ray::EPSILON, ops/shading.EPSILON
#define K_SURFACES 4

struct Ray {
  float ro[3], rd[3], t_coef[3], t_bias[3];
  int mirror;
};

struct State {
  float pos[3];
  int index, parent, scale;
  float scale_exp2, t_min, t_max, h;
  int status, cand;
  bool reject;
  int stack_idx[STACK_ROWS];
  float stack_t[STACK_ROWS];
};

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

// The surfaces a lane recorded (modes 2 and 3; w, cm and ts in mode 3 only).
struct Record {
  int count;
  int mat[K_SURFACES], face[K_SURFACES];
  float uu[K_SURFACES], vv[K_SURFACES], ts[K_SURFACES];
  float w;
  int cm;
};

__device__ __forceinline__ int child_word(int4 lo, int4 hi, int slot) {
  int4 q = (slot & 4) ? hi : lo;
  int s = slot & 3;
  return s == 0 ? q.x : (s == 1 ? q.y : (s == 2 ? q.z : q.w));
}

// One PUSH / ADVANCE / POP / hit decision against a fetched row.  Returns
// true when the lane did a same-parent ADVANCE (the row can be reused).
template <int MODE>
__device__ __forceinline__ bool examine(State& s, const Ray& r, int4 lo, int4 hi,
                                        int scale_base, float max_dst) {
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
    if (tc_max < s.h && rel >= 0 && rel < STACK_ROWS) {
      s.stack_idx[rel] = s.parent;
      s.stack_t[rel] = s.t_max;
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
  s.index = idx;
  s.parent = s.stack_idx[p_rel];
  s.t_max = s.stack_t[p_rel];
  s.scale = p_scale_c;
  s.scale_exp2 = __uint_as_float((uint32_t)(p_scale_c - MAX_SCALE + 127) << 23);
  s.h = 0.0f;
  return false;
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
  float rd_ax = r.rd[axis];
  face = axis * 2 + (int)(__float_as_uint(rd_ax) >> 31);
  int a1 = axis == 0 ? 2 : 0;
  int a2 = axis == 1 ? 2 : 1;
  uu = (r.ro[a1] + r.rd[a1] * tc_min - unm[a1]) / s.scale_exp2;
  vv = (r.ro[a2] + r.rd[a2] * tc_min - unm[a2]) / s.scale_exp2;
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

// The accept of a fresh candidate; false sends the lane back to ACTIVE.
template <int MODE>
__device__ __forceinline__ bool accept(const State& s, const Ray& r, const AlphaTables& tb,
                                       int strict, float inv_scale, Record& rec) {
  int face;
  float uu, vv, unm[3];
  hit_info(r, s, face, uu, vv, unm);
  int lv = min(max(s.cand, 0), tb.n_leaf - 1);
  if (MODE == 1 && !tb.rejectable[lv]) return true;  // no texel of it can reject
  // table indices clip like XLA's gathers (in range on any scene make_scene built)
  int mat = min(max(__ldg(tb.leaf_material + lv), 0), tb.n_mat - 1);
  if (MODE == 3) {
    float alpha = 1.0f;  // a binary-class leaf: a total blocker, no texel fetch
    if (!tb.binary[lv]) {
      int layer = min(max(__ldg(tb.texture_index + mat), 0), tb.n_layer - 1);
      alpha = texel_alpha(tb, layer, uu, vv);
      if (!(alpha > ALPHA_EPSILON_F)) return false;  // a hole: walk on
    }
    float w = rec.w * (1.0f - alpha);
    if (strict) {
      int cm = min(max(rec.cm, 0), tb.n_mat - 1);
      if (__ldg(tb.ior + cm) != __ldg(tb.ior + mat)) w = 0.0f;
    }
    float t_world = s.t_min * inv_scale;
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
    rec.w = w;
    rec.cm = mat;
    return rec.count >= K_SURFACES || w <= 0.0f;
  }
  int layer = min(max(__ldg(tb.texture_index + mat), 0), tb.n_layer - 1);
  bool is_surface = texel_alpha(tb, layer, uu, vv) > ALPHA_EPSILON_F;
  if (MODE == 1) return is_surface;
  if (!is_surface) return false;
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

template <int MODE>
__global__ void esvo_traverse_kernel(
    const int4* __restrict__ nodes, int root, int depth, float octree_scale,
    float inv_scale, float max_dst, const float* __restrict__ origins,
    const float* __restrict__ dirs, const uint8_t* __restrict__ active, int n,
    AlphaTables tb, ShadowIO sh, uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
    int* __restrict__ face_out, float* __restrict__ uv_out,
    int* __restrict__ leaf_out, float* __restrict__ vpos_out,
    float* __restrict__ vsize_out, int* __restrict__ steps_out,
    int* __restrict__ rec_count, int* __restrict__ rec_mats,
    int* __restrict__ rec_face, float* __restrict__ rec_uu,
    float* __restrict__ rec_vv) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int scale_base = MAX_SCALE - depth;

  // ---- _init: the ray in the [1, 2) cube, mirrored to negative directions
  Ray r;
  int pos_dir = 0;
  for (int a = 0; a < 3; ++a) {
    r.ro[a] = origins[3 * i + a] * octree_scale + 1.0f;
    float d = dirs[3 * i + a];
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
  s.parent = root;
  s.scale = MAX_SCALE - 1;
  s.scale_exp2 = 0.5f;
  s.h = s.t_max;
  s.status = (active == nullptr || active[i]) ? ACTIVE : MISS;
  s.cand = 0;
  s.reject = false;
  for (int k = 0; k <= depth; ++k) {
    s.stack_idx[k] = 0;
    s.stack_t[k] = 0.0f;
  }
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

  // ---- the walk: one row fetch per step, up to two decisions on it, then
  // the accept of a fresh candidate
  int steps = 0;
  while (s.status == ACTIVE && steps < MAX_STEPS) {
    const int4* row = nodes + 2 * (size_t)s.parent;
    int4 lo = __ldg(row);
    int4 hi = __ldg(row + 1);
    if (examine<MODE>(s, r, lo, hi, scale_base, max_dst)) {
      examine<MODE>(s, r, lo, hi, scale_base, max_dst);
    }
    if (MODE != 0 && s.status == CANDIDATE && !accept<MODE>(s, r, tb, sh.strict, inv_scale, rec)) {
      s.status = ACTIVE;
      s.reject = true;
    }
    ++steps;
  }

  int face;
  float uu, vv, unm[3];
  hit_info(r, s, face, uu, vv, unm);
  bool hit = s.status == CANDIDATE;
  hit_out[i] = hit;
  t_out[i] = hit ? s.t_min * inv_scale : __int_as_float(0x7f800000);
  face_out[i] = hit ? face : -1;
  uv_out[2 * i] = uu;
  uv_out[2 * i + 1] = vv;
  leaf_out[i] = hit ? s.cand : 0;
  for (int a = 0; a < 3; ++a) vpos_out[3 * i + a] = (unm[a] - 1.0f) * inv_scale;
  vsize_out[i] = s.scale_exp2 * inv_scale;
  steps_out[i] = steps;
  if (MODE == 2) {
    rec_count[i] = rec.count;
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {
      rec_mats[k * n + i] = rec.mat[k];
      rec_face[k * n + i] = rec.face[k];
      rec_uu[k * n + i] = rec.uu[k];
      rec_vv[k * n + i] = rec.vv[k];
    }
  }
  if (MODE == 3) {
    rec_count[i] = rec.count;
    sh.w[i] = rec.w;
    sh.cm[i] = rec.cm;
#pragma unroll
    for (int k = 0; k < K_SURFACES; ++k) {
      rec_mats[k * n + i] = rec.mat[k];
      rec_uu[k * n + i] = rec.uu[k];
      rec_vv[k * n + i] = rec.vv[k];
      if (sh.ts != nullptr) sh.ts[k * n + i] = rec.ts[k];
    }
  }
}

template <int MODE>
static int launch(const void* nodes, int root, int depth, float octree_scale,
                  float inv_scale, float max_dst, const void* origins,
                  const void* dirs, const void* active, int n, AlphaTables tb,
                  ShadowIO sh, void* hit, void* t, void* face, void* uv, void* leaf,
                  void* vpos, void* vsize, void* steps, void* rec_count,
                  void* rec_mats, void* rec_face, void* rec_uu, void* rec_vv,
                  void* stream) {
  if (n == 0) return 0;
  if (depth < 1 || depth > MAX_SCALE) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  esvo_traverse_kernel<MODE><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)nodes, root, depth, octree_scale, inv_scale, max_dst,
      (const float*)origins, (const float*)dirs, (const uint8_t*)active, n, tb, sh,
      (uint8_t*)hit, (float*)t, (int*)face, (float*)uv, (int*)leaf,
      (float*)vpos, (float*)vsize, (int*)steps, (int*)rec_count,
      (int*)rec_mats, (int*)rec_face, (float*)rec_uu, (float*)rec_vv);
  return (int)cudaGetLastError();
}

// K1: no accept.
extern "C" int esvo_traverse(const void* nodes, int root, int depth,
                             float octree_scale, float inv_scale, float max_dst,
                             const void* origins, const void* dirs,
                             const void* active, int n, void* hit, void* t,
                             void* face, void* uv, void* leaf, void* vpos,
                             void* vsize, void* steps, void* stream) {
  AlphaTables tb = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0};
  ShadowIO sh = {nullptr, 0, nullptr, nullptr, nullptr};
  return launch<0>(nodes, root, depth, octree_scale, inv_scale, max_dst, origins,
                   dirs, active, n, tb, sh, hit, t, face, uv, leaf, vpos, vsize,
                   steps, nullptr, nullptr, nullptr, nullptr, nullptr, stream);
}

// K2: the in-loop alpha accept.
extern "C" int esvo_traverse_alpha(
    const void* nodes, int root, int depth, float octree_scale, float inv_scale,
    float max_dst, const void* origins, const void* dirs, const void* active,
    int n, const void* leaf_material, int n_leaf, const void* texture_index,
    int n_mat, const void* atlas, int n_layer, int atlas_h, int atlas_w,
    const void* sizes, const void* rejectable, void* hit, void* t, void* face,
    void* uv, void* leaf, void* vpos, void* vsize, void* steps, void* stream) {
  AlphaTables tb = {(const int*)leaf_material, (const int*)texture_index,
                    (const float*)atlas, (const int*)sizes,
                    (const uint8_t*)rejectable, nullptr, nullptr, n_leaf, n_mat,
                    n_layer, atlas_h, atlas_w};
  ShadowIO sh = {nullptr, 0, nullptr, nullptr, nullptr};
  return launch<1>(nodes, root, depth, octree_scale, inv_scale, max_dst, origins,
                   dirs, active, n, tb, sh, hit, t, face, uv, leaf, vpos, vsize,
                   steps, nullptr, nullptr, nullptr, nullptr, nullptr, stream);
}

// K3r: record the first K_SURFACES surfaces, accept the last.
extern "C" int esvo_traverse_record(
    const void* nodes, int root, int depth, float octree_scale, float inv_scale,
    float max_dst, const void* origins, const void* dirs, const void* active,
    int n, const void* leaf_material, int n_leaf, const void* texture_index,
    int n_mat, const void* atlas, int n_layer, int atlas_h, int atlas_w,
    const void* sizes, void* hit, void* t, void* face, void* uv, void* leaf,
    void* vpos, void* vsize, void* steps, void* rec_count, void* rec_mats,
    void* rec_face, void* rec_uu, void* rec_vv, void* stream) {
  AlphaTables tb = {(const int*)leaf_material, (const int*)texture_index,
                    (const float*)atlas, (const int*)sizes, nullptr, nullptr,
                    nullptr, n_leaf, n_mat, n_layer, atlas_h, atlas_w};
  ShadowIO sh = {nullptr, 0, nullptr, nullptr, nullptr};
  return launch<2>(nodes, root, depth, octree_scale, inv_scale, max_dst, origins,
                   dirs, active, n, tb, sh, hit, t, face, uv, leaf, vpos, vsize,
                   steps, rec_count, rec_mats, rec_face, rec_uu, rec_vv, stream);
}

// K3s: the shadow walk.  `ts` may be null (the sun walk records no t).
extern "C" int esvo_traverse_shadow(
    const void* nodes, int root, int depth, float octree_scale, float inv_scale,
    float max_dst, const void* origins, const void* dirs, const void* active,
    int n, const void* leaf_material, int n_leaf, const void* texture_index,
    int n_mat, const void* atlas, int n_layer, int atlas_h, int atlas_w,
    const void* sizes, const void* binary, const void* ior, const void* cur_mat,
    int strict, void* hit, void* t, void* face, void* uv, void* leaf, void* vpos,
    void* vsize, void* steps, void* rec_count, void* rec_mats, void* rec_uu,
    void* rec_vv, void* w, void* cm, void* ts, void* stream) {
  AlphaTables tb = {(const int*)leaf_material, (const int*)texture_index,
                    (const float*)atlas, (const int*)sizes, nullptr,
                    (const uint8_t*)binary, (const float*)ior, n_leaf, n_mat,
                    n_layer, atlas_h, atlas_w};
  ShadowIO sh = {(const int*)cur_mat, strict, (float*)w, (int*)cm, (float*)ts};
  return launch<3>(nodes, root, depth, octree_scale, inv_scale, max_dst, origins,
                   dirs, active, n, tb, sh, hit, t, face, uv, leaf, vpos, vsize,
                   steps, rec_count, rec_mats, nullptr, rec_uu, rec_vv, stream);
}

extern "C" const char* esvo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
