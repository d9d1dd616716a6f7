// Kernel K4: hit resolve and shade, forward and backward.
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
// K2q's mode 1, or the nearest analytic primitive where it is nearer); the
// material row and
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
// The primitive: a scene with analytic primitives takes the forward's
// variant with K7's scan folded in (prims.cuh; kScan), which scans the
// lane's own ray (a dead lane sees none, as the traversal gives it no hit)
// in place of reading the hit that a K7 launch wrote: K7's launch leaves
// the bounce, and its 29 bytes a lane no longer go through device memory.
// The scan runs before the block's barrier, its few table words through
// __ldg, so that its arithmetic overlaps the lane's other loads and the
// staging of the tables; scanning after the barrier from a copy staged in
// shared memory measured 0.002 ms slower a bounce on the analytic scene
// (PERF.md §6).  Both build with -fmad=false, so the scan equals K7's bit
// for bit.  A caller that hands it K7's hit gets the variant without the
// scan, which is also every scene's without primitives: the kernel as it
// was before the fold.
//
// The backward, per lane: the gradients of the incoming throughput and of
// the albedo from the cotangents of the new throughput, the new radiance
// and the hand-off albedo; the albedo gradient goes to the texel the lane
// read, the emission gradient to its material's emittance.  After a
// compaction (K5) the throughput's gradient and the radiance's
// pass-through are stored at row src[i], the row the lane held before it:
// compact_backward's gather, folded into these stores (every row is
// written, so nothing is filled).
//
// The final unpermute: on a frame's last bounce of a scene that samples no
// light, this forward writes the frame's final radiance, and it stores row
// i's at row idx[i] (the lane's own index, which K5 carries): the scatter
// that put the radiance back in the lanes' order after the bounce loop,
// folded into the store (every row i is stored, the dead lanes' radiance
// passed through, so every output row is written once).  Its backward reads
// the radiance cotangent at row idx[i], the unpermute's gather folded into
// the load.  The other outputs stay in row order: nothing reads them after
// the last bounce.
//
// What bounds them: bytes.  Per lane the forward reads about 170 bytes (the
// state, 21 uniforms, the hit) and a texel and a material row from tables
// that stay in L2, and writes about 120 (the state, the hand-off, the
// residual); its arithmetic (a few dozen transcendental calls on the
// importance path) is far below the card's float32 rate.  But each lane's
// time is one dependent chain: its hit, then the leaf's material, the
// material row, the uniforms its lobe reads, the texel, then the lobe's
// arithmetic.  The design cuts links from that chain:
//
// - Blocks of 128 threads, at most SMs x resident blocks of them, each
//   walking its tiles of lanes in a grid-stride loop.
// - Before the block's one barrier, every load that does not depend on
//   another is in flight together: the lane's own words (state, hit, and
//   the uniform words of slots 0-7, one or two 32-byte sectors of its row,
//   where the bounce may scatter), the sun's parameters, and, where they fit
//   K4_TABLE_SMEM_BUDGET, the 7 material columns, the leaf materials and
//   the per-layer atlas sizes, staged in shared memory.  After it the leaf's
//   material, the material row and the layer's size are shared-memory
//   reads, and the texel is the one dependent load left.  Above the budget
//   the lanes read the tables through __ldg.
// - Measured and dropped (PERF.md §6): blocks of 32 and 64 on the
//   late bounces (to put work on every SM at 4,072 lanes) and the lane rows
//   staged through shared memory as 16-byte vectors; both were slower on
//   the card than blocks of 128 with each lane reading its own rows.
//
// The backward's sums: each warp combines its lanes that read the same
// texel (__match_any_sync; the group's first lane sums its peers' values
// in lane order, in float64) and adds once per channel to the dense
// gradient with a float atomicAdd; the emittance's likewise by material.
// A minecraft atlas has few texels and the terrain few materials, so tens
// of thousands of lanes per bounce add into the same few L2 addresses; the
// warp's combine divides those atomics by the lanes a warp shares them
// among.  Measured and dropped: per-block float64 (or float32) partial sums
// of the whole atlas in shared memory, flushed once per entry and block;
// zeroing and flushing the table cost more than the atomics they saved.
// The dense gradients are zero-filled by the caller, one fill for both.
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
// arithmetic (torch_rounding.cuh): a sum over a last axis of 3 is
// (a0 + a2) + a1 (its reduction splits the axis over two threads); a
// division by a Python number is a multiply by the reciprocal rounded to
// float; a comparison with a Python number rounds it to float; `%` is fmodf
// with torch.remainder's sign rule; `.to(torch.int32)` truncates.  The hit
// point is the float64 multiply-add of ops/geometry.fma.  The sun disk's
// three dot products are matrix-vector products on the card (cuBLAS), taken
// here as the chain of fused multiply-adds.  The backward's sums take an
// order that the schedule sets, as the twin's index_put with accumulate
// does on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "prims.cuh"
#include "torch_rounding.cuh"

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
#define U_HEAD 8  // slots 0-7, read together

// the residual's lane code (ops/shade.py)
#define CODE_MISS 1
#define CODE_EMIT 2
#define LOBE_SHIFT 2
#define LOBE_NONE 0
#define LOBE_METAL 1
#define LOBE_DIFFUSE 2
#define LOBE_ENTERS 3

// The forward's shared-memory budget (bytes per block) for its staged
// tables: the 7 material columns, the leaf materials, the per-layer sizes.
#define K4_TABLE_SMEM_BUDGET 16384

constexpr int kThreads = 128;  // the forward's blocks
constexpr int kBwdThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpScratchWords = 32 * 5;  // the backward's per-warp keys and values

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
  int n_mat;
  const float* atlas;  // (T, H, W, 4)
  const int* sizes;    // (T, 2) per-layer (h, w), or null for a uniform atlas
  int n_layers, atlas_h, atlas_w;
  SunParams sun;
  PrimTables prims;  // the scene's analytic primitives (counts 0 without them)
  float prim_t_max;  // the scan's t_max (models/scene.MAX_DIST)
};

struct ShadeFlags {
  int is_first, may_scatter, importance, diffuse_sun, draw_texture, emission;
  int scan;  // the forward scans the primitives itself (K7 folded in), reading no S_P_* slot
};

// The per-lane pointers of one forward call, in the order of the flat slot
// array the wrapper passes (ops/shade.py IN_SLOTS, STRIDE_SLOTS,
// OUT_SLOTS): inputs, row strides, outputs.
enum LaneSlot {
  S_ORIGIN, S_DIR, S_THROUGHPUT, S_RADIANCE, S_ACTIVE, S_SPECULAR, S_CUR_MAT, S_U,
  S_HIT, S_T, S_FACE_ID, S_UV, S_LEAF_VALUE,
  S_Q_FOUND, S_Q_MAT, S_Q_UV, S_Q_NORMAL, S_Q_T,  // the quad surfaces: null without quad models
  S_P_HIT, S_P_T, S_P_MAT, S_P_UV, S_P_NORMAL,    // the primitive hit: null without primitives
  S_IDX,  // the final bounce's lane order: row i's radiance is stored at row idx[i]; null: at row i
  S_ORIGIN_STRIDE, S_DIR_STRIDE, S_THROUGHPUT_STRIDE, S_RADIANCE_STRIDE, S_U_STRIDE,
  S_OUT_ORIGIN, S_OUT_DIR, S_OUT_THROUGHPUT, S_OUT_RADIANCE, S_OUT_ACTIVE, S_OUT_SPECULAR, S_OUT_CUR_MAT,
  S_OUT_ALBEDO, S_OUT_HITPOINT, S_OUT_NORMAL, S_OUT_MAT, S_OUT_DIFFUSE_ON,
  S_OUT_RESID_I, S_OUT_RESID_F,  // (B, 3) each; null without a gradient
  N_LANE_SLOTS
};

// the backward's slots (ops/shade.py BACKWARD_SLOTS)
enum BackwardSlot {
  B_G_THROUGHPUT, B_G_RADIANCE, B_G_ALBEDO, B_ALBEDO, B_THROUGHPUT, B_RESID_I, B_RESID_F, B_EMITTANCE,
  B_D_THROUGHPUT, B_D_ATLAS, B_D_EMITTANCE,
  B_SRC, B_D_RADIANCE,  // after a compaction: row i's gradients go to lane src[i]; null: to row i
  B_IDX,  // the final bounce's lane order: row i's radiance cotangent is read at row idx[i]; null: at row i
  N_BACKWARD_SLOTS
};

struct ForwardParams {
  ShadeTables tb;
  ShadeFlags fl;
  const void* in[S_ORIGIN_STRIDE];  // the input slots
  long long stride[4];              // origin, dir, throughput, radiance (floats per row)
  long long u_stride;
  void* out[N_LANE_SLOTS - S_OUT_ORIGIN];
  int n;
  int tables_smem;  // the tables staged in shared memory
  int table_words;  // their words, a multiple of 4
};

struct BackwardParams {
  const float* g_tp;
  const float* g_rad;
  const float* g_alb;
  const float* albedo;
  const float* throughput;
  const int* resid_i;
  const float* resid_f;
  const float* emittance;
  float* d_tp;
  float* d_atlas;
  float* d_emit;
  const int* src;  // null: the gradients of row i go to row i
  float* d_rad;    // the radiance cotangent moved to src or from idx (null: not wanted, or neither given)
  const int* idx;  // null: the radiance cotangent of row i is read at row i
  int n;
};

// the sun's parameters in shared memory
struct SunShared {
  float azimuth, altitude, radius, color[4], luminosity, chance, sample_radius;
  float sw[3], su[3], sv[3], apparent[3];
};
constexpr int kSunWords = 24;  // sizeof(SunShared) / 4 = 22, padded to 16 bytes
static_assert(sizeof(SunShared) <= kSunWords * 4, "SunShared outgrew its words");

__device__ __forceinline__ float sgnf(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

__device__ void load_sun(const SunParams& p, SunShared& s) {
  s.azimuth = __ldg(p.azimuth);
  s.altitude = __ldg(p.altitude);
  s.radius = __ldg(p.radius);
  for (int c = 0; c < 4; ++c) s.color[c] = __ldg(p.color + c);
  s.luminosity = __ldg(p.luminosity);
  s.chance = __ldg(p.chance);
  s.sample_radius = __ldg(p.sample_radius);
  for (int c = 0; c < 3; ++c) {
    s.sw[c] = __ldg(p.sw + c);
    s.su[c] = __ldg(p.su + c);
    s.sv[c] = __ldg(p.sv + c);
    s.apparent[c] = __ldg(p.apparent + c);
  }
}

__device__ __forceinline__ float tdot(const float a[3], const float b[3]) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// a (B, 3) @ (3,) matrix-vector product (cuBLAS): a chain of fused multiply-adds
__device__ __forceinline__ float mv3(const float a[3], const float b[3]) {
  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

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
// returns the weight.  `u` holds slots 0-7; the redraws are read from
// `u_row` where the rejection needs them.
__device__ float diffuse_dir(const float n[3], const SunShared& sun, const float* u, const float* u_row,
                             bool importance, float out[3]) {
  float x1 = u[U_X1], x2 = u[U_X2];
  float r = sqrtf(x1);
  float theta = x2 * TWO_PI_F;
  float tx = r * cosf(theta);
  float ty = r * sinf(theta);
  float weight = 1.0f;

  if (importance) {
    float alt_f = sun.altitude, az = sun.azimuth;
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

    float cr = sun.radius * sun.sample_radius;
    float chance = sun.chance;
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
              rr = sqrtf(__ldg(u_row + U_REDRAW0 + 2 * k));
              rtheta = __ldg(u_row + U_REDRAW0 + 2 * k + 1) * TWO_PI_F;
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
__device__ bool in_sun_disk(const SunShared& sun, const float d[3]) {
  float cos_sw = mv3(d, sun.sw);
  float width = sun.radius * 4.0f;
  float width2 = width * 2.0f;
  float a = (HALF_PI_F - acosf(clampf(mv3(d, sun.su), -1.0f, 1.0f))) + width;
  float b = (HALF_PI_F - acosf(clampf(mv3(d, sun.sv), -1.0f, 1.0f))) + width;
  return cos_sw >= 0.5f && a >= 0.0f && a < width2 && b >= 0.0f && b < width2;
}

// pathtracer.sky_radiance: the specular path's sun (add_sun_color) on the
// primary bounce and after a specular one, the diffuse path's otherwise
__device__ void sky_radiance(const SunShared& sun, const ShadeFlags& fl, const float d[3],
                             bool specular_path, float out[3]) {
  const float sky[3] = {0.5f, 0.7f, 1.0f};
  for (int c = 0; c < 3; ++c) out[c] = sky[c];
  if (specular_path) {
    if (fl.draw_texture && in_sun_disk(sun, d))
      for (int c = 0; c < 3; ++c) out[c] = sky[c] + sun.apparent[c] * 10.0f;
  } else if (fl.diffuse_sun && in_sun_disk(sun, d)) {
    float lum = sun.luminosity;
    for (int c = 0; c < 3; ++c) out[c] = sky[c] + (sun.color[c] * 10.0f) * lum;
  }
}

// ---- the small tables: shared memory where they fit the budget, else __ldg

// the staged layout (words): 7 material columns of n_mat (ior, specular,
// emittance, roughness, metalness, flags, texture_index), the leaf
// materials, then the per-layer sizes
enum { M_IOR, M_SPECULAR, M_EMITTANCE, M_ROUGHNESS, M_METALNESS, M_FLAGS, M_TEXTURE_INDEX, N_MAT_COLS };

__host__ __device__ __forceinline__ int table_words(const ShadeTables& tb) {
  int w = N_MAT_COLS * tb.n_mat + tb.n_leaf + (tb.sizes != nullptr ? 2 * tb.n_layers : 0);
  return (w + 3) & ~3;
}

struct Tables {
  const ShadeTables& tb;
  const float* s;  // the staged words, or null

  __device__ float colf(int k, const float* g, int m) const { return s ? s[k * tb.n_mat + m] : __ldg(g + m); }
  __device__ int coli(int k, const int* g, int m) const {
    return s ? __float_as_int(s[k * tb.n_mat + m]) : __ldg(g + m);
  }
  __device__ int leaf_material(int leaf) const {
    int k = min(max(leaf, 0), tb.n_leaf - 1);
    return s ? __float_as_int(s[N_MAT_COLS * tb.n_mat + k]) : __ldg(tb.leaf_material + k);
  }
  __device__ int size(int layer, int c) const {  // (h, w) of a layer of a per-layer atlas
    return s ? __float_as_int(s[N_MAT_COLS * tb.n_mat + tb.n_leaf + 2 * layer + c]) : __ldg(tb.sizes + 2 * layer + c);
  }
};

__device__ void stage_tables(const ShadeTables& tb, float* s, int tid, int nt) {
  const int m = tb.n_mat;
  for (int k = tid; k < m; k += nt) {
    s[M_IOR * m + k] = __ldg(tb.ior + k);
    s[M_SPECULAR * m + k] = __ldg(tb.specular + k);
    s[M_EMITTANCE * m + k] = __ldg(tb.emittance + k);
    s[M_ROUGHNESS * m + k] = __ldg(tb.roughness + k);
    s[M_METALNESS * m + k] = __ldg(tb.metalness + k);
    s[M_FLAGS * m + k] = __int_as_float(__ldg(tb.flags + k));
    s[M_TEXTURE_INDEX * m + k] = __int_as_float(__ldg(tb.texture_index + k));
  }
  float* leaf = s + N_MAT_COLS * m;
  for (int k = tid; k < tb.n_leaf; k += nt) leaf[k] = __int_as_float(__ldg(tb.leaf_material + k));
  if (tb.sizes != nullptr)
    for (int k = tid; k < 2 * tb.n_layers; k += nt) leaf[tb.n_leaf + k] = __int_as_float(__ldg(tb.sizes + k));
}

// ---- the forward, one lane

// What a lane reads of its own before the block's barrier, so that these
// loads are in flight together with the tables and the sun.
struct LaneIn {
  bool active, specular, oct_hit, p_hit;
  int cur_mat, face, leaf;
  float huv[2], t_hit;
  float o[3], d[3], tp[3], rad[3];
  float u[U_HEAD];  // slots 0-7 where the bounce may scatter
};

__device__ __forceinline__ void load_row(const ForwardParams& p, int k, long long i, float v[3]) {
  const float* row = static_cast<const float*>(p.in[k]) + i * p.stride[k];
  for (int c = 0; c < 3; ++c) v[c] = __ldg(row + c);
}

__device__ __forceinline__ void load_lane(const ForwardParams& p, long long i, LaneIn& L) {
  load_row(p, S_ORIGIN, i, L.o);
  load_row(p, S_DIR, i, L.d);
  load_row(p, S_THROUGHPUT, i, L.tp);
  load_row(p, S_RADIANCE, i, L.rad);
  L.active = static_cast<const uint8_t*>(p.in[S_ACTIVE])[i] != 0;
  L.specular = static_cast<const uint8_t*>(p.in[S_SPECULAR])[i] != 0;
  L.cur_mat = static_cast<const int*>(p.in[S_CUR_MAT])[i];
  L.oct_hit = static_cast<const uint8_t*>(p.in[S_HIT])[i] != 0;
  const uint8_t* p_hit = static_cast<const uint8_t*>(p.in[S_P_HIT]);
  L.p_hit = p_hit != nullptr && p_hit[i] != 0;
  L.face = static_cast<const int*>(p.in[S_FACE_ID])[i];
  const float* uv = static_cast<const float*>(p.in[S_UV]);
  L.huv[0] = uv[2 * i];
  L.huv[1] = uv[2 * i + 1];
  L.t_hit = static_cast<const float*>(p.in[S_T])[i];
  L.leaf = static_cast<const int*>(p.in[S_LEAF_VALUE])[i];
  const float* u_row = static_cast<const float*>(p.in[S_U]) + i * p.u_stride;
  for (int k = 0; k < U_HEAD; ++k) L.u[k] = p.fl.may_scatter ? __ldg(u_row + k) : 0.0f;
}

__device__ __forceinline__ void store3(void* out, long long i, float v0, float v1, float v2) {
  float* t = static_cast<float*>(out) + 3 * i;
  t[0] = v0;
  t[1] = v1;
  t[2] = v2;
}

// Shades lane `i` from what load_lane read.  kScan: with the nearest
// primitive `scanned` of the lane's ray, in place of reading K7's hit.
template <bool kScan>
__device__ void shade_lane(const ForwardParams& p, const Tables& tab, const PrimHit& scanned, const SunShared& sun,
                           long long i, const LaneIn& L) {
  const ShadeTables& tb = p.tb;
  const ShadeFlags& fl = p.fl;
  // where the new radiance goes: idx[i] on a frame's last bounce, else i
  // (read here, after the block's barrier, so that no register holds it
  // across the scan and the staging)
  const int* idx = static_cast<const int*>(p.in[S_IDX]);
  const long long rad_row = idx != nullptr ? (long long)__ldg(idx + i) : i;
  float o[3], d[3], tp[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = L.o[c];
    d[c] = L.d[c];
    tp[c] = L.tp[c];
    rad[c] = L.rad[c];
  }
  bool specular = L.specular;
  int cur_mat = L.cur_mat;
  bool p_hit = L.p_hit;
  const PrimHit& ph = scanned;
  if (kScan) p_hit = ph.t != __int_as_float(0x7f800000);
  const bool any_hit = L.oct_hit || p_hit;
  const bool miss = L.active && !any_hit;
  const bool can_scatter = fl.may_scatter && L.active && any_hit;
  const float* u = L.u;
  // the sky on a miss
  float sky[3] = {0.0f, 0.0f, 0.0f};
  if (miss) sky_radiance(sun, fl, d, fl.is_first || specular, sky);
  for (int c = 0; c < 3; ++c) rad[c] = rad[c] + (miss ? tp[c] * sky[c] : 0.0f);

  // resolve: the entry face's normal, uv and t; the leaf's or the model's
  // material; a quad model's quad; the nearer primitive
  int face = min(max(L.face, 0), 5);
  float sgn = (face & 1) ? 1.0f : -1.0f;  // selects: no register array indexed at run time
  float nrm[3] = {face >> 1 == 0 ? sgn : 0.0f, face >> 1 == 1 ? sgn : 0.0f, face >> 1 == 2 ? sgn : 0.0f};
  float huv[2] = {L.huv[0], L.huv[1]};
  float t_hit = L.t_hit;
  int mat;
  if (tb.leaf_model == nullptr) {
    mat = tab.leaf_material(L.leaf);
  } else {
    int model = __ldg(tb.leaf_model + min(max(L.leaf, 0), tb.n_leaf_model - 1));
    mat = __ldg(tb.face_material + 6 * model + face);
    const uint8_t* q_found = static_cast<const uint8_t*>(p.in[S_Q_FOUND]);
    if (q_found != nullptr && q_found[i]) {
      const float* q_uv = static_cast<const float*>(p.in[S_Q_UV]);
      const float* q_normal = static_cast<const float*>(p.in[S_Q_NORMAL]);
      mat = static_cast<const int*>(p.in[S_Q_MAT])[i];
      huv[0] = q_uv[2 * i];
      huv[1] = q_uv[2 * i + 1];
      for (int c = 0; c < 3; ++c) nrm[c] = q_normal[3 * i + c];
      t_hit = static_cast<const float*>(p.in[S_Q_T])[i];
    }
  }
  if (p_hit) {
    float p_t = kScan ? ph.t : static_cast<const float*>(p.in[S_P_T])[i];
    if (p_t < (L.oct_hit ? t_hit : __int_as_float(0x7f800000))) {
      if (kScan) {
        mat = ph.mat;
        huv[0] = ph.u;
        huv[1] = ph.v;
        for (int c = 0; c < 3; ++c) nrm[c] = ph.n[c];
      } else {
        const float* p_uv = static_cast<const float*>(p.in[S_P_UV]);
        const float* p_normal = static_cast<const float*>(p.in[S_P_NORMAL]);
        mat = static_cast<const int*>(p.in[S_P_MAT])[i];
        huv[0] = p_uv[2 * i];
        huv[1] = p_uv[2 * i + 1];
        for (int c = 0; c < 3; ++c) nrm[c] = p_normal[3 * i + c];
      }
      t_hit = p_t;
    }
  }

  // the material row and the nearest texel
  float ior1 = tab.colf(M_IOR, tb.ior, mat), spec = tab.colf(M_SPECULAR, tb.specular, mat);
  float emit = tab.colf(M_EMITTANCE, tb.emittance, mat);
  float rough = tab.colf(M_ROUGHNESS, tb.roughness, mat), metal = tab.colf(M_METALNESS, tb.metalness, mat);
  int mflags = tab.coli(M_FLAGS, tb.flags, mat), layer = tab.coli(M_TEXTURE_INDEX, tb.texture_index, mat);
  int t_h = tb.atlas_h, t_w = tb.atlas_w;
  if (tb.sizes != nullptr) {
    t_h = tab.size(layer, 0);
    t_w = tab.size(layer, 1);
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
  float ior2 = tab.colf(M_IOR, tb.ior, cur_mat);
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
      const float* u_row = static_cast<const float*>(p.in[S_U]) + i * p.u_stride;
      diff_w = diffuse_dir(nrm, sun, u, u_row, fl.importance, nd);
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

  void* const* out = p.out;
  store3(out[S_OUT_ORIGIN - S_OUT_ORIGIN], i, o[0], o[1], o[2]);
  store3(out[S_OUT_DIR - S_OUT_ORIGIN], i, d[0], d[1], d[2]);
  store3(out[S_OUT_THROUGHPUT - S_OUT_ORIGIN], i, tp[0], tp[1], tp[2]);
  store3(out[S_OUT_RADIANCE - S_OUT_ORIGIN], rad_row, rad[0], rad[1], rad[2]);
  store3(out[S_OUT_HITPOINT - S_OUT_ORIGIN], i, hp[0], hp[1], hp[2]);
  store3(out[S_OUT_NORMAL - S_OUT_ORIGIN], i, nrm[0], nrm[1], nrm[2]);
  if (out[S_OUT_RESID_I - S_OUT_ORIGIN] != nullptr) {
    int* ri = static_cast<int*>(out[S_OUT_RESID_I - S_OUT_ORIGIN]) + 3 * i;
    ri[0] = texel;
    ri[1] = mat;
    ri[2] = (miss ? CODE_MISS : 0) | (emit_on ? CODE_EMIT : 0) | (lobe << LOBE_SHIFT);
    store3(out[S_OUT_RESID_F - S_OUT_ORIGIN], i, miss ? sky[0] : diff_w, sky[1], sky[2]);
  }
  static_cast<uint8_t*>(out[S_OUT_ACTIVE - S_OUT_ORIGIN])[i] = can_scatter;
  static_cast<uint8_t*>(out[S_OUT_SPECULAR - S_OUT_ORIGIN])[i] = specular;
  static_cast<int*>(out[S_OUT_CUR_MAT - S_OUT_ORIGIN])[i] = cur_mat;
  reinterpret_cast<float4*>(out[S_OUT_ALBEDO - S_OUT_ORIGIN])[i] = alb;
  static_cast<int*>(out[S_OUT_MAT - S_OUT_ORIGIN])[i] = mat;
  static_cast<uint8_t*>(out[S_OUT_DIFFUSE_ON - S_OUT_ORIGIN])[i] = can_scatter && do_diff;
}

// kScan: the variant with K7's scan folded in (a scene with primitives);
// without it, the kernel of a scene with none, or of a caller that hands it
// K7's hit.
template <bool kScan>
__global__ void __launch_bounds__(kThreads) shade_forward_kernel(const __grid_constant__ ForwardParams p) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  SunShared& sun = *reinterpret_cast<SunShared*>(smem);
  float* staged = smem + kSunWords;
  const Tables tab{p.tb, p.tables_smem ? staged : nullptr};

  // every thread runs every tile of its block, so the barrier is uniform
  bool first = true;
  for (long long base = (long long)blockIdx.x * nt; base < p.n; base += (long long)gridDim.x * nt) {
    const long long i = base + tid;
    const bool live = i < p.n;
    LaneIn L;
    if (live) load_lane(p, i, L);
    // the scan of a live lane's ray, before the barrier: its arithmetic
    // beside the lane's other loads and the staging of the tables (a dead
    // lane sees no primitive, as the traversal gives it no hit)
    PrimHit ph;
    if (kScan) {
      if (live && L.active) prim_scan(p.tb.prims, L.o, L.d, p.tb.prim_t_max, ph);
      else prim_miss(ph);
    }
    if (first) {  // the sun and the tables, while the lane's own loads are in flight
      if (tid == nt - 1) load_sun(p.tb.sun, sun);
      if (p.tables_smem) stage_tables(p.tb, staged, tid, nt);
      __syncthreads();
      first = false;
    }
    if (live) shade_lane<kScan>(p, tab, ph, sun, i, L);
  }
}

// ---- the backward

// One lane's gradients (ops/shade.py `shade_backward_reference` written
// out): a null cotangent is zero, a null gradient is not wanted.
__device__ void backward_lane(const BackwardParams& p, long long i, float da[4], float& de, int& texel, int& mat,
                              bool& emit_on) {
  texel = p.resid_i[3 * i];
  mat = p.resid_i[3 * i + 1];
  int code = p.resid_i[3 * i + 2];
  bool miss = (code & CODE_MISS) != 0;
  emit_on = (code & CODE_EMIT) != 0;
  int lobe = code >> LOBE_SHIFT;
  float4 alb = reinterpret_cast<const float4*>(p.albedo)[i];
  float a[4] = {alb.x, alb.y, alb.z, alb.w};
  float tp[3], dt[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 4; ++c) da[c] = 0.0f;
  for (int c = 0; c < 3; ++c) tp[c] = p.throughput[3 * i + c];
  if (p.g_alb != nullptr)
    for (int c = 0; c < 4; ++c) da[c] = p.g_alb[4 * i + c];
  de = 0.0f;
  // the radiance cotangent of row i: at row idx[i] on a frame's last bounce
  float g_rad[3] = {0.0f, 0.0f, 0.0f};
  if (p.g_rad != nullptr) {
    const long long gi = p.idx != nullptr ? (long long)__ldg(p.idx + i) : i;
    for (int c = 0; c < 3; ++c) g_rad[c] = p.g_rad[3 * gi + c];
    float e = emit_on ? __ldg(p.emittance + mat) : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float g = g_rad[c];
      if (miss) dt[c] = dt[c] + g * p.resid_f[3 * i + c];
      if (emit_on) {
        dt[c] = dt[c] + g * (a[c] * a[c] * e);
        float ge = g * tp[c];
        da[c] = da[c] + 2.0f * (ge * e) * a[c];
        de = de + ge * (a[c] * a[c]);
      }
    }
  }
  if (p.g_tp != nullptr) {
    float dw = p.resid_f[3 * i];
    for (int c = 0; c < 3; ++c) {
      float g = p.g_tp[3 * i + c];
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
  // after a compaction the lane's gradients go to the row it came from
  const long long o = p.src != nullptr ? (long long)__ldg(p.src + i) : i;
  if (p.d_tp != nullptr)
    for (int c = 0; c < 3; ++c) p.d_tp[3 * o + c] = dt[c];
  if (p.d_rad != nullptr)
    for (int c = 0; c < 3; ++c) p.d_rad[3 * o + c] = g_rad[c];
}

// The warp's lanes that hold one key (>= 0), summed by the first of them
// in lane order, in float64, and added once per nonzero value to dst[key *
// width + c].  Every lane of the warp calls it; `scratch` is the warp's
// kWarpScratchWords words of shared memory.
template <int W>
__device__ __forceinline__ void warp_combined_add(int key, const float (&v)[W], float* dst, int* scratch,
                                                  int lane) {
  const unsigned peers = __match_any_sync(kFullMask, key);
  float* vals = reinterpret_cast<float*>(scratch + 32);
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
      if (acc[c] != 0.0) atomicAdd(dst + (long long)W * key + c, (float)acc[c]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kBwdThreads) shade_backward_kernel(const __grid_constant__ BackwardParams p) {
  __shared__ int scratch[kBwdThreads / 32][kWarpScratchWords];
  const int tid = threadIdx.x, lane = tid & 31;
  // every lane of a warp runs every tile of its block, so the warp's
  // intrinsics see all 32
  for (long long base = (long long)blockIdx.x * blockDim.x; base < p.n; base += (long long)gridDim.x * blockDim.x) {
    const long long i = base + tid;
    const bool valid = i < p.n;
    float da[4] = {0.0f, 0.0f, 0.0f, 0.0f}, de[1] = {0.0f};
    int texel = -1, mat = 0;
    bool emit_on = false;
    if (valid) backward_lane(p, i, da, de[0], texel, mat, emit_on);
    if (p.d_atlas != nullptr) {
      const bool any = valid && (da[0] != 0.0f || da[1] != 0.0f || da[2] != 0.0f || da[3] != 0.0f);
      warp_combined_add<4>(any ? texel : -1, da, p.d_atlas, scratch[tid >> 5], lane);
    }
    if (p.d_emit != nullptr) warp_combined_add<1>(emit_on ? mat : -1, de, p.d_emit, scratch[tid >> 5], lane);
  }
}

// ---- launch configuration

struct LaunchConfig {
  int threads, blocks, smem, resident, sms;
  int tables_smem;  // the forward's tables staged in shared memory
};

static int card_sms(int* sms) {
  static int per_device[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    e = cudaDeviceGetAttribute(&per_device[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = per_device[dev];
  return 0;
}

// resident blocks per SM of a kernel at (threads, dynamic shared memory),
// asked of the runtime once per device and shape
// (kernel: 0 the forward, 1 its scan variant, 2 the backward)
static int resident_blocks(int kernel, int threads, int smem, int* out) {
  struct Entry {
    int dev, kernel, threads, smem, blocks;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int n_cache = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < (n_cache < kEntries ? n_cache : kEntries); ++k)
    if (cache[k].dev == dev && cache[k].kernel == kernel && cache[k].threads == threads &&
        cache[k].smem == smem) {
      *out = cache[k].blocks;
      return 0;
    }
  int blocks = 0;
  if (kernel == 2)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_backward_kernel, threads, smem);
  else if (kernel == 1)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_forward_kernel<true>, threads, smem);
  else
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_forward_kernel<false>, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cache[n_cache % kEntries] = Entry{dev, kernel, threads, smem, blocks};
  ++n_cache;
  *out = blocks;
  return 0;
}

// blocks: one per `threads` lanes, at most SMs x resident blocks
static int grid_config(int kernel, int n, int threads, int smem, LaunchConfig* cfg) {
  int rc = card_sms(&cfg->sms);
  if (rc != 0) return rc;
  rc = resident_blocks(kernel, threads, smem, &cfg->resident);
  if (rc != 0) return rc;
  cfg->threads = threads;
  cfg->smem = smem;
  long long needed = ((long long)n + threads - 1) / threads, cap = (long long)cfg->sms * cfg->resident;
  cfg->blocks = (int)(needed < cap ? needed : cap);
  if (cfg->blocks < 1) cfg->blocks = 1;
  return 0;
}

static int forward_config(int n, const ShadeTables& tb, bool scan, LaunchConfig* cfg) {
  cfg->tables_smem = table_words(tb) * 4 <= K4_TABLE_SMEM_BUDGET;
  return grid_config(scan ? 1 : 0, n, kThreads, (kSunWords + (cfg->tables_smem ? table_words(tb) : 0)) * 4, cfg);
}

static void config_out(const LaunchConfig& c, int* out) {
  const int v[6] = {c.threads, c.blocks, c.smem, c.resident, c.sms, c.tables_smem};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
}

// ---- entry points; each returns a cudaError_t

// `slots`: the N_LANE_SLOTS words of LaneSlot's order (pointers, strides).
extern "C" int shade_forward(int n, const ShadeTables* tables, const ShadeFlags* flags, const void* const* slots,
                             int n_slots, void* stream) {
  if (n_slots != N_LANE_SLOTS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ForwardParams p;
  p.tb = *tables;
  p.fl = *flags;
  for (int k = 0; k < S_ORIGIN_STRIDE; ++k) p.in[k] = slots[k];
  for (int k = 0; k < 4; ++k) p.stride[k] = (long long)(intptr_t)slots[S_ORIGIN_STRIDE + k];
  p.u_stride = (long long)(intptr_t)slots[S_U_STRIDE];
  for (int k = S_OUT_ORIGIN; k < N_LANE_SLOTS; ++k) p.out[k - S_OUT_ORIGIN] = const_cast<void*>(slots[k]);
  p.n = n;
  const bool scan = p.fl.scan != 0;
  if (scan && prim_count(p.tb.prims) == 0) return (int)cudaErrorInvalidValue;
  LaunchConfig cfg;
  int rc = forward_config(n, p.tb, scan, &cfg);
  if (rc != 0) return rc;
  p.tables_smem = cfg.tables_smem;
  p.table_words = cfg.tables_smem ? table_words(p.tb) : 0;
  if (scan)
    shade_forward_kernel<true><<<cfg.blocks, cfg.threads, cfg.smem, (cudaStream_t)stream>>>(p);
  else
    shade_forward_kernel<false><<<cfg.blocks, cfg.threads, cfg.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// `out`: threads, blocks, dynamic shared memory bytes per block, resident
// blocks per SM, SMs, the tables staged in shared memory; then the
// registers per thread and the stack frame bytes of the variant (scan: the
// one with K7's scan folded in).
extern "C" int shade_forward_config(int n, const ShadeTables* tables, int scan, int* out) {
  LaunchConfig cfg;
  int rc = forward_config(n, *tables, scan != 0, &cfg);
  if (rc != 0) return rc;
  config_out(cfg, out);
  cudaFuncAttributes attr;
  cudaError_t e = scan ? cudaFuncGetAttributes(&attr, shade_forward_kernel<true>)
                       : cudaFuncGetAttributes(&attr, shade_forward_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  out[6] = attr.numRegs;
  out[7] = (int)attr.localSizeBytes;
  return 0;
}

// `slots`: the N_BACKWARD_SLOTS pointers of BackwardSlot's order.  The
// atlas and emittance gradients, where given, come zero-filled.
extern "C" int shade_backward(int n, const void* const* slots, int n_slots, void* stream) {
  if (n_slots != N_BACKWARD_SLOTS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  BackwardParams p;
  p.g_tp = (const float*)slots[B_G_THROUGHPUT];
  p.g_rad = (const float*)slots[B_G_RADIANCE];
  p.g_alb = (const float*)slots[B_G_ALBEDO];
  p.albedo = (const float*)slots[B_ALBEDO];
  p.throughput = (const float*)slots[B_THROUGHPUT];
  p.resid_i = (const int*)slots[B_RESID_I];
  p.resid_f = (const float*)slots[B_RESID_F];
  p.emittance = (const float*)slots[B_EMITTANCE];
  p.d_tp = (float*)slots[B_D_THROUGHPUT];
  p.d_atlas = (float*)slots[B_D_ATLAS];
  p.d_emit = (float*)slots[B_D_EMITTANCE];
  p.src = (const int*)slots[B_SRC];
  p.d_rad = (float*)slots[B_D_RADIANCE];
  p.idx = (const int*)slots[B_IDX];
  if (p.d_rad != nullptr && ((p.src == nullptr && p.idx == nullptr) || p.g_rad == nullptr))
    return (int)cudaErrorInvalidValue;
  p.n = n;
  LaunchConfig cfg;
  int rc = grid_config(2, n, kBwdThreads, 0, &cfg);
  if (rc != 0) return rc;
  shade_backward_kernel<<<cfg.blocks, cfg.threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// `out` as shade_forward_config's (its sixth word 0).
extern "C" int shade_backward_config(int n, int* out) {
  LaunchConfig cfg;
  cfg.tables_smem = 0;
  int rc = grid_config(2, n, kBwdThreads, 0, &cfg);
  if (rc != 0) return rc;
  config_out(cfg, out);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, shade_backward_kernel);
  if (e != cudaSuccess) return (int)e;
  out[6] = attr.numRegs;
  out[7] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
