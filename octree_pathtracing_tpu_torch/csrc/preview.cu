// Kernel K10: the flat-shaded preview's resolve and shade, one thread per
// pixel.
//
// Replaces: octree_pathtracing_tpu/render/preview.py `preview_render_rays`
// after its walk (:33-39): render/hit.py `resolve_hit` (:323), the hit
// material's texel forced opaque (ops/texture.py `sample_atlas`, rgb only),
// models/sun.py `flat_shading` (:219) = max(AMBIENT, n . sw) * emittance,
// and for a miss `sky_color` with `add_sun_color` (the sun's window,
// :177).  The JAX version is jnp that XLA fuses beside the walk; the port's
// plain-torch twin (ops/preview.py `preview_shade_reference`) runs it as
// some forty eager launches.
//
// Per pixel: on a hit, the entry face's normal and uv; the leaf's material,
// or a block model's face material, or a quad model's quad (K2q's mode 1
// wrote it); the material's layer and the nearest texel (clamp, v-flip,
// per-layer sizes); the flat shade.  On a miss the sky, plus the sun's
// apparent brightness x10 inside its window when the sun draws its
// texture.  It writes (B, 3) float32.
//
// What bounds it: bytes.  A pixel reads its hit (hit, face, uv, leaf: 17 B;
// a quad model's surface 29 B more), its direction (12 B) and, on a hit,
// one 16-byte texel, and writes 12 B; the arithmetic (a dot product, the
// texel index, two acosf on a miss) is far below the card's float32 rate.
// The tables (a few materials, an atlas of tens of KB) stay in L1 / L2.
// So the design is the simplest: one thread a pixel, blocks of 256, every
// table word through __ldg, no shared memory.
//
// Parity with the twin: built with -fmad=false, and the dot products are
// the fused chain cuBLAS's (B, 3) @ (3,) gives, as K4's (shade.cu mv3), so
// the kernel equals the twin on the card bit for bit.  K4's helpers are
// copied here, not shared, so K4's build stays as it was.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_rounding.cuh"

#define HALF_PI_F ((float)1.5707963267948966)  // PI / 2.0
#define AMBIENT_F 0.3f                         // models/sun.AMBIENT

struct PreviewTables {
  const int* leaf_material;  // (L,) the leaf value's material
  int n_leaf;
  const int* leaf_model;     // (Lm,) the leaf value's block model, or null without models
  int n_leaf_model;
  const int* face_material;  // (Mm, 6) a model's material per face
  const int* texture_index;  // (M,) the material's atlas layer
  const float* atlas;        // (T, H, W, 4) linear RGBA
  const int* sizes;          // (T, 2) per-layer (h, w), or null for a uniform atlas
  int atlas_h, atlas_w;
  const float* sw;           // the sun's basis, (3,) each
  const float* su;
  const float* sv;
  const float* radius;       // ()
  const float* emittance;    // (4,)
  const float* apparent;     // (3,) the apparent texture brightness
  int draw_texture;          // the sun draws its window on a miss
};

struct PreviewLanes {
  const uint8_t* hit;     // (B,) bool
  const int* face_id;     // (B,)
  const float* uv;        // (B, 2)
  const int* leaf_value;  // (B,)
  const uint8_t* q_found; // (B,) a quad model's quad was hit; null without quad models
  const int* q_mat;       // (B,)
  const float* q_uv;      // (B, 2)
  const float* q_normal;  // (B, 3)
  const float* dirs;      // (B, 3)
  float* out;             // (B, 3)
  int n;
};

// a (B, 3) @ (3,) matrix-vector product as cuBLAS computes it on the card
__device__ __forceinline__ float mv3(const float a[3], const float* b) {
  return fmaf(a[2], __ldg(b + 2), fmaf(a[1], __ldg(b + 1), a[0] * __ldg(b)));
}

// models/sun.sun_disk_factor's window test
__device__ bool in_sun_disk(const PreviewTables& tb, const float d[3]) {
  float cos_sw = mv3(d, tb.sw);
  float width = __ldg(tb.radius) * 4.0f;
  float width2 = width * 2.0f;
  float a = (HALF_PI_F - acosf(clampf(mv3(d, tb.su), -1.0f, 1.0f))) + width;
  float b = (HALF_PI_F - acosf(clampf(mv3(d, tb.sv), -1.0f, 1.0f))) + width;
  return cos_sw >= 0.5f && a >= 0.0f && a < width2 && b >= 0.0f && b < width2;
}

__global__ void __launch_bounds__(256) preview_shade_kernel(PreviewTables tb, PreviewLanes p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  float d[3] = {p.dirs[3 * i], p.dirs[3 * i + 1], p.dirs[3 * i + 2]};
  float rgb[3];
  if (!p.hit[i]) {
    const float sky[3] = {0.5f, 0.7f, 1.0f};
    bool sun = tb.draw_texture && in_sun_disk(tb, d);
    for (int c = 0; c < 3; ++c) rgb[c] = sun ? sky[c] + __ldg(tb.apparent + c) * 10.0f : sky[c];
  } else {
    // resolve: the entry face's normal and uv; the leaf's or the model's
    // material; a quad model's quad
    int face = min(max(p.face_id[i], 0), 5);
    float sgn = (face & 1) ? 1.0f : -1.0f;
    float nrm[3] = {face >> 1 == 0 ? sgn : 0.0f, face >> 1 == 1 ? sgn : 0.0f, face >> 1 == 2 ? sgn : 0.0f};
    float u = p.uv[2 * i], v = p.uv[2 * i + 1];
    int leaf = p.leaf_value[i];
    int mat;
    if (tb.leaf_model == nullptr) {
      mat = __ldg(tb.leaf_material + min(max(leaf, 0), tb.n_leaf - 1));
    } else {
      int model = __ldg(tb.leaf_model + min(max(leaf, 0), tb.n_leaf_model - 1));
      mat = __ldg(tb.face_material + 6 * model + face);
      if (p.q_found != nullptr && p.q_found[i]) {
        mat = p.q_mat[i];
        u = p.q_uv[2 * i];
        v = p.q_uv[2 * i + 1];
        for (int c = 0; c < 3; ++c) nrm[c] = p.q_normal[3 * i + c];
      }
    }
    // the nearest texel, as ops/texture.sample_atlas picks it
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
    long long texel = ((long long)layer * tb.atlas_h + tj) * tb.atlas_w + ti;
    float4 alb = __ldg(reinterpret_cast<const float4*>(tb.atlas) + texel);
    // flat_shading: color * (emittance * max(n . sw, AMBIENT))
    float shading = clamp_min(mv3(nrm, tb.sw), AMBIENT_F);
    const float a[3] = {alb.x, alb.y, alb.z};
    for (int c = 0; c < 3; ++c) rgb[c] = a[c] * (__ldg(tb.emittance + c) * shading);
  }
  for (int c = 0; c < 3; ++c) p.out[3 * i + c] = rgb[c];
}

extern "C" int preview_shade(const PreviewTables* tables, const PreviewLanes* lanes, void* stream) {
  if (lanes->n == 0) return 0;
  const int threads = 256;
  const int blocks = (lanes->n + threads - 1) / threads;
  preview_shade_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*tables, *lanes);
  return (int)cudaGetLastError();
}

extern "C" const char* preview_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
