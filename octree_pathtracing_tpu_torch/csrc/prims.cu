// Kernel K7: each ray's nearest analytic primitive (free spheres, then
// free backface-culled quads), one thread per ray.
//
// Replaces: octree_pathtracing_tpu/models/prims.py `intersect_prims` (:71)
// with ops/geometry.py `sphere_hit` (:121) and `quad_hit` (:84), a jnp
// loop over the primitives that XLA fuses beside the traversal.  Here each
// thread loops over the spheres, then the quads, in table order, keeping
// the nearest hit below t_max: `take = hit && t < best_t && t < t_max`, a
// quad tested up to min(best_t, t_max).  It writes hit (best t finite), t
// (inf on a miss), material, uv and normal.
//
// What bounds it: a scene holds a handful of primitives, so the tables stay
// in L1/L2 and each ray's 24 input bytes and ~29 output bytes are what must
// move; the arithmetic (~40 operations per sphere, ~50 per quad) is far
// below the card's float32 rate.  A launch over 65,536 rays moves ~3.5 MB:
// about a microsecond of HBM time, so launch latency sets the kernel's time.
// This first version is simple and right; fusing it into the shading is
// later work.
//
// Parity with the plain-torch twin (models/prims.py
// `intersect_prims_reference`): built with -fmad=false, the multiply-adds
// that the JAX package's CPU path fuses computed as ops/geometry.fma does
// (fma_f32 of quads.cuh), IEEE division and square root; hit, t, material
// and normal equal the twin's bit for bit.  The uv's acosf and
// atan2f may differ from PyTorch's by an ulp, and its division by 2 pi
// and pi is the multiply by the reciprocal that PyTorch does on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quads.cuh"

#define SPHERE_EPSILON_F 5e-8f  // Ray::EPSILON
#define PI_F 3.14159265358979323846f

struct SphereTable {
  const float* center;  // (S, 3)
  const float* radius;  // (S,)
  const int* material;  // (S,)
  int count;
};

__global__ void prims_intersect_kernel(const float* __restrict__ origins,
                                       const float* __restrict__ dirs, int n, float t_max,
                                       SphereTable st, QuadTable qt,
                                       uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                                       int* __restrict__ mat_out, float* __restrict__ uv_out,
                                       float* __restrict__ normal_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[3 * i + a];
    d[a] = dirs[3 * i + a];
  }
  const float inf = __int_as_float(0x7f800000);
  float best_t = inf, best_u = 0.0f, best_v = 0.0f, best_n[3] = {0.0f, 0.0f, 0.0f};
  int best_mat = 0;

  for (int s = 0; s < st.count; ++s) {
    float c[3], oc[3];
    for (int a = 0; a < 3; ++a) {
      c[a] = __ldg(st.center + 3 * s + a);
      oc[a] = c[a] - o[a];
    }
    float r = __ldg(st.radius + s);
    float qa = dot3(d, d);
    float h = dot3(d, oc);
    float cc = fma_f32(-r, r, dot3(oc, oc));
    float disc = fma_f32(h, h, -(qa * cc));
    float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
    float t0 = (h - sq) / qa;
    float t1 = (h + sq) / qa;
    float t = t0 > SPHERE_EPSILON_F ? t0 : t1;
    bool hit = disc >= 0.0f && t > SPHERE_EPSILON_F;
    if (!(hit && t < best_t && t < t_max)) continue;
    float nrm[3];
    for (int a = 0; a < 3; ++a) nrm[a] = (fma_f32(d[a], t, o[a]) - c[a]) / r;
    float ny = -nrm[1];
    float theta = acosf(ny < -1.0f ? -1.0f : (ny > 1.0f ? 1.0f : ny));
    float phi = atan2f(-nrm[2], nrm[0]) + PI_F;
    best_t = t;
    best_mat = __ldg(st.material + s);
    best_u = phi * (1.0f / (2.0f * PI_F));
    best_v = theta * (1.0f / PI_F);
    for (int a = 0; a < 3; ++a) best_n[a] = nrm[a];
  }

  for (int q = 0; q < qt.count; ++q) {
    float t, uu, vv;
    bool ok = quad_hit(qt, q, o, d, fminf(best_t, t_max), t, uu, vv);
    if (!(ok && t < best_t && t < t_max)) continue;
    best_t = t;
    best_mat = __ldg(qt.material + q);
    best_u = uu;
    best_v = vv;
    for (int a = 0; a < 3; ++a) best_n[a] = __ldg(qt.normal + 3 * q + a);
  }

  hit_out[i] = best_t != inf;
  t_out[i] = best_t;
  mat_out[i] = best_mat;
  uv_out[2 * i] = best_u;
  uv_out[2 * i + 1] = best_v;
  for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = best_n[a];
}

// The tables of one launch: spheres, then quads (count 0 where a scene has
// none).
struct PrimTables {
  SphereTable spheres;
  QuadTable quads;
};

extern "C" int prims_intersect(const void* origins, const void* dirs, int n, float t_max,
                               const PrimTables* tables, void* hit, void* t, void* mat,
                               void* uv, void* normal, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  prims_intersect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, n, t_max, tables->spheres, tables->quads,
      (uint8_t*)hit, (float*)t, (int*)mat, (float*)uv, (float*)normal);
  return (int)cudaGetLastError();
}

extern "C" const char* prims_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
