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
// So the main paths launch it no more: its scan (prims.cuh) is folded into
// K4's forward, which scans each live bounce ray itself, and into
// nee_setup, which scans each cast shadow ray it writes.  This kernel stays
// the entry point of a single walk (render/pathtracer.py `_prim_hit`) and
// the yardstick the folded scans are held to.
//
// Parity with the plain-torch twin (models/prims.py
// `intersect_prims_reference`): see prims.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prims.cuh"

__global__ void prims_intersect_kernel(const float* __restrict__ origins,
                                       const float* __restrict__ dirs, int n, float t_max,
                                       PrimTables tables, uint8_t* __restrict__ hit_out,
                                       float* __restrict__ t_out, int* __restrict__ mat_out,
                                       float* __restrict__ uv_out, float* __restrict__ normal_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[3 * i + a];
    d[a] = dirs[3 * i + a];
  }
  PrimHit h;
  prim_scan(tables, o, d, t_max, h);
  hit_out[i] = h.t != __int_as_float(0x7f800000);
  t_out[i] = h.t;
  mat_out[i] = h.mat;
  uv_out[2 * i] = h.u;
  uv_out[2 * i + 1] = h.v;
  for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = h.n[a];
}

extern "C" int prims_intersect(const void* origins, const void* dirs, int n, float t_max,
                               const PrimTables* tables, void* hit, void* t, void* mat,
                               void* uv, void* normal, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  prims_intersect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, n, t_max, *tables, (uint8_t*)hit, (float*)t,
      (int*)mat, (float*)uv, (float*)normal);
  return (int)cudaGetLastError();
}

extern "C" const char* prims_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
