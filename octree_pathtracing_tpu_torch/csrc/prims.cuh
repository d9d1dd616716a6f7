// K7's per-ray scan of the analytic primitives (free spheres, then free
// backface-culled quads), shared by the standalone kernel of prims.cu and
// the two kernels it is folded into: K4's forward (shade.cu, the bounce
// ray) and nee_setup (nee.cu, each cast shadow ray).
//
// The scan is models/prims.py `intersect_prims_reference` operation for
// operation: the spheres, then the quads, in table order, keeping the
// nearest hit below t_max (`take = hit && t < best_t && t < t_max`, a quad
// tested up to min(best_t, t_max)).  Every file that includes it is built
// with -fmad=false and computes the multiply-adds that the JAX package's
// CPU path fuses as ops/geometry.fma does (fma_f32 of quads.cuh), with IEEE
// division and square root; so the folded scans equal the standalone one
// bit for bit, and hit, t, material and normal equal the plain version's.
// The uv's acosf and atan2f may differ from PyTorch's by an ulp, and its
// division by 2 pi and pi is the multiply by the reciprocal that PyTorch
// does on the card.
#pragma once

#include "quads.cuh"

#define PRIM_SPHERE_EPSILON_F 5e-8f  // Ray::EPSILON
#define PRIM_PI_F 3.14159265358979323846f

struct SphereTable {
  const float* center;  // (S, 3)
  const float* radius;  // (S,)
  const int* material;  // (S,)
  int count;
};

// The tables of one scene: spheres, then quads (count 0 where a scene has
// none).
struct PrimTables {
  SphereTable spheres;
  QuadTable quads;
};

// The primitives of a scene's tables.
__host__ __device__ __forceinline__ int prim_count(const PrimTables& pt) { return pt.spheres.count + pt.quads.count; }

// The nearest primitive hit of one ray: t (inf on a miss), the material,
// uv and normal (zeros on a miss).
struct PrimHit {
  float t, u, v, n[3];
  int mat;
};

__device__ __forceinline__ void prim_miss(PrimHit& h) {
  h.t = __int_as_float(0x7f800000);
  h.u = h.v = 0.0f;
  h.n[0] = h.n[1] = h.n[2] = 0.0f;
  h.mat = 0;
}

// The ray o + t d against every primitive of `pt` below t_max, the tables
// read through __ldg (a few words that stay in L1).  (Computing the
// winner's normal and uv once after the loops, in place of at each take,
// measured 0.0003-0.0005 ms slower a bounce in K4's forward: PERF.md §6.)
__device__ __forceinline__ void prim_scan(const PrimTables& pt, const float o[3], const float d[3], float t_max,
                                          PrimHit& h) {
  prim_miss(h);
  const SphereTable& st = pt.spheres;
  for (int s = 0; s < st.count; ++s) {
    float c[3], oc[3];
    for (int a = 0; a < 3; ++a) {
      c[a] = __ldg(st.center + 3 * s + a);
      oc[a] = c[a] - o[a];
    }
    float r = __ldg(st.radius + s);
    float qa = dot3(d, d);
    float hh = dot3(d, oc);
    float cc = fma_f32(-r, r, dot3(oc, oc));
    float disc = fma_f32(hh, hh, -(qa * cc));
    float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
    float t0 = (hh - sq) / qa;
    float t1 = (hh + sq) / qa;
    float t = t0 > PRIM_SPHERE_EPSILON_F ? t0 : t1;
    bool hit = disc >= 0.0f && t > PRIM_SPHERE_EPSILON_F;
    if (!(hit && t < h.t && t < t_max)) continue;
    float nrm[3];
    for (int a = 0; a < 3; ++a) nrm[a] = (fma_f32(d[a], t, o[a]) - c[a]) / r;
    float ny = -nrm[1];
    float theta = acosf(ny < -1.0f ? -1.0f : (ny > 1.0f ? 1.0f : ny));
    float phi = atan2f(-nrm[2], nrm[0]) + PRIM_PI_F;
    h.t = t;
    h.mat = __ldg(st.material + s);
    h.u = phi * (1.0f / (2.0f * PRIM_PI_F));
    h.v = theta * (1.0f / PRIM_PI_F);
    for (int a = 0; a < 3; ++a) h.n[a] = nrm[a];
  }

  const QuadTable& qt = pt.quads;
  for (int q = 0; q < qt.count; ++q) {
    float t, uu, vv;
    bool ok = quad_hit(qt, q, o, d, fminf(h.t, t_max), t, uu, vv);
    if (!(ok && t < h.t && t < t_max)) continue;
    h.t = t;
    h.mat = __ldg(qt.material + q);
    h.u = uu;
    h.v = vv;
    for (int a = 0; a < 3; ++a) h.n[a] = __ldg(qt.normal + 3 * q + a);
  }
}
