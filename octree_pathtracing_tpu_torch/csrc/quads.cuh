// The quad table and `Quad::hit`, shared by the quad-model accept of
// traversal.cu (K2q), the primitive scan of prims.cuh (K7, and its copies
// folded into K4's forward and nee_setup) and the BVH walk of bvh.cu (K8,
// which reads a leaf's quad rows before it tests them: quad_load, then
// quad_test).
//
// The arithmetic is ops/geometry.py `quad_hit` operation for operation.
// Where the JAX package's CPU path fuses a multiply into an add (a dot
// product is fma(a2, b2, fma(a1, b1, a0*b0)), a cross product component
// fma(a1, b2, -(a2*b1)), o + d*t one fma), both compute that fused
// multiply-add the same way, through float64 (fma_f32); every other
// operation rounds on its own (both libraries are built with -fmad=false).
// So a quad test here equals the plain-torch one bit for bit.
#pragma once

#define QUAD_EPSILON_F 5e-8f  // Ray::EPSILON: the backface cull

// a * b + c with one float32 rounding of the exact sum, as ops/geometry.fma
// computes it: the float64 product of two floats is exact and the float64
// sum rounds to float32 (a second rounding only where it falls exactly
// between two floats).
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fma_f32(a[2], b[2], fma_f32(a[1], b[1], a[0] * b[0]));
}

// out = a x b
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = fma_f32(a[1], b[2], -(a[2] * b[1]));
  out[1] = fma_f32(a[2], b[0], -(a[0] * b[2]));
  out[2] = fma_f32(a[0], b[1], -(a[1] * b[0]));
}

// Structure of arrays of Q quads, as ops/geometry.QuadSoA holds them.
struct QuadTable {
  const float* origin;   // (Q, 3)
  const float* u;        // (Q, 3)
  const float* v;        // (Q, 3)
  const float* w;        // (Q, 3)  n / (n . n)
  const float* normal;   // (Q, 3)
  const float* d;        // (Q,)
  const int* material;   // (Q,)
  const float* u_range;  // (Q, 2)
  const float* v_range;  // (Q, 2)
  int count;
};

// One quad's row (84 bytes with its id): what quad_test reads.
struct QuadRow {
  float o[3], u[3], v[3], w[3], n[3];
  float d, ur[2], vr[2];
};

__device__ __forceinline__ void quad_load(const QuadTable& qt, int q, QuadRow& r) {
  for (int a = 0; a < 3; ++a) {
    r.o[a] = __ldg(qt.origin + 3 * q + a);
    r.u[a] = __ldg(qt.u + 3 * q + a);
    r.v[a] = __ldg(qt.v + 3 * q + a);
    r.w[a] = __ldg(qt.w + 3 * q + a);
    r.n[a] = __ldg(qt.normal + 3 * q + a);
  }
  r.d = __ldg(qt.d + q);
  r.ur[0] = __ldg(qt.u_range + 2 * q);
  r.ur[1] = __ldg(qt.u_range + 2 * q + 1);
  r.vr[0] = __ldg(qt.v_range + 2 * q);
  r.vr[1] = __ldg(qt.v_range + 2 * q + 1);
}

// The quad of row `r` against the ray o + t dir (o already in the quad's
// frame).  Returns whether it is hit in (0, t_next] from the front inside
// the quad, with its t and texture coordinates.
__device__ __forceinline__ bool quad_test(const QuadRow& r, const float o[3], const float dir[3], float t_next,
                                          float& t, float& uu, float& vv) {
  float denom = dot3(dir, r.n);
  t = (r.d - dot3(r.n, o)) / denom;
  float p[3], c[3], e[3];
  for (int a = 0; a < 3; ++a) p[a] = fma_f32(dir[a], t, o[a]) - r.o[a];
  cross3(p, r.v, c);
  cross3(r.u, p, e);
  float alpha = dot3(r.w, c);
  float beta = dot3(r.w, e);
  uu = fma_f32(alpha, r.ur[1] - r.ur[0], r.ur[0]);
  vv = fma_f32(beta, r.vr[1] - r.vr[0], r.vr[0]);
  return denom < -QUAD_EPSILON_F && t > 0.0f && t <= t_next && alpha >= 0.0f &&
         alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
}

// Quad q against the ray o + t dir: its row read, then tested.
__device__ __forceinline__ bool quad_hit(const QuadTable& qt, int q, const float o[3],
                                         const float dir[3], float t_next, float& t,
                                         float& uu, float& vv) {
  QuadRow r;
  quad_load(qt, q, r);
  return quad_test(r, o, dir, t_next, t, uu, vv);
}
