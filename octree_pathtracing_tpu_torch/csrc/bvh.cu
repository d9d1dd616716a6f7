// Kernel K8: each ray's nearest world-space quad through a flat SAH BVH,
// one thread per ray, with an ordered stack of 64 entries per thread.
//
// Replaces: octree_pathtracing_tpu/ops/bvh.py `bvh_intersect` (:99), a
// lax.while_loop that steps every lane's stack in lockstep and calls a
// primitive callback; the one callback the JAX package passes is
// `quad_hit` with the quad id as the payload, so this kernel tests quads
// (quads.cuh) and writes the quad id.
//
// The walk is the JAX one step for step: pop a node; its box counts where
// t0 <= t1, t1 > 0 and t0 < t_best; a leaf tests its first primitives, at
// most 2 (`k < count`), taking a hit where t < t_best; an interior node
// pushes the far child, then the near one, the near one being the child
// whose box is entered first (ties to the left).  Each node is a 32-byte
// row [min xyz, left's bits, max xyz, right's bits], read as two 16-byte
// __ldg loads; left = LEAF_FLAG | first primitive marks a leaf, whose
// right is its primitive count.  A push beyond the stack is dropped and a
// pop beyond it reads the last entry, as the plain-torch twin does.
//
// What bounds it: the node rows and quad rows each lane fetches (dependent
// loads, mostly from L2) and 33 bytes of ray in and out per lane; the
// arithmetic (~30 operations per box, ~60 per quad) is far below the
// card's rate.  This first version is simple and right.
//
// Parity with the twin (ops/bvh.py `bvh_intersect_reference`): built with
// -fmad=false, the quad test's fused multiply-adds computed as
// ops/geometry.fma does (fma_f32), IEEE division; hit, t and payload equal
// the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quads.cuh"

#define BVH_MAX_STACK 64
#define BVH_LEAF_FLAG (1 << 30)

// Slab test of the box in rows (lo = min xyz, hi = max xyz): entry t0 and
// exit t1.
__device__ __forceinline__ void slab(const float4 lo, const float4 hi, const float o[3],
                                     const float inv[3], float& t0, float& t1) {
  float bx = (lo.x - o[0]) * inv[0], tx = (hi.x - o[0]) * inv[0];
  float by = (lo.y - o[1]) * inv[1], ty = (hi.y - o[1]) * inv[1];
  float bz = (lo.z - o[2]) * inv[2], tz = (hi.z - o[2]) * inv[2];
  t0 = fmaxf(fmaxf(fminf(bx, tx), fminf(by, ty)), fminf(bz, tz));
  t1 = fminf(fminf(fmaxf(bx, tx), fmaxf(by, ty)), fmaxf(bz, tz));
}

__global__ void bvh_intersect_kernel(const float4* __restrict__ rows,
                                     const int* __restrict__ prim_order, int n_prims,
                                     QuadTable qt, const float* __restrict__ origins,
                                     const float* __restrict__ dirs,
                                     const float* __restrict__ t_init, int n,
                                     uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                                     int* __restrict__ payload_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tiny = (float)1e-12;
  float o[3], d[3], inv[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[3 * i + a];
    d[a] = dirs[3 * i + a];
    inv[a] = 1.0f / (fabsf(d[a]) < tiny ? tiny : d[a]);
  }
  float t_best = t_init ? t_init[i] : __int_as_float(0x7f800000);
  int payload = -1;

  int stack[BVH_MAX_STACK];
  stack[0] = 0;
  int sp = 1;
  while (sp > 0) {
    --sp;
    const int node = stack[sp < BVH_MAX_STACK ? sp : BVH_MAX_STACK - 1];
    const float4 lo = __ldg(rows + 2 * node), hi = __ldg(rows + 2 * node + 1);
    float t0, t1;
    slab(lo, hi, o, inv, t0, t1);
    if (!(t0 <= t1 && t1 > 0.0f && t0 < t_best)) continue;
    const int lw = __float_as_int(lo.w), rw = __float_as_int(hi.w);
    if (lw & BVH_LEAF_FLAG) {
      const int start = lw & ~BVH_LEAF_FLAG;
      for (int k = 0; k < 2 && k < rw; ++k) {
        int j = start + k;
        j = j < 0 ? 0 : (j > n_prims - 1 ? n_prims - 1 : j);
        const int pid = __ldg(prim_order + j);
        float t, uu, vv;
        if (quad_hit(qt, pid, o, d, t_best, t, uu, vv) && t < t_best) {
          t_best = t;
          payload = pid;
        }
      }
    } else {
      float lt0, rt0, unused;
      slab(__ldg(rows + 2 * lw), __ldg(rows + 2 * lw + 1), o, inv, lt0, unused);
      slab(__ldg(rows + 2 * rw), __ldg(rows + 2 * rw + 1), o, inv, rt0, unused);
      const bool near_is_left = lt0 <= rt0;
      if (sp < BVH_MAX_STACK) stack[sp] = near_is_left ? rw : lw;
      if (sp + 1 < BVH_MAX_STACK) stack[sp + 1] = near_is_left ? lw : rw;
      sp += 2;
    }
  }
  hit_out[i] = payload >= 0;
  t_out[i] = t_best;
  payload_out[i] = payload;
}

extern "C" int bvh_intersect(const void* rows, const void* prim_order, int n_prims,
                             const QuadTable* quads, const void* origins, const void* dirs,
                             const void* t_init, int n, void* hit, void* t, void* payload,
                             void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_intersect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)rows, (const int*)prim_order, n_prims, *quads, (const float*)origins,
      (const float*)dirs, (const float*)t_init, n, (uint8_t*)hit, (float*)t, (int*)payload);
  return (int)cudaGetLastError();
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
