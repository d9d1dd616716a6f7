// Kernel K8: each ray's nearest world-space quad through a flat SAH BVH,
// one thread per ray, with an ordered stack in shared memory.
//
// Replaces: octree_pathtracing_tpu/ops/bvh.py `bvh_intersect` (:99), a
// lax.while_loop that steps every lane's stack in lockstep and calls a
// primitive callback; the one callback the JAX package passes is
// `quad_hit` with the quad id as the payload, so this kernel tests quads
// (quads.cuh) and writes the quad id.
//
// The walk makes the JAX walk's decisions on the same floats: a node's box
// counts where t0 <= t1, t1 > 0 and t0 < t_best; a leaf tests its first
// primitives, at most 2 (`k < count`), the second against the t_best the
// first left, taking a hit where t < t_best; an interior node orders its
// children by their boxes' entry t0 (the near one is the child entered
// first, ties to the left) and visits the near one first.  Each node is a
// 32-byte row [min xyz, left's bits, max xyz, right's bits], read as two
// 16-byte __ldg loads; left = LEAF_FLAG | first primitive marks a leaf,
// whose right is its primitive count.
//
// The design reads each row once.  The JAX walk pushes both children and
// slab-tests a child's box again when it pops it, although its parent
// read both children's rows to order them.  Here the parent slab-tests
// both children fully: a child whose box fails t0 <= t1 && t1 > 0 (tests
// that do not depend on t_best) is not visited at all, and a child that
// passes is carried with what its visit needs: its left and right words
// and its t0.  The near child becomes the current node at once (the JAX
// walk pops it next); the far one, where both pass, goes on the stack.  A
// pop then tests t0 < t_best against the t_best of that moment and reads
// no node row.  So a ray reads the root's row and two rows per interior
// node it expands, where the JAX walk read 2 more per expansion.
//
// The stack is in shared memory, as the traversal's (traversal.cu), in
// blocks of 64 threads: each thread holds `cap` entries of 12 bytes, laid
// out word by word across the block's threads so that a warp's accesses
// fall in distinct banks.  Only far children wait on it, one per level of
// the path at most, so a tree of depth D needs at most D - 1 entries; the
// wrapper launches with cap = depth + 1 and refuses a tree deeper than the
// capacity (kMaxStack entries, 48 KB a block).  A leaf's two quad rows
// are loaded before either is tested, so their 84 bytes each are in
// flight together.
//
// What bounds it: the node rows and quad rows each lane fetches (dependent
// loads, mostly from L2) and 33 bytes of ray in and out per lane; the
// arithmetic (~30 operations per box, ~60 per quad) is far below the
// card's rate.
//
// Parity with the twin (ops/bvh.py `bvh_intersect_reference`): built with
// -fmad=false, the quad test's fused multiply-adds computed as
// ops/geometry.fma does (fma_f32), IEEE division; hit, t and payload equal
// the twin's bit for bit within the capacity.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quads.cuh"

#define BVH_LEAF_FLAG (1 << 30)

constexpr int kThreads = 64;
// entries a thread's stack can hold: 64 threads x 64 entries x 12 bytes is
// the 48 KB of dynamic shared memory a block gets without opting in
constexpr int kMaxStack = 64;
constexpr int kEntryWords = 3;  // left word, right word, t0's bits

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

// the part of a box's test that does not depend on t_best
__device__ __forceinline__ bool box_counts(float t0, float t1) { return t0 <= t1 && t1 > 0.0f; }

// A node to visit: its row's two words and its box's entry t.
struct Entry {
  int lw, rw;
  float t0;
};

__device__ __forceinline__ Entry entry_of(const float4 lo, const float4 hi, float t0) {
  return Entry{__float_as_int(lo.w), __float_as_int(hi.w), t0};
}

// Leaf `e`'s first primitives, at most 2, against t_best: both quad rows
// read, then the tests in order.
__device__ __forceinline__ void test_leaf(const Entry& e, const int* __restrict__ prim_order, int n_prims,
                                          const QuadTable& qt, const float o[3], const float d[3],
                                          float& t_best, int& payload) {
  const int start = e.lw & ~BVH_LEAF_FLAG, count = e.rw;
  if (count <= 0) return;
  const int j0 = min(max(start, 0), n_prims - 1), j1 = min(max(start + 1, 0), n_prims - 1);
  const int pid0 = __ldg(prim_order + j0);
  const int pid1 = count > 1 ? __ldg(prim_order + j1) : pid0;
  QuadRow q0, q1;
  quad_load(qt, pid0, q0);
  if (count > 1) quad_load(qt, pid1, q1);
  float t, uu, vv;
  if (quad_test(q0, o, d, t_best, t, uu, vv) && t < t_best) {
    t_best = t;
    payload = pid0;
  }
  if (count > 1 && quad_test(q1, o, d, t_best, t, uu, vv) && t < t_best) {
    t_best = t;
    payload = pid1;
  }
}

__global__ void __launch_bounds__(kThreads) bvh_intersect_kernel(
    const float4* __restrict__ rows, const int* __restrict__ prim_order, int n_prims, QuadTable qt,
    const float* __restrict__ origins, const float* __restrict__ dirs, const float* __restrict__ t_init, int n,
    int cap, uint8_t* __restrict__ hit_out, float* __restrict__ t_out, int* __restrict__ payload_out) {
  extern __shared__ int stack[];  // [cap][kEntryWords][kThreads]
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  if (i >= n) return;  // no barrier follows
  const float tiny = (float)1e-12;
  float o[3], d[3], inv[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[3 * i + a];
    d[a] = dirs[3 * i + a];
    inv[a] = 1.0f / (fabsf(d[a]) < tiny ? tiny : d[a]);
  }
  float t_best = t_init ? t_init[i] : __int_as_float(0x7f800000);
  int payload = -1;

  // the root's row, read once
  const float4 root_lo = __ldg(rows), root_hi = __ldg(rows + 1);
  float t0, t1;
  slab(root_lo, root_hi, o, inv, t0, t1);
  Entry cur = entry_of(root_lo, root_hi, t0);
  int sp = 0;
  bool visit = box_counts(t0, t1);
  while (visit) {
    bool next = false;  // a child becomes the current node
    if (cur.t0 < t_best) {
      if (cur.lw & BVH_LEAF_FLAG) {
        test_leaf(cur, prim_order, n_prims, qt, o, d, t_best, payload);
      } else {
        const float4 l_lo = __ldg(rows + 2 * cur.lw), l_hi = __ldg(rows + 2 * cur.lw + 1);
        const float4 r_lo = __ldg(rows + 2 * cur.rw), r_hi = __ldg(rows + 2 * cur.rw + 1);
        float lt0, lt1, rt0, rt1;
        slab(l_lo, l_hi, o, inv, lt0, lt1);
        slab(r_lo, r_hi, o, inv, rt0, rt1);
        const bool near_is_left = lt0 <= rt0;
        const Entry left = entry_of(l_lo, l_hi, lt0), right = entry_of(r_lo, r_hi, rt0);
        const bool near_in = near_is_left ? box_counts(lt0, lt1) : box_counts(rt0, rt1);
        const bool far_in = near_is_left ? box_counts(rt0, rt1) : box_counts(lt0, lt1);
        const Entry& near = near_is_left ? left : right;
        const Entry& far = near_is_left ? right : left;
        if (near_in && far_in) {  // the far child waits; within the capacity no push is dropped
          if (sp < cap) {
            int* slot = stack + sp * kEntryWords * kThreads + tid;
            slot[0] = far.lw;
            slot[kThreads] = far.rw;
            slot[2 * kThreads] = __float_as_int(far.t0);
          }
          ++sp;
        }
        if (near_in || far_in) {
          cur = near_in ? near : far;
          next = true;
        }
      }
    }
    if (!next) {
      if (sp == 0) break;
      --sp;
      const int* slot = stack + min(sp, cap - 1) * kEntryWords * kThreads + tid;
      cur = Entry{slot[0], slot[kThreads], __int_as_float(slot[2 * kThreads])};
    }
  }
  hit_out[i] = payload >= 0;
  t_out[i] = t_best;
  payload_out[i] = payload;
}

// `cap`: stack entries per thread (the tree's depth + 1, at most
// kMaxStack).
extern "C" int bvh_intersect(const void* rows, const void* prim_order, int n_prims,
                             const QuadTable* quads, const void* origins, const void* dirs,
                             const void* t_init, int n, int cap, void* hit, void* t, void* payload,
                             void* stream) {
  if (cap < 1 || cap > kMaxStack) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)cap * kEntryWords * kThreads * sizeof(int);
  bvh_intersect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)rows, (const int*)prim_order, n_prims, *quads, (const float*)origins,
      (const float*)dirs, (const float*)t_init, n, cap, (uint8_t*)hit, (float*)t, (int*)payload);
  return (int)cudaGetLastError();
}

// `out`: threads per block, the stack's capacity in entries per thread,
// registers per thread, stack frame bytes, and resident blocks per SM at
// `cap` entries.
extern "C" int bvh_intersect_attributes(int cap, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, bvh_intersect_kernel);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, bvh_intersect_kernel, kThreads,
                                                    (size_t)cap * kEntryWords * kThreads * sizeof(int));
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = kMaxStack;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = resident;
  return 0;
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
