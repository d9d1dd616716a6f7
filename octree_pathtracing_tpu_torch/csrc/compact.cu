// Kernel K5: the compaction of live lanes between bounces, a stable
// partition of the lane state with the live lanes first, its backward, and
// the final scatter of each lane's radiance back to its pixel.
//
// Replaces: octree_pathtracing_tpu/render/pathtracer.py
// `_sort_state_by_active` (:666, key="active": the cumsum and scatter of
// :707-709 and the two row gathers after them), the gather of the bounce's
// uniforms through the carried lane index (:891) and the final
// `.at[idx].set(radiance)` (:1016).  In JAX all of it is XLA code over a
// static batch; the port ran it as `nonzero`, gathers and `index_put`s of
// the live lanes, which read the live count back to the host every bounce.
//
// compact_forward: lane i of the B input lanes goes to row pos[i], where
//   pos[i] = (live lanes before i)                        if lane i is live,
//            L + (dead lanes before i)                    if it is dead,
// L the live count: JAX's order, the live lanes in their order, then the
// dead ones in theirs.  Every state field is written at row pos[i], the
// carried original index too (idx[i], or i where no index is given yet),
// and row pos[i] of the (B, 21) uniform block of the bounce is row idx[i]
// of the frame's (B, n_bounces, 21) block at the bounce.  pos is kept for
// the backward, and the live count goes to counts[bounce], on the device.
//
// One launch, a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016) over tiles of kTile lanes.  A block takes its tile from an atomic
// ticket, not from blockIdx, so that a tile's predecessors are always held
// by blocks that already run: the look-back then never waits on a tile that
// no block has started.  Within a tile each warp's ballot gives its lanes'
// ranks, and one warp scans the tile's 32 (row, warp) counts with shuffles.
// The tile publishes its count at once (flag A) and, after the look-back,
// the live lanes before its end (flag P); the look-back reads 32
// predecessors at a time, one per lane of the scanning warp.  A live lane's
// row needs only its tile's prefix, so the live lanes are written then.  A
// dead lane's row needs the total L, known only when the last tile has
// published its prefix; so each block, once the tickets are spent, writes
// the dead lanes of tiles blockIdx.x, blockIdx.x + gridDim.x, ...: by then
// every tile belongs to a running block, so that wait ends too.  The tile
// status words carry the call's epoch beside their flag, so that no fill
// clears them between calls; the last block to finish resets the ticket and
// advances the epoch.  The scratch (control words and one 64-bit status
// word per tile) is the wrapper's, one buffer per card that calls on one
// stream share; it is zero when first allocated.
//
// compact_backward: d_in[i] = d_out[pos[i]] for the throughput and the
// radiance (the only state fields that carry a gradient), a permutation:
// no atomics, bit-exact.
//
// unpermute_forward: out[idx[j]] = radiance[j]; unpermute_backward:
// d[j] = g[idx[j]].  idx is a permutation of 0..B-1 (compact_forward's
// output), so every output row is written once.
//
// What bounds them: bytes.  At the headline's 65,536 lanes the forward
// moves ~15 MB (each state row read once and written once, 84 bytes of
// uniforms per lane read and written, 4 bytes of pos); there is no
// arithmetic to speak of, and at 65,536 lanes few blocks: the time is the
// latency of dependent loads.  So a tile is 256 lanes, one per thread (256
// blocks at 65,536 lanes; tiles of 1,024 and 512 lanes measured 2.0x and
// 1.3x slower there, and 5% faster at 2,097,152 lanes: PERF.md); every
// load of a lane is issued before any of its stores (a live lane's row
// while the look-back runs, a dead lane's while its tile's prefix is
// read), the state rows' reads are coalesced (each warp reads 32
// consecutive lanes) and the writes nearly so (the live lanes of a tile land
// in consecutive rows, as do its dead ones); the uniform rows are copied by
// the whole block word by word through a list of (source row, destination
// row) in shared memory, consecutive threads on consecutive words of one
// row, eight loads in flight per thread before their stores.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 1;  // lanes per thread and tile
constexpr int kTile = kThreads * kItems;
static_assert(kItems * kWarps <= 32, "one warp scans the tile's (row, warp) counts");
constexpr int N_U = 21;  // uniform words per lane and bounce (ops/shading.N_UNIFORMS)
constexpr int kCopyThreads = 256;

// a tile's status word: bits 32-63 the epoch (30 bits) and the flag, bits
// 0-31 the value
constexpr unsigned FLAG_AGGREGATE = 1, FLAG_PREFIX = 2;
// the control words ahead of the status words: the ticket, the blocks
// done, the epoch (as unsigned ints)
constexpr int CTL_TICKET = 0, CTL_DONE = 1, CTL_EPOCH = 2, CTL_WORDS64 = 2;

struct CompactIn {
  const float* origin;
  const float* dir;
  const float* throughput;
  const float* radiance;
  const uint8_t* active;
  const uint8_t* specular;
  const int* cur_mat;
  const int* idx;  // null: lane i's original index is i
  const float* uniforms;  // the frame's block; lane l's rows start at l * u_lane_stride
  long long u_lane_stride;
  int bounce;
};

struct CompactOut {
  float* origin;
  float* dir;
  float* throughput;
  float* radiance;
  uint8_t* active;
  uint8_t* specular;
  int* cur_mat;
  int* idx;
  float* u;  // (B, N_U)
  int* pos;
  int* counts;  // counts[bounce] takes the live count
};

struct Params {
  CompactIn in;
  CompactOut out;
  int n;
  int n_tiles;
  unsigned long long* scratch;
};

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag, unsigned value) {
  return ((unsigned long long)(((epoch & 0x3FFFFFFFu) << 2) | flag) << 32) | value;
}

// the flag of a status word of this epoch (0: not yet published)
__device__ __forceinline__ unsigned status_flag(unsigned long long w, unsigned epoch) {
  unsigned tag = (unsigned)(w >> 32);
  return (tag >> 2) == (epoch & 0x3FFFFFFFu) ? (tag & 3u) : 0u;
}

// What a tile's lanes are: per item row, each lane's liveness and, among
// the tile's lanes before it, the live ones.
struct TileRanks {
  bool live[kItems];
  int live_before[kItems];  // live lanes of the tile before this lane
  int count;  // live lanes of the tile
};

// Block-wide: the ranks of tile `t`'s lanes.  Lane (row k, thread tid) is
// lane base + k * kThreads + tid, so the tile's order is row-major.
__device__ void tile_ranks(const Params& p, long long base, TileRanks& r, int* s_counts) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  int in_warp[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long i = base + (long long)k * kThreads + tid;
    r.live[k] = i < p.n && p.in.active[i] != 0;
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, r.live[k]);
    in_warp[k] = __popc(ballot & below);
    if (lane == 0) s_counts[k * kWarps + warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the tile's (row, warp) counts, at most 32
    int v = lane < kItems * kWarps ? s_counts[lane] : 0, incl = v;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += o;
    }
    s_counts[32 + lane] = incl - v;
    if (lane == 31) s_counts[64] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) r.live_before[k] = s_counts[32 + k * kWarps + warp] + in_warp[k];
  r.count = s_counts[64];
  __syncthreads();  // s_counts is reused by the next tile
}

// One lane's state row, held in registers between its load and its store.
struct LaneRow {
  float f[12];  // origin, dir, throughput, radiance
  int cur_mat, src;  // the medium; the original index
  uint8_t active, specular;
};

// Loads lane i's row; every load is issued before any store of the tile,
// so the loads of a thread's lanes are in flight together.
__device__ __forceinline__ void load_lane(const CompactIn& in, long long i, LaneRow& r) {
  for (int c = 0; c < 3; ++c) {
    r.f[c] = __ldg(in.origin + 3 * i + c);
    r.f[3 + c] = __ldg(in.dir + 3 * i + c);
    r.f[6 + c] = __ldg(in.throughput + 3 * i + c);
    r.f[9 + c] = __ldg(in.radiance + 3 * i + c);
  }
  r.active = __ldg(in.active + i);
  r.specular = __ldg(in.specular + i);
  r.cur_mat = __ldg(in.cur_mat + i);
  r.src = in.idx != nullptr ? __ldg(in.idx + i) : (int)i;
}

// Writes lane i's row at `dst` and stages its uniform row's copy in `slot`.
__device__ __forceinline__ void store_lane(const CompactOut& out, long long i, int dst, int slot, const LaneRow& r,
                                           int* s_src, int* s_dst) {
  for (int c = 0; c < 3; ++c) {
    out.origin[3LL * dst + c] = r.f[c];
    out.dir[3LL * dst + c] = r.f[3 + c];
    out.throughput[3LL * dst + c] = r.f[6 + c];
    out.radiance[3LL * dst + c] = r.f[9 + c];
  }
  out.active[dst] = r.active;
  out.specular[dst] = r.specular;
  out.cur_mat[dst] = r.cur_mat;
  out.idx[dst] = r.src;
  out.pos[i] = dst;
  s_src[slot] = r.src;
  s_dst[slot] = dst;
}

// Block-wide: copies the `rows` uniform rows staged in (s_src, s_dst), word
// by word, consecutive threads on consecutive words, kCopyUnroll loads in
// flight per thread before their stores.
constexpr int kCopyUnroll = 8;
__device__ __forceinline__ void copy_uniforms(const Params& p, int rows, const int* s_src, const int* s_dst) {
  const float* u = p.in.uniforms + (long long)p.in.bounce * N_U;
  const int words = rows * N_U;
  for (int f0 = threadIdx.x; f0 < words; f0 += kThreads * kCopyUnroll) {
    float v[kCopyUnroll];
    long long dst[kCopyUnroll];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) {
      const int f = f0 + j * kThreads;
      if (f < words) {
        const int r = f / N_U, w = f - r * N_U;
        v[j] = __ldg(u + (long long)s_src[r] * p.in.u_lane_stride + w);
        dst[j] = (long long)s_dst[r] * N_U + w;
      }
    }
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j)
      if (f0 + j * kThreads < words) p.out.u[dst[j]] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads) compact_forward_kernel(const __grid_constant__ Params p) {
  __shared__ int s_counts[65];
  __shared__ int s_src[kTile], s_dst[kTile];
  __shared__ unsigned s_tile;
  __shared__ int s_excl, s_total;
  unsigned* ctl = reinterpret_cast<unsigned*>(p.scratch);
  unsigned long long* status = p.scratch + CTL_WORDS64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(ctl + CTL_EPOCH);

  // the live lanes of every tile this block takes
  while (true) {
    if (tid == 0) s_tile = atomicAdd(ctl + CTL_TICKET, 1u);
    __syncthreads();
    const unsigned t = s_tile;
    if (t >= (unsigned)p.n_tiles) break;
    const long long base = (long long)t * kTile;
    TileRanks r;
    tile_ranks(p, base, r, s_counts);
    LaneRow rows[kItems];  // the live lanes' rows, loading while the look-back runs
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (r.live[k]) load_lane(p.in, base + (long long)k * kThreads + tid, rows[k]);
    if (warp == 0) {  // publish the count, look back for the prefix
      unsigned excl = 0;
      if (t == 0) {
        if (lane == 0) store_relaxed(status + t, status_word(epoch, FLAG_PREFIX, r.count));
      } else {
        if (lane == 0) store_relaxed(status + t, status_word(epoch, FLAG_AGGREGATE, r.count));
        long long j = (long long)t - 1 - lane;  // lane k reads the tile k + 1 before t
        while (true) {
          unsigned long long w = j >= 0 ? load_relaxed(status + j) : status_word(epoch, FLAG_PREFIX, 0);
          unsigned flag = status_flag(w, epoch);
          if (__any_sync(0xFFFFFFFFu, flag == 0)) continue;  // a predecessor has not published yet
          unsigned prefix = __ballot_sync(0xFFFFFFFFu, flag == FLAG_PREFIX);
          int stop = prefix ? __ffs(prefix) - 1 : 31;  // the nearest prefix ends the walk
          unsigned v = lane <= stop ? (unsigned)w : 0u;
#pragma unroll
          for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
          excl += v;
          if (prefix) break;
          j -= 32;
        }
        if (lane == 0) store_relaxed(status + t, status_word(epoch, FLAG_PREFIX, excl + r.count));
      }
      if (lane == 0) {
        s_excl = (int)excl;
        if (t == (unsigned)p.n_tiles - 1) p.out.counts[p.in.bounce] = (int)excl + r.count;
      }
    }
    __syncthreads();
    const int excl = s_excl;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (r.live[k]) store_lane(p.out, base + (long long)k * kThreads + tid, excl + r.live_before[k], r.live_before[k],
                                rows[k], s_src, s_dst);
    }
    __syncthreads();
    copy_uniforms(p, r.count, s_src, s_dst);
    __syncthreads();
  }

  // the dead lanes of tiles blockIdx.x, blockIdx.x + gridDim.x, ...: every
  // tile now belongs to a running block, so the total comes
  if (tid == 0) {
    unsigned long long w;
    do {
      w = load_relaxed(status + p.n_tiles - 1);
    } while (status_flag(w, epoch) != FLAG_PREFIX);
    s_total = (int)(unsigned)w;
  }
  __syncthreads();
  const int total = s_total;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const long long base = (long long)t * kTile;
    TileRanks r;
    tile_ranks(p, base, r, s_counts);
    LaneRow rows[kItems];  // the dead lanes' rows, loading while the tile's prefix is read
    bool dead[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + (long long)k * kThreads + tid;
      dead[k] = i < p.n && !r.live[k];
      if (dead[k]) load_lane(p.in, i, rows[k]);
    }
    if (tid == 0) {
      unsigned long long w;
      do {
        w = load_relaxed(status + t);
      } while (status_flag(w, epoch) != FLAG_PREFIX);
      s_excl = (int)(unsigned)w - r.count;
    }
    __syncthreads();
    const int excl = s_excl;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      // the dead lanes of the tile before this one: its place in the tile less the live ones
      const int dead_before = k * kThreads + tid - r.live_before[k];
      if (dead[k])
        store_lane(p.out, base + (long long)k * kThreads + tid, total + (int)(base - excl) + dead_before, dead_before,
                   rows[k], s_src, s_dst);
    }
    const long long tile_lanes = (long long)p.n - base < kTile ? (long long)p.n - base : kTile;
    __syncthreads();
    copy_uniforms(p, (int)tile_lanes - r.count, s_src, s_dst);
    __syncthreads();
  }

  // the last block to finish resets the ticket and opens the next epoch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ctl + CTL_DONE, 1u) == gridDim.x - 1) {
      ctl[CTL_TICKET] = 0;
      ctl[CTL_DONE] = 0;
      __threadfence();
      atomicAdd(ctl + CTL_EPOCH, 1u);
    }
  }
}

__global__ void compact_backward_kernel(int n, const int* __restrict__ pos, const float* __restrict__ g_tp,
                                        const float* __restrict__ g_rad, float* __restrict__ d_tp,
                                        float* __restrict__ d_rad) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long src = 3LL * __ldg(pos + i);
    for (int c = 0; c < 3; ++c) {
      if (d_tp != nullptr) d_tp[3 * i + c] = __ldg(g_tp + src + c);
      if (d_rad != nullptr) d_rad[3 * i + c] = __ldg(g_rad + src + c);
    }
  }
}

// scatter (out[idx[j]] = x[j]) or gather (out[j] = x[idx[j]]) of (B, 3) rows
template <bool kScatter>
__global__ void unpermute_kernel(int n, const int* __restrict__ idx, const float* __restrict__ x,
                                 float* __restrict__ out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += (long long)gridDim.x * blockDim.x) {
    const long long other = 3LL * __ldg(idx + j);
    for (int c = 0; c < 3; ++c) {
      if (kScatter) out[other + c] = __ldg(x + 3 * j + c);
      else out[3 * j + c] = __ldg(x + other + c);
    }
  }
}

static unsigned copy_grid(int n) {
  long long g = ((long long)n + kCopyThreads - 1) / kCopyThreads;
  return (unsigned)(g < 1 ? 1 : (g > 65535LL * 16 ? 65535LL * 16 : g));
}

// ---- entry points; each returns a cudaError_t

// The tiles a batch of `n` lanes takes (the scratch holds CTL_WORDS64 +
// this many 64-bit words).
extern "C" int compact_tiles(int n) { return n <= 0 ? 1 : (int)(((long long)n + kTile - 1) / kTile); }

// `in`, `out`: CompactIn and CompactOut; `scratch`: the wrapper's, at least
// compact_tiles(n) + CTL_WORDS64 words, zero when first allocated.
extern "C" int compact_forward(int n, const CompactIn* in, const CompactOut* out, void* scratch, void* stream) {
  if (n < 0 || in == nullptr || out == nullptr || scratch == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  p.in = *in;
  p.out = *out;
  p.n = n;
  p.n_tiles = compact_tiles(n);
  p.scratch = static_cast<unsigned long long*>(scratch);
  compact_forward_kernel<<<p.n_tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// d_tp / d_rad (each null where not wanted) from g_tp / g_rad through pos.
extern "C" int compact_backward(int n, const void* pos, const void* g_tp, const void* g_rad, void* d_tp, void* d_rad,
                                void* stream) {
  if (n <= 0) return 0;
  if ((d_tp != nullptr && g_tp == nullptr) || (d_rad != nullptr && g_rad == nullptr)) return (int)cudaErrorInvalidValue;
  compact_backward_kernel<<<copy_grid(n), kCopyThreads, 0, (cudaStream_t)stream>>>(
      n, (const int*)pos, (const float*)g_tp, (const float*)g_rad, (float*)d_tp, (float*)d_rad);
  return (int)cudaGetLastError();
}

// scatter != 0: out[idx[j]] = x[j]; else out[j] = x[idx[j]].
extern "C" int unpermute(int n, const void* idx, const void* x, void* out, int scatter, void* stream) {
  if (n <= 0) return 0;
  if (scatter)
    unpermute_kernel<true><<<copy_grid(n), kCopyThreads, 0, (cudaStream_t)stream>>>(n, (const int*)idx,
                                                                                     (const float*)x, (float*)out);
  else
    unpermute_kernel<false><<<copy_grid(n), kCopyThreads, 0, (cudaStream_t)stream>>>(n, (const int*)idx,
                                                                                      (const float*)x, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
