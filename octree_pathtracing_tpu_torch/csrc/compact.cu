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
// Where the caller asks for it, src, the inverse of pos (src[pos[i]] = i),
// is written too: the bounce loop hands it to K4's backward and
// nee_backward, which store each lane's gradients at the row the lane came
// from, so that no frame launches compact_backward (ops/compact
// `compact_for_bounce`).
//
// One launch, a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016) over tiles of kTile lanes.  A block takes its tile from an atomic
// ticket, not from blockIdx, so that a tile's predecessors are always held
// by blocks that already run: the look-back then never waits on a tile that
// no block has started.  Within a tile each warp's ballot gives its lanes'
// ranks, and one warp scans the tile's (row, warp) counts with shuffles.
// The tile publishes its count at once (flag A) and, after the look-back,
// the live lanes before its end (flag P); the look-back reads 32
// predecessors at a time, one per lane of the scanning warp, and waits only
// on those before the nearest prefix.  A live lane's row needs only its
// tile's prefix, so the live lanes are written then.  A dead lane's row
// needs the total L, known only when the last tile has published its
// prefix; so each block, once the tickets are spent, writes the dead lanes
// of tiles blockIdx.x, blockIdx.x + gridDim.x, ...: by then every tile
// belongs to a running block, so that wait ends too, and the pass streams
// with no look-back.  The tile status words carry the call's epoch beside
// their flag, so that no fill clears them between calls; the last block to
// finish resets the ticket and advances the epoch.  The scratch (control
// words and one 64-bit status word per tile) is the wrapper's, one buffer
// per card that calls on one stream share; it is zero when first
// allocated.
//
// compact_backward: d_in[i] = d_out[pos[i]] for the throughput and the
// radiance (the only state fields that carry a gradient), a permutation:
// no atomics, bit-exact.  A direct caller of ops/compact.compact runs it;
// the bounce loop's frames do not (see src above).
//
// unpermute_forward: out[idx[j]] = radiance[j]; unpermute_backward:
// d[j] = g[idx[j]].  idx is a permutation of 0..B-1 (compact_forward's
// output), so every output row is written once.
//
// What bounds them: bytes.  The forward moves 288 bytes a lane (each state
// row read once and written once, the 84-byte uniform row read and written,
// 4 bytes of pos; 4 more of src where it is asked for); there is no
// arithmetic to speak of.  At the headline's
// 65,536 lanes the time is the latency of the kernel's dependent steps; at
// 2 M lanes it is device memory's rate.  So a tile is 256 lanes, one per
// thread (tiles of 1,024 and 512 lanes measured 2.0x and 1.3x slower at
// 65,536 lanes, 128 lanes slower at both sizes: PERF.md); every load of a
// lane is issued before any of its stores (a live lane's row while the
// look-back runs, a dead lane's while its tile's prefix is read); the state
// rows' reads are coalesced (each warp reads 32 consecutive lanes) and the
// writes nearly so (a tile's live lanes land in consecutive rows, as do its
// dead ones); a run's uniform rows are copied by the whole block word by
// word through the run's list of original indices in shared memory,
// consecutive threads on consecutive words, eight loads in flight per
// thread before their stores, and the stores land on consecutive words of
// the run.  Measured on the card and dropped (PERF.md): a second look-back
// over the dead lanes from the last tile back, so that no block waits for
// the total (at best 0.002 ms faster at 65,536 lanes, a third slower at
// 2 M, where this design's dead pass streams), with tiles staged in shared
// memory by 16-byte cp.async and 16-byte run stores, or rows through
// registers; the uniform rows written as aligned 16-byte stores of the
// run (4-13% slower than the word copy).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 1;  // lanes per thread and tile
constexpr int kTile = kThreads * kItems;
static_assert(kItems * kWarps <= 32, "one warp scans a tile's (row, warp) counts");
constexpr int N_U = 21;  // uniform words per lane and bounce (ops/shading.N_UNIFORMS)
constexpr int kCopyUnroll = 8;  // uniform words a thread loads before it stores them
constexpr int kCopyThreads = 256;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// a tile's status word: bits 32-63 the epoch (30 bits) and the flag, bits
// 0-31 the value
constexpr unsigned FLAG_AGGREGATE = 1, FLAG_PREFIX = 2;
// the control words ahead of the status words: the ticket, the blocks
// done, the epoch (as unsigned ints)
constexpr int CTL_TICKET = 0, CTL_DONE = 1, CTL_EPOCH = 2, CTL_WORDS64 = 2;

// compact_forward's slot array (ops/compact.FORWARD_SLOTS): the inputs,
// the outputs, the scratch, then two integers
enum Slot {
  S_ORIGIN, S_DIR, S_THROUGHPUT, S_RADIANCE, S_ACTIVE, S_SPECULAR, S_CUR_MAT, S_IDX, S_UNIFORMS,
  S_OUT_ORIGIN, S_OUT_DIR, S_OUT_THROUGHPUT, S_OUT_RADIANCE, S_OUT_ACTIVE, S_OUT_SPECULAR, S_OUT_CUR_MAT,
  S_OUT_IDX, S_OUT_U, S_POS, S_SRC, S_COUNTS, S_SCRATCH, S_U_LANE_STRIDE, S_BOUNCE, N_SLOTS
};

struct Params {
  const float* f_in[4];  // origin, dir, throughput, radiance: (B, 3)
  const uint8_t* active;
  const uint8_t* specular;
  const int* cur_mat;
  const int* idx;  // null: lane i's original index is i
  const float* uniforms;  // the frame's block; lane l's rows start at l * u_lane_stride
  long long u_lane_stride;
  int bounce;
  float* f_out[4];
  uint8_t* active_out;
  uint8_t* specular_out;
  int* cur_mat_out;
  int* idx_out;
  float* u_out;  // (B, N_U)
  int* pos;
  int* src;  // pos's inverse, row pos[i] came from lane i; null: not wanted
  int* counts;  // counts[bounce] takes the live count
  unsigned long long* scratch;
  int n, n_tiles;
};

// One lane's state row, held in registers between its load and its store.
struct LaneRow {
  float f[12];  // origin, dir, throughput, radiance
  int cur_mat, src;  // the medium; the original index
  uint8_t active, specular;
};

struct Smem {
  int counts[65];  // the tile's (row, warp) counts, their exclusive scan, the total
  int src[kTile];  // a run's original indices (their uniform rows) in destination order
  unsigned ticket;
  int excl, total;
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

// tile t's prefix, the live lanes up to its end, once it is published
__device__ __forceinline__ unsigned wait_prefix(const unsigned long long* status, int t, unsigned epoch) {
  unsigned long long w;
  do {
    w = load_relaxed(status + t);
  } while (status_flag(w, epoch) != FLAG_PREFIX);
  return (unsigned)w;
}

// Warp-wide: publishes tile t's live count (its aggregate at once, its
// inclusive prefix after the look-back) and returns the live lanes of the
// tiles before t.  Every lane of the warp calls it.  A round reads the 32
// tiles below the window's top, one a lane, and sums them back to the
// nearest prefix; it reads them again while a tile before that prefix has
// not published.
__device__ unsigned look_back(unsigned long long* status, unsigned t, unsigned count, unsigned epoch) {
  const int lane = threadIdx.x % 32;
  if (t == 0) {
    if (lane == 0) store_relaxed(status, status_word(epoch, FLAG_PREFIX, count));
    return 0;
  }
  if (lane == 0) store_relaxed(status + t, status_word(epoch, FLAG_AGGREGATE, count));
  unsigned excl = 0;
  long long j = (long long)t - 1 - lane;  // lane k reads the tile k + 1 below the window's top
  while (true) {
    const unsigned long long w = j >= 0 ? load_relaxed(status + j) : status_word(epoch, FLAG_PREFIX, 0);
    const unsigned flag = status_flag(w, epoch);
    const unsigned prefix = __ballot_sync(kFullMask, flag == FLAG_PREFIX);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;  // the nearest prefix ends the walk
    if (__any_sync(kFullMask, lane <= stop && flag == 0)) continue;  // a tile before it has not published
    unsigned v = lane <= stop ? (unsigned)w : 0u;
#pragma unroll
    for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(kFullMask, v, d);
    excl += v;
    if (prefix) break;
    j -= 32;
  }
  if (lane == 0) store_relaxed(status + t, status_word(epoch, FLAG_PREFIX, excl + count));
  return excl;
}

// What a tile's lanes are: per item row, each lane's liveness and, among
// the tile's lanes before it, the live ones.
struct TileRanks {
  bool live[kItems];
  int live_before[kItems];  // live lanes of the tile before this lane
  int count;  // live lanes of the tile
};

// Block-wide: the ranks of the lanes of the tile at `base`.  Lane (row k,
// thread tid) is lane base + k * kThreads + tid, so the tile's order is
// row-major.
__device__ void tile_ranks(const Params& p, long long base, TileRanks& r, int* s_counts) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  int in_warp[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + tid;
    r.live[k] = i < p.n && p.active[i] != 0;
    const unsigned ballot = __ballot_sync(kFullMask, r.live[k]);
    in_warp[k] = __popc(ballot & below);
    if (lane == 0) s_counts[k * kWarps + warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the tile's (row, warp) counts, at most 32
    int v = lane < kItems * kWarps ? s_counts[lane] : 0, incl = v;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      int o = __shfl_up_sync(kFullMask, incl, d);
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

// Loads lane i's row into registers; every load of a thread's lanes is
// issued before any of its stores.
__device__ __forceinline__ void load_lane(const Params& p, long long i, LaneRow& r) {
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.f[3 * f + c] = __ldg(p.f_in[f] + 3 * i + c);
  r.active = __ldg(p.active + i);
  r.specular = __ldg(p.specular + i);
  r.cur_mat = __ldg(p.cur_mat + i);
  r.src = p.idx != nullptr ? __ldg(p.idx + i) : (int)i;
}

// Writes lane i's row at `dst`, its pos and (where wanted) src[dst] = i,
// and puts its original index at `slot` of the run's list.
__device__ __forceinline__ void store_lane(const Params& p, long long i, int dst, int slot, const LaneRow& r,
                                           int* s_src) {
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int c = 0; c < 3; ++c) p.f_out[f][3LL * dst + c] = r.f[3 * f + c];
  p.active_out[dst] = r.active;
  p.specular_out[dst] = r.specular;
  p.cur_mat_out[dst] = r.cur_mat;
  p.idx_out[dst] = r.src;
  p.pos[i] = dst;
  if (p.src != nullptr) p.src[dst] = (int)i;
  s_src[slot] = r.src;
}

// Block-wide: the uniform rows of a run of `rows` lanes (their original
// indices in `src`) at rows [dst0, dst0 + rows) of the output block, word
// by word, consecutive threads on consecutive words, kCopyUnroll loads in
// flight per thread before their stores.
__device__ __forceinline__ void copy_uniforms(const Params& p, const int* src, int rows, int dst0) {
  const float* u = p.uniforms + (long long)p.bounce * N_U;
  float* out = p.u_out + (long long)dst0 * N_U;
  const int words = rows * N_U;
  for (int f0 = threadIdx.x; f0 < words; f0 += kThreads * kCopyUnroll) {
    float v[kCopyUnroll];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) {
      const int f = f0 + j * kThreads;
      if (f < words) {
        const int r = f / N_U;
        v[j] = __ldg(u + (long long)src[r] * p.u_lane_stride + (f - r * N_U));
      }
    }
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j)
      if (f0 + j * kThreads < words) out[f0 + j * kThreads] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads) compact_forward_kernel(const __grid_constant__ Params p) {
  __shared__ Smem s;
  unsigned* ctl = reinterpret_cast<unsigned*>(p.scratch);
  unsigned long long* status = p.scratch + CTL_WORDS64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(ctl + CTL_EPOCH);

  // the live lanes of every tile this block takes
  while (true) {
    if (tid == 0) s.ticket = atomicAdd(ctl + CTL_TICKET, 1u);
    __syncthreads();
    const unsigned t = s.ticket;
    if (t >= (unsigned)p.n_tiles) break;
    const long long base = (long long)t * kTile;
    TileRanks r;
    tile_ranks(p, base, r, s.counts);
    LaneRow rows[kItems];  // the live lanes' rows, loading while the look-back runs
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (r.live[k]) load_lane(p, base + (long long)k * kThreads + tid, rows[k]);
    if (warp == 0) {  // publish the count, look back for the prefix
      const unsigned excl = look_back(status, t, (unsigned)r.count, epoch);
      if (lane == 0) {
        s.excl = (int)excl;
        if (t == (unsigned)p.n_tiles - 1) p.counts[p.bounce] = (int)excl + r.count;
      }
    }
    __syncthreads();
    const int excl = s.excl;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (r.live[k])
        store_lane(p, base + (long long)k * kThreads + tid, excl + r.live_before[k], r.live_before[k], rows[k], s.src);
    __syncthreads();
    copy_uniforms(p, s.src, r.count, excl);
    __syncthreads();
  }

  // the dead lanes of tiles blockIdx.x, blockIdx.x + gridDim.x, ...: every
  // tile now belongs to a running block, so the total comes
  if (tid == 0) s.total = (int)wait_prefix(status, p.n_tiles - 1, epoch);
  __syncthreads();
  const int total = s.total;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const long long base = (long long)t * kTile;
    TileRanks r;
    tile_ranks(p, base, r, s.counts);
    LaneRow rows[kItems];  // the dead lanes' rows, loading while the tile's prefix is read
    bool dead[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + (long long)k * kThreads + tid;
      dead[k] = i < p.n && !r.live[k];
      if (dead[k]) load_lane(p, i, rows[k]);
    }
    if (tid == 0) s.excl = (int)wait_prefix(status, t, epoch) - r.count;
    __syncthreads();
    const int dst0 = total + (int)(base - s.excl);  // L + the dead lanes of the tiles before this one
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      // the dead lanes of the tile before this one: its place in the tile less the live ones
      const int dead_before = k * kThreads + tid - r.live_before[k];
      if (dead[k])
        store_lane(p, base + (long long)k * kThreads + tid, dst0 + dead_before, dead_before, rows[k], s.src);
    }
    const long long tile_lanes = (long long)p.n - base < kTile ? (long long)p.n - base : kTile;
    __syncthreads();
    copy_uniforms(p, s.src, (int)tile_lanes - r.count, dst0);
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

static int n_tiles(int n) { return n <= 0 ? 1 : (int)(((long long)n + kTile - 1) / kTile); }

// ---- entry points; each returns a cudaError_t

// The 64-bit words of the forward's scratch for a batch of `n` lanes.
extern "C" int compact_scratch_words(int n) { return CTL_WORDS64 + n_tiles(n); }

// `out`: the forward's launch on the current card for `n` lanes: threads,
// lanes per tile, blocks, shared memory bytes per block, resident blocks
// per SM, SMs, registers per thread.
extern "C" int compact_forward_config(int n, int* out) {
  int dev = 0, sms = 0, resident = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, compact_forward_kernel, kThreads, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, compact_forward_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = kTile;
  out[2] = n_tiles(n);
  out[3] = (int)sizeof(Smem);
  out[4] = resident;
  out[5] = sms;
  out[6] = attr.numRegs;
  return 0;
}

// `slots`: the N_SLOTS words of Slot's order (pointers; the uniforms'
// lane stride and the bounce as integers).  The scratch holds at least
// compact_scratch_words(n) words, zero when first allocated.
extern "C" int compact_forward(int n, const void* const* slots, int n_slots, void* stream) {
  if (n < 0 || n_slots != N_SLOTS || slots == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  for (int f = 0; f < 4; ++f) {
    p.f_in[f] = (const float*)slots[S_ORIGIN + f];
    p.f_out[f] = (float*)slots[S_OUT_ORIGIN + f];
  }
  p.active = (const uint8_t*)slots[S_ACTIVE];
  p.specular = (const uint8_t*)slots[S_SPECULAR];
  p.cur_mat = (const int*)slots[S_CUR_MAT];
  p.idx = (const int*)slots[S_IDX];
  p.uniforms = (const float*)slots[S_UNIFORMS];
  p.u_lane_stride = (long long)(intptr_t)slots[S_U_LANE_STRIDE];
  p.bounce = (int)(intptr_t)slots[S_BOUNCE];
  p.active_out = (uint8_t*)slots[S_OUT_ACTIVE];
  p.specular_out = (uint8_t*)slots[S_OUT_SPECULAR];
  p.cur_mat_out = (int*)slots[S_OUT_CUR_MAT];
  p.idx_out = (int*)slots[S_OUT_IDX];
  p.u_out = (float*)slots[S_OUT_U];
  p.pos = (int*)slots[S_POS];
  p.src = (int*)slots[S_SRC];
  p.counts = (int*)slots[S_COUNTS];
  p.scratch = (unsigned long long*)slots[S_SCRATCH];
  p.n = n;
  p.n_tiles = n_tiles(n);
  if (p.scratch == nullptr || p.counts == nullptr) return (int)cudaErrorInvalidValue;
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
