// Kernel P2: a flat block of uniforms in [0, 1) from Philox4x32-10.
//
// Replaces: tools/profile_pallas.py `probe_rng`'s Pallas kernel (:114,
// called at :122), which drew 32 random bits per element from the TPU's
// hardware PRNG and mapped them to [0, 1) through the mantissa:
// bitcast((bits >> 9) | 0x3F800000) - 1.0.  The port's draw_uniforms
// (render/pathtracer.py) feeds every forward and training step from it.
//
// Hopper has no PRNG in hardware, so the bits come from the counter-based
// Philox4x32-10 (Salmon et al., SC'11; Random123's constants and round):
//   key     = the 64-bit seed as two 32-bit words (lo, hi),
//   counter = (block lo, block hi, stream lo, stream hi),
// where `block` is the index of a group of 4 outputs and `stream` the
// caller's 64-bit counter.  Output element i is word i % 4 of block i / 4,
// mapped to a float exactly as P2 maps it.  ops/random.py repeats the same
// arithmetic in torch int64; the two agree bit for bit, whatever the grid.
//
// What bounds it: the write of 4 bytes per output (a (65536, 5, 21) block
// is 27.5 MB: ~8.2 us at 3.35 TB/s).  Ten rounds of two 32x32 multiplies
// per 4 outputs are a chain of dependent multiplies; enough resident warps,
// or independent chains within a thread, hide it.  The design: a grid sized
// to the card (SMs x resident blocks of 256 threads, from the occupancy
// query, read once per device), in which each thread walks the output with
// a grid-stride loop and keeps kInFlight independent Philox blocks in
// flight per iteration, so that their chains overlap; then streaming
// 16-byte stores (`__stcs` of a float4: the block is read later by another
// kernel, not now), each store instruction writing consecutive 16-byte
// pieces from consecutive lanes.  On the H100 this runs at the bound, as
// one block per thread over a grid of ~6,700 blocks also did; kInFlight =
// 2 measured fastest (1, 2 and 4 in flight, grids of 1x and 4x the
// resident blocks: PERF.md).  The output comes from torch.empty, 16-byte
// aligned, and block b starts at byte 16 b; block n / 4 holds the n % 4
// outputs of the masked tail.

#include <cuda_runtime.h>
#include <stdint.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

constexpr int kThreads = 256;
constexpr int kInFlight = 2;  // Philox blocks per thread and iteration
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    uint32_t hi0 = __umulhi(PHILOX_M0, c.x);
    uint32_t lo0 = PHILOX_M0 * c.x;
    uint32_t hi1 = __umulhi(PHILOX_M1, c.z);
    uint32_t lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint4 philox_block(unsigned long long b, uint32_t stream_lo,
                                              uint32_t stream_hi, uint2 key) {
  return philox4x32_10(make_uint4((uint32_t)b, (uint32_t)(b >> 32), stream_lo, stream_hi), key);
}

__global__ void __launch_bounds__(kThreads)
philox_uniforms_kernel(float* __restrict__ out, long long n, uint32_t key_lo, uint32_t key_hi,
                       uint32_t stream_lo, uint32_t stream_hi) {
  const uint2 key = make_uint2(key_lo, key_hi);
  const long long full = n >> 2;  // blocks of 4 outputs written whole
  const long long stride = (long long)gridDim.x * kThreads;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long b0 = (long long)blockIdx.x * kThreads + threadIdx.x; b0 < full;
       b0 += kInFlight * stride) {
    uint4 w[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      w[j] = philox_block((unsigned long long)(b0 + j * stride), stream_lo, stream_hi, key);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (b0 + j * stride < full)
        __stcs(out4 + b0 + j * stride, make_float4(bits_to_unit(w[j].x), bits_to_unit(w[j].y),
                                                   bits_to_unit(w[j].z), bits_to_unit(w[j].w)));
    }
  }
  if ((n & 3) && blockIdx.x == 0 && threadIdx.x == 0) {  // the masked tail
    uint4 w = philox_block((unsigned long long)full, stream_lo, stream_hi, key);
    uint32_t words[4] = {w.x, w.y, w.z, w.w};
    for (int j = 0; j < (int)(n & 3); ++j) out[4 * full + j] = bits_to_unit(words[j]);
  }
}

// The card-sized grid: SMs x resident blocks, read once per device.
static int resident_blocks(int* out) {
  static int per_device[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, philox_uniforms_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    per_device[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = per_device[dev];
  return 0;
}

// Returns a cudaError_t.  `out` must be 16-byte aligned.
extern "C" int philox_uniforms(void* out, long long n, unsigned int key_lo,
                               unsigned int key_hi, unsigned int stream_lo,
                               unsigned int stream_hi, void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)out % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int card = 0;
  int rc = resident_blocks(&card);
  if (rc != 0) return rc;
  long long needed = ((n >> 2) + kThreads - 1) / kThreads;  // one block per thread at most
  long long grid = needed < card ? needed : card;
  if (grid < 1) grid = 1;
  philox_uniforms_kernel<<<(unsigned int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, key_lo, key_hi, stream_lo, stream_hi);
  return (int)cudaGetLastError();
}

extern "C" int philox_resident_blocks() {
  int card = 0;
  return resident_blocks(&card) == 0 ? card : -1;
}

extern "C" const char* philox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
