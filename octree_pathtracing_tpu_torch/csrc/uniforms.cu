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
// arithmetic in torch int64; the two agree bit for bit.
//
// What bounds it: the write of 4 bytes per output (a (65536, 5, 21) block
// is 27.5 MB: ~8.2 us at 3.35 TB/s).  Ten rounds of two 32x32 multiplies per
// 4 outputs stay below that.  One thread per block of 4 outputs, one 16-byte
// store per thread (the output comes from torch.empty, 16-byte aligned, and
// block b starts at byte 16 b), a masked tail for n % 4.

#include <cuda_runtime.h>
#include <stdint.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

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

__global__ void philox_uniforms_kernel(float* __restrict__ out, long long n,
                                       uint32_t key_lo, uint32_t key_hi,
                                       uint32_t stream_lo, uint32_t stream_hi) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long first = 4 * b;
  if (first >= n) return;
  uint4 w = philox4x32_10(
      make_uint4((uint32_t)b, (uint32_t)((unsigned long long)b >> 32), stream_lo, stream_hi),
      make_uint2(key_lo, key_hi));
  if (first + 4 <= n) {
    reinterpret_cast<float4*>(out)[b] =
        make_float4(bits_to_unit(w.x), bits_to_unit(w.y), bits_to_unit(w.z), bits_to_unit(w.w));
    return;
  }
  uint32_t words[4] = {w.x, w.y, w.z, w.w};
  for (int j = 0; first + j < n; ++j) out[first + j] = bits_to_unit(words[j]);
}

extern "C" int philox_uniforms(void* out, long long n, unsigned int key_lo,
                               unsigned int key_hi, unsigned int stream_lo,
                               unsigned int stream_hi, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long n_blocks = (n + 3) / 4;
  long long grid = (n_blocks + threads - 1) / threads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  philox_uniforms_kernel<<<(unsigned int)grid, threads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, key_lo, key_hi, stream_lo, stream_hi);
  return (int)cudaGetLastError();
}

extern "C" const char* philox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
