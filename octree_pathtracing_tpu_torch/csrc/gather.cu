// Kernel P1: the row gather out[i] = table[idx[i]] of (N, W) 32-bit rows.
//
// Replaces: tools/profile_pallas.py `k_smem_loop` (:67, called at :75), the
// TPU probe that gathered (N, 8) int32 rows through scalar-prefetched
// indices.  In the port it does the two small-table gathers of the emitter
// pick, models/emitters._spatial_pick: each shading lane's supercell row of
// `grid_idx` (int32) and of `grid_w` (float32, gathered through an int32
// view, so the copy is bit-exact), both (4096, K) with K = min(8, emitters).
//
// Indices are clipped to [0, N - 1], as XLA clips the indices of a gather.
//
// What bounds it: bytes.  Per output row it reads a 4-byte index and one
// 4W-byte table row and writes 4W bytes; there is no arithmetic to speak of.
// When W is a multiple of 4 (W = 8 on the main path), W / 4 threads share a
// row: each loads the row's index, then one 16-byte piece of the row (`__ldg`
// of an int4) and stores it as one 16-byte store, so for W = 8 a thread pair
// moves a row and a warp writes 512 contiguous bytes.  Other widths (a table
// of fewer than 8 emitters) take one thread per 32-bit word.  The emitter
// grid's table is 128 KB and stays in L2; the probe's (131072, 8) table is
// 4 MB, also L2-resident.  This first version is simple and right; it is not
// tuned.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ long long clip_row(long long r, long long n_rows) {
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// T = int4: `pieces` 16-byte pieces per row; T = int: `pieces` words per row.
template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ table, long long n_rows,
                                  const int* __restrict__ idx, long long n_out,
                                  int pieces, T* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = t / pieces;
  if (row >= n_out) return;
  int piece = (int)(t - row * pieces);
  long long r = clip_row(__ldg(idx + row), n_rows);
  out[row * pieces + piece] = __ldg(table + r * pieces + piece);
}

// `vec4` != 0: width % 4 == 0 and table / out 16-byte aligned (the wrapper
// checks both).
extern "C" int row_gather(const void* table, long long n_rows, int width, int vec4,
                          const void* idx, long long n_out, void* out, void* stream) {
  if (n_out <= 0) return 0;
  if (n_rows <= 0 || width <= 0 || (vec4 && width % 4 != 0)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int pieces = vec4 ? width / 4 : width;
  long long grid = (n_out * pieces + threads - 1) / threads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (vec4) {
    row_gather_kernel<int4><<<(unsigned int)grid, threads, 0, (cudaStream_t)stream>>>(
        (const int4*)table, n_rows, (const int*)idx, n_out, pieces, (int4*)out);
  } else {
    row_gather_kernel<int><<<(unsigned int)grid, threads, 0, (cudaStream_t)stream>>>(
        (const int*)table, n_rows, (const int*)idx, n_out, pieces, (int*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
