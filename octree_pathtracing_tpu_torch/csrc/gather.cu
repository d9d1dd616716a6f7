// Kernel P1: the row gather out[i] = table[idx[i]] of (N, W) 32-bit rows,
// from one table or from two tables of one shape with the same indices.
//
// Replaces: tools/profile_pallas.py `k_smem_loop` (:67, called at :75), the
// TPU probe that gathered (N, 8) int32 rows through scalar-prefetched
// indices.  In the port it does the two small-table gathers of the emitter
// pick, models/emitters._spatial_pick, in one launch: each shading lane's
// supercell row of `grid_idx` (int32) and of `grid_w` (float32; the kernel
// copies bits, so the copy is exact), both (4096, K) with K = min(8,
// emitters).
//
// Indices are int32 or int64, read as they come.  An index in [-N, -1]
// wraps to index + N, as jnp indexing (and the Pallas kernel in interpret
// mode) does; then every index is clipped to [0, N - 1], as XLA clips the
// indices of a gather.
//
// What bounds it: at the shapes it runs at, launch latency.  By bytes it
// would be bound by the memory: per output row a 4- or 8-byte index and one
// 4W-byte row read per table and 4W bytes written per table, no arithmetic;
// but 65,536 rows of 32 B are ~2 MB, under a microsecond at 3.35 TB/s,
// well below a launch.  So the design keeps the launch count and the work
// per launch small: both tables in one launch, each index read once per
// row, no staging.  When W is a multiple of 4 (W = 8 on the main path),
// W / 4 threads share a row and move 16-byte pieces (`__ldg` of an int4,
// one 16-byte store per piece and table), so for W = 8 a thread pair moves
// a row and a warp writes 512 contiguous bytes per table.  Other widths (a
// table of fewer than 8 emitters) take one thread per 32-bit word.  The
// emitter grid's tables (128 KB each) and the probe's (131072, 8) table
// (4 MB) stay in the 50 MB L2; staging them in shared memory would not fit
// two grid tables in one SM's 228 KB and would add a pass.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ long long clip_row(long long r, long long n_rows) {
  if (r < 0) r += n_rows;  // [-N, -1] wraps
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// T = int4: `pieces` 16-byte pieces per row; T = int: `pieces` words per row.
// I: the index type.  kTables = 2 gathers the same rows of `a` and `b`.
template <typename T, typename I, int kTables>
__global__ void row_gather_kernel(const T* __restrict__ a, const T* __restrict__ b, long long n_rows,
                                  const I* __restrict__ idx, long long n_out, int pieces,
                                  T* __restrict__ out_a, T* __restrict__ out_b) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = t / pieces;
  if (row >= n_out) return;
  long long piece = t - row * pieces;
  long long src = clip_row((long long)__ldg(idx + row), n_rows) * pieces + piece;
  T va = __ldg(a + src);
  if (kTables == 2) out_b[t] = __ldg(b + src);
  out_a[t] = va;
}

template <typename T, typename I>
static void launch(const void* a, const void* b, long long n_rows, const void* idx, long long n_out,
                   int pieces, void* out_a, void* out_b, unsigned int grid, cudaStream_t stream) {
  const int threads = 256;
  if (b) {
    row_gather_kernel<T, I, 2><<<grid, threads, 0, stream>>>(
        (const T*)a, (const T*)b, n_rows, (const I*)idx, n_out, pieces, (T*)out_a, (T*)out_b);
  } else {
    row_gather_kernel<T, I, 1><<<grid, threads, 0, stream>>>(
        (const T*)a, nullptr, n_rows, (const I*)idx, n_out, pieces, (T*)out_a, nullptr);
  }
}

// out_a = a[clip(idx)] and, when `b` is not null, out_b = b[clip(idx)], for
// (n_rows, width) tables of 32-bit words.  `idx64`: the indices are int64,
// else int32.  `vec4` != 0: width % 4 == 0 and every table and output
// 16-byte aligned (the wrapper checks both).  Returns a cudaError_t.
extern "C" int row_gather(const void* a, const void* b, long long n_rows, int width, int vec4,
                          const void* idx, int idx64, long long n_out, void* out_a, void* out_b,
                          void* stream) {
  if (n_out <= 0) return 0;
  if (n_rows <= 0 || width <= 0 || (vec4 && width % 4 != 0)) return (int)cudaErrorInvalidValue;
  int pieces = vec4 ? width / 4 : width;
  long long grid = (n_out * pieces + 255) / 256;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int g = (unsigned int)grid;
  if (vec4 && idx64) launch<int4, long long>(a, b, n_rows, idx, n_out, pieces, out_a, out_b, g, s);
  else if (vec4) launch<int4, int>(a, b, n_rows, idx, n_out, pieces, out_a, out_b, g, s);
  else if (idx64) launch<int, long long>(a, b, n_rows, idx, n_out, pieces, out_a, out_b, g, s);
  else launch<int, int>(a, b, n_rows, idx, n_out, pieces, out_a, out_b, g, s);
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
