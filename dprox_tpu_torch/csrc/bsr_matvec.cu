// Block-sparse matrix-vector product over dense tiles:
//   out[ob] = sum over t in [row_ptr[ob], row_ptr[ob + 1]) of tiles[t] @ x[idx_in[t]]
// for tiles [T, bm, bn], x [n_in_blocks, bn], out [n_out_blocks, bm]. The
// tiles are ordered by output block, so row_ptr (n_out_blocks + 1 entries)
// delimits each output block's tiles; an output block without tiles is 0.
//
// Replaces dprox_tpu/ops/pallas_kernels.py::bsr_matvec (body _bsr_kernel),
// which algo/lp/utils.py::BSRMat applies forward (tiles, row-major tile
// order) and transposed (pre-transposed tiles, column-major order) in the
// LP ADMM's PCG loop, and whose gradient is the other direction's apply.
// The TPU kernel walks its tiles serially on one core, eight a grid step,
// accumulating into an output that stays in VMEM and is zeroed at step 0.
// On the card every output row is independent of every other, so the work
// is cut by rows, with no ordering between blocks: thread block
// (ob, part) owns ROWS_PER_BLOCK rows of output block ob, each of its warps
// owns ROWS_PER_WARP of them, and walks the output block's tiles in order.
// For each tile a lane reads its x values once and one element of each of
// the warp's rows per step (the 32 lanes read 32 neighbouring elements of a
// row), keeps a running sum per row in registers across all the tiles, and
// the lanes' sums are added once at the end by warp shuffles. Each output
// element is written exactly once by one warp: no atomics, no zero fill, no
// padding tiles, so two calls give the same bits. Products and sums are in
// the element type (float or double; never TF32), compiled with
// --fmad=false like the other kernels.
//
// Bound on the card: bytes. Every tile element is read once:
// T * bm * bn * sizeof(T), plus the vectors. For the energy-planning LP's
// 324 tiles of 128 x 128 floats that is 21 MB (~6.3 us at 3.35 TB/s) for a
// product that has ~33k non-zero terms; the dense-tile layout, not this
// kernel, sets that cost, so that operator takes the compressed route
// (csr_matvec.cu). BSRMat sends here only operators whose tiles move fewer
// bytes than compressed rows would. An output block with a long tile list
// (a dense block column of the transposed operator) is walked by its
// (bm / ROWS_PER_BLOCK) thread blocks alone, one tile after another.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
bsr_matvec_kernel(const T* __restrict__ tiles, const int* __restrict__ idx_in,
                  const int* __restrict__ row_ptr, const T* __restrict__ x,
                  T* __restrict__ out, int bm, int bn) {
  const int ob = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  if (row0 >= bm) return;  // whole warp leaves together; no barrier follows
  const int t_begin = row_ptr[ob], t_end = row_ptr[ob + 1];
  const long long tile_elems = (long long)bm * bn;

  T acc[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i] = T(0);

  // Unrolled so that the index, vector and tile loads of several tiles are in
  // flight at once: an output block with hundreds of tiles (a dense block
  // column of the transposed operator) is otherwise one memory latency per tile.
#pragma unroll 4
  for (int t = t_begin; t < t_end; ++t) {
    const T* __restrict__ xb = x + (long long)idx_in[t] * bn;
    const T* __restrict__ rows = tiles + t * tile_elems + (long long)row0 * bn;
    for (int j = lane; j < bn; j += 32) {
      const T xj = xb[j];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        if (row0 + i < bm) acc[i] += rows[(long long)i * bn + j] * xj;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    T v = acc[i];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && row0 + i < bm) out[(long long)ob * bm + row0 + i] = v;
  }
}

template <typename T>
int launch(const void* tiles, const int* idx_in, const int* row_ptr, const void* x,
           void* out, int n_out_blocks, int bm, int bn, cudaStream_t s) {
  const dim3 grid(n_out_blocks, (bm + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  bsr_matvec_kernel<T><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(tiles), idx_in, row_ptr, static_cast<const T*>(x),
      static_cast<T*>(out), bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. tiles: [T, bm, bn] contiguous; idx_in:
// [T] int32 input-block index of each tile; row_ptr: [n_out_blocks + 1] int32,
// non-decreasing, row_ptr[0] = 0 and row_ptr[n_out_blocks] = T; x: contiguous
// [*, bn] holding every block idx_in names; out: [n_out_blocks, bm].
// is_double: 0 for float32 tiles, x and out, 1 for float64.
int dprox_bsr_matvec(const void* tiles, const int* idx_in, const int* row_ptr,
                     const void* x, void* out, int n_out_blocks, int bm, int bn,
                     int is_double, void* stream) {
  if (n_out_blocks <= 0 || bm <= 0 || bn <= 0 ||
      (bm + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double>(tiles, idx_in, row_ptr, x, out, n_out_blocks, bm, bn, s);
  return launch<float>(tiles, idx_in, row_ptr, x, out, n_out_blocks, bm, bn, s);
}

const char* dprox_bsr_matvec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
