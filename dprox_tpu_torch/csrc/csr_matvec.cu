// Compressed-row matrix-vector product: y[r] = sum over k in
// [indptr[r], indptr[r + 1]) of values[k] * x[indices[k]], for a matrix of m
// rows given as indptr [m + 1], indices [nnz] (int32) and values [nnz].
//
// The second route of dprox_tpu/ops/pallas_kernels.py::bsr_matvec (body
// _bsr_kernel) on the card, in its own source so that it builds in parallel
// with the tile kernel. algo/lp/utils.py::BSRMat derives these arrays from
// its dense tiles for A and for A^T (explicit zeros dropped) and takes this
// route for both directions when they move fewer bytes than the tiles: the
// energy-planning LP's tiles are ~0.6% full, so the tile kernel (bsr_matvec.cu)
// reads 21 MB to use 0.43 MB of non-zeros. x is read flat, with no padding
// to whole blocks, and y is written at its length: the kernel masks its own
// ragged edge.
//
// The work is cut by non-zeros, not by rows. A^T of that LP has 16 rows of
// 513 (2049 at 2048 periods) non-zeros beside 8 192 (32 768) rows of 3.
// So the wrapper sorts the rows once, when the arrays are built
// (ops/kernels.py::csr_split), into three kinds of work, all in one launch:
//   * rows of at most MAX_SHORT non-zeros: one thread each, all of the
//     row's loads issued at once (a predicated, unrolled loop), summed in
//     row order;
//   * rows of at most WARP_ROW: one warp each; a lane sums every 32nd
//     product, then warp shuffles add the lanes;
//   * longer rows: pieces of at most MAX_CHUNK non-zeros, one thread
//     block each; a thread sums every THREADS-th product, then the
//     block's sum is taken in a fixed order (reduce.cuh). A row of one piece
//     is written by its block. Only a row longer than MAX_CHUNK has several
//     pieces: they write partial sums to a workspace (those pieces come
//     first), and a second launch adds each such row's pieces in order.
// So the energy-planning LP's long rows cost one launch like the short ones;
// A^T's capacity rows are cut from 4096 periods on (an hourly year has 8760).
// The kernel's MAX_SHORT, WARP_ROW and MAX_CHUNK are the wrapper's
// CSR_SHORT_ROW, CSR_WARP_ROW and CSR_CHUNK. Each output is written exactly
// once, in an order that depends only on the matrix: no atomics, no zero
// fill, the same bits twice, capturable in a CUDA graph. Products and sums are in the element type (float or double),
// compiled with --fmad=false like the other kernels.
//
// Bound on the card: bytes. nnz * (sizeof(T) + 4) for values and indices,
// (m + 1) * 4 for indptr, and the vectors: n * sizeof(T) read, m * sizeof(T)
// written. For the LP at 512 periods that is ~0.43 MB, 0.13 us at
// 3.35 TB/s, far below a launch: launch latency is the real floor here.

#include "reduce.cuh"

namespace {

using dprox::allow_dependent_launch;
using dprox::block_sum;
using dprox::launch_dependent;
using dprox::wait_for_primary;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SHORT = 16;                     // longest row one thread sums
constexpr int WARP_ROW = 128;                     // longest row one warp sums
constexpr int PER_THREAD = 16;                    // a block piece's loads per thread
constexpr int MAX_CHUNK = THREADS * PER_THREAD;   // longest block piece, 4096
constexpr int FINISH_THREADS = 128;

// Blocks [0, row_blocks): one thread per row of at most MAX_SHORT non-zeros.
// Blocks [row_blocks, row_blocks + n_wide): one block per piece p < n_wide.
// The rest: one warp per piece p >= n_wide (rows of at most WARP_ROW).
// Pieces p < n_split_pieces write partial[p]; the others write y[owner[p]].
template <typename T>
__global__ void __launch_bounds__(THREADS)
csr_matvec_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                  const T* __restrict__ values, const T* __restrict__ x,
                  const int* __restrict__ owner, const int* __restrict__ begin,
                  const int* __restrict__ end, T* __restrict__ y, T* __restrict__ partial,
                  int m, int row_blocks, int n_wide, int n_pieces,
                  int n_split_pieces) {
  allow_dependent_launch();
  const int blk = blockIdx.x;
  if (blk < row_blocks) {
    const int r = blk * THREADS + threadIdx.x;
    if (r >= m) return;
    const int b = indptr[r], e = indptr[r + 1];
    if (e - b > MAX_SHORT) return;  // a warp or a block writes this row
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < MAX_SHORT; ++q)
      if (b + q < e) acc += values[b + q] * x[indices[b + q]];
    y[r] = acc;
    return;
  }
  if (blk < row_blocks + n_wide) {  // the whole block takes this branch
    __shared__ T smem[32];
    const int p = blk - row_blocks;
    const int b = begin[p], e = end[p];
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int k = b + q * THREADS + threadIdx.x;
      if (k < e) acc += values[k] * x[indices[k]];
    }
    const T total = block_sum(acc, smem);
    if (threadIdx.x == 0) {
      if (p < n_split_pieces) partial[p] = total;
      else y[owner[p]] = total;
    }
    return;
  }
  // one warp per piece; the whole warp leaves together, no barrier follows
  const int p = n_wide + (blk - row_blocks - n_wide) * WARPS + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int b = begin[p], e = end[p];
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < WARP_ROW / 32; ++q) {
    const int k = b + q * 32 + lane;
    if (k < e) acc += values[k] * x[indices[k]];
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) y[owner[p]] = acc;
}

// y[row] = the row's pieces' partial sums, added in order, for each cut row.
template <typename T>
__global__ void csr_finish_kernel(const int* __restrict__ owner,
                                  const int* __restrict__ split_ptr,
                                  const T* __restrict__ partial, T* __restrict__ y,
                                  int n_split) {
  wait_for_primary();
  const int s = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (s >= n_split) return;
  const int p0 = split_ptr[s], p1 = split_ptr[s + 1];
  T acc = T(0);
  // unrolled: the loads are issued together, the adds stay in order
#pragma unroll 16
  for (int p = p0; p < p1; ++p) acc += partial[p];
  y[owner[p0]] = acc;
}

template <typename T>
int launch(const int* indptr, const int* indices, const void* values, const void* x,
           const int* owner, const int* begin, const int* end, const int* split_ptr,
           void* y, void* partial, int m, int n_wide, int n_pieces,
           int n_split, int n_split_pieces, cudaStream_t s) {
  const int row_blocks = (m + THREADS - 1) / THREADS;
  const int warp_blocks = (n_pieces - n_wide + WARPS - 1) / WARPS;
  csr_matvec_kernel<T><<<row_blocks + n_wide + warp_blocks, THREADS, 0, s>>>(
      indptr, indices, static_cast<const T*>(values), static_cast<const T*>(x), owner,
      begin, end, static_cast<T*>(y), static_cast<T*>(partial), m, row_blocks,
      n_wide, n_pieces, n_split_pieces);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 0) return (int)e;
  return launch_dependent(csr_finish_kernel<T>,
                          dim3((n_split + FINISH_THREADS - 1) / FINISH_THREADS), FINISH_THREADS,
                          s, owner, split_ptr, static_cast<const T*>(partial),
                          static_cast<T*>(y), n_split);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. indptr: [m + 1] int32, non-decreasing
// from 0; indices: [nnz] int32 columns within x; values: [nnz]; x: [n];
// y: [m]. The split (ops/kernels.py::csr_split): rows of at most 16
// non-zeros are summed by one thread. Every longer row is given as
// pieces [begin[p], end[p]) of row owner[p], n_pieces in all: the first
// n_wide are one thread block's each (at most 4096 non-zeros),
// the rest one warp's (a whole row of at most 128). The first
// n_split_pieces pieces belong to the n_split rows cut in two or more
// (split_ptr [n_split + 1] delimits each row's) and write partial
// [n_split_pieces]; the others write y. is_double: 0 for float32 values, x,
// y and partial, 1 for float64.
int dprox_csr_matvec(const int* indptr, const int* indices, const void* values,
                     const void* x, const int* owner, const int* begin, const int* end,
                     const int* split_ptr, void* y, void* partial, int m, int n_wide,
                     int n_pieces, int n_split, int n_split_pieces, int is_double,
                     void* stream) {
  if (m <= 0 || n_wide < 0 || n_wide > n_pieces || n_split < 0 || n_split_pieces < 0 ||
      n_split_pieces > n_wide || (n_split > 0) != (n_split_pieces > 0) ||
      (n_split_pieces > 0 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double>(indptr, indices, values, x, owner, begin, end, split_ptr, y,
                          partial, m, n_wide, n_pieces, n_split, n_split_pieces, s);
  return launch<float>(indptr, indices, values, x, owner, begin, end, split_ptr, y, partial,
                       m, n_wide, n_pieces, n_split, n_split_pieces, s);
}

const char* dprox_csr_matvec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
