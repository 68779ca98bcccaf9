// Deterministic per-batch-row reductions shared by bdot.cu and cg_tail.cu,
// and the block sum and the dependent launch of a second pass that
// csr_matvec.cu also takes.
//
// A row of D elements is read in 16-byte groups (4 floats or 2 doubles):
// as vectors where D is a multiple of the group and the bases are 16-byte
// aligned, else element by element with zeros beyond D. Both ways add in
// the same order, so the bits do not depend on alignment.
//
// A long row is reduced in two fixed-order steps: `reduce_blocks` blocks
// spread over the card each write one partial sum of their grid-stride
// share of the row to a workspace, and whoever needs the row's total sums
// the partials with `reduce_partials`, in a launch that depends on the
// first (launch_dependent). No atomics: the order of every addition
// depends only on D and the launch geometry, so two runs give the same
// bits, and every block that sums the same partials gets the same total.
// Accumulation is in the element type T. Compiled with --fmad=false: a
// product and its accumulation round separately, as in the unfused PyTorch
// version.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dprox {

constexpr int THREADS = 256;
constexpr int GROUPS_PER_BLOCK = 512;  // two groups per thread and operand
constexpr int MAX_BLOCKS = 1024;       // per row; grid-stride beyond this

template <typename T>
struct Group;
template <>
struct Group<float> {
  using vec = float4;
  static constexpr int W = 4;
};
template <>
struct Group<double> {
  using vec = double2;
  static constexpr int W = 2;
};

template <typename T>
__host__ __device__ inline long long groups_of(long long D) {
  return (D + Group<T>::W - 1) / Group<T>::W;
}

// Blocks that share one row of D elements (also the row's partial count).
template <typename T>
inline int reduce_blocks(long long D) {
  const long long n = (groups_of<T>(D) + GROUPS_PER_BLOCK - 1) / GROUPS_PER_BLOCK;
  return (int)(n < MAX_BLOCKS ? n : MAX_BLOCKS);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// max(v, lo) that lets NaN through, as torch.clamp(min=lo) does.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// Group g of a row: elements W g .. W g + W - 1, zero beyond D.
template <bool VEC, typename T>
__device__ __forceinline__ void load_group(const T* a, long long g, long long D,
                                           T (&v)[Group<T>::W]) {
  constexpr int W = Group<T>::W;
  if constexpr (VEC) {
    const typename Group<T>::vec x = reinterpret_cast<const typename Group<T>::vec*>(a)[g];
    v[0] = x.x;
    v[1] = x.y;
    if constexpr (W == 4) {
      v[2] = x.z;
      v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = g * W + k < D ? a[g * W + k] : T(0);
  }
}

// Stores group g of a row, the elements below D only.
template <bool VEC>
__device__ __forceinline__ void store_group(float* a, long long g, long long D,
                                            const float (&v)[4]) {
  if constexpr (VEC) {
    reinterpret_cast<float4*>(a)[g] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (g * 4 + k < D) a[g * 4 + k] = v[k];
  }
}

// Sum of `v` over the block, returned to every thread. Warp shuffles, then
// one slot per warp in `smem` (>= 32 elements), added in warp order.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // smem may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += smem[w];
  return total;
}

// Sum of a row's `n` partials, the same value in every thread of every block.
template <typename T>
__device__ __forceinline__ T reduce_partials(const T* partial, int n, T* smem) {
  T acc = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  return block_sum(acc, smem);
}

// This thread's share of <a, b> over a row of `groups` groups: groups
// start, start + step, ... added in that order, UNROLL of them (of each
// operand) loaded before any is added.
template <int UNROLL, bool VEC, typename T>
__device__ __forceinline__ T dot_share(const T* a, const T* b, long long start, long long step,
                                       long long groups, long long D) {
  constexpr int W = Group<T>::W;
  T acc = T(0);
  for (long long g0 = start; g0 < groups; g0 += UNROLL * step) {
    T x[UNROLL][W], y[UNROLL][W];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * step;
      if (g < groups) {
        load_group<VEC>(a, g, D, x[u]);
        load_group<VEC>(b, g, D, y[u]);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) x[u][k] = y[u][k] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < W; ++k) acc += x[u][k] * y[u][k];
  }
  return acc;
}

// A second pass that adds the first's partial sums, launched as a
// programmatic dependent launch: the card may start it while the first
// still runs; it calls wait_for_primary() before it reads anything the
// first writes, which waits for the first grid's completion and its
// writes. The first calls allow_dependent_launch(). That hides most of the
// gap between two dependent launches.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// partial[row * nblk + k] = block k's share of <a_row, b_row>, for the
// grid's nblk * B blocks (rows along x). Lets the launch that sums the
// partials start at once.
template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
dot_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ partial,
                   long long D, int nblk) {
  allow_dependent_launch();
  __shared__ T smem[32];
  const long long row = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const T acc = dot_share<2, VEC>(a + row * D, b + row * D,
                                  (long long)blk * THREADS + threadIdx.x,
                                  (long long)nblk * THREADS, groups_of<T>(D), D);
  const T total = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, cudaStream_t s,
                     Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.stream = s;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, args...);
}

// Makes `device` current for the life of the guard (a wrapper hands the
// operands' device, so that it need not switch PyTorch's).
struct DeviceGuard {
  int previous = -1;
  cudaError_t error = cudaSuccess;
  explicit DeviceGuard(int device) {
    error = cudaGetDevice(&previous);
    if (error == cudaSuccess && previous != device) error = cudaSetDevice(device);
    else previous = -1;
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

}  // namespace dprox
