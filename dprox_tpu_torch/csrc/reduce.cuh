// Deterministic per-batch-row reductions shared by bdot.cu and cg_tail.cu,
// and the block sum and the dependent launch of its second pass that
// csr_matvec.cu takes.
//
// A row of D elements is reduced in two fixed-order steps: `reduce_blocks(D)`
// blocks each write one partial sum of their grid-stride share of the row to
// a workspace, and whoever needs the row's total sums the partials with
// `reduce_partials`. No atomics: the order of every addition depends only on
// D and the launch geometry, so two runs give the same bits, and every block
// that sums the same partials gets the same total. Accumulation is in the
// element type T: float32 everywhere, and float64 in bdot.cu's double entry.
// Compiled with --fmad=false: a product and its accumulation round
// separately, as in the unfused PyTorch version.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dprox {

constexpr int THREADS = 256;
constexpr int ELEMS_PER_BLOCK = 2048;  // two float4 loads per thread and array
constexpr int MAX_BLOCKS = 1024;       // per row; grid-stride beyond this

// Blocks that share one row of D elements (also the row's partial count).
inline int reduce_blocks(long long D) {
  long long n = (D + ELEMS_PER_BLOCK - 1) / ELEMS_PER_BLOCK;
  if (n < 1) n = 1;
  return (int)(n < MAX_BLOCKS ? n : MAX_BLOCKS);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// max(v, lo) that lets NaN through, as torch.clamp(min=lo) does.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
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

// partial[row * gridDim.x + blockIdx.x] = this block's share of <a_row, b_row>.
// Grid (reduce_blocks(D), B). VEC (float only): D % 4 == 0 and both bases
// 16-byte aligned.
template <bool VEC, typename T>
__global__ void dot_partial_kernel(const T* __restrict__ a,
                                   const T* __restrict__ b,
                                   T* __restrict__ partial, long long D) {
  static_assert(!VEC || sizeof(T) == sizeof(float), "float4 path is float only");
  __shared__ T smem[32];
  const long long base = (long long)blockIdx.y * D;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  T acc = T(0);
  if constexpr (VEC) {
    const float4* a4 = reinterpret_cast<const float4*>(a + base);
    const float4* b4 = reinterpret_cast<const float4*>(b + base);
    for (long long i = start; i < D / 4; i += step) {
      const float4 x = a4[i], y = b4[i];
      acc += x.x * y.x;
      acc += x.y * y.y;
      acc += x.z * y.z;
      acc += x.w * y.w;
    }
  } else {
    for (long long i = start; i < D; i += step) acc += a[base + i] * b[base + i];
  }
  const T total = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// A second pass that adds the first's partial sums, launched as a
// programmatic dependent launch: the card may start it while the first
// still runs; it calls wait_for_primary() before it reads a partial sum,
// which waits for the first grid's completion and its writes. The first
// calls allow_dependent_launch(). That hides most of the gap between two
// dependent launches.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
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

}  // namespace dprox
