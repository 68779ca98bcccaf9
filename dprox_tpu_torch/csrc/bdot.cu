// Per-batch dot products: out[b] = <p_b, q_b> over [B, D] float32 or float64
// rows.
//
// Replaces dprox_tpu/ops/pallas_kernels.py::bdot_pallas (body _bdot_kernel),
// the inner product of every CG-family solver (linalg/solvers.py::bdot). The
// TPU kernel holds one whole batch row in VMEM per grid step. Here a short
// row (at most ONE_BLOCK_GROUPS 16-byte groups: 10 240 floats, which holds
// the LP solvers' rows of 8208 variables) is one block: one launch, no
// workspace. A longer row is shared by
// reduce_blocks(D) blocks spread over the card that write partial sums to
// a workspace, and a one-block-per-row launch that depends on the first
// (a programmatic dependent launch, so it is scheduled while the first
// runs) adds them in a fixed order (reduce.cuh). Rows lie along grid x. No
// atomics: the same bits on every call, and both routes can be captured
// in a CUDA graph. Accumulation is in the operands' type: float32 as in
// the TPU kernel, and float64 for the float64 LP solves (dprox_bdot_f64),
// whose JAX counterpart takes the plain jnp.sum route.
//
// A thread-block cluster would keep a long row in one launch, but a
// cluster lies in one GPC of the card and reads a row of megabytes at
// that GPC's share of the L2 bandwidth: at 1x3x256x256 it lost to the
// spread blocks and their second launch.
//
// Bound on the card: bytes, 2 * D * sizeof(T) per row (each operand read
// once): 66 KB at path C's [1, 8208], 0.02 us at 3.35 TB/s, and 1.6 MB at
// 1x3x256x256, 0.47 us. At the solvers' sizes launch latency is the floor.

#include "reduce.cuh"

namespace {

using namespace dprox;

constexpr int ONE_BLOCK_THREADS = 512, ONE_BLOCK_GROUPS = 2560;

// Row blockIdx.x in one block: thread t adds groups t, t + THREADS, ...
template <bool VEC, typename T>
__global__ void __launch_bounds__(ONE_BLOCK_THREADS)
bdot_row_kernel(const T* __restrict__ p, const T* __restrict__ q, T* __restrict__ out,
                long long D) {
  __shared__ T smem[32];
  const long long row = blockIdx.x;
  const T acc = dot_share<4, VEC>(p + row * D, q + row * D, threadIdx.x, ONE_BLOCK_THREADS,
                                  groups_of<T>(D), D);
  const T total = block_sum(acc, smem);
  if (threadIdx.x == 0) out[row] = total;
}

// out[row] = the sum of the row's nblk partials, one block per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bdot_finish_kernel(const T* __restrict__ partial, int nblk, T* __restrict__ out) {
  __shared__ T smem[32];
  wait_for_primary();
  const T total = reduce_partials(partial + (long long)blockIdx.x * nblk, nblk, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

template <typename T>
bool one_block(long long D) {
  return groups_of<T>(D) <= ONE_BLOCK_GROUPS;
}

template <bool VEC, typename T>
int launch(const T* p, const T* q, T* out, T* workspace, int B, long long D,
           cudaStream_t s) {
  if (one_block<T>(D)) {
    bdot_row_kernel<VEC, T><<<B, ONE_BLOCK_THREADS, 0, s>>>(p, q, out, D);
    return (int)cudaGetLastError();
  }
  const int nblk = reduce_blocks<T>(D);
  if ((long long)nblk * B > 0x7fffffffLL || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  dot_partial_kernel<VEC, T><<<nblk * B, THREADS, 0, s>>>(p, q, workspace, D, nblk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_dependent(bdot_finish_kernel<T>, dim3(B), THREADS, s,
                          (const T*)workspace, nblk, out);
}

template <typename T>
int bdot(const T* p, const T* q, T* out, T* workspace, int B, long long D, int device,
         void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % Group<T>::W == 0 && aligned16(p) && aligned16(q))
    return launch<true>(p, q, out, workspace, B, D, s);
  return launch<false>(p, q, out, workspace, B, D, s);
}

}  // namespace

extern "C" {

// Elements of workspace (of the operands' type, `elem_bytes` each: 4 or 8)
// that dprox_bdot or dprox_bdot_f64 need for B rows of D elements; 0 for
// rows short enough for one block; -1 past the grid's limit.
int dprox_bdot_workspace(int B, long long D, int elem_bytes) {
  const bool f64 = elem_bytes == 8;
  if (f64 ? one_block<double>(D) : one_block<float>(D)) return 0;
  const long long n = (long long)B * (f64 ? reduce_blocks<double>(D) : reduce_blocks<float>(D));
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// Returns a cudaError_t (0 on success). Launches on `stream` of CUDA device
// `device` and does not synchronise. p, q: [B, D] contiguous; out: [B];
// workspace as sized above (may be null when that is 0).
int dprox_bdot(const float* p, const float* q, float* out, float* workspace, int B,
               long long D, int device, void* stream) {
  return bdot(p, q, out, workspace, B, D, device, stream);
}

// The same for float64 operands, output and workspace.
int dprox_bdot_f64(const double* p, const double* q, double* out, double* workspace, int B,
                   long long D, int device, void* stream) {
  return bdot(p, q, out, workspace, B, D, device, stream);
}

const char* dprox_bdot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
