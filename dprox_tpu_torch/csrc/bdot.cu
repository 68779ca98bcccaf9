// Per-batch dot products: out[b] = <p_b, q_b> over [B, D] float32 or float64
// rows.
//
// Replaces dprox_tpu/ops/pallas_kernels.py::bdot_pallas (body _bdot_kernel),
// the inner product of every CG-family solver (linalg/solvers.py::bdot). The
// TPU kernel holds one whole batch row in VMEM per grid step; a GPU block
// cannot, so a row is shared by reduce_blocks(D) blocks that write partial
// sums to a workspace, and a second one-block-per-row launch adds them in a
// fixed order (reduce.cuh). No float atomicAdd: the result is deterministic.
// Accumulation is in the operands' type: float32 as in the TPU kernel, and
// float64 for the float64 LP solves (dprox_bdot_f64), whose JAX counterpart
// takes the plain jnp.sum route.
//
// Bound on the card: bytes, 8 per element (each operand read once): 1.6 MB
// at 1x3x256x256, ~0.5 us at 3.35 TB/s, below the cost of launching the
// two kernels, so launch latency is the real floor at the solver's sizes.

#include "reduce.cuh"

namespace {

using namespace dprox;

template <typename T>
__global__ void bdot_finish_kernel(const T* __restrict__ partial, int n,
                                   T* __restrict__ out) {
  __shared__ T smem[32];
  const T total = reduce_partials(partial + (long long)blockIdx.x * n, n, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

}  // namespace

extern "C" {

// Elements of workspace (of the operands' type) that dprox_bdot and
// dprox_bdot_f64 need for B rows of D elements.
int dprox_bdot_workspace(int B, long long D) { return B * reduce_blocks(D); }

// Returns a cudaError_t (0 on success). Launches on `stream` and does not
// synchronise. p, q: [B, D] contiguous; out: [B]; workspace as sized above.
int dprox_bdot(const float* p, const float* q, float* out, float* workspace,
               int B, long long D, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(D);
  const dim3 grid(nblk, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0 && aligned16(p) && aligned16(q))
    dot_partial_kernel<true><<<grid, THREADS, 0, s>>>(p, q, workspace, D);
  else
    dot_partial_kernel<false><<<grid, THREADS, 0, s>>>(p, q, workspace, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bdot_finish_kernel<<<B, THREADS, 0, s>>>(workspace, nblk, out);
  return (int)cudaGetLastError();
}

// The same for float64 operands, output and workspace.
int dprox_bdot_f64(const double* p, const double* q, double* out, double* workspace,
                   int B, long long D, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(D);
  const dim3 grid(nblk, B);
  cudaStream_t s = (cudaStream_t)stream;
  dot_partial_kernel<false><<<grid, THREADS, 0, s>>>(p, q, workspace, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bdot_finish_kernel<<<B, THREADS, 0, s>>>(workspace, nblk, out);
  return (int)cudaGetLastError();
}

const char* dprox_bdot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
