// One conjugate-gradient iteration minus the matvec, per batch row:
//   pAp = <p, Ap>;  alpha = rs / max(pAp, 1e-32)
//   x' = x + alpha p;  r' = r - alpha Ap;  rs' = <r', r'>
//   beta = rs' / max(rs, 1e-32);  p' = r' + beta p
//
// Replaces dprox_tpu/ops/pallas_kernels.py::fused_cg_tail (body
// _cg_tail_kernel), which linalg/solvers.py::cg_pallas runs every inner
// iteration. The TPU kernel holds a whole batch row in VMEM and does both
// reductions there; on the card a row is spread over many blocks and the
// second reduction depends on the first through alpha, so the work is three
// ordinary launches on one stream inside one C entry point:
//   1. partial sums of <p, Ap>                        (reads p, Ap)
//   2. every block adds the partials to alpha (same order, same bits in
//      every block), writes x' and r', and partial sums of <r', r'>
//   3. every block adds those to rs' and beta, writes p'; block 0 writes rs'
// alpha, beta and rs' never leave the device and nothing synchronises with
// the host. Reductions are fixed-order (reduce.cuh), so results are
// deterministic. Between the launches the arrays stay in the 50 MB L2 at the
// solver's sizes (5.5 MB of state at 3x256x256). Ordinary launches can be
// captured in a CUDA graph; a cooperative grid-wide sync was not needed.
//
// x_out, r_out and p_out may alias x, r and p (each element is read and
// written by the same thread); rs_out must not alias rs.
//
// Bound on the card: bytes, 28 per element (x, r, p, Ap read, x', r', p'
// written): 5.5 MB at 1x3x256x256, ~1.6 us at 3.35 TB/s. The three launches
// move 44 bytes per element (p, Ap and r' are read twice).

#include "reduce.cuh"

namespace {

using namespace dprox;

template <bool VEC>
__global__ void cg_update_xr_kernel(const float* x, const float* r,
                                    const float* __restrict__ p,
                                    const float* __restrict__ Ap,
                                    const float* __restrict__ rs,
                                    const float* __restrict__ partial_pAp,
                                    float* x_out, float* r_out,
                                    float* __restrict__ partial_rr, long long D) {
  __shared__ float smem[32];
  const int row = blockIdx.y, nblk = gridDim.x;
  const float pAp = reduce_partials(partial_pAp + (long long)row * nblk, nblk, smem);
  const float alpha = rs[row] / clamp_min(pAp, 1e-32f);
  const long long base = (long long)row * D;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  float acc = 0.0f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* r4 = reinterpret_cast<const float4*>(r + base);
    const float4* p4 = reinterpret_cast<const float4*>(p + base);
    const float4* A4 = reinterpret_cast<const float4*>(Ap + base);
    float4* xo4 = reinterpret_cast<float4*>(x_out + base);
    float4* ro4 = reinterpret_cast<float4*>(r_out + base);
    for (long long i = start; i < D / 4; i += step) {
      const float4 xv = x4[i], rv = r4[i], pv = p4[i], av = A4[i];
      const float4 rn = make_float4(rv.x - alpha * av.x, rv.y - alpha * av.y,
                                    rv.z - alpha * av.z, rv.w - alpha * av.w);
      xo4[i] = make_float4(xv.x + alpha * pv.x, xv.y + alpha * pv.y,
                           xv.z + alpha * pv.z, xv.w + alpha * pv.w);
      ro4[i] = rn;
      acc += rn.x * rn.x;
      acc += rn.y * rn.y;
      acc += rn.z * rn.z;
      acc += rn.w * rn.w;
    }
  } else {
    for (long long i = start; i < D; i += step) {
      const float rn = r[base + i] - alpha * Ap[base + i];
      x_out[base + i] = x[base + i] + alpha * p[base + i];
      r_out[base + i] = rn;
      acc += rn * rn;
    }
  }
  const float total = block_sum(acc, smem);
  if (threadIdx.x == 0) partial_rr[(long long)row * nblk + blockIdx.x] = total;
}

template <bool VEC>
__global__ void cg_update_p_kernel(const float* __restrict__ r_new, const float* p,
                                   const float* __restrict__ rs,
                                   const float* __restrict__ partial_rr,
                                   float* p_out, float* __restrict__ rs_out,
                                   long long D) {
  __shared__ float smem[32];
  const int row = blockIdx.y, nblk = gridDim.x;
  const float rs_new = reduce_partials(partial_rr + (long long)row * nblk, nblk, smem);
  const float beta = rs_new / clamp_min(rs[row], 1e-32f);
  const long long base = (long long)row * D;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  if (VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(r_new + base);
    const float4* p4 = reinterpret_cast<const float4*>(p + base);
    float4* po4 = reinterpret_cast<float4*>(p_out + base);
    for (long long i = start; i < D / 4; i += step) {
      const float4 rv = r4[i], pv = p4[i];
      po4[i] = make_float4(rv.x + beta * pv.x, rv.y + beta * pv.y,
                           rv.z + beta * pv.z, rv.w + beta * pv.w);
    }
  } else {
    for (long long i = start; i < D; i += step)
      p_out[base + i] = r_new[base + i] + beta * p[base + i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) rs_out[row] = rs_new;
}

}  // namespace

extern "C" {

// Floats of workspace that dprox_cg_tail needs for B rows of D elements.
int dprox_cg_tail_workspace(int B, long long D) { return 2 * B * reduce_blocks(D); }

// Returns a cudaError_t (0 on success). Launches on `stream` and does not
// synchronise. x, r, p, Ap and the three outputs: [B, D] contiguous; rs,
// rs_out: [B]; workspace as sized above.
int dprox_cg_tail(const float* x, const float* r, const float* p, const float* Ap,
                  const float* rs, float* x_out, float* r_out, float* p_out,
                  float* rs_out, float* workspace, int B, long long D, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0 || rs == rs_out) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(D);
  const dim3 grid(nblk, B);
  cudaStream_t s = (cudaStream_t)stream;
  float* partial_pAp = workspace;
  float* partial_rr = workspace + (long long)B * nblk;
  const bool vec = D % 4 == 0 && aligned16(x) && aligned16(r) && aligned16(p) &&
                   aligned16(Ap) && aligned16(x_out) && aligned16(r_out) &&
                   aligned16(p_out);
  cudaError_t e;
  if (vec) {
    dot_partial_kernel<true><<<grid, THREADS, 0, s>>>(p, Ap, partial_pAp, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cg_update_xr_kernel<true><<<grid, THREADS, 0, s>>>(
        x, r, p, Ap, rs, partial_pAp, x_out, r_out, partial_rr, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cg_update_p_kernel<true><<<grid, THREADS, 0, s>>>(
        r_out, p, rs, partial_rr, p_out, rs_out, D);
  } else {
    dot_partial_kernel<false><<<grid, THREADS, 0, s>>>(p, Ap, partial_pAp, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cg_update_xr_kernel<false><<<grid, THREADS, 0, s>>>(
        x, r, p, Ap, rs, partial_pAp, x_out, r_out, partial_rr, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cg_update_p_kernel<false><<<grid, THREADS, 0, s>>>(
        r_out, p, rs, partial_rr, p_out, rs_out, D);
  }
  return (int)cudaGetLastError();
}

const char* dprox_cg_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
