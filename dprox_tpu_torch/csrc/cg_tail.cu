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
// launches on one stream inside one C entry point:
//   1. partial sums of <p, Ap>                        (reads p, Ap)
//   2. every block adds the partials to alpha (same order, same bits in
//      every block), writes x' and r', and partial sums of <r', r'>
//   3. every block adds those to rs' and beta, writes p'; block 0 writes rs'
// The second and third are programmatic dependent launches: the card
// schedules their blocks while the launch before still runs, and they load
// what that launch does not write (x, r, p, Ap; p) before they wait for it.
// alpha, beta and rs' never leave the device and nothing synchronises with
// the host. Reductions are fixed-order (reduce.cuh), so results are
// deterministic, and the three launches can be captured in a CUDA graph.
// Between the launches the arrays stay in the 50 MB L2 at the solver's
// sizes (5.5 MB of state at 3x256x256).
//
// One thread-block cluster per row would keep the tail in one launch, but a
// cluster lies in one GPC of the card and moves a row of megabytes at that
// GPC's share of the L2 bandwidth: at 1x3x256x256 it lost to these spread
// launches.
//
// The outputs must not alias the inputs (the third launch reads p while the
// second writes x' and r'); rs_out must not alias rs.
//
// Bound on the card: bytes, 28 per element (x, r, p, Ap read, x', r', p'
// written): 5.5 MB at 1x3x256x256, ~1.6 us at 3.35 TB/s. The three launches
// move 44 bytes per element (p, Ap and r' are read twice).

#include "reduce.cuh"

namespace {

using namespace dprox;

constexpr int UNROLL = 2;  // groups of each operand in flight per thread

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cg_update_xr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    const float* __restrict__ p, const float* __restrict__ Ap,
                    const float* __restrict__ rs, const float* __restrict__ partial_pAp,
                    float* __restrict__ x_out, float* __restrict__ r_out,
                    float* __restrict__ partial_rr, long long D, int nblk) {
  __shared__ float smem[32];
  const long long row = blockIdx.x / nblk, base = row * D, groups = groups_of<float>(D);
  const long long step = (long long)nblk * THREADS;
  long long g0 = (long long)(blockIdx.x % nblk) * THREADS + threadIdx.x;
  float xv[UNROLL][4], rv[UNROLL][4], pv[UNROLL][4], av[UNROLL][4];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * step;
      if (g < groups) {
        load_group<VEC>(x + base, g, D, xv[u]);
        load_group<VEC>(r + base, g, D, rv[u]);
        load_group<VEC>(p + base, g, D, pv[u]);
        load_group<VEC>(Ap + base, g, D, av[u]);
      }
    }
  };
  // x, r, p, Ap and rs were written before the first launch started
  load();
  const float rs_row = rs[row];
  wait_for_primary();
  allow_dependent_launch();
  const float pAp = reduce_partials(partial_pAp + row * nblk, nblk, smem);
  const float alpha = rs_row / clamp_min(pAp, 1e-32f);
  float acc = 0.0f;
  while (g0 < groups) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * step;
      if (g >= groups) break;
      float xn[4], rn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rn[k] = rv[u][k] - alpha * av[u][k];
        xn[k] = xv[u][k] + alpha * pv[u][k];
      }
      store_group<VEC>(x_out + base, g, D, xn);
      store_group<VEC>(r_out + base, g, D, rn);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (VEC || g * 4 + k < D) acc += rn[k] * rn[k];
    }
    g0 += UNROLL * step;
    load();
  }
  const float total = block_sum(acc, smem);
  if (threadIdx.x == 0) partial_rr[blockIdx.x] = total;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cg_update_p_kernel(const float* __restrict__ r_new, const float* __restrict__ p,
                   const float* __restrict__ rs, const float* __restrict__ partial_rr,
                   float* __restrict__ p_out, float* __restrict__ rs_out, long long D,
                   int nblk) {
  __shared__ float smem[32];
  const long long row = blockIdx.x / nblk, base = row * D, groups = groups_of<float>(D);
  const long long step = (long long)nblk * THREADS;
  long long g0 = (long long)(blockIdx.x % nblk) * THREADS + threadIdx.x;
  float pv[UNROLL][4], rv[UNROLL][4];
  // p and rs are not written by the launch before
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (g0 + u * step < groups) load_group<VEC>(p + base, g0 + u * step, D, pv[u]);
  const float rs_row = rs[row];
  wait_for_primary();
  const float rs_new = reduce_partials(partial_rr + row * nblk, nblk, smem);
  const float beta = rs_new / clamp_min(rs_row, 1e-32f);
  while (g0 < groups) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g0 + u * step < groups) load_group<VEC>(r_new + base, g0 + u * step, D, rv[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * step;
      if (g >= groups) break;
      float pn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pn[k] = rv[u][k] + beta * pv[u][k];
      store_group<VEC>(p_out + base, g, D, pn);
    }
    g0 += UNROLL * step;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g0 + u * step < groups) load_group<VEC>(p + base, g0 + u * step, D, pv[u]);
  }
  if (blockIdx.x % nblk == 0 && threadIdx.x == 0) rs_out[row] = rs_new;
}

template <bool VEC>
int launch(const float* x, const float* r, const float* p, const float* Ap, const float* rs,
           float* x_out, float* r_out, float* p_out, float* rs_out, float* workspace, int B,
           long long D, cudaStream_t s) {
  const int nblk = reduce_blocks<float>(D);
  float* partial_pAp = workspace;
  float* partial_rr = workspace + (long long)B * nblk;
  dot_partial_kernel<VEC, float><<<nblk * B, THREADS, 0, s>>>(p, Ap, partial_pAp, D, nblk);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  e = launch_dependent(cg_update_xr_kernel<VEC>, dim3(nblk * B), THREADS, s, x, r, p, Ap, rs,
                       (const float*)partial_pAp, x_out, r_out, partial_rr, D, nblk);
  if (e != 0) return e;
  return launch_dependent(cg_update_p_kernel<VEC>, dim3(nblk * B), THREADS, s,
                          (const float*)r_out, p, rs, (const float*)partial_rr, p_out, rs_out,
                          D, nblk);
}

}  // namespace

extern "C" {

// Floats of workspace that dprox_cg_tail needs for B rows of D elements;
// -1 past the grid's limit.
int dprox_cg_tail_workspace(int B, long long D) {
  const long long n = 2LL * B * reduce_blocks<float>(D);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// Returns a cudaError_t (0 on success). Launches on `stream` of CUDA device
// `device` and does not synchronise. x, r, p, Ap and the three outputs:
// [B, D] contiguous; rs, rs_out: [B]; workspace as sized above.
int dprox_cg_tail(const float* x, const float* r, const float* p, const float* Ap,
                  const float* rs, float* x_out, float* r_out, float* p_out, float* rs_out,
                  float* workspace, int B, long long D, int device, void* stream) {
  if (B <= 0 || D <= 0 || rs == rs_out || workspace == nullptr ||
      (long long)reduce_blocks<float>(D) * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = D % 4 == 0 && aligned16(x) && aligned16(r) && aligned16(p) &&
                   aligned16(Ap) && aligned16(x_out) && aligned16(r_out) && aligned16(p_out);
  if (vec)
    return launch<true>(x, r, p, Ap, rs, x_out, r_out, p_out, rs_out, workspace, B, D, s);
  return launch<false>(x, r, p, Ap, rs, x_out, r_out, p_out, rs_out, workspace, B, D, s);
}

const char* dprox_cg_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
