// Fused ADMM consensus update: w = Kx + u; v = prox(w); u' = u + Kx - v, with
// prox(w) = max(w, 0) ("nonneg") or sign(w) * max(|w| - lam, 0) ("soft").
//
// Replaces dprox_tpu/ops/pallas_kernels.py::fused_admm_update (body
// _admm_update_kernel): the prox and the dual update share their loads of Kx
// and u and write both outputs in one pass, where the unfused form makes four
// elementwise passes. lam is read from a device pointer holding one value or
// one per batch element, so no launch waits for the host.
//
// The arithmetic is the unfused form's, operation for operation (compiled
// with --fmad=false, so u + Kx - sign*max is not contracted), and the result
// equals it exactly: sign(0) = 0, NaN goes through both outputs as it does
// in torch.sign / torch.clamp.
//
// Bound on the card: bytes, 16 per element (Kx and u read, v and u' written):
// 12.6 MB at 1x3x512x512, ~3.8 us at 3.35 TB/s, against 4-6 float operations
// per element. Design: one grid-stride pass, float4 loads and stores when the
// pointers are 16-byte aligned and a batch row is a multiple of 4 long (so
// the four lanes share one lam), else one element per thread.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int NONNEG = 0, SOFT = 1;

template <int KIND>
__device__ __forceinline__ void update(float kx, float u, float lam, float& v,
                                       float& u_new) {
  const float w = kx + u;
  if (KIND == NONNEG) {
    v = w < 0.0f ? 0.0f : w;  // NaN goes through, as in torch.clamp(min=0)
  } else {
    const float sign = (float)(0.0f < w) - (float)(w < 0.0f);
    const float m = fabsf(w) - lam;
    v = sign * (m < 0.0f ? 0.0f : m);
  }
  u_new = u + kx - v;
}

template <int KIND, bool VEC>
__global__ void fused_admm_update_kernel(const float* __restrict__ Kx,
                                         const float* __restrict__ u,
                                         const float* __restrict__ lam,
                                         int lam_per_batch, float* __restrict__ v,
                                         float* __restrict__ u_new, long long n,
                                         long long per_batch) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  if (VEC) {
    const float4* k4 = reinterpret_cast<const float4*>(Kx);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* v4 = reinterpret_cast<float4*>(v);
    float4* n4 = reinterpret_cast<float4*>(u_new);
    for (long long i = start; i < n / 4; i += step) {
      const float l = KIND == SOFT ? lam[lam_per_batch ? (4 * i) / per_batch : 0] : 0.0f;
      const float4 k = k4[i], uu = u4[i];
      float4 vo, no;
      update<KIND>(k.x, uu.x, l, vo.x, no.x);
      update<KIND>(k.y, uu.y, l, vo.y, no.y);
      update<KIND>(k.z, uu.z, l, vo.z, no.z);
      update<KIND>(k.w, uu.w, l, vo.w, no.w);
      v4[i] = vo;
      n4[i] = no;
    }
  } else {
    for (long long i = start; i < n; i += step) {
      const float l = KIND == SOFT ? lam[lam_per_batch ? i / per_batch : 0] : 0.0f;
      update<KIND>(Kx[i], u[i], l, v[i], u_new[i]);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int KIND>
cudaError_t launch(const float* Kx, const float* u, const float* lam,
                   int lam_per_batch, float* v, float* u_new, long long n,
                   long long per_batch, cudaStream_t s) {
  const bool vec = per_batch % 4 == 0 && aligned16(Kx) && aligned16(u) &&
                   aligned16(v) && aligned16(u_new);
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  if (vec)
    fused_admm_update_kernel<KIND, true><<<(unsigned)blocks, THREADS, 0, s>>>(
        Kx, u, lam, lam_per_batch, v, u_new, n, per_batch);
  else
    fused_admm_update_kernel<KIND, false><<<(unsigned)blocks, THREADS, 0, s>>>(
        Kx, u, lam, lam_per_batch, v, u_new, n, per_batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Launches on `stream` and does not
// synchronise. Kx, u, v, u_new: n = B * per_batch contiguous floats; lam: 1
// value, or B values with lam_per_batch, read only by the soft threshold (may
// be null for nonneg); kind: 0 nonneg, 1 soft threshold.
int dprox_fused_admm_update(const float* Kx, const float* u, const float* lam,
                            int lam_per_batch, int kind, float* v, float* u_new,
                            long long n, long long per_batch, void* stream) {
  if (n <= 0 || per_batch <= 0 || n % per_batch != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == NONNEG)
    return (int)launch<NONNEG>(Kx, u, lam, lam_per_batch, v, u_new, n, per_batch, s);
  if (kind == SOFT)
    return (int)launch<SOFT>(Kx, u, lam, lam_per_batch, v, u_new, n, per_batch, s);
  return (int)cudaErrorInvalidValue;
}

const char* dprox_fused_admm_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
