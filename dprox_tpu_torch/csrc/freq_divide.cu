// Frequency-diagonal divide of the x-update: out = (F + eps) / (diag + rho + eps).
//
// Replaces dprox_tpu/ops/pallas_kernels.py::freq_divide (body
// _freq_divide_kernel), the divide that every freq-diagonal x-update runs
// (proxfn/sum_squares.py::_freq_xupdate). F is complex64 [B, C, H, W],
// read interleaved (one float2 per element, no split into re/im planes);
// diag is real float32, broadcast over F by strides (0 on broadcast dims);
// rho is a device scalar or one value per batch element. eps goes on the
// real part only, and re and im share one reciprocal. F is read through
// its strides too (cuFFT output need not be contiguous); out is
// contiguous.
//
// A second entry, dprox_freq_divide_c64, takes a complex64 diag (a
// divisor whose spectrum is not real, as _freq_xupdate accepts one):
// D = (diag + rho) + eps on the real part, and the complex quotient by
// Smith's method in PyTorch's order (c10::complex operator/=: scale by the
// larger of |Re D| and |Im D|), so the kernel needs no wider type and
// overflows where PyTorch does.
//
// Bound on the card: bytes. Per element it reads 8 bytes of F and writes
// 8 bytes, plus the distinct diag values once (4 bytes per element when
// diag is a full [1, C, H, W] plane set, 8 when complex): 15.7 MB at
// 1x3x512x512, ~4.7 us at 3.35 TB/s (18.9 MB, ~5.6 us, complex), against
// 6 float operations per element (about 11 for the complex quotient).
// Design: one thread per element with 8-byte vector loads and stores,
// consecutive threads on consecutive elements, so every access is
// coalesced; a grid-stride loop covers any size. Compiled with
// --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// (F + eps) / D for a real divisor: re and im share one reciprocal.
__device__ __forceinline__ float2 divide(float2 f, float d, float r, float eps) {
  const float inv = 1.0f / ((d + r) + eps);
  return make_float2((f.x + eps) * inv, f.y * inv);
}

// (F + eps) / D for a complex divisor, as c10::complex<float>::operator/=.
__device__ __forceinline__ float2 divide(float2 f, float2 d, float r, float eps) {
  const float a = f.x + eps, b = f.y;
  const float c = (d.x + r) + eps, e = d.y;
  if (fabsf(c) >= fabsf(e)) {
    if (c == 0.0f && e == 0.0f) return make_float2(a / fabsf(c), b / fabsf(e));
    const float rat = e / c;
    const float scl = 1.0f / (c + e * rat);
    return make_float2((a + b * rat) * scl, (b - a * rat) * scl);
  }
  const float rat = c / e;
  const float scl = 1.0f / (e + c * rat);
  return make_float2((a * rat + b) * scl, (b * rat - a) * scl);
}

// Index is int when every offset fits in 32 bits (the common case: 64-bit
// division costs several times more), else long long. Diag is float or
// float2 (a complex divisor).
template <typename Index, typename Diag>
__global__ void freq_divide_kernel(const float2* __restrict__ F,
                                   Index fs0, Index fs1, Index fs2, Index fs3,
                                   const Diag* __restrict__ diag,
                                   Index ds0, Index ds1, Index ds2, Index ds3,
                                   const float* __restrict__ rho,
                                   int rho_per_batch, float eps,
                                   float2* __restrict__ out,
                                   Index n, Index C, Index H, Index W) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index idx = (Index)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const Index w = idx % W;
    Index q = idx / W;
    const Index h = q % H;
    q /= H;
    const Index c = q % C;
    const Index b = q / C;
    const Diag d = diag[b * ds0 + c * ds1 + h * ds2 + w * ds3];
    const float r = rho[rho_per_batch ? b : 0];
    out[idx] = divide(F[b * fs0 + c * fs1 + h * fs2 + w * fs3], d, r, eps);
  }
}

template <typename Diag>
int launch(const void* F, long long fs0, long long fs1, long long fs2, long long fs3,
           const Diag* diag, long long ds0, long long ds1, long long ds2, long long ds3,
           const float* rho, int rho_per_batch, float eps, void* out,
           int B, int C, int H, int W, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C * H * W;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  // largest offset + 1 bounds every index into F and diag
  const long long fmax = (B - 1) * fs0 + (C - 1) * fs1 + (H - 1) * fs2 + (W - 1) * fs3 + 1;
  const long long dmax = (B - 1) * ds0 + (C - 1) * ds1 + (H - 1) * ds2 + (W - 1) * ds3 + 1;
  const long long lim = (1LL << 31) - THREADS * blocks;
  if (n < lim && fmax < lim && dmax < lim) {
    freq_divide_kernel<int, Diag><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float2*)F, (int)fs0, (int)fs1, (int)fs2, (int)fs3, diag, (int)ds0,
        (int)ds1, (int)ds2, (int)ds3, rho, rho_per_batch, eps, (float2*)out, (int)n,
        C, H, W);
  } else {
    freq_divide_kernel<long long, Diag><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float2*)F, fs0, fs1, fs2, fs3, diag, ds0, ds1, ds2, ds3, rho,
        rho_per_batch, eps, (float2*)out, n, C, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Return a cudaError_t (0 on success). Launch on `stream` and do not
// synchronise. Strides are in elements (complex elements for F and for a
// complex diag).
int dprox_freq_divide(const void* F, long long fs0, long long fs1, long long fs2,
                      long long fs3, const float* diag,
                      long long ds0, long long ds1, long long ds2, long long ds3,
                      const float* rho, int rho_per_batch, float eps, void* out,
                      int B, int C, int H, int W, void* stream) {
  return launch(F, fs0, fs1, fs2, fs3, diag, ds0, ds1, ds2, ds3, rho, rho_per_batch, eps,
                out, B, C, H, W, stream);
}

int dprox_freq_divide_c64(const void* F, long long fs0, long long fs1, long long fs2,
                          long long fs3, const void* diag,
                          long long ds0, long long ds1, long long ds2, long long ds3,
                          const float* rho, int rho_per_batch, float eps, void* out,
                          int B, int C, int H, int W, void* stream) {
  return launch(F, fs0, fs1, fs2, fs3, (const float2*)diag, ds0, ds1, ds2, ds3, rho,
                rho_per_batch, eps, out, B, C, H, W, stream);
}

const char* dprox_freq_divide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
