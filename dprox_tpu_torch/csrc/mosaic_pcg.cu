// Preconditioned CG on the joint demosaic + deconvolution system, one pass a
// stage: the elementwise work between the cuFFT calls of
// linalg/structured.py::mosaic_conv_pcg.
//
// It replaces no TPU kernel: it fuses the elementwise stages of the CG
// x-update of dprox_tpu/proxfn/sum_squares.py (least_squares.solve_cg with
// the frequency-Jacobi preconditioner) for the operator mosaic(conv(x)):
//
//   A p = K^T K p + n_rho * rho p,  K = Bayer mask * circular convolution,
//   M^-1 r = F^-1(F r / Mdiag).
//
// Fields are [B, C, H, W] float32 (x, r, p, z, A p, b) or complex64 (the
// FFTs' inputs and outputs); C = 3 where the mask is applied. The inverse
// FFTs run unscaled (torch's norm="forward"), and the stage after each one
// multiplies by scale = 1 / (H W), as torch's scaled ifftn followed by
// `.real` does. Every stage keeps the plain version's operation order
// (ops/kernels.py, mcg_*_plain), with no contraction (--fmad=false):
//
//   otf_apply    F = OTF F, or conj(OTF) F, in place          (K1, K3)
//   mask         G = complex(m (m (scale Re G)), 0), in place  (K2)
//   gram         A p = ((scale Re k + 0) + rho p) + ... n_rho  (K4)
//   step         alpha; x += alpha p; r -= alpha A p; r_c; max|r| (K5)
//   precond      R = R / Mdiag, in place                      (K6)
//   real         z = scale Re Z                               (K7)
//   direction    beta; p = z + beta p; p_c; the stop flag     (K8)
//   start        x = x0 (or 0); x_c; the maxima zeroed        (set-up)
//   residual     r = b - A x; r_c; max|r|; max|b|             (set-up)
//
// The mask m is the RGGB Bayer pattern computed from (c, h, w) parity (R on
// even rows and columns, G where they differ, B on odd ones), equal to
// utils/imaging.py::bayer_mask. The per-batch maxima of the stop test are
// an atomicMax on the bits of |v| (a non-negative float orders as its bits;
// NaN's bits order above infinity's, so a NaN wins, as torch.amax gives):
// the result does not depend on the order of the blocks. `direction`
// compares them with rtol * max(max|b|, 1e-32) and writes one int that the
// host reads once an iteration.
//
// Bound on the card: bytes. At 1x3x2048x2048 a float32 field is 50.3 MB and
// a complex64 one 100.7 MB: otf_apply 302 MB (F read and written, the OTF
// read), mask 201, gram 201, step 403, precond 252, real 151, direction
// 252; at 3.35 TB/s 90, 60, 60, 120, 75, 45 and 75 us.
//
// Design: a plane (b, c) per grid row (blockIdx.y), 256 threads a block, a
// thread a 16-byte group of 4 elements (a float4, or two for complex) where
// H W is a multiple of 4 and every base is 16-byte aligned, else an element;
// loads and stores with the evict-first hint (__ldcs, __stcs). On the H100
// at 1x3x2048x2048 that ran 83-86% of the bound and a CG iteration 2.7-4.6%
// faster than a grid of 4, 8 or 16 blocks an SM looping over the plane,
// with or without the hint (PERF.md, PR 19). A block's maximum goes to the
// batch element's slot in one atomic. Kernel names avoid the words the
// benchmark's trace classifier keys on (conv, fft, ...).

#include <initializer_list>

#include "reduce.cuh"

namespace {

using namespace dprox;

// Every field streams through a stage once and is larger than the L2
// cache: loads and stores carry the evict-first hint.
template <typename T>
__device__ __forceinline__ T ld(const T* a) {
  return __ldcs(a);
}
template <typename T>
__device__ __forceinline__ void st(T* a, T v) {
  __stcs(a, v);
}

// ---- loads and stores of N consecutive elements (N = 4: 16-byte vectors) --

template <int N>
__device__ __forceinline__ void load(const float* a, long long e, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = ld(reinterpret_cast<const float4*>(a + e));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = ld(a + e);
  }
}

template <int N>
__device__ __forceinline__ void store(float* a, long long e, const float (&v)[N]) {
  if constexpr (N == 4) {
    st(reinterpret_cast<float4*>(a + e), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    st(a + e, v[0]);
  }
}

template <int N>
__device__ __forceinline__ void load(const float2* a, long long e, float2 (&v)[N]) {
  if constexpr (N == 4) {
    const float4* q = reinterpret_cast<const float4*>(a + e);
    const float4 s = ld(q), t = ld(q + 1);
    v[0] = make_float2(s.x, s.y);
    v[1] = make_float2(s.z, s.w);
    v[2] = make_float2(t.x, t.y);
    v[3] = make_float2(t.z, t.w);
  } else {
    v[0] = ld(a + e);
  }
}

template <int N>
__device__ __forceinline__ void store(float2* a, long long e, const float2 (&v)[N]) {
  if constexpr (N == 4) {
    float4* q = reinterpret_cast<float4*>(a + e);
    st(q, make_float4(v[0].x, v[0].y, v[1].x, v[1].y));
    st(q + 1, make_float4(v[2].x, v[2].y, v[3].x, v[3].y));
  } else {
    st(a + e, v[0]);
  }
}

// The real field v as complex values (v, 0): the FFT's input.
template <int N>
__device__ __forceinline__ void store_real(float2* a, long long e, const float (&v)[N]) {
  float2 c[N];
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = make_float2(v[k], 0.0f);
  store<N>(a, e, c);
}

// ---- the grid: plane blockIdx.y, its groups of N elements grid-strided ----

struct Plane {
  long long base;  // the plane's first element
  long long g0, step, groups;
};

__device__ __forceinline__ Plane plane_of(long long hw, int n) {
  Plane p;
  p.base = (long long)blockIdx.y * hw;
  p.g0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  p.step = (long long)gridDim.x * blockDim.x;
  p.groups = hw / n;
  return p;
}

// |v| as bits that order as the values do (NaN above infinity).
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// The block's largest of m into *target (a float slot read as its bits).
// Every thread of the block calls it.
__device__ __forceinline__ void block_max_to(unsigned m, float* target, unsigned* smem) {
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, o));
  __syncthreads();  // smem may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t = max(t, smem[w]);
    atomicMax(reinterpret_cast<unsigned*>(target), t);
  }
}

// Zeroes the B slots of each given array, in the grid's first block.
__device__ __forceinline__ void zero_slots(float* a, float* b, int B) {
  if (blockIdx.x != 0 || blockIdx.y != 0) return;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    a[i] = 0.0f;
    if (b != nullptr) b[i] = 0.0f;
  }
}

__device__ __forceinline__ float bayer(int c, int h, int w) {
  const int hp = h & 1, wp = w & 1;
  const bool on = c == 0 ? (hp == 0 && wp == 0) : c == 1 ? (hp != wp) : (hp == 1 && wp == 1);
  return on ? 1.0f : 0.0f;
}

// (scale Re k + 0) + rho p, n_rho times: K^T K p + n_rho rho p in the order
// least_squares.solve_cg's KtK adds its terms.
__device__ __forceinline__ float gram_value(float2 k, float p, float rho, int n_rho,
                                            float scale) {
  float a = k.x * scale + 0.0f;
  const float t = rho * p;
  for (int i = 0; i < n_rho; ++i) a = a + t;
  return a;
}

// ---- the stages ---------------------------------------------------------

// K1 / K3: F = OTF F (ADJ: conj(OTF) F), c10::complex's product order with
// the OTF on the left. otf: [C, H, W].
template <bool ADJ, int N>
__global__ void __launch_bounds__(THREADS)
mcg_otf_apply_kernel(float2* __restrict__ F, const float2* __restrict__ otf, int C,
                     long long hw) {
  const Plane pl = plane_of(hw, N);
  const float2* o = otf + (long long)(blockIdx.y % C) * hw;
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    float2 f[N], h[N];
    load<N>(F, pl.base + g * N, f);
    load<N>(o, g * N, h);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float hx = h[k].x, hy = ADJ ? -h[k].y : h[k].y;
      f[k] = make_float2(hx * f[k].x - hy * f[k].y, hx * f[k].y + hy * f[k].x);
    }
    store<N>(F, pl.base + g * N, f);
  }
}

// K2: G = complex(m (m (scale Re G)), 0): the mask forward and adjoint.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_mask_kernel(float2* __restrict__ G, float scale, int C, int W, long long hw) {
  const Plane pl = plane_of(hw, N);
  const int c = blockIdx.y % C;
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long o = g * N;
    int h = (int)(o / W), w = (int)(o - (long long)h * W);
    float2 v[N];
    load<N>(G, pl.base + o, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float m = bayer(c, h, w);
      v[k] = make_float2(m * (m * (v[k].x * scale)), 0.0f);
      if (++w == W) {
        w = 0;
        ++h;
      }
    }
    store<N>(G, pl.base + o, v);
  }
}

// K4: A p from the unscaled inverse k of the second round trip; zeroes the
// maxima that `step` fills next.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_gram_kernel(const float2* __restrict__ Kc, const float* __restrict__ p,
                const float* __restrict__ rho, int rho_per_batch, int n_rho, float scale,
                float* __restrict__ Ap, float* __restrict__ rmax, int B, int C, long long hw) {
  zero_slots(rmax, nullptr, B);
  const Plane pl = plane_of(hw, N);
  const float r = rho[rho_per_batch ? blockIdx.y / C : 0];
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float2 k[N];
    float pv[N], a[N];
    load<N>(Kc, e, k);
    load<N>(p, e, pv);
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = gram_value(k[i], pv[i], r, n_rho, scale);
    store<N>(Ap, e, a);
  }
}

// K5: alpha = rz / max(pAp, 1e-32); x += alpha p; r -= alpha A p; r_c = r;
// rmax[b] = max |r|.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_step_kernel(float* __restrict__ x, float* __restrict__ r, const float* __restrict__ p,
                const float* __restrict__ Ap, const float* __restrict__ rz,
                const float* __restrict__ pAp, float2* __restrict__ r_c,
                float* __restrict__ rmax, int C, long long hw) {
  __shared__ unsigned smem[32];
  const Plane pl = plane_of(hw, N);
  const int b = blockIdx.y / C;
  const float alpha = rz[b] / clamp_min(pAp[b], 1e-32f);
  unsigned m = 0u;
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float xv[N], rv[N], pv[N], av[N];
    load<N>(x, e, xv);
    load<N>(r, e, rv);
    load<N>(p, e, pv);
    load<N>(Ap, e, av);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      xv[k] = xv[k] + alpha * pv[k];
      rv[k] = rv[k] - alpha * av[k];
      m = max(m, abs_bits(rv[k]));
    }
    store<N>(x, e, xv);
    store<N>(r, e, rv);
    store_real<N>(r_c, e, rv);
  }
  block_max_to(m, rmax + b, smem);
}

// K6: R = R / Mdiag as c10::complex divides by a real promoted to complex:
// both parts times one reciprocal. mdiag: [B or 1, C, H, W].
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_precond_kernel(float2* __restrict__ R, const float* __restrict__ mdiag,
                   int mdiag_per_batch, int C, long long hw) {
  const Plane pl = plane_of(hw, N);
  const float* d = mdiag + (long long)(mdiag_per_batch ? blockIdx.y : blockIdx.y % C) * hw;
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    float2 v[N];
    float dv[N];
    load<N>(R, pl.base + g * N, v);
    load<N>(d, g * N, dv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float inv = 1.0f / dv[k];
      v[k] = make_float2(v[k].x * inv, v[k].y * inv);
    }
    store<N>(R, pl.base + g * N, v);
  }
}

// K7: z = scale Re Z.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_real_kernel(const float2* __restrict__ Zc, float scale, float* __restrict__ z,
                long long hw) {
  const Plane pl = plane_of(hw, N);
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float2 v[N];
    float o[N];
    load<N>(Zc, e, v);
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = v[k].x * scale;
    store<N>(z, e, o);
  }
}

// K8: beta = rz_new / max(rz, 1e-32); p = z + beta p (FIRST: p = z); p_c = p;
// and, in the first block, flag = any(rmax > rtol max(bmax, 1e-32)).
template <bool FIRST, int N>
__global__ void __launch_bounds__(THREADS)
mcg_direction_kernel(const float* __restrict__ z, float* __restrict__ p,
                     const float* __restrict__ rz_new, const float* __restrict__ rz,
                     float2* __restrict__ p_c, const float* __restrict__ rmax,
                     const float* __restrict__ bmax, float rtol, int* __restrict__ flag, int B,
                     int C, long long hw) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    int any = 0;
    for (int i = 0; i < B; ++i) any |= rmax[i] > rtol * clamp_min(bmax[i], 1e-32f);
    *flag = any;
  }
  const Plane pl = plane_of(hw, N);
  const int b = blockIdx.y / C;
  const float beta = FIRST ? 0.0f : rz_new[b] / clamp_min(rz[b], 1e-32f);
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float zv[N], pv[N];
    load<N>(z, e, zv);
    if (!FIRST) load<N>(p, e, pv);
#pragma unroll
    for (int k = 0; k < N; ++k) pv[k] = FIRST ? zv[k] : zv[k] + beta * pv[k];
    store<N>(p, e, pv);
    store_real<N>(p_c, e, pv);
  }
}

// Set-up: x = x0 (or 0 where x0 is null), x_c = x; rmax and bmax zeroed.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_start_kernel(const float* __restrict__ x0, float* __restrict__ x, float2* __restrict__ x_c,
                 float* __restrict__ rmax, float* __restrict__ bmax, int B, long long hw) {
  zero_slots(rmax, bmax, B);
  const Plane pl = plane_of(hw, N);
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float v[N];
    if (x0 != nullptr) {
      load<N>(x0, e, v);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = 0.0f;
    }
    store<N>(x, e, v);
    store_real<N>(x_c, e, v);
  }
}

// Set-up: r = b - A x from the unscaled inverse k of A x's second round trip;
// r_c = r; rmax[b] = max |r|, bmax[b] = max |b|.
template <int N>
__global__ void __launch_bounds__(THREADS)
mcg_residual_kernel(const float2* __restrict__ Kc, const float* __restrict__ bv,
                    const float* __restrict__ x, const float* __restrict__ rho,
                    int rho_per_batch, int n_rho, float scale, float* __restrict__ r,
                    float2* __restrict__ r_c, float* __restrict__ rmax,
                    float* __restrict__ bmax, int C, long long hw) {
  __shared__ unsigned smem[32];
  const Plane pl = plane_of(hw, N);
  const int b = blockIdx.y / C;
  const float rh = rho[rho_per_batch ? b : 0];
  unsigned mr = 0u, mb = 0u;
  for (long long g = pl.g0; g < pl.groups; g += pl.step) {
    const long long e = pl.base + g * N;
    float2 k[N];
    float bb[N], xv[N], rv[N];
    load<N>(Kc, e, k);
    load<N>(bv, e, bb);
    load<N>(x, e, xv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      rv[i] = bb[i] - gram_value(k[i], xv[i], rh, n_rho, scale);
      mr = max(mr, abs_bits(rv[i]));
      mb = max(mb, abs_bits(bb[i]));
    }
    store<N>(r, e, rv);
    store_real<N>(r_c, e, rv);
  }
  block_max_to(mr, rmax + b, smem);
  block_max_to(mb, bmax + b, smem);
}

// ---- launches -------------------------------------------------------------

struct Launch {
  dim3 grid;
  bool vec;
};

// The grid for `planes` planes of hw elements, a group a thread; vec where
// every base in `ptrs` is 16-byte aligned and hw a multiple of 4.
Launch geometry(int planes, long long hw, std::initializer_list<const void*> ptrs) {
  bool vec = hw % 4 == 0;
  for (const void* q : ptrs) vec = vec && (q == nullptr || aligned16(q));
  const long long groups = vec ? hw / 4 : hw;
  long long x = (groups + THREADS - 1) / THREADS;
  if (x > 0x7fffffffLL) x = 0x7fffffffLL;  // the loop strides over the rest
  return {dim3((unsigned)x, (unsigned)planes), vec};
}

int check_dims(int B, int C, long long hw) {
  if (B <= 0 || C <= 0 || hw <= 0 || (long long)B * C > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

#define MCG_LAUNCH(KERNEL, L, S, ...)                                   \
  do {                                                                  \
    if ((L).vec)                                                        \
      KERNEL<4><<<(L).grid, THREADS, 0, (S)>>>(__VA_ARGS__);            \
    else                                                                \
      KERNEL<1><<<(L).grid, THREADS, 0, (S)>>>(__VA_ARGS__);            \
  } while (0)

}  // namespace

extern "C" {

// Each entry returns a cudaError_t (0 on success), launches on `stream` of
// CUDA device `device` and does not synchronise. Fields are contiguous
// [B, C, H, W] (hw = H W); complex fields are interleaved complex64.

int dprox_mcg_otf_apply(void* F, const void* otf, int adjoint, int B, int C, long long hw,
                        int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {F, otf});
  cudaStream_t s = (cudaStream_t)stream;
  float2* f = (float2*)F;
  const float2* o = (const float2*)otf;
  if (adjoint) {
    if (L.vec) mcg_otf_apply_kernel<true, 4><<<L.grid, THREADS, 0, s>>>(f, o, C, hw);
    else mcg_otf_apply_kernel<true, 1><<<L.grid, THREADS, 0, s>>>(f, o, C, hw);
  } else {
    if (L.vec) mcg_otf_apply_kernel<false, 4><<<L.grid, THREADS, 0, s>>>(f, o, C, hw);
    else mcg_otf_apply_kernel<false, 1><<<L.grid, THREADS, 0, s>>>(f, o, C, hw);
  }
  return (int)cudaGetLastError();
}

int dprox_mcg_mask(void* G, float scale, int B, int C, int H, int W, int device,
                   void* stream) {
  const long long hw = (long long)H * W;
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {G});
  MCG_LAUNCH(mcg_mask_kernel, L, (cudaStream_t)stream, (float2*)G, scale, C, W, hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_gram(const void* Kc, const float* p, const float* rho, int rho_per_batch,
                   int n_rho, float scale, float* Ap, float* rmax, int B, int C, long long hw,
                   int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {Kc, p, Ap});
  MCG_LAUNCH(mcg_gram_kernel, L, (cudaStream_t)stream, (const float2*)Kc, p, rho,
             rho_per_batch, n_rho, scale, Ap, rmax, B, C, hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_step(float* x, float* r, const float* p, const float* Ap, const float* rz,
                   const float* pAp, void* r_c, float* rmax, int B, int C, long long hw,
                   int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {x, r, p, Ap, r_c});
  MCG_LAUNCH(mcg_step_kernel, L, (cudaStream_t)stream, x, r, p, Ap, rz, pAp, (float2*)r_c,
             rmax, C, hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_precond(void* R, const float* mdiag, int mdiag_per_batch, int B, int C,
                      long long hw, int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {R, mdiag});
  MCG_LAUNCH(mcg_precond_kernel, L, (cudaStream_t)stream, (float2*)R, mdiag, mdiag_per_batch,
             C, hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_real(const void* Zc, float scale, float* z, int B, int C, long long hw,
                   int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {Zc, z});
  MCG_LAUNCH(mcg_real_kernel, L, (cudaStream_t)stream, (const float2*)Zc, scale, z, hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_direction(const float* z, float* p, const float* rz_new, const float* rz,
                        void* p_c, const float* rmax, const float* bmax, float rtol, int* flag,
                        int first, int B, int C, long long hw, int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {z, p, p_c});
  cudaStream_t s = (cudaStream_t)stream;
  float2* pc = (float2*)p_c;
  if (first) {
    if (L.vec)
      mcg_direction_kernel<true, 4><<<L.grid, THREADS, 0, s>>>(z, p, rz_new, rz, pc, rmax,
                                                               bmax, rtol, flag, B, C, hw);
    else
      mcg_direction_kernel<true, 1><<<L.grid, THREADS, 0, s>>>(z, p, rz_new, rz, pc, rmax,
                                                               bmax, rtol, flag, B, C, hw);
  } else {
    if (L.vec)
      mcg_direction_kernel<false, 4><<<L.grid, THREADS, 0, s>>>(z, p, rz_new, rz, pc, rmax,
                                                                bmax, rtol, flag, B, C, hw);
    else
      mcg_direction_kernel<false, 1><<<L.grid, THREADS, 0, s>>>(z, p, rz_new, rz, pc, rmax,
                                                                bmax, rtol, flag, B, C, hw);
  }
  return (int)cudaGetLastError();
}

// x0 may be null (a zero start).
int dprox_mcg_start(const float* x0, float* x, void* x_c, float* rmax, float* bmax, int B,
                    int C, long long hw, int device, void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {x0, x, x_c});
  MCG_LAUNCH(mcg_start_kernel, L, (cudaStream_t)stream, x0, x, (float2*)x_c, rmax, bmax, B,
             hw);
  return (int)cudaGetLastError();
}

int dprox_mcg_residual(const void* Kc, const float* b, const float* x, const float* rho,
                       int rho_per_batch, int n_rho, float scale, float* r, void* r_c,
                       float* rmax, float* bmax, int B, int C, long long hw, int device,
                       void* stream) {
  if (int e = check_dims(B, C, hw)) return e;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return (int)guard.error;
  const Launch L = geometry(B * C, hw, {Kc, b, x, r, r_c});
  MCG_LAUNCH(mcg_residual_kernel, L, (cudaStream_t)stream, (const float2*)Kc, b, x, rho,
             rho_per_batch, n_rho, scale, r, (float2*)r_c, rmax, bmax, C, hw);
  return (int)cudaGetLastError();
}

const char* dprox_mcg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
