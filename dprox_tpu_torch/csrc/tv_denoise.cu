// Fused TV dual-ascent denoiser: every iteration in one launch, the state
// in registers.
//
// Replaces dprox_tpu/ops/pallas_kernels.py::tv_denoise_chw_pallas (body
// _tv_kernel). Computes models/tv.py::tv_denoising_chw on [planes, H, W]
// float32, in its operation order:
//   x0 = ((y0 - Dh^T zh) + (y0 - Dv^T zv)) / 2
//   zh = clip(zh + 0.2 * Dh x0, lam / 2),  zv likewise (alpha = 5)
// Duals live at full plane size and are pinned to zero by masks in global
// coordinates (zh on col <= W-2, zv on row <= H-2, zero outside the
// image), so the uniform stencil z[j-1] - z[j] reproduces the edge rows
// and columns of Dh^T / Dv^T exactly.
//
// Bound on an H100 at 3x512x512 and 10 iterations: the function reads y0
// once and writes x0 once, 6.3 MB, 1.88 us at 3.35 TB/s; it does ~150
// float operations per pixel (16 per iteration), 1.76 us at 67 TFLOP/s.
// Under --fmad=false none of them is a fused multiply-add, and a plain add,
// multiply, min or max issues at about half the FMA rate, so the practical
// floor is ~4 us.
//
// Design. A block owns a window of 128 columns by NW * RPT rows, with a
// halo of R = iterations cells on every side of its output rectangle
// ((128 - 2R) x (NW * RPT - 2R)); a cell at the window's edge reads zeros
// for its missing neighbours, an error that moves inward one cell per
// iteration, so after R iterations the output rectangle is exact. Lane l
// of warp w owns the 4 columns 4l..4l+3 of the warp's RPT rows and keeps
// y0, zh and zv of those 4 * RPT cells in registers for all iterations;
// x0 of a row is a temporary. Neighbours along W come from the thread's
// own registers, and at its strip's edge from one shuffle per row
// (zh[j-1] up, x0[j+1] down); neighbours along H from its own registers,
// and at the warp's top and bottom rows through shared memory: each warp
// publishes its top row's x0 and its bottom row's zv, one float4 a lane.
// An iteration is one pass over the rows (x0 of row r, then zh of row r
// and zv of row r - 1) between two barriers. Each cell's coordinates and
// its two masks are computed once, before the iterations; the loop has
// no division and no mask arithmetic beyond a bit test.
//
// Windows (TV_WINDOWS in ops/kernels.py): (NW, RPT) = (8, 4) and (8, 12),
// 128 x 32 and 128 x 96 cells, 256 threads. The host picks the one that
// puts the fewest window rows on the most loaded SM, ceil(blocks / SMs) *
// rows; on 132 SMs that is 128 x 96 at 3x512x512 and 10 iterations (105
// blocks, one wave; recompute 128*96 / (108*76) = 1.50x, where a 32 x 32
// tile with its halo recomputes 52^2 / 32^2 = 2.64x) and 128 x 32 at 3x256x256 and 5 iterations (108
// blocks; recompute 128*32 / (118*22) = 1.58x). Up to 47 iterations run in
// one launch (the 96-row window keeps one output row); 1..15 fit the
// 32-row window. -Xptxas -v (sm_90a, nvcc 12.9): 99 registers for 128 x 32,
// 189 for 128 x 96, no spills. A 128 x 64 window (2 blocks an SM at 128
// registers) and 128 x 96 with 16 warps (6 rows a lane) spill and were
// slower at both path shapes on an H100 (PERF.md).
//
// Bits: every cell runs the same float32 operations in the same order as
// the plain version, compiled with --fmad=false so no a*b+c is
// contracted, so each output equals the plain version's to the last bit,
// whatever the window.

#include <cuda_runtime.h>

namespace {

constexpr int WX = 128;  // window columns: 32 lanes x 4
constexpr unsigned FULL = 0xffffffffu;

struct Window {
  int warps, rows_per_thread;
};
constexpr Window WINDOWS[] = {{8, 4}, {8, 12}};
constexpr int N_WINDOWS = sizeof(WINDOWS) / sizeof(WINDOWS[0]);
constexpr int MAX_ROWS = 96;  // tallest window

__device__ __forceinline__ float clip(float v, float t) { return fminf(fmaxf(v, -t), t); }

__device__ __forceinline__ bool bit(unsigned long long m, int k) { return (m >> k) & 1ull; }

// x0 of one row of 4 cells: ((y - (zh[j-1] - zh[j])) + (y - (zu - zv))) / 2,
// zu being zv of the row above.
__device__ __forceinline__ void primal(const float (&y)[4], const float (&zh)[4],
                                       const float (&zv)[4], const float (&zu)[4],
                                       int lane, float (&x)[4]) {
  float zl0 = __shfl_up_sync(FULL, zh[3], 1);
  if (lane == 0) zl0 = 0.0f;  // window's left edge
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float zl = c == 0 ? zl0 : zh[c == 0 ? 0 : c - 1];
    const float x0h = y[c] - (zl - zh[c]);
    const float x0v = y[c] - (zu[c] - zv[c]);
    x[c] = (x0h + x0v) / 2.0f;
  }
}

template <int NW, int RPT>
__global__ void __launch_bounds__(NW * 32, 1)
tv_denoise_chw_kernel(const float* __restrict__ y0, const float* __restrict__ lam,
                      int lam_per_plane, float* __restrict__ out, int planes, int H, int W,
                      int R) {
  static_assert(RPT * 4 <= 64, "the masks hold one bit a cell in 64 bits");
  __shared__ float4 zv_edge[NW][32];  // each warp's bottom row of zv
  __shared__ float4 x_edge[NW][32];   // each warp's top row of x0
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int OH = NW * RPT - 2 * R, OW = WX - 2 * R;  // output rectangle
  const int wi0 = w * RPT, wj0 = 4 * lane;           // window coords of cell (0, 0)
  const int gr0 = blockIdx.y * OH - R + wi0;         // its global coords
  const int gc0 = blockIdx.x * OW - R + wj0;

  // one bit a cell (bit 4r + c): zh's and zv's masks, in the image, output
  unsigned long long mh = 0, mv = 0, in = 0, keep = 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gr = gr0 + r, gc = gc0 + c, i = wi0 + r, j = wj0 + c;
      const unsigned long long b = 1ull << (4 * r + c);
      if (gr >= 0 && gr <= H - 1 && gc >= 0 && gc <= W - 2) mh |= b;
      if (gr >= 0 && gr <= H - 2 && gc >= 0 && gc <= W - 1) mv |= b;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) in |= b;
      if (i >= R && i < R + OH && j >= R && j < R + OW && gr < H && gc < W) keep |= b;
    }
  }

  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* yp = y0 + (size_t)p * H * W;
    float* op = out + (size_t)p * H * W;
    const float t = lam[lam_per_plane ? p : 0] / 2.0f;
    float y[RPT][4], zh[RPT][4], zv[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[r][c] = bit(in, 4 * r + c) ? yp[(size_t)(gr0 + r) * W + (gc0 + c)] : 0.0f;
        zh[r][c] = 0.0f;
        zv[r][c] = 0.0f;
      }
    }

    for (int k = 0; k < R - 1; ++k) {
      __syncthreads();  // zv_edge holds this iteration's zv; x_edge is free
      float zu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (w > 0 && k > 0) {
        const float4 e = zv_edge[w - 1][lane];
        zu[0] = e.x, zu[1] = e.y, zu[2] = e.z, zu[3] = e.w;
      }
      float xp[4];  // x0 of the row above
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float up[4], x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) up[c] = r == 0 ? zu[c] : zv[r == 0 ? 0 : r - 1][c];
        primal(y[r], zh[r], zv[r], up, lane, x);
        if (r == 0) x_edge[w][lane] = make_float4(x[0], x[1], x[2], x[3]);
        float xr = __shfl_down_sync(FULL, x[0], 1);
        if (lane == 31) xr = 0.0f;  // window's right edge
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dh = (c == 3 ? xr : x[c == 3 ? 0 : c + 1]) - x[c];
          zh[r][c] = bit(mh, 4 * r + c) ? clip(zh[r][c] + 0.2f * dh, t) : 0.0f;
        }
        if (r > 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = r == 0 ? 0 : r - 1;
            const float dv = x[c] - xp[c];
            zv[q][c] = bit(mv, 4 * q + c) ? clip(zv[q][c] + 0.2f * dv, t) : 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) xp[c] = x[c];
      }
      __syncthreads();  // every warp's top row of x0 is in x_edge
      float xb[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // x0 of the row below; window's bottom edge
      if (w + 1 < NW) {
        const float4 e = x_edge[w + 1][lane];
        xb[0] = e.x, xb[1] = e.y, xb[2] = e.z, xb[3] = e.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dv = xb[c] - xp[c];
        zv[RPT - 1][c] = bit(mv, 4 * (RPT - 1) + c) ? clip(zv[RPT - 1][c] + 0.2f * dv, t) : 0.0f;
      }
      zv_edge[w][lane] = make_float4(zv[RPT - 1][0], zv[RPT - 1][1], zv[RPT - 1][2],
                                     zv[RPT - 1][3]);
    }

    // the last primal half-step is the output
    __syncthreads();
    float zu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (w > 0 && R > 1) {
      const float4 e = zv_edge[w - 1][lane];
      zu[0] = e.x, zu[1] = e.y, zu[2] = e.z, zu[3] = e.w;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float up[4], x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) up[c] = r == 0 ? zu[c] : zv[r == 0 ? 0 : r - 1][c];
      primal(y[r], zh[r], zv[r], up, lane, x);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (bit(keep, 4 * r + c)) op[(size_t)(gr0 + r) * W + (gc0 + c)] = x[c];
    }
  }
}

int output_rows(int window, int R) {
  return WINDOWS[window].warps * WINDOWS[window].rows_per_thread - 2 * R;
}

long long blocks(int window, int planes, int H, int W, int R) {
  const int oh = output_rows(window, R), ow = WX - 2 * R;
  return (long long)planes * ((H + oh - 1) / oh) * ((W + ow - 1) / ow);
}

template <int NW, int RPT>
cudaError_t launch(const float* y0, const float* lam, int lam_per_plane, float* out,
                   int planes, int H, int W, int R, cudaStream_t stream) {
  const int oh = NW * RPT - 2 * R, ow = WX - 2 * R;
  dim3 grid((W + ow - 1) / ow, (H + oh - 1) / oh, planes < 65535 ? planes : 65535);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  tv_denoise_chw_kernel<NW, RPT><<<grid, NW * 32, 0, stream>>>(y0, lam, lam_per_plane, out,
                                                               planes, H, W, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest iteration count (= halo) that one launch takes: the tallest
// window must keep one output row.
int dprox_tv_max_iterations() { return (MAX_ROWS - 1) / 2; }

// The window (an index into WINDOWS) that puts the fewest window rows on
// the most loaded SM of the current device; -1 if none fits.
int dprox_tv_window(int planes, int H, int W, int iterations) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  int best = -1;
  long long best_cost = 0;
  for (int i = 0; i < N_WINDOWS; ++i) {
    if (output_rows(i, iterations) < 1 || WX - 2 * iterations < 1) continue;
    const long long n = blocks(i, planes, H, W, iterations);
    const long long cost = (n + sms - 1) / sms * (WINDOWS[i].warps * WINDOWS[i].rows_per_thread);
    if (best < 0 || cost < best_cost) best = i, best_cost = cost;
  }
  return best;
}

// Returns a cudaError_t (0 on success). `window` indexes WINDOWS, -1 picks
// one (dprox_tv_window). Launches on `stream` and does not synchronise.
int dprox_tv_denoise_chw(const float* y0, const float* lam, int lam_per_plane, float* out,
                         int planes, int H, int W, int iterations, int window,
                         void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || iterations <= 0 ||
      iterations > dprox_tv_max_iterations() || window < -1 || window >= N_WINDOWS)
    return (int)cudaErrorInvalidValue;
  if (window < 0) window = dprox_tv_window(planes, H, W, iterations);
  if (window < 0 || output_rows(window, iterations) < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (window) {
    case 0: return (int)launch<8, 4>(y0, lam, lam_per_plane, out, planes, H, W, iterations, s);
    default: return (int)launch<8, 12>(y0, lam, lam_per_plane, out, planes, H, W, iterations, s);
  }
}

const char* dprox_tv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
