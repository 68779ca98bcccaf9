// Fused TV dual-ascent denoiser: every iteration in one launch, the state
// in registers; and its backward: every adjoint step in one launch.
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
// tile with its halo recomputes 52^2 / 32^2 = 2.64x) and 128 x 32 at
// 3x256x256 and 5 iterations (108 blocks; recompute 128*32 / (118*22) =
// 1.58x). Up to 47 iterations run in one launch (the 96-row window keeps one
// output row); 1..15 fit the 32-row window. -Xptxas -v (sm_90a, nvcc 12.9):
// 108 registers for 128 x 32, 193 for 128 x 96, no spills. A 128 x 64
// window (2 blocks an SM at 128 registers) and 128 x 96 with 16 warps (6
// rows a lane) spill and were slower at both path shapes on an H100
// (PERF.md). dprox_tv_kernel_attributes reads every kernel's registers and
// spill bytes on the card.
//
// Bits: every cell runs the same float32 operations in the same order as
// the plain version, compiled with --fmad=false so no a*b+c is
// contracted, so each output equals the plain version's to the last bit,
// whatever the window.
//
// Under grad the same kernel (CODES) also writes, for every output cell and
// iteration k = 0..R-2 (the last dual update is dead), one byte: for each of
// the cell's two duals, 4 bits that say where the pre-clip value p stood
// against -t and where max(p, -t) stood against t (clip_code). That is all
// the backward needs of the forward: R - 1 bytes a cell (whether a dual
// exists follows from its position). The codes' rows are padded to a
// multiple of 4 bytes and the CODES windows start on a multiple of 4
// columns (a left halo of R rounded up to 4, an output width that is a
// multiple of 4), so a lane's 4 cells of a row are one aligned 32-bit word.
// A lane puts each row's word into a shared-memory plane of the window
// (two planes, one an iteration, alternating); after the next barrier the
// block stores the plane's output rows, a warp a row, each lane one word:
// the row loop carries no code pointer and no store.
//
// Backward (dprox_tv_vjp): the VJP of the function above, for the
// cotangent g of the output x_{R-1}, in ops/kernels.py::
// tv_denoise_chw_vjp_plain's operation order. With a = g and the pre-clip
// cotangents q = 0, for k = R-2 down to 0 (one step each):
//   q' = clip_vjp(code_k, q - Dh a / 2)  (zh; zv likewise with Dv)
//   a' = Dh^T (0.2 q'h) + Dv^T (0.2 q'v),  d y0 += a',  d t += the clip's share
// and d lam = d t / 2 (t = lam / 2). A clip's cotangent follows torch.maximum
// / torch.minimum's backward, as JAX's jnp.clip does: a tie gives each side
// half.
//
// Backward design: temporal blocking, as the forward. q' at (i, j) reads a
// at (i, j), (i, j+1), (i+1, j), and a' at (i, j) reads q' at (i, j), (i,
// j-1), (i-1, j), so a step's dependence cone grows by one cell each way: a
// window with a halo of S = R - 1 cells (left: S rounded up to 4, for the
// codes' words) is exact on its output rectangle after the S steps, with
// zeros for a and q beyond the window. A lane owns 4 columns x RPT rows as
// in the forward and keeps q'h and q'v of its cells in registers for all
// steps, and d y0 too where that fits; a lives in shared memory (a float4
// a lane a row), where the row below and the next warp's top row are at
// hand; q'h[j-1] comes by shuffle, the previous warp's bottom row of q'v
// through shared memory. A step is two passes over the rows (q' from a,
// then a' from q'), each after a barrier. A row whose codes hold no tie and
// no NaN (the common case) is decoded in two selects a dual
// (clip_vjp_plain_code), any other by the general clip_vjp. Each thread
// fetches its own code words of the next step with cp.async into a
// two-slot ring while the current step computes. g is read once, through
// its strides; d y0 is written once, for the output cells. Each block adds
// d t over its own output cells, all steps, in a fixed order, into one
// partial; a second launch (programmatic dependent launch) adds the
// partials per lam in a fixed order: 2 launches a call at every R, two
// calls give the same bits, and d y0 equals the plain adjoint's bits in
// every window. The workspace is the partials.
//
// Backward windows (TV_VJP_WINDOWS): 16 warps of 2, 4 or 6 rows, 128 x 32,
// 64 and 96 cells, picked as the forward's; 96 rows keep up to 47
// iterations. A step is latency-bound (two barriers, a shuffle and a
// shared-memory load a row), so 16 warps of few rows beat 8 warps of
// twice as many (8 x 12 and 8 x 8 spilled at 255 registers and were 1.4x
// slower at 3x512x512 and 3x748x748 on an H100, PERF.md); at 6 rows d y0
// moves to shared memory, or the 128 registers a thread has at 512 threads
// spill.
//
// Bound on an H100 at 3x512x512 and 10 iterations: the backward reads the
// codes (9 bytes a cell) and g and writes d y0, 13.4 MB, 4.0 us at
// 3.35 TB/s; ~18 float operations a cell a step, 1.9 us at 67 TFLOP/s.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int WX = 128;  // window columns: 32 lanes x 4
constexpr unsigned FULL = 0xffffffffu;

struct Window {
  int warps, rows_per_thread;
};
constexpr Window WINDOWS[] = {{8, 4}, {8, 12}};
constexpr int N_WINDOWS = sizeof(WINDOWS) / sizeof(WINDOWS[0]);
constexpr Window VJP_WINDOWS[] = {{16, 2}, {16, 4}, {16, 6}};
constexpr int VJP_D_SHARED_RPT = 6;  // d y0 in shared memory from this many rows a thread
constexpr int N_VJP_WINDOWS = sizeof(VJP_WINDOWS) / sizeof(VJP_WINDOWS[0]);
constexpr int MAX_ROWS = 96;  // tallest window
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float clip(float v, float t) { return fminf(fmaxf(v, -t), t); }

// A dual's clip code (4 bits) from its pre-clip value p: bit 0 p >= -t,
// bit 1 p <= -t, bit 2 max(p, -t) >= t, bit 3 max(p, -t) <= t. Both bits of
// a pair are a tie, one says which side is larger, neither is unordered
// (NaN). A cell's byte holds zh's code in its low and zv's in its high 4
// bits.
__device__ __forceinline__ unsigned clip_code(float p, float t) {
  const float m = fmaxf(p, -t);
  return (unsigned)(p >= -t) | (unsigned)(p <= -t) << 1 | (unsigned)(m >= t) << 2 |
         (unsigned)(m <= t) << 3;
}

// The left halo and the output width of a window 128 columns wide at R
// iterations: R and 128 - 2R; with CODES, R rounded up to 4 and the width
// rounded down to 4, so each lane's 4 columns start on a multiple of 4.
__host__ __device__ constexpr int left_halo(int R, bool codes) {
  return codes ? (R + 3) / 4 * 4 : R;
}
__host__ __device__ constexpr int out_cols(int R, bool codes) {
  return codes ? (128 - left_halo(R, true) - R) / 4 * 4 : 128 - 2 * R;
}

// Bytes in a row of the codes: W rounded up to 4.
__host__ __device__ constexpr long long code_pitch(int W) { return (W + 3) / 4 * 4; }

// The clip's VJP for the cotangent c of its output, from the dual's 4-bit
// code: returns p's, and sets dt to t's (t enters as -t in the max and as t
// in the min). Each branch as torch.maximum / torch.minimum's backward: the
// side that wins takes c, a tie gives each side c / 2, an unordered pair
// gives c to both.
__device__ __forceinline__ float clip_vjp(unsigned code, float c, float& dt) {
  const bool pge = code & 1u, ple = code & 2u, mge = code & 4u, mle = code & 8u;
  const float gm = mge && mle ? c / 2.0f : mge ? 0.0f : c;    // to max(p, -t)
  const float gt = mge && mle ? c / 2.0f : mle ? 0.0f : c;    // to t
  const float gp = pge && ple ? gm / 2.0f : ple ? 0.0f : gm;  // to p
  const float gn = pge && ple ? gm / 2.0f : pge ? 0.0f : gm;  // to -t
  dt = gt - gn;
  return gp;
}

// clip_vjp where the code has one bit of each pair set (no tie, no NaN):
// p's cotangent is c where p stood inside (-t, t) and 0 where it was
// clipped; t's is c above, -c below, 0 inside. The same values as clip_vjp
// gives such a code. `word` holds the code at bit `s`.
__device__ __forceinline__ float clip_vjp_plain_code(unsigned word, int s, float c, float& dt) {
  dt = (word >> s) & 4u ? c : (word >> s) & 2u ? -c : 0.0f;
  return (word >> s) & 6u ? 0.0f : c;
}

// Whether every pair of bits in a word of codes has exactly one bit set.
__device__ __forceinline__ bool plain_codes(unsigned word) {
  return ((word ^ (word >> 1)) & 0x55555555u) == 0x55555555u;
}

__device__ __forceinline__ bool bit(unsigned long long m, int k) { return (m >> k) & 1ull; }
__device__ __forceinline__ bool bit(unsigned m, int k) { return (m >> k) & 1u; }

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

// codes (CODES): [R - 1, planes, H, code_pitch(W)] bytes, written for the
// output cells (and the row padding of a lane's group that holds W - 1).
template <int NW, int RPT, bool CODES>
__global__ void __launch_bounds__(NW * 32, 1)
tv_denoise_chw_kernel(const float* __restrict__ y0, const float* __restrict__ lam,
                      int lam_per_plane, float* __restrict__ out,
                      unsigned char* __restrict__ codes, int planes, int H, int W, int R) {
  static_assert(RPT * 4 <= 64, "the masks hold one bit a cell in 64 bits");
  __shared__ float4 zv_edge[NW][32];  // each warp's bottom row of zv
  __shared__ float4 x_edge[NW][32];   // each warp's top row of x0
  // CODES: the codes of the last two iterations, a word (4 cells) a lane a row
  __shared__ unsigned cbuf[CODES ? 2 : 1][CODES ? NW * RPT : 1][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int OH = NW * RPT - 2 * R, OW = out_cols(R, CODES);  // output rectangle
  const int HL = left_halo(R, CODES);
  const int wi0 = w * RPT, wj0 = 4 * lane;            // window coords of cell (0, 0)
  const int gr0 = blockIdx.y * OH - R + wi0;          // its global coords
  const int gc0 = blockIdx.x * OW - HL + wj0;

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
      if (i >= R && i < R + OH && j >= HL && j < HL + OW && gr < H && gc < W) keep |= b;
    }
  }
  // CODES: a lane whose group of 4 columns is output stores that column
  // group of the window's output rows R + w, R + w + NW, ... of a plane
  const bool cstore = CODES && wj0 >= HL && wj0 < HL + OW && gc0 < W;
  const size_t cw = code_pitch(W), cplane = (size_t)H * cw, kbytes = (size_t)planes * cplane;
  const int crow0 = blockIdx.y * OH - R;  // global row of window row 0
  const int crows = H - crow0 < R + OH ? H - crow0 : R + OH;  // window rows below both ends

  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* yp = y0 + (size_t)p * H * W;
    float* op = out + (size_t)p * H * W;
    // this lane's code word of window row i at iteration k: cbase + k kbytes + i cw
    unsigned char* cbase = CODES ? codes + p * cplane + (long long)crow0 * (long long)cw + gc0
                                 : nullptr;
    // the output rows of iteration k's plane to global memory
    auto store_codes = [&](int k) {
      if constexpr (CODES)
        if (cstore)
          for (int i = R + w; i < crows; i += NW)
            *reinterpret_cast<unsigned*>(cbase + k * kbytes + (size_t)i * cw) =
                cbuf[k & 1][i][lane];
    };
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
      if (CODES && k > 0) store_codes(k - 1);  // complete since the barrier
      float zu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (w > 0 && k > 0) {
        const float4 e = zv_edge[w - 1][lane];
        zu[0] = e.x, zu[1] = e.y, zu[2] = e.z, zu[3] = e.w;
      }
      float xp[4];      // x0 of the row above
      unsigned hc = 0;  // zh's codes of the row above (CODES), 4 bits a cell
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float up[4], x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) up[c] = r == 0 ? zu[c] : zv[r == 0 ? 0 : r - 1][c];
        primal(y[r], zh[r], zv[r], up, lane, x);
        if (r == 0) x_edge[w][lane] = make_float4(x[0], x[1], x[2], x[3]);
        float xr = __shfl_down_sync(FULL, x[0], 1);
        if (lane == 31) xr = 0.0f;  // window's right edge
        unsigned hn = 0;  // this row's zh codes
        float pre[4];     // pre-clip values (CODES)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dh = (c == 3 ? xr : x[c == 3 ? 0 : c + 1]) - x[c];
          const float v = zh[r][c] + 0.2f * dh;
          pre[c] = v;
          zh[r][c] = bit(mh, 4 * r + c) ? clip(v, t) : 0.0f;
        }
        if (CODES)
#pragma unroll
          for (int c = 0; c < 4; ++c) hn |= clip_code(pre[c], t) << (8 * c);
        if (r > 0) {
          const int q = r == 0 ? 0 : r - 1;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float dv = x[c] - xp[c];
            const float v = zv[q][c] + 0.2f * dv;
            pre[c] = v;
            zv[q][c] = bit(mv, 4 * q + c) ? clip(v, t) : 0.0f;
          }
          if constexpr (CODES) {
            unsigned word = hc;
#pragma unroll
              for (int c = 0; c < 4; ++c) word |= clip_code(pre[c], t) << (8 * c + 4);
            cbuf[k & 1][wi0 + q][lane] = word;
          }
        }
        hc = hn;
#pragma unroll
        for (int c = 0; c < 4; ++c) xp[c] = x[c];
      }
      __syncthreads();  // every warp's top row of x0 is in x_edge
      float xb[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // x0 of the row below; window's bottom edge
      if (w + 1 < NW) {
        const float4 e = x_edge[w + 1][lane];
        xb[0] = e.x, xb[1] = e.y, xb[2] = e.z, xb[3] = e.w;
      }
      float pre[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = 4 * (RPT - 1) + c;
        const float v = zv[RPT - 1][c] + 0.2f * (xb[c] - xp[c]);
        pre[c] = v;
        zv[RPT - 1][c] = bit(mv, b) ? clip(v, t) : 0.0f;
      }
      if constexpr (CODES) {
        unsigned word = hc;
#pragma unroll
          for (int c = 0; c < 4; ++c) word |= clip_code(pre[c], t) << (8 * c + 4);
        cbuf[k & 1][wi0 + RPT - 1][lane] = word;
      }
      zv_edge[w][lane] = make_float4(zv[RPT - 1][0], zv[RPT - 1][1], zv[RPT - 1][2],
                                     zv[RPT - 1][3]);
    }

    // the last primal half-step is the output
    __syncthreads();
    if (CODES && R > 1) store_codes(R - 2);
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

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

template <int NW, int RPT>
cudaError_t launch(const float* y0, const float* lam, int lam_per_plane, float* out,
                   unsigned char* codes, int planes, int H, int W, int R, cudaStream_t stream) {
  const int oh = NW * RPT - 2 * R, ow = out_cols(R, codes != nullptr);
  dim3 grid((W + ow - 1) / ow, (H + oh - 1) / oh, planes < 65535 ? planes : 65535);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (codes)
    tv_denoise_chw_kernel<NW, RPT, true><<<grid, NW * 32, 0, stream>>>(
        y0, lam, lam_per_plane, out, codes, planes, H, W, R);
  else
    tv_denoise_chw_kernel<NW, RPT, false><<<grid, NW * 32, 0, stream>>>(
        y0, lam, lam_per_plane, out, nullptr, planes, H, W, R);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Backward

// The backward window's left halo and output width at R iterations (S = R
// - 1 steps): S rounded up to 4 and 128 - that - S rounded down to 4, so
// that each lane's 4 columns are one aligned word of the codes.
__host__ __device__ constexpr int vjp_left_halo(int R) { return (R + 2) / 4 * 4; }
__host__ __device__ constexpr int vjp_out_cols(int R) {
  return (WX - vjp_left_halo(R) - (R - 1)) / 4 * 4;
}
int vjp_out_rows(int window, int R) {
  return VJP_WINDOWS[window].warps * VJP_WINDOWS[window].rows_per_thread - 2 * (R - 1);
}
bool vjp_fits(int window, int R) { return vjp_out_rows(window, R) >= 1 && vjp_out_cols(R) >= 4; }

dim3 vjp_grid(int window, int planes, int H, int W, int R) {
  const int oh = vjp_out_rows(window, R), ow = vjp_out_cols(R);
  return dim3((W + ow - 1) / ow, (H + oh - 1) / oh, planes < 65535 ? planes : 65535);
}

// The backward block's shared memory (dynamic: above 48 KB at 64 and 96 rows).
template <int NW, int RPT>
struct VjpShared {
  float4 a[NW * RPT][32];          // a: lane l's 4 cells of window row i at a[i][l]
  unsigned code[2][NW * RPT][32];  // two steps' codes: lane l's word of row i
  float4 qv_edge[NW][32];          // each warp's bottom row of q'v
  float4 d[RPT >= VJP_D_SHARED_RPT ? NW * RPT : 1][32];  // d y0 (RPT >= VJP_D_SHARED_RPT)
  float red[32];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Every step of the adjoint recursion (see the header) on one window:
// reads g through its strides s0, s1, s2 and the codes ([R - 1, planes, H,
// code_pitch(W)]); writes d y0 of the output cells and the block's sum of d
// t over its output cells and all steps into partial[(p gridDim.y +
// blockIdx.y) gridDim.x + blockIdx.x].
template <int NW, int RPT>
__global__ void __launch_bounds__(NW * 32, 1)
tv_vjp_kernel(const unsigned char* __restrict__ codes, const float* __restrict__ g,
              long long s0, long long s1, long long s2, float* __restrict__ dy,
              float* __restrict__ partial, int planes, int H, int W, int R) {
  static_assert(RPT * 4 <= 32, "the masks hold one bit a cell in 32 bits");
  // d y0 in registers, or in shared memory where registers would spill (at
  // 512 threads a thread has 128)
  constexpr bool D_SHARED = RPT >= VJP_D_SHARED_RPT;
  dprox::allow_dependent_launch();
  extern __shared__ float4 dyn_smem[];
  VjpShared<NW, RPT>& sm = *reinterpret_cast<VjpShared<NW, RPT>*>(dyn_smem);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int S = R - 1;  // steps, and the halo
  const int OH = NW * RPT - 2 * S, OW = vjp_out_cols(R), HL = vjp_left_halo(R);
  const int wi0 = w * RPT, wj0 = 4 * lane;    // window coords of cell (0, 0)
  const int gr0 = blockIdx.y * OH - S + wi0;  // its global coords
  const int gc0 = blockIdx.x * OW - HL + wj0;

  // one bit a cell (bit 4r + c): zh's and zv's masks, in the image, output;
  // kh / kv: the output cells' duals, whose d t this block adds
  unsigned mh = 0, mv = 0, in = 0, keep = 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gr = gr0 + r, gc = gc0 + c, i = wi0 + r, j = wj0 + c;
      const unsigned b = 1u << (4 * r + c);
      if (gr >= 0 && gr <= H - 1 && gc >= 0 && gc <= W - 2) mh |= b;
      if (gr >= 0 && gr <= H - 2 && gc >= 0 && gc <= W - 1) mv |= b;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) in |= b;
      if (i >= S && i < S + OH && j >= HL && j < HL + OW && gr < H && gc < W) keep |= b;
    }
  }
  const unsigned kh = keep & mh, kv = keep & mv;
  const long long cw = code_pitch(W), cplane = (long long)H * cw;
  const bool ccol = gc0 >= 0 && gc0 < W;  // this lane's code words exist

  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    // this lane's code word of window row r at iteration k: cp + k kstride + r cw
    const unsigned char* cp = codes + p * cplane + (long long)gr0 * cw + gc0;
    const long long kstride = (long long)planes * cplane;
    // iteration k's code words into a ring slot; beyond the image (no
    // duals there) a word of plain codes
    auto fetch = [&](int k, int slot) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (ccol && gr0 + r >= 0 && gr0 + r < H)
          cp_async4(&sm.code[slot][wi0 + r][lane], cp + k * kstride + r * cw);
        else
          sm.code[slot][wi0 + r][lane] = 0x99999999u;
      }
    };
    __syncthreads();  // the previous plane is done with the shared memory
    float qh[RPT][4], qv[RPT][4], d[D_SHARED ? 1 : RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float g0[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        g0[c] = bit(in, 4 * r + c) ? g[p * s0 + (gr0 + r) * s1 + (gc0 + c) * s2] : 0.0f;
        if constexpr (!D_SHARED) d[r][c] = g0[c];
        qh[r][c] = 0.0f;
        qv[r][c] = 0.0f;
      }
      sm.a[wi0 + r][lane] = make_float4(g0[0], g0[1], g0[2], g0[3]);
      if constexpr (D_SHARED) sm.d[wi0 + r][lane] = sm.a[wi0 + r][lane];
    }
    if (S > 0) fetch(S - 1, 0);
    cp_async_commit();
    float dt = 0.0f;  // this thread's share of d t, in a fixed order

    for (int s = 0; s < S; ++s) {
      if (s + 1 < S) fetch(S - 2 - s, (s + 1) & 1);  // the next step's codes
      cp_async_commit();
      cp_async_wait_all_but_one();  // this step's codes are in slot s & 1
      __syncthreads();              // a of this step is in sm.a; qv_edge is free
      // q' of every cell from a: a[j+1] by shuffle, a of the row below from
      // sm.a. A row of plain codes takes clip_vjp_plain_code, any other
      // clip_vjp (a branch a row: one a pass, or none, was slower)
      float4 nx = sm.a[wi0][lane];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float ac[4] = {nx.x, nx.y, nx.z, nx.w};
        nx = w + 1 < NW || r + 1 < RPT ? sm.a[wi0 + r + 1][lane]
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float ad[4] = {nx.x, nx.y, nx.z, nx.w};  // the row below; window's bottom edge
        float ar = __shfl_down_sync(FULL, ac[0], 1);
        if (lane == 31) ar = 0.0f;  // window's right edge
        const unsigned word = sm.code[s & 1][wi0 + r][lane];
        const bool plain = plain_codes(word);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = 4 * r + c;
          const float ah = c == 3 ? ar : ac[c == 3 ? 0 : c + 1];  // a[j+1]
          const float ch = qh[r][c] - (ah - ac[c]) / 2.0f;
          const float cv = qv[r][c] - (ad[c] - ac[c]) / 2.0f;
          float th, tv, nh, nv;
          if (plain) {
            nh = clip_vjp_plain_code(word, 8 * c, ch, th);
            nv = clip_vjp_plain_code(word, 8 * c + 4, cv, tv);
          } else {
            nh = clip_vjp((word >> (8 * c)) & 15u, ch, th);
            nv = clip_vjp((word >> (8 * c + 4)) & 15u, cv, tv);
          }
          qh[r][c] = bit(mh, b) ? nh : 0.0f;
          qv[r][c] = bit(mv, b) ? nv : 0.0f;
          if (bit(kh, b)) dt += th;
          if (bit(kv, b)) dt += tv;
        }
      }
      sm.qv_edge[w][lane] = make_float4(qv[RPT - 1][0], qv[RPT - 1][1], qv[RPT - 1][2],
                                        qv[RPT - 1][3]);
      __syncthreads();  // every warp's bottom row of q'v is in qv_edge; sm.a is read
      // a' of every cell from 0.2 q': 0.2 q'h[j-1] by shuffle, 0.2 q'v of the
      // row above from registers or the warp above
      float su[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // window's top edge
      if (w > 0) {
        const float4 e = sm.qv_edge[w - 1][lane];
        su[0] = 0.2f * e.x, su[1] = 0.2f * e.y, su[2] = 0.2f * e.z, su[3] = 0.2f * e.w;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float sh[4], sv[4], an[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) sh[c] = 0.2f * qh[r][c], sv[c] = 0.2f * qv[r][c];
        float sl = __shfl_up_sync(FULL, sh[3], 1);
        if (lane == 0) sl = 0.0f;  // window's left edge
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          an[c] = ((c == 0 ? sl : sh[c == 0 ? 0 : c - 1]) - sh[c]) + (su[c] - sv[c]);
          if constexpr (!D_SHARED) d[r][c] = d[r][c] + an[c];
          su[c] = sv[c];
        }
        sm.a[wi0 + r][lane] = make_float4(an[0], an[1], an[2], an[3]);
        if constexpr (D_SHARED) {
          float4 e = sm.d[wi0 + r][lane];
          e.x = e.x + an[0], e.y = e.y + an[1], e.z = e.z + an[2], e.w = e.w + an[3];
          sm.d[wi0 + r][lane] = e;
        }
      }
    }

    float* dp = dy + (long long)p * H * W;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float out[4];
      if constexpr (D_SHARED) {
        const float4 e = sm.d[wi0 + r][lane];
        out[0] = e.x, out[1] = e.y, out[2] = e.z, out[3] = e.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = d[r][c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (bit(keep, 4 * r + c)) dp[(long long)(gr0 + r) * W + (gc0 + c)] = out[c];
    }
    const float total = dprox::block_sum(dt, sm.red);
    if (threadIdx.x == 0)
      partial[((long long)p * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
  }
}

// d lam of block l: the sum of partial[l n .. l n + n - 1], over 2. Launched
// dependent on tv_vjp_kernel: waits for its partials before reading them.
__global__ void __launch_bounds__(dprox::THREADS)
tv_vjp_lam_kernel(const float* __restrict__ partial, int n, float* __restrict__ dlam) {
  dprox::wait_for_primary();
  __shared__ float red[32];
  const float total = dprox::reduce_partials(partial + (long long)blockIdx.x * n, n, red);
  if (threadIdx.x == 0) dlam[blockIdx.x] = total / 2.0f;
}

template <int NW, int RPT>
cudaError_t vjp_launch(int window, const unsigned char* codes, const float* g, long long s0,
                       long long s1, long long s2, float* dy, float* partial, int planes, int H,
                       int W, int R, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(VjpShared<NW, RPT>);
  static bool ready[MAX_DEVICES] = {};  // the shared-memory limit is raised on that device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(tv_vjp_kernel<NW, RPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid = vjp_grid(window, planes, H, W, R);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  tv_vjp_kernel<NW, RPT><<<grid, NW * 32, smem, stream>>>(codes, g, s0, s1, s2, dy, partial,
                                                         planes, H, W, R);
  return cudaGetLastError();
}

long long vjp_blocks(int window, int planes, int H, int W, int R) {
  const dim3 grid = vjp_grid(window, 1, H, W, R);
  return (long long)planes * grid.x * grid.y;
}

}  // namespace

extern "C" {

// Largest iteration count (= halo) that one launch takes: the tallest
// window must keep one output row.
int dprox_tv_max_iterations() { return (MAX_ROWS - 1) / 2; }

// The window (an index into WINDOWS) that puts the fewest window rows on
// the most loaded SM of the current device; -1 if none fits.
int dprox_tv_window(int planes, int H, int W, int iterations) {
  const int sms = sm_count();
  if (sms <= 0) return -1;
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
// one (dprox_tv_window). `codes`: null, or [iterations - 1, planes, H,
// code_pitch(W)] bytes (4-byte aligned) that receive the clip codes the
// backward reads. Launches on `stream` and does not synchronise.
int dprox_tv_denoise_chw(const float* y0, const float* lam, int lam_per_plane, float* out,
                         unsigned char* codes, int planes, int H, int W, int iterations,
                         int window, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || iterations <= 0 ||
      iterations > dprox_tv_max_iterations() || window < -1 || window >= N_WINDOWS)
    return (int)cudaErrorInvalidValue;
  if (window < 0) window = dprox_tv_window(planes, H, W, iterations);
  if (window < 0 || output_rows(window, iterations) < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (window) {
    case 0:
      return (int)launch<8, 4>(y0, lam, lam_per_plane, out, codes, planes, H, W, iterations, s);
    default:
      return (int)launch<8, 12>(y0, lam, lam_per_plane, out, codes, planes, H, W, iterations, s);
  }
}

// The backward's window (an index into VJP_WINDOWS), picked as
// dprox_tv_window picks the forward's; -1 if none fits.
int dprox_tv_vjp_window(int planes, int H, int W, int iterations) {
  const int sms = sm_count();
  if (sms <= 0) return -1;
  int best = -1;
  long long best_cost = 0;
  for (int i = 0; i < N_VJP_WINDOWS; ++i) {
    if (!vjp_fits(i, iterations)) continue;
    const long long n = vjp_blocks(i, planes, H, W, iterations);
    const long long cost =
        (n + sms - 1) / sms * (VJP_WINDOWS[i].warps * VJP_WINDOWS[i].rows_per_thread);
    if (best < 0 || cost < best_cost) best = i, best_cost = cost;
  }
  return best;
}

// Floats of workspace dprox_tv_vjp takes in `window` (-1: the one it
// picks): one partial sum of d t per plane and block; -1 if no window fits.
long long dprox_tv_vjp_workspace(int planes, int H, int W, int iterations, int window) {
  if (planes <= 0 || H <= 0 || W <= 0 || iterations <= 0 ||
      iterations > dprox_tv_max_iterations() || window < -1 || window >= N_VJP_WINDOWS)
    return -1;
  if (window < 0) window = dprox_tv_vjp_window(planes, H, W, iterations);
  if (window < 0 || !vjp_fits(window, iterations)) return -1;
  return vjp_blocks(window, planes, H, W, iterations);
}

// The VJP of dprox_tv_denoise_chw: d y0 [planes, H, W] and d lam (one value,
// or one per plane) for the cotangent g of the output, read through its
// strides (in elements), from the forward's `codes` (null at one
// iteration). `work` holds dprox_tv_vjp_workspace floats of the same
// window (an index into VJP_WINDOWS, -1 picks one). Two launches: every
// step in one, then the sum of d t. Returns a cudaError_t.
int dprox_tv_vjp(const unsigned char* codes, const float* g, long long s0, long long s1,
                 long long s2, int lam_per_plane, float* dy, float* dlam, float* work,
                 int planes, int H, int W, int iterations, int window, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || iterations <= 0 ||
      iterations > dprox_tv_max_iterations() || window < -1 || window >= N_VJP_WINDOWS ||
      (iterations > 1 && codes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (window < 0) window = dprox_tv_vjp_window(planes, H, W, iterations);
  if (window < 0 || !vjp_fits(window, iterations)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  constexpr Window V0 = VJP_WINDOWS[0], V1 = VJP_WINDOWS[1], V2 = VJP_WINDOWS[2];
  switch (window) {
    case 0:
      err = vjp_launch<V0.warps, V0.rows_per_thread>(window, codes, g, s0, s1, s2, dy, work,
                                                     planes, H, W, iterations, st);
      break;
    case 1:
      err = vjp_launch<V1.warps, V1.rows_per_thread>(window, codes, g, s0, s1, s2, dy, work,
                                                     planes, H, W, iterations, st);
      break;
    default:
      err = vjp_launch<V2.warps, V2.rows_per_thread>(window, codes, g, s0, s1, s2, dy, work,
                                                     planes, H, W, iterations, st);
  }
  if (err != cudaSuccess) return (int)err;
  const long long per = vjp_blocks(window, lam_per_plane ? 1 : planes, H, W, iterations);
  if (per > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return dprox::launch_dependent(tv_vjp_lam_kernel, dim3(lam_per_plane ? planes : 1),
                                 dprox::THREADS, st, (const float*)work, (int)per, dlam);
}

// Registers, local (spill) bytes and static shared bytes of one kernel, as
// the card's loader reports them (cudaFuncGetAttributes): kind 0 the
// forward, 1 the forward with codes (window indexes WINDOWS), 2 the
// backward (window indexes VJP_WINDOWS). Returns a cudaError_t.
int dprox_tv_kernel_attributes(int kind, int window, int* regs, int* local_bytes,
                               int* shared_bytes) {
  const void* fn = nullptr;
  if (kind == 0 && window == 0) fn = (const void*)tv_denoise_chw_kernel<8, 4, false>;
  if (kind == 0 && window == 1) fn = (const void*)tv_denoise_chw_kernel<8, 12, false>;
  if (kind == 1 && window == 0) fn = (const void*)tv_denoise_chw_kernel<8, 4, true>;
  if (kind == 1 && window == 1) fn = (const void*)tv_denoise_chw_kernel<8, 12, true>;
  constexpr Window V0 = VJP_WINDOWS[0], V1 = VJP_WINDOWS[1], V2 = VJP_WINDOWS[2];
  if (kind == 2 && window == 0) fn = (const void*)tv_vjp_kernel<V0.warps, V0.rows_per_thread>;
  if (kind == 2 && window == 1) fn = (const void*)tv_vjp_kernel<V1.warps, V1.rows_per_thread>;
  if (kind == 2 && window == 2) fn = (const void*)tv_vjp_kernel<V2.warps, V2.rows_per_thread>;
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* dprox_tv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
