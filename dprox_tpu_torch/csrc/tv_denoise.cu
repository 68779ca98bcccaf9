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
// tile with its halo recomputes 52^2 / 32^2 = 2.64x) and 128 x 32 at
// 3x256x256 and 5 iterations (108 blocks; recompute 128*32 / (118*22) =
// 1.58x). Up to 47 iterations run in one launch (the 96-row window keeps one
// output row); 1..15 fit the 32-row window. -Xptxas -v (sm_90a, nvcc 12.9):
// 108 registers for 128 x 32, 193 for 128 x 96, no spills; the CODES
// variants 146, and 255 with 48 bytes of spills. A 128 x 64 window (2 blocks an SM at 128
// registers) and 128 x 96 with 16 warps (6 rows a lane) spill and were
// slower at both path shapes on an H100 (PERF.md).
//
// Bits: every cell runs the same float32 operations in the same order as
// the plain version, compiled with --fmad=false so no a*b+c is
// contracted, so each output equals the plain version's to the last bit,
// whatever the window.
//
// Under grad the same kernel (CODES) also writes, for every output cell and
// iteration k = 0..R-2 (the last dual update is dead), one byte: for each of
// the cell's two duals, 4 bits that say where the pre-clip value p stood
// against -t and where max(p, -t) stood against t (below, equal, above or
// unordered). That is all the backward needs of the forward: R - 1 bytes a
// cell (whether a dual exists follows from its position). The codes' rows
// are padded to a multiple of 4 bytes and the CODES windows start on a
// multiple of 4 columns (a left halo of R rounded up to 4, an output width
// that is a multiple of 4), so a lane writes its 4 cells' codes of a row as
// one aligned 32-bit word: one store a row an iteration.
//
// Backward (dprox_tv_vjp): the VJP of the function above, for the
// cotangent g of the output x_{R-1}, in ops/kernels.py::
// tv_denoise_chw_vjp_plain's operation order. With a = g and the pre-clip
// cotangents q = 0, for k = R-1 down to 1:
//   q' = clip_vjp(code_{k-1}, q - Dh a / 2)  (zh; zv likewise with Dv)
//   a' = Dh^T (0.2 q'h) + Dv^T (0.2 q'v),  d y0 += a',  d t += the clip's share
// and d lam = d t / 2 (t = lam / 2). A clip's cotangent follows torch.maximum
// / torch.minimum's backward, as JAX's jnp.clip does: a tie gives each side
// half. One launch a step (a 32 x 8 tile of cells a block, a one-cell halo
// of a in shared memory, the q' of the tile's left column and top row
// recomputed), then one launch that adds the per-block sums of d t in a
// fixed order (no atomics): R launches a call, and two calls give the same
// bits; d y0 equals the plain adjoint's bits.
//
// Bound on an H100 at 3x512x512 and 10 iterations: the backward reads the
// codes (9 bytes a cell) and g and writes d y0, 13.4 MB, 4.0 us at
// 3.35 TB/s; ~18 float operations a cell a step, 1.9 us at 67 TFLOP/s. A
// step moves ~33 bytes a cell (a, q and d y0 in and out, the codes).

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
constexpr int MAX_ROWS = 96;  // tallest window

__device__ __forceinline__ float clip(float v, float t) { return fminf(fmaxf(v, -t), t); }

// A dual's clip code (4 bits): bits 0-1 the order of the pre-clip value p
// against -t, bits 2-3 that of max(p, -t) against t. A cell's byte holds
// zh's code in its low and zv's in its high 4 bits.
constexpr unsigned LT = 1, EQ = 2, GT = 3;

__device__ __forceinline__ unsigned order(float a, float b) {
  return a < b ? LT : a == b ? EQ : a > b ? GT : 0;
}

__device__ __forceinline__ unsigned clip_code(float p, float t) {
  return order(p, -t) | (order(fmaxf(p, -t), t) << 2);
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
// side that wins takes c, a tie gives each side c / 2.
__device__ __forceinline__ float clip_vjp(unsigned code, float c, float& dt) {
  const unsigned lo = code & 3, hi = (code >> 2) & 3;
  const float gm = hi == EQ ? c / 2.0f : hi == GT ? 0.0f : c;   // to max(p, -t)
  const float gt = hi == EQ ? c / 2.0f : hi == LT ? 0.0f : c;   // to t
  const float gp = lo == EQ ? gm / 2.0f : lo == LT ? 0.0f : gm;  // to p
  const float gn = lo == EQ ? gm / 2.0f : lo == GT ? 0.0f : gm;  // to -t
  dt = gt - gn;
  return gp;
}

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
  // codes: the rows this lane writes (one bit a row), where its group of 4
  // columns is output
  unsigned krow = 0;
  if (wj0 >= HL && wj0 < HL + OW && gc0 < W)
    for (int r = 0; r < RPT; ++r)
      if (wi0 + r >= R && wi0 + r < R + OH && gr0 + r < H) krow |= 1u << r;

  const size_t cw = code_pitch(W), cplane = (size_t)H * cw;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* yp = y0 + (size_t)p * H * W;
    float* op = out + (size_t)p * H * W;
    // this lane's code word of row r at iteration k: cp[(k planes cplane + r cw) / 4]
    unsigned* cp = CODES ? reinterpret_cast<unsigned*>(codes + p * cplane +
                                                       gr0 * (long long)cw + gc0)
                         : nullptr;
    const size_t kstride = (size_t)planes * cplane / 4, rstride = cw / 4;
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
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dh = (c == 3 ? xr : x[c == 3 ? 0 : c + 1]) - x[c];
          const float v = zh[r][c] + 0.2f * dh;
          if (CODES) hn |= clip_code(v, t) << (8 * c);
          zh[r][c] = bit(mh, 4 * r + c) ? clip(v, t) : 0.0f;
        }
        if (r > 0) {
          const int q = r == 0 ? 0 : r - 1;
          unsigned word = hc;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float dv = x[c] - xp[c];
            const float v = zv[q][c] + 0.2f * dv;
            if (CODES) word |= clip_code(v, t) << (8 * c + 4);
            zv[q][c] = bit(mv, 4 * q + c) ? clip(v, t) : 0.0f;
          }
          if (CODES && ((krow >> q) & 1u)) cp[k * kstride + q * rstride] = word;
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
      unsigned word = hc;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = 4 * (RPT - 1) + c;
        const float v = zv[RPT - 1][c] + 0.2f * (xb[c] - xp[c]);
        if (CODES) word |= clip_code(v, t) << (8 * c + 4);
        zv[RPT - 1][c] = bit(mv, b) ? clip(v, t) : 0.0f;
      }
      if (CODES && ((krow >> (RPT - 1)) & 1u)) cp[k * kstride + (RPT - 1) * rstride] = word;
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

constexpr int TX = 32, TY = 8;  // a step's tile of cells: one thread a cell

// One step of the adjoint recursion (see the header) on [planes, H, W]:
// reads a and the pre-clip cotangents q of iteration k (FIRST: a is g, read
// through its strides s0, s1, s2, and q is 0) and the clip codes of
// iteration k - 1 ([planes, H, code_pitch(W)]); writes a', q' and d y0
// (FIRST: g + a', else += a'), and adds each block's share of d t into its
// slot of `partial` (FIRST: sets it). q is [planes, H, W], pinned duals
// included (never read).
template <bool FIRST>
__global__ void __launch_bounds__(TX * TY)
tv_vjp_step_kernel(const float* __restrict__ a_in, long long s0, long long s1, long long s2,
                   const float* __restrict__ qh_in, const float* __restrict__ qv_in,
                   const unsigned char* __restrict__ code, float* __restrict__ a_out,
                   float* __restrict__ qh_out, float* __restrict__ qv_out,
                   float* __restrict__ dy, float* __restrict__ partial, int planes, int H,
                   int W) {
  __shared__ float as[TY + 2][TX + 2];  // a at rows i0 - 1 .. i0 + TY, cols j0 - 1 .. j0 + TX
  __shared__ float sh[TY][TX + 1];      // 0.2 q'h at cols j0 - 1 .. j0 + TX - 1
  __shared__ float sv[TY + 1][TX];      // 0.2 q'v at rows i0 - 1 .. i0 + TY - 1
  __shared__ float red[32];
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const long long HW = (long long)H * W, cw = code_pitch(W);
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const unsigned char* cp = code + (long long)p * H * cw;
    for (int e = threadIdx.x; e < (TY + 2) * (TX + 2); e += blockDim.x) {
      const int r = e / (TX + 2), c = e % (TX + 2), i = i0 - 1 + r, j = j0 - 1 + c;
      as[r][c] = i >= 0 && i < H && j >= 0 && j < W ? a_in[p * s0 + i * s1 + j * s2] : 0.0f;
    }
    __syncthreads();
    float dt = 0.0f;  // this thread's share of d t, over the tile's own duals
    for (int e = threadIdx.x; e < TY * (TX + 1); e += blockDim.x) {
      const int r = e / (TX + 1), c = e % (TX + 1), i = i0 + r, j = j0 - 1 + c;
      float s = 0.0f;
      if (i < H && j >= 0 && j <= W - 2) {
        const long long at = p * HW + (long long)i * W + j;
        const float q = FIRST ? 0.0f : qh_in[at];
        float d;
        const float qn = clip_vjp(cp[i * cw + j] & 15u,
                                  q - (as[r + 1][c + 1] - as[r + 1][c]) / 2.0f, d);
        s = 0.2f * qn;
        if (c > 0) {
          qh_out[at] = qn;
          dt += d;
        }
      }
      sh[r][c] = s;
    }
    for (int e = threadIdx.x; e < (TY + 1) * TX; e += blockDim.x) {
      const int r = e / TX, c = e % TX, i = i0 - 1 + r, j = j0 + c;
      float s = 0.0f;
      if (i >= 0 && i <= H - 2 && j < W) {
        const long long at = p * HW + (long long)i * W + j;
        const float q = FIRST ? 0.0f : qv_in[at];
        float d;
        const float qn = clip_vjp(cp[i * cw + j] >> 4,
                                  q - (as[r + 1][c + 1] - as[r][c + 1]) / 2.0f, d);
        s = 0.2f * qn;
        if (r > 0) {
          qv_out[at] = qn;
          dt += d;
        }
      }
      sv[r][c] = s;
    }
    __syncthreads();
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX, i = i0 + ty, j = j0 + tx;
    if (i < H && j < W) {
      const long long at = p * HW + (long long)i * W + j;
      const float an = (sh[ty][tx] - sh[ty][tx + 1]) + (sv[ty][tx] - sv[ty + 1][tx]);
      a_out[at] = an;
      dy[at] = (FIRST ? as[ty + 1][tx + 1] : dy[at]) + an;
    }
    const float total = dprox::block_sum(dt, red);  // its barriers also free as, sh, sv
    if (threadIdx.x == 0) {
      float* slot = partial + ((long long)p * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      *slot = FIRST ? total : *slot + total;
    }
  }
}

// d lam of block l: the sum of partial[l n .. l n + n - 1], over 2.
__global__ void __launch_bounds__(dprox::THREADS)
tv_vjp_lam_kernel(const float* __restrict__ partial, int n, float* __restrict__ dlam) {
  __shared__ float red[32];
  const float total = dprox::reduce_partials(partial + (long long)blockIdx.x * n, n, red);
  if (threadIdx.x == 0) dlam[blockIdx.x] = total / 2.0f;
}

// One iteration: d y0 = g (read through its strides).
__global__ void __launch_bounds__(dprox::THREADS)
tv_vjp_copy_kernel(const float* __restrict__ g, long long s0, long long s1, long long s2,
                   float* __restrict__ dy, int planes, int H, int W) {
  const long long n = (long long)planes * H * W;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long j = e % W, i = e / W % H, p = e / ((long long)H * W);
    dy[e] = g[p * s0 + i * s1 + j * s2];
  }
}

long long tiles(int H, int W) { return (long long)((W + TX - 1) / TX) * ((H + TY - 1) / TY); }

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

// Floats of workspace dprox_tv_vjp takes: a, q'h and q'v twice over, and
// one partial sum of d t per plane and step tile.
long long dprox_tv_vjp_workspace(int planes, int H, int W) {
  return 6LL * planes * H * W + planes * tiles(H, W);
}

// The VJP of dprox_tv_denoise_chw: d y0 [planes, H, W] and d lam (one value,
// or one per plane) for the cotangent g of the output, read through its
// strides (in elements), from the forward's `codes`. `work` holds
// dprox_tv_vjp_workspace floats. iterations launches (iterations - 1 steps
// and the sum of d t; one iteration: a copy of g and d lam = 0). Returns a
// cudaError_t.
int dprox_tv_vjp(const unsigned char* codes, const float* g, long long s0, long long s1,
                 long long s2, int lam_per_plane, float* dy, float* dlam, float* work,
                 int planes, int H, int W, int iterations, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || iterations <= 0 ||
      iterations > dprox_tv_max_iterations())
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)planes * H * W, HW = (long long)H * W;
  float* a[2] = {work, work + n};
  float* qh[2] = {work + 2 * n, work + 3 * n};
  float* qv[2] = {work + 4 * n, work + 5 * n};
  float* partial = work + 6 * n;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, planes < 65535 ? planes : 65535);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  for (int step = 0; step + 1 < iterations; ++step) {
    const int k = iterations - 2 - step;  // the iteration whose codes this step reads
    const unsigned char* ck = codes + (long long)k * planes * H * code_pitch(W);
    const int o = step & 1, i = o ^ 1;
    if (step == 0)
      tv_vjp_step_kernel<true><<<grid, TX * TY, 0, st>>>(g, s0, s1, s2, nullptr, nullptr, ck,
                                                         a[o], qh[o], qv[o], dy, partial,
                                                         planes, H, W);
    else
      tv_vjp_step_kernel<false><<<grid, TX * TY, 0, st>>>(a[i], HW, W, 1, qh[i], qv[i], ck,
                                                          a[o], qh[o], qv[o], dy, partial,
                                                          planes, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (iterations == 1) {
    const long long nb = (n + dprox::THREADS - 1) / dprox::THREADS;
    tv_vjp_copy_kernel<<<(unsigned)(nb < 4096 ? nb : 4096), dprox::THREADS, 0, st>>>(
        g, s0, s1, s2, dy, planes, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long per = iterations == 1 ? 0 : (lam_per_plane ? 1 : planes) * tiles(H, W);
  if (per > 0x7fffffff) return (int)cudaErrorInvalidValue;
  tv_vjp_lam_kernel<<<lam_per_plane ? planes : 1, dprox::THREADS, 0, st>>>(partial, (int)per,
                                                                           dlam);
  return (int)cudaGetLastError();
}

const char* dprox_tv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
