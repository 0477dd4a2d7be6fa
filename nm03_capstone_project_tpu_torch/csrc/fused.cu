// Hopper kernel for the fused normalize -> clip -> k x k median -> unsharp
// sharpen preprocessing stage.
//
// Replaces the JAX package's Pallas kernel _fused_band_kernel
// (ops/pallas_median.py:165, called at :335) with nm03_fused_preprocess.
//
// Design. A persistent grid (one CTA an SM, `grid` CTAs) walks tiles of
// tile_h x tile_w outputs; the wrapper picks the tile height so that the
// tiles make whole waves of the grid, trading halo rows against a ragged
// last wave, and tiles span the slice's width up to 256 columns. A tile:
//
// 1. stages its median region plus the median's halo in shared memory,
//    normalized and clipped on load, with row and column indices clamped
//    to the canvas (no padded copy of the image is made);
// 2. computes every median of the region that lies on the canvas (the
//    tile's outputs plus the sharpen's rs-row and rs-column halo): a thread
//    takes a run of R horizontally adjacent medians of one row and runs the
//    generated MedianRun<K, R> (median_runs.cuh, from
//    kernels/median_runs.py): it loads the R + 2r window columns, presorts
//    each with the Batcher network in registers (32 min/max at K = 7) and
//    runs the shared plan median_merge_plan(K, share=True), each node
//    computed once at each lane the run needs it. At K = 7, R = 16 that is
//    316.5 min/max a median against the 294 of presort plus shared plan;
//    consecutive threads take consecutive rows, and the row strides are
//    odd, so the shared-memory loads and stores are free of bank conflicts;
// 3. blurs vertically and then horizontally (ks taps, the median read at
//    its canvas-clamped index: the sharpen's edge pad) and writes
//    c + gain * (c - blur); a thread walks down one column, four rows at a
//    time, so four independent sums hide the shared-memory latency that
//    one CTA an SM (8 warps) cannot hide by switching warps.
//
// Exactness. Any exact rank selection gives the reference's bits: min/max
// return one of their inputs, and the data is finite. The arithmetic uses
// __fsub_rn/__fmul_rn/__fadd_rn in the plain PyTorch version's order
// (normalize (x - min) * scale + low; taps vertical then horizontal,
// acc = term then acc + term; c + gain * (c - blur)), so nvcc contracts
// nothing into an FMA and the kernel matches the plain version bit for bit.
//
// Bound on the H100: ~300 min/max a pixel against 8 bytes of traffic, so
// the issue rate of min/max bounds it; the design spends its effort on
// doing fewer of them (shared plan, optimal presort, little halo, whole
// waves).
//
// The sharpen kernel (nm03_sharpen) is the second launch of the fused
// stage's split route, which takes every config the fused kernel does not
// (k > 15, or more than 31 taps; ops/hopper_median.py): the median kernel
// of median.cu with normalize and clip in its prologue, then this kernel,
// the unsharp update of the median image with its ks-tap separable
// gaussian blur, so the route runs no torch op between its two launches.
// It replaces no Pallas kernel of its own: it is the sharpen half of
// _fused_band_kernel (ops/pallas_median.py:165), which the JAX package
// runs as XLA ops where no band fits VMEM.
//
// Design (up to 33 taps, windowed_sharpen_kernel<KS>, one instantiation
// an odd KS: windowed_kernel's switch, WIN_MAX_TAPS in the wrapper). Each
// CTA takes tiles of TH x TW outputs (one tile a CTA as the wrapper
// launches it). It stages the median tile plus
// rs = KS / 2 rows each side and RSP = rs rounded up to 4 columns each
// side, so its rows are whole 16-byte chunks, with cp.async: a chunk
// inside the canvas goes as one 16-byte copy where the rows start 16-byte
// aligned (W % 4 == 0 and an aligned base), any other chunk as four 4-byte
// copies from canvas-clamped columns, and every row from its
// canvas-clamped row. That is the plain version's edge pad on both passes
// (the horizontal pass pads the vertical result, and the vertical result
// at a clamped column is the blur of the clamped column), so no index is
// clamped after staging and nothing is fixed up after a copy lands. The
// vertical pass is a register window: a thread takes one column and
// WIN_SEG rows of V and reads each staged row once (KS + WIN_SEG - 1
// shared loads for WIN_SEG outputs, against KS each); the taps sit in
// registers. The horizontal pass takes four adjacent outputs a thread from
// 16-byte reads of V (KS + 3 values in (KS + 6) / 4 loads, against 4 KS)
// and writes them with one 16-byte store where the row is aligned. A tile
// is computed whole (rows and columns past the canvas read clamped values)
// and only its outputs on the canvas are stored. Each pass sums its taps
// in the plain order (acc = t0 x0, then acc + ti xi), every product and
// sum rounded on its own. On the card (scripts/torch_kernel_probe.py
// sharpen) cp.async staging beats 16-byte loads through registers, and one
// staged tile a CTA with the hardware scheduling CTAs beats two staged
// tiles a CTA on a persistent grid that copies its next tile in while it
// blurs one: the second tile's shared memory costs more CTAs an SM than
// the overlap gains. The staging and stores alone take about twice a
// plain copy of the same bytes at the main batch's size, and a tile's
// loads are not hidden behind another tile's blur.

// Past 33 taps (sharpen_kernel<STAGED>, the general loop): each CTA takes
// tiles of TH x TW outputs and stages the median tile plus rs rows and
// columns each side at canvas-clamped indices; the vertical pass fills V,
// then the horizontal pass and c + gain * (c - blur); a thread sums
// BLUR_ROWS rows of one column at once, one shared load of a tap for the
// four. Where the staged tile does not fit a block (past 177 taps at 32 x
// 64 tiles), the kernel stages only V, the rows of one pass, and the
// vertical pass reads the median through L1 at clamped indices; the
// wrapper shortens the tile until V fits, reads the taps from their buffer
// where they do not fit beside it, and past that keeps V in a device
// scratch of its own (a sharpen longer than a block's shared memory holds
// twice). The taps come from a device buffer in every plan. Bound on the
// H100: bytes, one read of the median and one write of the output (8
// bytes an output), against 4 ks + 1 operations an output, which pass the
// bytes from 21 taps on (133 operations an output at 33).

#include <cuda_runtime.h>
#include <stdint.h>

#include "median_runs.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_TAPS = 31;
constexpr int BLUR_ROWS = 4;  // outputs a thread's blur accumulates together

struct Pre {
  float norm_min, norm_scale, norm_low, clip_low, clip_high, gain;
  int ks;
  float taps[MAX_TAPS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// n / d with one multiply-high, exact while n * d < 2^32 (here n < 2^17,
// d < 2^10): the staging loop's index split without a division.
struct FastDiv {
  uint32_t m;
  __device__ explicit FastDiv(int d) : m(0xffffffffu / (uint32_t)d + 1u) {}
  __device__ int operator()(int n) const { return (int)__umulhi((uint32_t)n, m); }
};

// The layout every tile of a launch shares; the host sizes shared memory
// from the same numbers. The medians sit in rows of the tile's output rows
// plus rs above and below (row z is canvas row y0 - rs + z), and the
// vertical blur in columns of its output columns plus rs each side (column
// z is canvas column x0 - rs + z); where those fall off the canvas the edge
// row or column is copied in, so the blur passes clamp nothing.
struct Layout {
  int mrows, mws, ih, iws, vws;  // median rows and the row strides of M, in and V
  __host__ __device__ Layout(int H, int W, int TH, int TW, int rs, int K, int R) {
    const int mh = H < TH + 2 * rs ? H : TH + 2 * rs;
    const int mw = W < TW + 2 * rs ? W : TW + 2 * rs;
    mrows = TH + 2 * rs + BLUR_ROWS - 1;  // the last BLUR_ROWS - 1 only read, then dropped
    mws = ((mw + R - 1) / R * R) | 1;
    ih = mh + 2 * (K / 2);
    iws = ((mw + R - 1) / R * R + 2 * (K / 2)) | 1;
    vws = (TW + 2 * rs) | 1;
  }
  // `in` (ih x iws), reused for the vertical blur (TH x vws), then M
  __host__ __device__ size_t in_floats(int TH) const {
    const size_t a = (size_t)ih * iws, b = (size_t)TH * vws;
    return a > b ? a : b;
  }
  __host__ __device__ size_t floats(int TH) const { return in_floats(TH) + (size_t)mrows * mws; }
};

template <int K, int R>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_kernel(const float* __restrict__ x, float* __restrict__ out, int B, int H, int W,
             int TH, int TW, Pre p) {
  constexpr int r = K / 2;
  const int rs = p.ks / 2;
  const Layout L(H, W, TH, TW, rs, K, R);
  extern __shared__ float smem[];
  float* in = smem;
  float* M = smem + L.in_floats(TH);
  float* V = in;  // `in` is dead once the medians are written
  const int n_r = (H + TH - 1) / TH, n_c = (W + TW - 1) / TW;
  const int tiles = B * n_r * n_c;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / (n_r * n_c), ty = (t / n_c) % n_r, tx = t % n_c;
    const int y0 = ty * TH, x0 = tx * TW;
    const int th = min(TH, H - y0), tw = min(TW, W - x0);
    // the medians on the canvas: rows [my0, my1), columns [mx0, mx1)
    const int my0 = max(0, y0 - rs), my1 = min(H, y0 + th + rs);
    const int mx0 = max(0, x0 - rs), mx1 = min(W, x0 + tw + rs);
    const int mh = my1 - my0, mw = mx1 - mx0;
    const int mo = my0 - (y0 - rs), co = mx0 - (x0 - rs);  // their first M row, V column
    const int truns = (mw + R - 1) / R;
    const int ih = mh + 2 * r, iw = truns * R + 2 * r;
    const float* xb = x + (size_t)b * H * W;
    float* ob = out + (size_t)b * H * W;

    // 1. stage: in[i][j] = canvas (my0 - r + i, mx0 - r + j), clamped
    const FastDiv div_iw(iw);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ih * iw; idx += NTHREADS) {
      const int i = div_iw(idx), j = idx - i * iw;
      const int gy = clampi(my0 - r + i, 0, H - 1), gx = clampi(mx0 - r + j, 0, W - 1);
      const float v = xb[(size_t)gy * W + gx];
      const float n = __fadd_rn(__fmul_rn(__fsub_rn(v, p.norm_min), p.norm_scale), p.norm_low);
      in[i * L.iws + j] = fminf(fmaxf(n, p.clip_low), p.clip_high);
    }
    __syncthreads();

    // 2. medians: M row mo + i, column c is the median at canvas
    //    (my0 + i, mx0 + c); a thread takes row i of run j, consecutive
    //    threads consecutive rows
    for (int q = threadIdx.x; q < mh * truns; q += NTHREADS) {
      const int j = q / mh, i = q - j * mh;
      MedianRun<K, R>::run(in + i * L.iws + j * R, L.iws, M + (mo + i) * L.mws + j * R);
    }
    __syncthreads();
    // the sharpen's edge pad: rows of M above and below the canvas copy its
    // first and last median row
    const int pad_rows = th + 2 * rs - mh;
    for (int idx = threadIdx.x; idx < pad_rows * mw; idx += NTHREADS) {
      const int z0 = idx / mw, c = idx - z0 * mw;
      const int z = z0 < mo ? z0 : mo + mh + (z0 - mo);
      M[z * L.mws + c] = M[(z0 < mo ? mo : mo + mh - 1) * L.mws + c];
    }
    __syncthreads();

    // 3. vertical blur: V row y, column co + c, from M rows y .. y + ks - 1;
    //    a thread walks down a column, BLUR_ROWS rows at a time, their sums
    //    interleaved (one CTA an SM leaves few warps to hide latency)
    for (int c = threadIdx.x; c < mw; c += NTHREADS) {
      for (int y = 0; y < th; y += BLUR_ROWS) {
        float acc[BLUR_ROWS];
        const float* m = M + y * L.mws + c;
        for (int k = 0; k < p.ks; ++k, m += L.mws) {
          const float tap = p.taps[k];
#pragma unroll
          for (int u = 0; u < BLUR_ROWS; ++u) {
            const float term = __fmul_rn(tap, m[u * L.mws]);
            acc[u] = k == 0 ? term : __fadd_rn(acc[u], term);
          }
        }
#pragma unroll
        for (int u = 0; u < BLUR_ROWS; ++u) {
          if (y + u < th) V[(y + u) * L.vws + co + c] = acc[u];
        }
      }
    }
    __syncthreads();
    // the edge pad again: columns of V left and right of the canvas copy
    // its first and last column
    const int pad_cols = tw + 2 * rs - mw;
    for (int idx = threadIdx.x; idx < th * pad_cols; idx += NTHREADS) {
      const int y = idx / pad_cols, z0 = idx - y * pad_cols;
      const int z = z0 < co ? z0 : co + mw + (z0 - co);
      V[y * L.vws + z] = V[y * L.vws + (z0 < co ? co : co + mw - 1)];
    }
    __syncthreads();

    // 4. horizontal pass, V columns xx .. xx + ks - 1, and the unsharp
    //    update c + gain * (c - blur); a thread walks down an output column
    for (int xx = threadIdx.x; xx < tw; xx += NTHREADS) {
      for (int y = 0; y < th; y += BLUR_ROWS) {
        float acc[BLUR_ROWS];
        for (int k = 0; k < p.ks; ++k) {
          const float tap = p.taps[k];
#pragma unroll
          for (int u = 0; u < BLUR_ROWS; ++u) {
            const float term = __fmul_rn(tap, V[min(y + u, th - 1) * L.vws + xx + k]);
            acc[u] = k == 0 ? term : __fadd_rn(acc[u], term);
          }
        }
#pragma unroll
        for (int u = 0; u < BLUR_ROWS; ++u) {
          if (y + u < th) {
            const float c = M[(y + u + rs) * L.mws + (x0 + xx - mx0)];
            ob[(size_t)(y0 + y + u) * W + x0 + xx] =
                __fadd_rn(c, __fmul_rn(p.gain, __fsub_rn(c, acc[u])));
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites in, V and M
  }
}

template <int K>
cudaError_t launch(const float* x, float* out, int B, int H, int W, int TH, int TW, int grid,
                   const Pre& p, cudaStream_t stream) {
  constexpr int R = FusedRuns<K>::R;
  const size_t bytes = Layout(H, W, TH, TW, p.ks / 2, K, R).floats(TH) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_kernel<K, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  fused_kernel<K, R><<<grid, NTHREADS, bytes, stream>>>(x, out, B, H, W, TH, TW, p);
  return cudaGetLastError();
}

constexpr int SHARPEN_THREADS = 256;

// Shared floats of a sharpen CTA, the wrapper's sharpen_smem_bytes / 4:
// staged, the taps and the staged tile ((TH + 2 rs) x (TW + 2 rs)); and V
// (TH x (TW + 2 rs)) where it is in shared memory.
__host__ __device__ inline size_t sharpen_floats(int ks, int TH, int TW, int staged,
                                                 int v_shared) {
  const size_t sw = TW + ks - 1;
  return (staged ? ks + (TH + ks - 1) * sw : 0) + (v_shared ? TH * sw : 0);
}

// STAGED: the staged tile, the taps and V in shared memory (the wrapper's
// tile plan). Else V in shared memory or in `vscratch`, the taps and the
// median read from their buffers.
template <bool STAGED>
__global__ void __launch_bounds__(SHARPEN_THREADS)
sharpen_kernel(const float* __restrict__ m, float* __restrict__ out,
               const float* __restrict__ taps, float* vscratch, int H, int W, int ks,
               float gain, int TH, int TW, long long tiles) {
  extern __shared__ float smem[];
  const int rs = ks / 2, SW = TW + 2 * rs;  // SW: the row stride of S and V
  float* S = smem + (STAGED ? ks : 0);  // STAGED: tile (i, j) = canvas (y0 - rs + i, x0 - rs + j)
  float* V = (!STAGED && vscratch) ? vscratch + (size_t)blockIdx.x * TH * SW
                                   : S + (STAGED ? (size_t)(TH + 2 * rs) * SW : 0);
  if (STAGED) {
    for (int i = threadIdx.x; i < ks; i += SHARPEN_THREADS) smem[i] = taps[i];
  }
  const float* tp = STAGED ? smem : taps;
  const int n_r = (H + TH - 1) / TH, n_c = (W + TW - 1) / TW;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tx = (int)(t % n_c), ty = (int)((t / n_c) % n_r);
    const long long b = t / ((long long)n_c * n_r);
    const int y0 = ty * TH, x0 = tx * TW;
    const int th = min(TH, H - y0), tw = min(TW, W - x0);
    const int groups = (th + BLUR_ROWS - 1) / BLUR_ROWS;  // BLUR_ROWS rows a thread
    const float* mb = m + (size_t)b * H * W;
    float* ob = out + (size_t)b * H * W;

    if (STAGED) {
      for (int idx = threadIdx.x; idx < (th + 2 * rs) * SW; idx += SHARPEN_THREADS) {
        const int i = idx / SW, j = idx - i * SW;
        S[idx] = mb[(size_t)clampi(y0 - rs + i, 0, H - 1) * W + clampi(x0 - rs + j, 0, W - 1)];
      }
    }
    __syncthreads();

    // vertical pass: V (y, j) = sum_i t_i S (y + i, j); a thread's rows
    // past the tile repeat its last (their sums are dropped)
    for (int q = threadIdx.x; q < groups * SW; q += SHARPEN_THREADS) {
      const int g = q / SW, j = q - g * SW, y = g * BLUR_ROWS;
      const int last = min(BLUR_ROWS, th - y) - 1;
      float acc[BLUR_ROWS];
      if (STAGED) {
        int off[BLUR_ROWS];
#pragma unroll
        for (int u = 0; u < BLUR_ROWS; ++u) off[u] = min(u, last) * SW;
        const float* s = S + y * SW + j;
        for (int i = 0; i < ks; ++i, s += SW) {
          const float tap = tp[i];
#pragma unroll
          for (int u = 0; u < BLUR_ROWS; ++u) {
            const float term = __fmul_rn(tap, s[off[u]]);
            acc[u] = i == 0 ? term : __fadd_rn(acc[u], term);
          }
        }
      } else {
        const float* col = mb + clampi(x0 - rs + j, 0, W - 1);
        for (int i = 0; i < ks; ++i) {
          const float tap = tp[i];
#pragma unroll
          for (int u = 0; u < BLUR_ROWS; ++u) {
            const int row = clampi(y0 + y + u - rs + i, 0, H - 1);
            const float term = __fmul_rn(tap, __ldg(col + (size_t)row * W));
            acc[u] = i == 0 ? term : __fadd_rn(acc[u], term);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BLUR_ROWS; ++u) {
        if (u <= last) V[(y + u) * SW + j] = acc[u];
      }
    }
    __syncthreads();

    // horizontal pass, V (y, xx .. xx + ks - 1), and the unsharp update
    for (int q = threadIdx.x; q < groups * tw; q += SHARPEN_THREADS) {
      const int g = q / tw, xx = q - g * tw, y = g * BLUR_ROWS;
      const int last = min(BLUR_ROWS, th - y) - 1;
      int off[BLUR_ROWS];
#pragma unroll
      for (int u = 0; u < BLUR_ROWS; ++u) off[u] = min(u, last) * SW;
      float acc[BLUR_ROWS];
      const float* v = V + y * SW + xx;
      for (int i = 0; i < ks; ++i, ++v) {
        const float tap = tp[i];
#pragma unroll
        for (int u = 0; u < BLUR_ROWS; ++u) {
          const float term = __fmul_rn(tap, v[off[u]]);
          acc[u] = i == 0 ? term : __fadd_rn(acc[u], term);
        }
      }
#pragma unroll
      for (int u = 0; u < BLUR_ROWS; ++u) {
        if (u <= last) {
          const int gy = y0 + y + u, gx = x0 + xx;
          const float c = STAGED ? S[(y + u + rs) * SW + xx + rs] : __ldg(mb + (size_t)gy * W + gx);
          ob[(size_t)gy * W + gx] = __fadd_rn(c, __fmul_rn(gain, __fsub_rn(c, acc[u])));
        }
      }
    }
    __syncthreads();  // the next tile overwrites S and V
  }
}

template <bool STAGED>
cudaError_t launch_sharpen(const float* m, float* out, const float* taps, float* vs, int B,
                           int H, int W, int ks, float gain, int TH, int TW, int grid,
                           cudaStream_t stream) {
  const size_t bytes = sharpen_floats(ks, TH, TW, STAGED, vs == nullptr) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sharpen_kernel<STAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int g = tiles < grid ? (int)tiles : grid;
  sharpen_kernel<STAGED><<<g, SHARPEN_THREADS, bytes, stream>>>(m, out, taps, vs, H, W, ks, gain,
                                                                 TH, TW, tiles);
  return cudaGetLastError();
}


constexpr int WIN_SEG = 8;  // rows of V a thread's vertical window fills

// cp.async: a copy from global to shared memory that the thread does not
// wait on; the copies a thread committed complete together at the wait.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The layout of a windowed CTA, the wrapper's sharpen_smem_bytes("windowed")
// / 4: the staged tile, srows x ss (staged column j is canvas column x0 -
// rsp + j, row i canvas row y0 - rs + i), then V, TH rows of vs (V column c
// is canvas column x0 - rs + c; the columns from TW + ks - 1 on are read by
// the horizontal pass's last 16-byte loads and never summed).
struct WinLayout {
  int rsp, ss, vs, srows;
  __host__ __device__ WinLayout(int ks, int TH, int TW)
      : rsp((ks / 2 + 3) & ~3),
        ss(TW + 2 * ((ks / 2 + 3) & ~3)),
        vs(TW - 4 + 4 * ((ks + 6) / 4)),
        srows(TH + ks - 1) {}
  __host__ __device__ size_t floats(int TH) const { return (size_t)srows * ss + (size_t)TH * vs; }
};

template <int KS>
__global__ void __launch_bounds__(SHARPEN_THREADS)
windowed_sharpen_kernel(const float* __restrict__ m, float* __restrict__ out,
                        const float* __restrict__ taps, int H, int W, float gain, int TH,
                        int TW, long long tiles) {
  constexpr int rs = KS / 2, RSP = (rs + 3) & ~3, VW = 4 * ((KS + 6) / 4);
  extern __shared__ __align__(16) float smem_win[];  // the staged tile, then V
  const WinLayout L(KS, TH, TW);
  float* S = smem_win;
  float* V = smem_win + L.srows * L.ss;
  float t[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) t[k] = __ldg(taps + k);
  const int n_r = (H + TH - 1) / TH, n_c = (W + TW - 1) / TW;
  const bool vec_in = W % 4 == 0 && ((uintptr_t)m & 15) == 0;
  const bool vec_out = W % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const int cpr = L.ss / 4, chunks = L.srows * cpr;  // 16-byte chunks: a row's, a tile's
  const FastDiv div_cpr(cpr);

  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const long long b = tt / ((long long)n_c * n_r);
    const int y0 = (int)((tt / n_c) % n_r) * TH, x0 = (int)(tt % n_c) * TW;
    const int th = min(TH, H - y0), tw = min(TW, W - x0);
    const float* mb = m + (size_t)b * H * W;

    // stage: chunk (i, q) is staged row i, columns 4q .. 4q + 3
    for (int idx = threadIdx.x; idx < chunks; idx += SHARPEN_THREADS) {
      const int i = div_cpr(idx), q = idx - i * cpr;
      const float* row = mb + (size_t)clampi(y0 - rs + i, 0, H - 1) * W;
      float* dst = S + i * L.ss + 4 * q;
      const int cx = x0 - RSP + 4 * q;
      if (vec_in && cx >= 0 && cx + 4 <= W) {
        cp_async16(dst, row + cx);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, row + clampi(cx + e, 0, W - 1));
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // vertical pass: V (y, c) = sum_k t_k S (y + k, c + RSP - rs); a thread
    // walks WIN_SEG rows of one column, each staged row read once and
    // added to every sum that takes it, in tap order
    const int nvc = TW + KS - 1;
    for (int q = threadIdx.x; q < nvc * (TH / WIN_SEG); q += SHARPEN_THREADS) {
      const int g = q / nvc, c = q - g * nvc;
      const float* s = S + g * WIN_SEG * L.ss + c + (RSP - rs);
      float acc[WIN_SEG];
#pragma unroll
      for (int r = 0; r < KS + WIN_SEG - 1; ++r) {
        const float v = s[r * L.ss];
#pragma unroll
        for (int u = 0; u < WIN_SEG; ++u) {
          const int k = r - u;
          if (k >= 0 && k < KS) {
            const float term = __fmul_rn(t[k], v);
            acc[u] = k == 0 ? term : __fadd_rn(acc[u], term);
          }
        }
      }
      float* vo = V + g * WIN_SEG * L.vs + c;
#pragma unroll
      for (int u = 0; u < WIN_SEG; ++u) vo[u * L.vs] = acc[u];
    }
    __syncthreads();

    // horizontal pass and the unsharp update: outputs (y, xx .. xx + 3) from
    // V (y, xx .. xx + KS + 2), read 16 bytes at a time
    const int groups = TW / 4;
    float* ob = out + (size_t)b * H * W;
    for (int q = threadIdx.x; q < TH * groups; q += SHARPEN_THREADS) {
      const int y = q / groups, xx = 4 * (q - y * groups);
      if (y >= th || xx >= tw) continue;  // off the canvas: nothing to store
      const float4* vrow = reinterpret_cast<const float4*>(V + y * L.vs + xx);
      float acc[4];
#pragma unroll
      for (int j = 0; j < VW / 4; ++j) {
        const float4 v4 = vrow[j];
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = 4 * j + e - u;
            if (k >= 0 && k < KS) {
              const float term = __fmul_rn(t[k], vv[e]);
              acc[u] = k == 0 ? term : __fadd_rn(acc[u], term);
            }
          }
        }
      }
      const float4 c4 = *reinterpret_cast<const float4*>(S + (y + rs) * L.ss + RSP + xx);
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        o[u] = __fadd_rn(c[u], __fmul_rn(gain, __fsub_rn(c[u], acc[u])));
      }
      float* orow = ob + (size_t)(y0 + y) * W + x0 + xx;
      if (vec_out && xx + 4 <= tw) {
        *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (xx + u < tw) orow[u] = o[u];
        }
      }
    }
    __syncthreads();  // the next tile stages into S and overwrites V
  }
}

using WinKernel = void (*)(const float*, float*, const float*, int, int, float, int, int,
                           long long);

WinKernel windowed_kernel(int ks) {
  switch (ks) {
    case 1: return windowed_sharpen_kernel<1>;
    case 3: return windowed_sharpen_kernel<3>;
    case 5: return windowed_sharpen_kernel<5>;
    case 7: return windowed_sharpen_kernel<7>;
    case 9: return windowed_sharpen_kernel<9>;
    case 11: return windowed_sharpen_kernel<11>;
    case 13: return windowed_sharpen_kernel<13>;
    case 15: return windowed_sharpen_kernel<15>;
    case 17: return windowed_sharpen_kernel<17>;
    case 19: return windowed_sharpen_kernel<19>;
    case 21: return windowed_sharpen_kernel<21>;
    case 23: return windowed_sharpen_kernel<23>;
    case 25: return windowed_sharpen_kernel<25>;
    case 27: return windowed_sharpen_kernel<27>;
    case 29: return windowed_sharpen_kernel<29>;
    case 31: return windowed_sharpen_kernel<31>;
    case 33: return windowed_sharpen_kernel<33>;
    default: return nullptr;
  }
}

// One launch of the windowed kernel for ks taps at TH x TW tiles; an error
// where ks has no instantiation, the tile breaks the kernel's layout or
// does not fit a block.
cudaError_t launch_windowed(const float* m, float* out, const float* taps, int B, int H, int W,
                            int ks, float gain, int TH, int TW, int grid, cudaStream_t stream) {
  const WinKernel kernel = windowed_kernel(ks);
  if (kernel == nullptr || TH < WIN_SEG || TH % WIN_SEG || TW < 4 || TW % 4) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = WinLayout(ks, TH, TW).floats(TH) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int g = tiles < grid ? (int)tiles : grid;
  kernel<<<g, SHARPEN_THREADS, bytes, stream>>>(m, out, taps, H, W, gain, TH, TW, tiles);
  return cudaGetLastError();
}

}  // namespace

// normalize -> clip -> k x k median -> unsharp sharpen of a (B, H, W)
// float32 batch; odd k <= 15. `taps` is a host array of ks gaussian taps;
// tiles of tile_h x tile_w outputs are walked by `grid` CTAs.
extern "C" int nm03_fused_preprocess(const float* x, float* out, int B, int H, int W,
                                     int k, float norm_min, float norm_scale,
                                     float norm_low, float clip_low, float clip_high,
                                     float gain, const float* taps, int ks, int tile_h,
                                     int tile_w, int grid, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || ks < 1 || ks > MAX_TAPS || ks % 2 == 0 || tile_h < 1 ||
      tile_w < 1 || grid < 1) {
    return cudaErrorInvalidValue;
  }
  Pre p = {};
  p.norm_min = norm_min;
  p.norm_scale = norm_scale;
  p.norm_low = norm_low;
  p.clip_low = clip_low;
  p.clip_high = clip_high;
  p.gain = gain;
  p.ks = ks;
  for (int t = 0; t < ks; ++t) p.taps[t] = taps[t];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 3: return launch<3>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 5: return launch<5>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 7: return launch<7>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 9: return launch<9>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 11: return launch<11>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 13: return launch<13>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    case 15: return launch<15>(x, out, B, H, W, tile_h, tile_w, grid, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The unsharp sharpen of a (B, H, W) float32 batch: c + gain * (c -
// blur(c)), the blur ks taps (a device array, any odd ks) down the rows,
// then along them, clamp-to-edge. `grid` CTAs walk the tiles of tile_h x
// tile_w outputs. `plan` 2, windowed (odd ks <= 33; tile_h a multiple of
// 8, tile_w of 4): the staged tile and V in shared memory, register
// windows down and 16-byte reads across. `plan` 1, staged: the median
// tile, the taps and V in shared memory. `plan` 0: the median and the taps
// read from their buffers through L1, and V in shared memory, or with
// `vscratch` not null in that device scratch (grid x tile_h x (tile_w + ks
// - 1) floats). `vscratch` is null in the other plans.
extern "C" int nm03_sharpen(const float* m, float* out, const float* taps, void* vscratch,
                            int B, int H, int W, int ks, float gain, int tile_h, int tile_w,
                            int plan, int grid, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  float* vs = static_cast<float*>(vscratch);
  if (B <= 0 || H <= 0 || W <= 0 || ks < 1 || ks % 2 == 0 || tile_h < 1 || tile_w < 1 ||
      grid < 1 || taps == nullptr || plan < 0 || plan > 2 || (plan && vs != nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == 2) {
    return launch_windowed(m, out, taps, B, H, W, ks, gain, tile_h, tile_w, grid, s);
  }
  return plan ? launch_sharpen<true>(m, out, taps, vs, B, H, W, ks, gain, tile_h, tile_w, grid,
                                     s)
              : launch_sharpen<false>(m, out, taps, vs, B, H, W, ks, gain, tile_h, tile_w,
                                      grid, s);
}
