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
