// Hopper kernel for the k x k clamp-to-edge median.
//
// Replaces the JAX package's Pallas kernel _median_band_kernel
// (ops/pallas_median.py:101, called at :146) with nm03_median_filter. The
// fused preprocess stage (_fused_band_kernel) has its own kernel, in
// fused.cu.
//
// Design. One CTA per (slice, 32-row band, 32-column band), 256 threads.
// The CTA stages its input tile plus halo in shared memory with the row and
// column indices clamped to the canvas (so no padded copy of the image is
// made), presorts each column of K vertical neighbours once (shared by the
// K windows that read it), then runs median_merge_plan(K, share=False) from
// the generated median_plans.cuh per pixel: 346 min/max at K=7 in
// registers.
//
// Exactness. Any exact rank selection gives the reference's bits: min/max
// return one of their inputs, and the data is finite.
//
// Bound on the H100. Per pixel the median is ~300 min/max (presort plus
// plan) against 8 bytes of traffic: the kernel is bound by operations, not
// by memory.
//
// Windows past 15 (nm03_median_select, the wrapper's "select" route). The
// generated plans stop at 15: from k = 17 a plan's live set passes what a
// thread's registers hold. There one CTA per (slice, 8-row band, 32-column
// band), 256 threads, one output a thread: the CTA stages its tile and the
// 2r halo in shared memory as order-preserving uint32 keys (a float's
// bits with the sign flipped, or all bits flipped for a negative, so that
// key order is float order with -0.0 below +0.0), and each thread selects
// rank k*k/2 of its window exactly by bisection on the key: for each bit,
// from the highest one where the window's least and greatest keys differ,
// count the samples below the candidate and keep the bit while that count
// is at most the rank. Ranks are exact, so the value is one of the
// window's samples, bit for bit. A window holding a NaN gives the first
// NaN of the window in row-major order: the plain network's
// torch.minimum/torch.maximum return a NaN operand whenever there is one
// and every sample reaches the median, so its answer is a NaN of the
// window as well (the same bits wherever the window's NaNs share them).
// Where -0.0 and +0.0 meet at the median rank, the key order returns the
// sign that rank holds when -0.0 sorts first.
//
// Bound: per output and bisection step, k*k shared-memory reads and
// compares (at most 32 steps, none for a window of one value): bound by
// the rate of those operations, not by memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "median_plans.cuh"

namespace {

constexpr int TH = 32;        // output rows per CTA
constexpr int TW = 32;        // output columns per CTA
constexpr int NTHREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Odd-even transposition sort: K rounds of neighbour compare-exchanges.
template <int K>
__device__ __forceinline__ void sort_column(float (&v)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
#pragma unroll
    for (int i = p & 1; i + 1 < K; i += 2) {
      const float a = v[i], b = v[i + 1];
      v[i] = fminf(a, b);
      v[i + 1] = fmaxf(a, b);
    }
  }
}

__host__ __device__ inline size_t smem_floats(int K) {
  const int R = K / 2;
  const size_t IH = TH + 2 * R, IW = TW + 2 * R;
  return IH * IW + K * TH * IW;
}

// Shared memory: the input tile `in` (IH x IW) and the K presorted planes
// `S` (each TH x IW). Tile coordinate (i, j) is canvas (y0 + i, x0 + j).
template <int K>
__global__ void __launch_bounds__(NTHREADS)
band_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W) {
  constexpr int R = K / 2;
  constexpr int IH = TH + 2 * R, IW = TW + 2 * R;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  extern __shared__ float smem[];
  float* in = smem;
  float* S = in + IH * IW;
  const float* xb = x + (size_t)b * H * W;
  float* ob = out + (size_t)b * H * W;

  // 1. stage the tile with clamped indices
  for (int idx = threadIdx.x; idx < IH * IW; idx += NTHREADS) {
    const int i = idx / IW, j = idx - i * IW;
    const int gy = clampi(y0 - R + i, 0, H - 1);
    const int gx = clampi(x0 - R + j, 0, W - 1);
    in[idx] = xb[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. presort: S[a][i][j] = a-th smallest of in[i .. i+K-1][j]
  for (int idx = threadIdx.x; idx < TH * IW; idx += NTHREADS) {
    const int i = idx / IW, j = idx - i * IW;
    float v[K];
#pragma unroll
    for (int a = 0; a < K; ++a) v[a] = in[(i + a) * IW + j];
    sort_column<K>(v);
#pragma unroll
    for (int a = 0; a < K; ++a) S[a * TH * IW + idx] = v[a];
  }
  __syncthreads();

  // 3. the median at every tile position inside the canvas
  for (int idx = threadIdx.x; idx < TH * TW; idx += NTHREADS) {
    const int i = idx / TW, j = idx - i * TW;
    const int gy = y0 + i, gx = x0 + j;
    if (gy >= H || gx >= W) continue;
    ob[(size_t)gy * W + gx] = median_plan<K>(S + i * IW + j + R, TH * IW);
  }
}

template <int K>
cudaError_t launch(const float* x, float* out, int B, int H, int W, cudaStream_t stream) {
  const size_t bytes = smem_floats(K) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(band_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  band_kernel<K><<<grid, NTHREADS, bytes, stream>>>(x, out, H, W);
  return cudaGetLastError();
}

// -- windows past 15: exact selection by bisection on order-preserving keys --

constexpr int STH = 8;   // output rows per CTA
constexpr int STW = 32;  // output columns per CTA: a warp a row
constexpr int SNT = STH * STW;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a NaN's key lies above +inf's (0xff800000) or below -inf's (0x007fffff)
__device__ __forceinline__ bool key_is_nan(uint32_t k) {
  return k > 0xff800000u || k < 0x007fffffu;
}

__host__ __device__ inline size_t select_smem_bytes(int K) {
  return (size_t)(STH + K - 1) * (STW + K - 1) * sizeof(uint32_t);
}

__global__ void __launch_bounds__(SNT)
select_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int K,
              int b0) {
  const int R = K / 2, IH = STH + 2 * R, IW = STW + 2 * R;
  const int b = b0 + blockIdx.z, y0 = blockIdx.y * STH, x0 = blockIdx.x * STW;
  extern __shared__ uint32_t keys[];
  const float* xb = x + (size_t)b * H * W;

  for (int idx = threadIdx.x; idx < IH * IW; idx += SNT) {
    const int i = idx / IW, j = idx - i * IW;
    const int gy = clampi(y0 - R + i, 0, H - 1);
    const int gx = clampi(x0 - R + j, 0, W - 1);
    keys[idx] = order_key(xb[(size_t)gy * W + gx]);
  }
  __syncthreads();

  const int i = threadIdx.x / STW, j = threadIdx.x - i * STW;
  const int gy = y0 + i, gx = x0 + j;
  if (gy >= H || gx >= W) return;
  const uint32_t* win = keys + i * IW + j;
  const int rank = (K * K) / 2;

  // the window's extreme keys, and its first NaN
  uint32_t lo = 0xffffffffu, hi = 0u, nan_key = 0u;
  bool has_nan = false;
  for (int dy = 0; dy < K; ++dy) {
    const uint32_t* row = win + dy * IW;
    for (int dx = 0; dx < K; ++dx) {
      const uint32_t k = row[dx];
      lo = min(lo, k);
      hi = max(hi, k);
      if (!has_nan && key_is_nan(k)) {
        has_nan = true;
        nan_key = k;
      }
    }
  }
  float* o = out + (size_t)b * H * W + (size_t)gy * W + gx;
  if (has_nan) {
    *o = key_value(nan_key);
    return;
  }
  // the bits above the highest one where lo and hi differ are the median's
  const uint32_t diff = lo ^ hi;
  uint32_t prefix = lo;
  if (diff != 0u) {
    const int top = 31 - __clz(diff);
    prefix = lo & ~((2u << top) - 1u);  // (2 << 31) wraps to 0: all bits cleared
    for (int bit = top; bit >= 0; --bit) {
      const uint32_t cand = prefix | (1u << bit);
      int below = 0;
      for (int dy = 0; dy < K; ++dy) {
        const uint32_t* row = win + dy * IW;
#pragma unroll 4
        for (int dx = 0; dx < K; ++dx) below += row[dx] < cand;
      }
      if (below <= rank) prefix = cand;
    }
  }
  *o = key_value(prefix);
}

}  // namespace

// k x k median of a (B, H, W) float32 batch, clamp-to-edge; odd k <= 15.
extern "C" int nm03_median_filter(const float* x, float* out, int B, int H, int W,
                                  int k, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(x, out, B, H, W, s);
    case 3: return launch<3>(x, out, B, H, W, s);
    case 5: return launch<5>(x, out, B, H, W, s);
    case 7: return launch<7>(x, out, B, H, W, s);
    case 9: return launch<9>(x, out, B, H, W, s);
    case 11: return launch<11>(x, out, B, H, W, s);
    case 13: return launch<13>(x, out, B, H, W, s);
    case 15: return launch<15>(x, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// k x k median of slices [b0, b0 + nb) of a (., H, W) float32 batch,
// clamp-to-edge, by exact selection; odd k in [1, max_k]. nb <= 65535 (the
// grid's z dimension: the wrapper splits a larger batch).
extern "C" int nm03_median_select(const float* x, float* out, int b0, int nb, int H, int W,
                                  int k, int max_k, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (b0 < 0 || nb <= 0 || nb > 65535 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0 ||
      k > max_k) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = select_smem_bytes(k);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + STW - 1) / STW, (H + STH - 1) / STH, nb);
  select_kernel<<<grid, SNT, bytes, static_cast<cudaStream_t>(stream)>>>(x, out, H, W, k, b0);
  return cudaGetLastError();
}
