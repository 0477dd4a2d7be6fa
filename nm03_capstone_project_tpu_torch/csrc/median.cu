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
