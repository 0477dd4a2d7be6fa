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
// band), 256 threads, one output a thread, selects rank k*k/2 of each
// window exactly on order-preserving uint32 keys (a float's bits with the
// sign flipped, or all bits flipped for a negative, so that key order is
// float order with -0.0 below +0.0). Ranks are exact, so the value is one
// of the window's samples, bit for bit. A window holding a NaN gives the
// first NaN of the window in row-major order: the plain network's
// torch.minimum/torch.maximum return a NaN operand whenever there is one
// and every sample reaches the median, so its answer is a NaN of the
// window as well (the same bits wherever the window's NaNs share them).
// Where -0.0 and +0.0 meet at the median rank, the key order returns the
// sign that rank holds when -0.0 sorts first.
//
// What bounds it on the H100: the counts of samples below a candidate. A
// count over all k*k keys costs a shared load a compare, and the
// shared-memory pipe issues one warp-wide load a clock an SM, a quarter of
// the integer rate; a warp runs as many passes as its slowest lane, and a
// bisection on the key's bits needs 25-30 where a noisy edge meets a flat
// background. This design:
// * shares work between neighbouring outputs: the CTA sorts each column
//   segment of k keys once (by rank: a key's place is the count of the
//   segment's keys that order before it, kept from one segment down to the
//   next by dropping a row and adding a row), into planes whose stride is a
//   multiple of 32 words, so any mix of ranks across a warp is one
//   conflict-free load. A segment serves the k outputs of a row that read
//   it, and all of their passes;
// * counts below a candidate by a binary search in each of the k sorted
//   segments: ceil(log2(k + 1)) loads a segment (5 at k = 17 and 31, 6 at
//   63) instead of k, four segments at once for the load latency, the
//   segments padded to 2^m - 1 keys so no probe checks a bound;
// * bisects between keys of the window, not bits: after each count the
//   lower end moves up to the least key at or above the candidate, or the
//   upper end down past the greatest key below it (one more load each a
//   segment), so empty stretches of key space and runs of equal keys cost
//   no passes: about log2(k*k) passes on noisy data, one or two on flat.
// The extreme keys are the planes' first and last; a window's NaN shows in
// them. Shared memory: (2P + 1) planes of the 8 x (32 + k - 1) segments (P
// the largest power of 2 <= k) and the staged tile, 55 KB at k = 17 and
// 226,000 bytes at k = 63, the largest window.
//
// Windows past 63 (nm03_median_wide, the wrapper's "wide" route): the
// planes no longer fit a block, so each output bisects over its window's
// keys alone, with the select kernel's keys and rule (the extreme keys,
// the first NaN row-major, then candidates between keys of the window that
// snap to the least key at or above the candidate or past the greatest
// below it). One CTA per (slice, 8-row band, 32-column band), 256 threads,
// one output a thread. Where the CTA's (8 + k - 1) x (32 + k - 1) keys fit
// its shared memory (k <= 221: 229,824 bytes) it stages them once, clamped
// to the canvas, and every pass reads them there, a warp's 32 lanes 32
// neighbouring words; past that each pass reads the window from global
// memory through L1 and L2 (clamped indices, the key made on the fly).
// Bound on the H100: a pass reads k*k keys an output, one load, a compare
// and two selects a key; about log2(k*k) passes on noisy data and one or
// two on flat, so operations, not bytes, bound it. Counts are 64-bit, so
// any odd k the int arguments hold works.

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

// -- windows past 15: exact selection over sorted column segments ------------

constexpr int STH = 8;   // output rows per CTA
constexpr int STW = 32;  // output columns per CTA: a warp a row
constexpr int SNT = STH * STW;
constexpr uint32_t KEY_PAD_HI = 0xffffffffu;  // above every key the bisection compares
constexpr uint32_t KEY_PAD_LO = 0u;           // below every key that is not a NaN

__host__ __device__ inline int select_log2p(int K) {  // P = 2^LOGP, the largest power of 2 <= K
  int l = 0;
  while ((2 << l) <= K) ++l;
  return l;
}

// The select kernel's shared memory, in words: 2P + 1 planes (index -1 .. 2P
// - 1) of PL words, then the staged tile of keys, IH x IW.
struct SelectLayout {
  int R, IH, IW, PL, planes;
  __host__ __device__ explicit SelectLayout(int K) {
    R = K / 2;
    IH = STH + K - 1;
    IW = STW + K - 1;
    PL = (STH * IW + 31) / 32 * 32;  // a multiple of 32: plane a's word (y, x) in bank y IW + x
    planes = (2 << select_log2p(K)) + 1;
  }
  __host__ __device__ size_t words() const { return (size_t)planes * PL + (size_t)IH * IW; }
};

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
  return SelectLayout(K).words() * sizeof(uint32_t);
}

// Shared memory: plane a (a = -1 .. 2P - 1) at seg + (a + 1) PL holds, at
// y IW + x, the a-th smallest key of column segment (y, x): tile column x,
// tile rows y .. y + K - 1, the K keys output row y reads there. Planes K
// .. 2P - 1 hold KEY_PAD_HI and plane -1 KEY_PAD_LO, so a count below a
// candidate probes P, P/2, ..., 1 places without a bound check. Then the
// staged tile: tile (i, j) is canvas (y0 - R + i, x0 - R + j), clamped.
template <int LOGP>
__global__ void __launch_bounds__(SNT)
select_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int K, int b0) {
  constexpr int LV = LOGP + 1;  // probes a count: ceil(log2(K + 1))
  const SelectLayout L(K);
  const int R = L.R, IH = L.IH, IW = L.IW, PL = L.PL;
  const int b = b0 + blockIdx.z, y0 = blockIdx.y * STH, x0 = blockIdx.x * STW;
  extern __shared__ uint32_t seg[];
  uint32_t* keys = seg + (size_t)L.planes * PL;
  const float* xb = x + (size_t)b * H * W;

  for (int idx = threadIdx.x; idx < IH * IW; idx += SNT) {
    const int i = idx / IW, j = idx - i * IW;
    const int gy = clampi(y0 - R + i, 0, H - 1);
    const int gx = clampi(x0 - R + j, 0, W - 1);
    keys[idx] = order_key(xb[(size_t)gy * W + gx]);
  }
  __syncthreads();

  // 1. sort the column segments, by rank: key (i, x) goes to place pos of
  // every segment y that holds it (y <= i < y + K), pos = the keys of the
  // segment that order before it (smaller, or equal and above it). From
  // one segment to the next the count drops row y and gains row y + K.
  for (int idx = threadIdx.x; idx < IH * IW; idx += SNT) {
    const int i = idx / IW, xx = idx - i * IW;
    const uint32_t v = keys[idx];
    const int ylo = max(0, i - K + 1), yhi = min(STH - 1, i);
    if (ylo > yhi) continue;
    int pos = 0;
    for (int jj = ylo; jj < ylo + K; ++jj) {
      const uint32_t u = keys[jj * IW + xx];
      pos += u < v || (u == v && jj < i);
    }
    for (int y = ylo;; ++y) {
      seg[(size_t)(pos + 1) * PL + y * IW + xx] = v;
      if (y == yhi) break;
      const uint32_t out_k = keys[y * IW + xx], in_k = keys[(y + K) * IW + xx];
      pos -= out_k < v || (out_k == v && y < i);
      pos += in_k < v || (in_k == v && y + K < i);
    }
  }
  for (int idx = threadIdx.x; idx < STH * IW; idx += SNT) {
    seg[idx] = KEY_PAD_LO;
    for (int a = K; a < L.planes - 1; ++a) seg[(size_t)(a + 1) * PL + idx] = KEY_PAD_HI;
  }
  __syncthreads();

  // 2. rank K*K/2 of each window: its K segments (i, j .. j + K - 1)
  const int i = threadIdx.x / STW, j = threadIdx.x - i * STW;
  const int gy = y0 + i, gx = x0 + j;
  if (gy >= H || gx >= W) return;
  const int base = PL + i * IW + j;  // plane 0 of the window's first segment
  uint32_t lo = 0xffffffffu, hi = 0u;
  for (int c = 0; c < K; ++c) {
    lo = min(lo, seg[base + c]);
    hi = max(hi, seg[base + (K - 1) * PL + c]);
  }
  float* o = out + (size_t)b * H * W + (size_t)gy * W + gx;
  if (key_is_nan(lo) || key_is_nan(hi)) {  // the window's first NaN, row-major
    for (int dy = 0; dy < K; ++dy) {
      for (int dx = 0; dx < K; ++dx) {
        const uint32_t k = keys[(i + dy) * IW + j + dx];
        if (key_is_nan(k)) {
          *o = key_value(k);
          return;
        }
      }
    }
  }
  // Bisection on the key between keys of the window, l <= median < u: a
  // candidate's count below it in each segment by binary search (LV probes,
  // four segments at once), then l moves up to the least key at or above
  // the candidate, or u down past the greatest key below it, so a run of
  // equal keys or an empty stretch of keys ends the search at once.
  const int rank_pl = (K * K) / 2 * PL;  // counts are kept in units of PL
  uint32_t l = lo, u = hi + 1u;
  while (u - l > 1u) {
    const uint32_t cand = l + ((u - l) >> 1);
    int below = 0;
    uint32_t succ = KEY_PAD_HI, pred = KEY_PAD_LO;
    for (int c0 = 0; c0 < K; c0 += 4) {
      int p[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) p[t] = base + min(c0 + t, K - 1);
#pragma unroll
      for (int lv = LOGP; lv >= 0; --lv) {
        const int step = PL << lv;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (seg[p[t] + step - PL] < cand) p[t] += step;
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (c0 + t < K) {
          below += p[t] - (base + c0 + t);
          succ = min(succ, seg[p[t]]);
          pred = max(pred, seg[p[t] - PL]);
        }
      }
    }
    if (below <= rank_pl) {
      l = succ;
    } else {
      u = pred + 1u;
    }
  }
  *o = key_value(l);
}

template <int LOGP>
cudaError_t launch_select(const float* x, float* out, int b0, int nb, int H, int W, int K,
                          cudaStream_t stream) {
  const size_t bytes = select_smem_bytes(K);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(select_kernel<LOGP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + STW - 1) / STW, (H + STH - 1) / STH, nb);
  select_kernel<LOGP><<<grid, SNT, bytes, stream>>>(x, out, H, W, K, b0);
  return cudaGetLastError();
}

// -- windows past 63: a bisection over each window's keys --------------------

__host__ __device__ inline size_t wide_smem_bytes(int K) {  // the staged tile of keys
  return (size_t)(STH + K - 1) * (STW + K - 1) * sizeof(uint32_t);
}

// f(key) for each key of output (gy, gx)'s window, row-major: from the
// staged tile (tile (i, j) is canvas (y0 - R + i, x0 - R + j), clamped), or
// from the image with clamped indices.
template <bool STAGED, typename F>
__device__ __forceinline__ void for_window(const uint32_t* keys, const float* __restrict__ xb,
                                           int H, int W, int K, int i, int j, int gy, int gx,
                                           F f) {
  const int R = K / 2, IW = STW + K - 1;
  for (int dy = 0; dy < K; ++dy) {
    if (STAGED) {
      const uint32_t* row = keys + (size_t)(i + dy) * IW + j;
      for (int dx = 0; dx < K; ++dx) f(row[dx]);
    } else {
      const float* row = xb + (size_t)clampi(gy - R + dy, 0, H - 1) * W;
      for (int dx = 0; dx < K; ++dx) f(order_key(__ldg(row + clampi(gx - R + dx, 0, W - 1))));
    }
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(SNT)
wide_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int K, int b0) {
  const int R = K / 2, IH = STH + K - 1, IW = STW + K - 1;
  const int b = b0 + blockIdx.z, y0 = blockIdx.y * STH, x0 = blockIdx.x * STW;
  extern __shared__ uint32_t keys[];
  const float* xb = x + (size_t)b * H * W;
  if (STAGED) {
    for (int idx = threadIdx.x; idx < IH * IW; idx += SNT) {
      const int i = idx / IW, j = idx - i * IW;
      const int gy = clampi(y0 - R + i, 0, H - 1);
      const int gx = clampi(x0 - R + j, 0, W - 1);
      keys[idx] = order_key(xb[(size_t)gy * W + gx]);
    }
    __syncthreads();
  }
  const int i = threadIdx.x / STW, j = threadIdx.x - i * STW;
  const int gy = y0 + i, gx = x0 + j;
  if (gy >= H || gx >= W) return;
  uint32_t lo = 0xffffffffu, hi = 0u;
  for_window<STAGED>(keys, xb, H, W, K, i, j, gy, gx, [&](uint32_t k) {
    lo = min(lo, k);
    hi = max(hi, k);
  });
  float* o = out + (size_t)b * H * W + (size_t)gy * W + gx;
  if (key_is_nan(lo) || key_is_nan(hi)) {  // the window's first NaN, row-major
    uint32_t first = 0u;
    bool seen = false;
    for_window<STAGED>(keys, xb, H, W, K, i, j, gy, gx, [&](uint32_t k) {
      if (!seen && key_is_nan(k)) {
        first = k;
        seen = true;
      }
    });
    *o = key_value(first);
    return;
  }
  // the select kernel's bisection, l <= median < u, counting over the
  // whole window: l moves up to the least key at or above the candidate,
  // or u down past the greatest key below it
  const long long rank = (long long)K * K / 2;
  uint32_t l = lo, u = hi + 1u;
  while (u - l > 1u) {
    const uint32_t cand = l + ((u - l) >> 1);
    long long below = 0;
    uint32_t succ = KEY_PAD_HI, pred = KEY_PAD_LO;
    for_window<STAGED>(keys, xb, H, W, K, i, j, gy, gx, [&](uint32_t k) {
      const bool lt = k < cand;
      below += lt;
      pred = lt ? max(pred, k) : pred;
      succ = lt ? succ : min(succ, k);
    });
    if (below <= rank) {
      l = succ;
    } else {
      u = pred + 1u;
    }
  }
  *o = key_value(l);
}

template <bool STAGED>
cudaError_t launch_wide(const float* x, float* out, int b0, int nb, int H, int W, int K,
                        cudaStream_t stream) {
  size_t bytes = 0;
  if (STAGED) {
    bytes = wide_smem_bytes(K);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(wide_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return err;
    }
  }
  const dim3 grid((W + STW - 1) / STW, (H + STH - 1) / STH, nb);
  wide_kernel<STAGED><<<grid, SNT, bytes, stream>>>(x, out, H, W, K, b0);
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

// k x k median of slices [b0, b0 + nb) of a (., H, W) float32 batch,
// clamp-to-edge, by exact selection; odd k in [1, max_k]. nb <= 65535 (the
// grid's z dimension: the wrapper splits a larger batch).
extern "C" int nm03_median_select(const float* x, float* out, int b0, int nb, int H, int W,
                                  int k, int max_k, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (b0 < 0 || nb <= 0 || nb > 65535 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0 ||
      k > max_k || k > 63) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (select_log2p(k)) {
    case 0: return launch_select<0>(x, out, b0, nb, H, W, k, s);
    case 1: return launch_select<1>(x, out, b0, nb, H, W, k, s);
    case 2: return launch_select<2>(x, out, b0, nb, H, W, k, s);
    case 3: return launch_select<3>(x, out, b0, nb, H, W, k, s);
    case 4: return launch_select<4>(x, out, b0, nb, H, W, k, s);
    default: return launch_select<5>(x, out, b0, nb, H, W, k, s);
  }
}

// k x k median of slices [b0, b0 + nb) of a (., H, W) float32 batch,
// clamp-to-edge, by a bisection over each window's keys; any odd k. With
// `staged` the CTA's keys sit in shared memory (the caller checks that they
// fit: wide_smem_bytes; cudaErrorInvalidConfiguration if they do not), else
// each pass reads the image. nb <= 65535, as for nm03_median_select.
extern "C" int nm03_median_wide(const float* x, float* out, int b0, int nb, int H, int W,
                                int k, int staged, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (b0 < 0 || nb <= 0 || nb > 65535 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return staged ? launch_wide<true>(x, out, b0, nb, H, W, k, s)
                : launch_wide<false>(x, out, b0, nb, H, W, k, s);
}
