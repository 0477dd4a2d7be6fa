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
// select's planes of a 2D tile no longer fit a block, so the sort is shared
// down the rows instead. A CTA owns a strip of 32 output columns and walks
// a band of output rows (the wrapper picks the band so that the tiles fill
// the card where the canvas allows). It keeps the 32 + k - 1 column
// segments of its current row, k keys each, sorted: at the top of the band
// it loads and sorts them once (a bitonic network), and moving down a row
// each segment drops its top key and takes the new bottom one (two counts
// find their places, the keys between shift by one), O(k) a column
// instead of a sort. Each output then runs the select kernel's bisection
// with the same keys and rule (the extreme keys, the window's first NaN
// row-major, candidates that snap to the least key at or above them or
// past the greatest below), a count below a candidate by a binary search
// in each of its k segments; an output's segments are split over 8 lanes
// and reduced by shuffles, so a warp holds 4 outputs and its 32 lanes read
// 32 neighbouring columns at any ranks, one conflict-free load. The
// segments take k x (32 + k - 1, rounded up to 32) words: in shared memory
// up to k = 225 (230,400 bytes), past that in a device scratch the wrapper
// allocates, read through L1 and L2. Bound on the H100: operations (about
// k (2 ceil(log2(k + 1)) + 3) a pass an output, plus the band's sort and
// the rows' upkeep shared by the strip), not bytes. Counts are 64-bit.
//
// The prologue (the *_pre entry points: the first launch of the fused
// stage's split route, ops/hopper_median.py). Each kernel can normalize and
// clip every value where it reads the input: (x - norm_min) * scale +
// norm_low, each step rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn:
// no FMA, as the plain ops and fused.cu round), then torch.clamp's rule, a
// NaN kept. So the median is that of clip_intensity(normalize(x)), bit for
// bit, with no pass of its own over the image. It runs on every value
// read, not once on the selected one: the order statistic would commute
// with these non-decreasing maps, but a NaN's bits and the first NaN of a
// window are decided on the mapped values. Off (the standalone entry
// points), a kernel reads the input as it is.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "median_plans.cuh"

namespace {

constexpr int TH = 32;        // output rows per CTA
constexpr int TW = 32;        // output columns per CTA
constexpr int NTHREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Prologue {
  int on;
  float norm_min, scale, norm_low, clip_low, clip_high;
  __device__ __forceinline__ float operator()(float v) const {
    if (!on) return v;
    const float n = __fadd_rn(__fmul_rn(__fsub_rn(v, norm_min), scale), norm_low);
    return n != n ? n : fminf(fmaxf(n, clip_low), clip_high);
  }
};

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
band_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, Prologue pro) {
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
    in[idx] = pro(xb[(size_t)gy * W + gx]);
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
cudaError_t launch(const float* x, float* out, int B, int H, int W, const Prologue& pro,
                   cudaStream_t stream) {
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
  band_kernel<K><<<grid, NTHREADS, bytes, stream>>>(x, out, H, W, pro);
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
select_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int K, int b0,
              Prologue pro) {
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
    keys[idx] = order_key(pro(xb[(size_t)gy * W + gx]));
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
                          const Prologue& pro, cudaStream_t stream) {
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
  select_kernel<LOGP><<<grid, SNT, bytes, stream>>>(x, out, H, W, K, b0, pro);
  return cudaGetLastError();
}

// -- windows past 63: sorted column segments kept down a strip --------------

constexpr int WTW = 32;     // output columns of a tile: one strip
constexpr int WNT = 256;    // threads of a CTA
constexpr int WSPLIT = 8;   // threads of an output: segments t, t + 8, t + 16, ...
constexpr unsigned WFULL = 0xffffffffu;

// A wide CTA's segments: plane a (a = 0 .. K - 1) at seg + a PL holds, at
// column cx, the a-th smallest key of column segment cx (canvas column x0 -
// R + cx, clamped; the K rows of the current output row's windows). PL is a
// multiple of 32 words: any mix of ranks over 32 neighbouring columns is
// one conflict-free load.
struct WideLayout {
  int R, IW, PL;
  __host__ __device__ explicit WideLayout(int K) {
    R = K / 2;
    IW = WTW + K - 1;
    PL = (IW + 31) / 32 * 32;
  }
};

__host__ __device__ inline size_t wide_segment_words(int K) {
  return (size_t)K * WideLayout(K).PL;
}

// The keys of sorted segment `col` (K keys, stride PL) below v. The first
// probe, at P - 1 (P the largest power of 2 <= K), leaves P places to
// search, so no later probe checks a bound.
__device__ __forceinline__ int count_below(const uint32_t* col, int PL, int K, int P,
                                           uint32_t v) {
  int pos = col[(P - 1) * PL] < v ? K - P + 1 : 0;
  for (int step = P >> 1; step > 0; step >>= 1) {
    if (col[(pos + step - 1) * PL] < v) pos += step;
  }
  return pos;
}

template <typename T, typename F>
__device__ __forceinline__ T group_reduce(T v, F f) {  // over an output's 8 lanes
#pragma unroll
  for (int d = 1; d < WSPLIT; d <<= 1) v = f(v, __shfl_xor_sync(WFULL, v, d));
  return v;
}

// One CTA walks tiles (slice, band of `rows` output rows, strip of 32
// columns), blockIdx.x, + gridDim.x, ... For each it loads the segments of
// the band's first row and sorts them (a bitonic network, ascending
// compare-exchanges; partners past K hold +inf and are skipped), then for
// each row of the band: the segments move down a row (each drops its top
// key and takes the new bottom one: two counts find their places, the keys
// between shift by one), then each output's rank K*K/2 by the select
// kernel's bisection, an output's K segments split over 8 lanes (warp w
// holds outputs w, w + 8, w + 16, w + 24, so its 32 lanes read 32
// neighbouring columns) and reduced by shuffles. SHARED: the segments in
// shared memory, else in `scratch`, K PL words a CTA, through L1 and L2.
template <bool SHARED>
__global__ void __launch_bounds__(WNT)
wide_kernel(const float* __restrict__ x, float* __restrict__ out, uint32_t* scratch, int H,
            int W, int K, int b0, int rows, int bands, int strips, long long tiles,
            Prologue pro) {
  const WideLayout L(K);
  const int R = L.R, IW = L.IW, PL = L.PL;
  extern __shared__ uint32_t wseg[];
  uint32_t* seg = SHARED ? wseg : scratch + (size_t)blockIdx.x * K * PL;
  int P = 1, N = 1;
  while ((P << 1) <= K) P <<= 1;
  while (N < K) N <<= 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & (WSPLIT - 1);
  const int j = warp + (WNT / 32) * (lane / WSPLIT);  // the output's column in the strip
  const int nseg = (K - t + WSPLIT - 1) / WSPLIT;
  const long long rank = (long long)K * K / 2;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int strip = (int)(tile % strips);
    const long long rest = tile / strips;
    const int y0 = (int)(rest % bands) * rows, y1 = min(H, y0 + rows);
    const int b = b0 + (int)(rest / bands), x0 = strip * WTW;
    const float* xb = x + (size_t)b * H * W;
    float* ob = out + (size_t)b * H * W;

    // 1. row y0's segments, then a bitonic sort of each
    for (int a = warp; a < K; a += WNT / 32) {
      const float* row = xb + (size_t)clampi(y0 - R + a, 0, H - 1) * W;
      for (int cx = lane; cx < IW; cx += 32) {
        seg[a * PL + cx] = order_key(pro(__ldg(row + clampi(x0 - R + cx, 0, W - 1))));
      }
    }
    __syncthreads();
    for (int size = 2; size <= N; size <<= 1) {
      for (int d = size >> 1; d > 0; d >>= 1) {
        for (int p = warp; p < N / 2; p += WNT / 32) {
          const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
          const int i2 = d == (size >> 1) ? (i ^ (size - 1)) : (i | d);
          if (i2 >= K) continue;
          for (int cx = lane; cx < IW; cx += 32) {
            const uint32_t a = seg[i * PL + cx], c = seg[i2 * PL + cx];
            if (c < a) {
              seg[i * PL + cx] = c;
              seg[i2 * PL + cx] = a;
            }
          }
        }
        __syncthreads();
      }
    }

    for (int y = y0; y < y1; ++y) {
      // 2. down one row: drop canvas row yo, take row yn (a column a thread)
      if (y > y0) {
        const int yo = clampi(y - 1 - R, 0, H - 1), yn = clampi(y + R, 0, H - 1);
        for (int cx = tid; cx < IW && yo != yn; cx += WNT) {
          const int gx = clampi(x0 - R + cx, 0, W - 1);
          const uint32_t ko = order_key(pro(__ldg(xb + (size_t)yo * W + gx)));
          const uint32_t kn = order_key(pro(__ldg(xb + (size_t)yn * W + gx)));
          if (ko == kn) continue;
          uint32_t* col = seg + cx;
          const int p = count_below(col, PL, K, P, ko);             // ko's place
          const int q = count_below(col, PL, K, P, kn) - (ko < kn);  // kn's, ko gone
          for (int i = p; i < q; ++i) col[i * PL] = col[(i + 1) * PL];
          for (int i = p; i > q; --i) col[i * PL] = col[(i - 1) * PL];
          col[q * PL] = kn;
        }
        __syncthreads();
      }

      // 3. rank K*K/2 of each output's window: its segments j .. j + K - 1
      const uint32_t* base = seg + j + t;  // plane 0 of this lane's first segment
      uint32_t lo = 0xffffffffu, hi = 0u;
      for (int m = 0; m < nseg; ++m) {
        lo = min(lo, base[WSPLIT * m]);
        hi = max(hi, base[(K - 1) * PL + WSPLIT * m]);
      }
      lo = group_reduce(lo, [](uint32_t a, uint32_t c) { return min(a, c); });
      hi = group_reduce(hi, [](uint32_t a, uint32_t c) { return max(a, c); });
      const int gx = x0 + j;
      const bool nan = key_is_nan(lo) || key_is_nan(hi);
      long long first = LLONG_MAX;  // the window's first NaN, row-major: dy K + dx
      if (nan) {
        for (int dy = t; dy < K && first == LLONG_MAX; dy += WSPLIT) {
          const float* row = xb + (size_t)clampi(y - R + dy, 0, H - 1) * W;
          for (int dx = 0; dx < K; ++dx) {
            if (key_is_nan(order_key(pro(__ldg(row + clampi(gx - R + dx, 0, W - 1)))))) {
              first = (long long)dy * K + dx;
              break;
            }
          }
        }
      }
      first = group_reduce(first, [](long long a, long long c) { return min(a, c); });
      // the select kernel's bisection, l <= median < u: l moves up to the
      // least key at or above the candidate, or u down past the greatest
      // key below it
      uint32_t l = lo, u = hi + 1u;
      bool run = !nan && u - l > 1u;
      while (__any_sync(WFULL, run)) {
        const uint32_t cand = l + ((u - l) >> 1);
        int below = 0;
        uint32_t succ = KEY_PAD_HI, pred = KEY_PAD_LO;
        for (int m0 = 0; m0 < nseg; m0 += 4) {
          int off[4], pos[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            off[v] = WSPLIT * min(m0 + v, nseg - 1);
            pos[v] = base[(P - 1) * PL + off[v]] < cand ? K - P + 1 : 0;
          }
          for (int step = P >> 1; step > 0; step >>= 1) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if (base[(pos[v] + step - 1) * PL + off[v]] < cand) pos[v] += step;
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (m0 + v < nseg) {
              below += pos[v];
              const uint32_t s = base[min(pos[v], K - 1) * PL + off[v]];
              const uint32_t r = base[max(pos[v] - 1, 0) * PL + off[v]];
              succ = pos[v] < K ? min(succ, s) : succ;
              pred = pos[v] > 0 ? max(pred, r) : pred;
            }
          }
        }
        const long long all = group_reduce((long long)below,
                                           [](long long a, long long c) { return a + c; });
        succ = group_reduce(succ, [](uint32_t a, uint32_t c) { return min(a, c); });
        pred = group_reduce(pred, [](uint32_t a, uint32_t c) { return max(a, c); });
        if (run) {
          if (all <= rank) {
            l = succ;
          } else {
            u = pred + 1u;
          }
        }
        run = run && u - l > 1u;
      }
      if (t == 0 && gx < W) {
        float v = key_value(l);
        if (nan) {
          const int dy = (int)(first / K), dx = (int)(first - (long long)dy * K);
          v = pro(xb[(size_t)clampi(y - R + dy, 0, H - 1) * W + clampi(gx - R + dx, 0, W - 1)]);
        }
        ob[(size_t)y * W + gx] = v;
      }
      __syncthreads();  // the next row moves the segments, or the next tile loads them
    }
  }
}

template <bool SHARED>
cudaError_t launch_wide(const float* x, float* out, uint32_t* scratch, int b0, int nb, int H,
                        int W, int K, int rows, int grid, const Prologue& pro,
                        cudaStream_t stream) {
  const int strips = (W + WTW - 1) / WTW, bands = (H + rows - 1) / rows;
  const long long tiles = (long long)nb * bands * strips;
  size_t bytes = 0;
  if (SHARED) {
    bytes = wide_segment_words(K) * sizeof(uint32_t);
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
  const int g = tiles < grid ? (int)tiles : grid;
  wide_kernel<SHARED><<<g, WNT, bytes, stream>>>(x, out, scratch, H, W, K, b0, rows, bands,
                                                 strips, tiles, pro);
  return cudaGetLastError();
}

cudaError_t median_filter(const float* x, float* out, int B, int H, int W, int k,
                          const Prologue& pro, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(x, out, B, H, W, pro, s);
    case 3: return launch<3>(x, out, B, H, W, pro, s);
    case 5: return launch<5>(x, out, B, H, W, pro, s);
    case 7: return launch<7>(x, out, B, H, W, pro, s);
    case 9: return launch<9>(x, out, B, H, W, pro, s);
    case 11: return launch<11>(x, out, B, H, W, pro, s);
    case 13: return launch<13>(x, out, B, H, W, pro, s);
    case 15: return launch<15>(x, out, B, H, W, pro, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t median_select(const float* x, float* out, int b0, int nb, int H, int W, int k,
                          int max_k, const Prologue& pro, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (b0 < 0 || nb <= 0 || nb > 65535 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0 ||
      k > max_k || k > 63) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (select_log2p(k)) {
    case 0: return launch_select<0>(x, out, b0, nb, H, W, k, pro, s);
    case 1: return launch_select<1>(x, out, b0, nb, H, W, k, pro, s);
    case 2: return launch_select<2>(x, out, b0, nb, H, W, k, pro, s);
    case 3: return launch_select<3>(x, out, b0, nb, H, W, k, pro, s);
    case 4: return launch_select<4>(x, out, b0, nb, H, W, k, pro, s);
    default: return launch_select<5>(x, out, b0, nb, H, W, k, pro, s);
  }
}

cudaError_t median_wide(const float* x, float* out, void* scratch, int b0, int nb, int H, int W,
                        int k, int rows, int grid, const Prologue& pro, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (b0 < 0 || nb <= 0 || nb > 65535 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0 ||
      rows < 1 || grid < 1 || wide_segment_words(k) > (size_t)INT_MAX) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  return sc ? launch_wide<false>(x, out, sc, b0, nb, H, W, k, rows, grid, pro, s)
            : launch_wide<true>(x, out, nullptr, b0, nb, H, W, k, rows, grid, pro, s);
}

Prologue prologue(float norm_min, float scale, float norm_low, float clip_low,
                  float clip_high) {
  return Prologue{1, norm_min, scale, norm_low, clip_low, clip_high};
}

}  // namespace

// k x k median of a (B, H, W) float32 batch, clamp-to-edge; odd k <= 15.
extern "C" int nm03_median_filter(const float* x, float* out, int B, int H, int W,
                                  int k, void* stream) {
  return median_filter(x, out, B, H, W, k, Prologue{}, stream);
}

// k x k median of slices [b0, b0 + nb) of a (., H, W) float32 batch,
// clamp-to-edge, by exact selection; odd k in [1, max_k]. nb <= 65535 (the
// grid's z dimension: the wrapper splits a larger batch).
extern "C" int nm03_median_select(const float* x, float* out, int b0, int nb, int H, int W,
                                  int k, int max_k, void* stream) {
  return median_select(x, out, b0, nb, H, W, k, max_k, Prologue{}, stream);
}

// k x k median of slices [b0, b0 + nb) of a (., H, W) float32 batch,
// clamp-to-edge, by a bisection over sorted column segments that each CTA
// keeps down a band of `rows` output rows; any odd k. With `scratch` null
// the segments sit in shared memory (cudaErrorInvalidConfiguration where
// wide_segment_words(k) words do not fit a block), else in `scratch`,
// grid x wide_segment_words(k) words. `grid` CTAs (at most the tiles) walk
// the nb x ceil(H / rows) x ceil(W / 32) tiles. nb <= 65535, as for
// nm03_median_select.
extern "C" int nm03_median_wide(const float* x, float* out, void* scratch, int b0, int nb,
                                int H, int W, int k, int rows, int grid, void* stream) {
  return median_wide(x, out, scratch, b0, nb, H, W, k, rows, grid, Prologue{}, stream);
}

// The same three, each with the prologue on: the median of
// clamp((x - norm_min) * scale + norm_low, clip_low, clip_high).
extern "C" int nm03_median_filter_pre(const float* x, float* out, int B, int H, int W, int k,
                                      float norm_min, float scale, float norm_low,
                                      float clip_low, float clip_high, void* stream) {
  return median_filter(x, out, B, H, W, k,
                       prologue(norm_min, scale, norm_low, clip_low, clip_high), stream);
}

extern "C" int nm03_median_select_pre(const float* x, float* out, int b0, int nb, int H, int W,
                                      int k, int max_k, float norm_min, float scale,
                                      float norm_low, float clip_low, float clip_high,
                                      void* stream) {
  return median_select(x, out, b0, nb, H, W, k, max_k,
                       prologue(norm_min, scale, norm_low, clip_low, clip_high), stream);
}

extern "C" int nm03_median_wide_pre(const float* x, float* out, void* scratch, int b0, int nb,
                                    int H, int W, int k, int rows, int grid, float norm_min,
                                    float scale, float norm_low, float clip_low,
                                    float clip_high, void* stream) {
  return median_wide(x, out, scratch, b0, nb, H, W, k, rows, grid,
                     prologue(norm_min, scale, norm_low, clip_low, clip_high), stream);
}

// The wide kernel's CTAs an SM holds at once with window k's segments in
// shared memory, by the runtime's occupancy (threads, registers and shared
// memory): *per_sm. cudaErrorInvalidConfiguration where the segments do not
// fit a block. Legal during stream capture, as the launch is.
extern "C" int nm03_median_wide_ctas_per_sm(int k, int* per_sm) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (k < 1 || k % 2 == 0 || per_sm == nullptr) return cudaErrorInvalidValue;
  const size_t bytes = wide_segment_words(k) * sizeof(uint32_t);
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
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, wide_kernel<true>, WNT, bytes);
}
