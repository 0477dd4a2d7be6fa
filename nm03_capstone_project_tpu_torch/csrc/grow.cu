// Hopper kernel for seeded region growing: the masked-dilation fixpoint.
//
// Replaces the JAX package's Pallas kernel _grow_kernel
// (ops/pallas_region_growing.py:30, called at :117) with nm03_region_grow.
//
// Semantics, as _grow_kernel: band = (x >= low) & (x <= high) & valid, with
// low/high compared as float32; region0 = seeds & band; each step is
// region <- (centre | 4 or 8 neighbours) & band, with out-of-canvas
// neighbours 0. One unconditional block of block_iters steps, then blocks
// while the popcount changed and iters < max_iters (iters starts at
// block_iters); converged = (last two popcounts equal). Steps are Jacobi:
// each reads the previous region and writes the other buffer, so growth per
// step, the mask under a truncating max_iters and the converged flag are
// the reference's.
//
// Design. One CTA (1024 threads) per slice, iterating in shared memory.
// The Pallas f32 scratch (258*258*4 B at 256^2) does not fit the 227 KB a
// block may use, so the band and two region buffers are bit-packed, 32
// pixels per word, row-major (bit b of word (y, i) is pixel (y, 32 i + b)):
// 8 KB each at 256^2, 32 KB each at 512^2, plus 132 bytes for the popcount
// reduction: (3 H ceil(W / 32) + 33) * 4 bytes in all. A step is a few
// shifts, ORs and one AND per word; the popcount is __popc and a block
// reduction. Packing and unpacking use __ballot_sync, one warp per word,
// so global loads and stores stay coalesced. A slice whose packed buffers
// exceed the shared memory a block may opt in to (227 KB on the H100: a
// 768 x 768 canvas fits, 1024 x 1024 does not) is refused with
// cudaErrorInvalidConfiguration before launch; a variant for larger slices
// (a cluster per slice, or global memory) is later work.
//
// Bound on the H100. The data moved (7 bytes a pixel) and the bit
// operations are tiny; the time goes to the sequential depth, about the
// lesion's diameter in steps, each ending in a block barrier. One CTA per
// slice leaves most SMs idle at batch 25: several slices per CTA or a
// cluster per slice is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;

// Pixel x gains x-1 and x+1; l and r are the neighbouring words of the row.
__device__ __forceinline__ uint32_t hdilate(uint32_t c, uint32_t l, uint32_t r) {
  return c | (c << 1) | (l >> 31) | (c >> 1) | (r << 31);
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* g, int y, int i, int H, int WW) {
  return (y < 0 || y >= H || i < 0 || i >= WW) ? 0u : g[y * WW + i];
}

// Sum of __popc over the n words of g; every thread returns the total.
__device__ int block_popcount(const uint32_t* g, int n, int* red) {
  int c = 0;
  for (int w = threadIdx.x; w < n; w += NTHREADS) c += __popc(g[w]);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = red[lane];  // NWARPS == 32
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) red[NWARPS] = c;
  }
  __syncthreads();
  const int total = red[NWARPS];
  __syncthreads();  // red is reused by the next call
  return total;
}

__global__ void __launch_bounds__(NTHREADS)
grow_kernel(const float* __restrict__ image, const uint8_t* __restrict__ seeds,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ mask,
            int32_t* __restrict__ conv, int32_t* __restrict__ steps, int H, int W,
            float low, float high, int conn8, int block_iters, int max_iters) {
  extern __shared__ uint32_t sm[];
  const int WW = (W + 31) >> 5, n = H * WW;
  uint32_t* band = sm;
  uint32_t* cur = sm + n;
  uint32_t* nxt = sm + 2 * n;
  int* red = reinterpret_cast<int*>(sm + 3 * n);  // NWARPS + 1 ints
  const size_t off = (size_t)blockIdx.x * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // pack band and seeds & band, one warp per word
  for (int w = warp; w < n; w += NWARPS) {
    const int y = w / WW, x = (w - y * WW) * 32 + lane;
    bool in_band = false, seed = false;
    if (x < W) {
      const size_t q = off + (size_t)y * W + x;
      const float v = image[q];
      in_band = v >= low && v <= high && (valid == nullptr || valid[q] != 0);
      seed = seeds[q] != 0;
    }
    const uint32_t bw = __ballot_sync(0xffffffffu, in_band);
    const uint32_t sw = __ballot_sync(0xffffffffu, seed);
    if (lane == 0) {
      band[w] = bw;
      cur[w] = sw & bw;
    }
  }
  __syncthreads();

  auto run_block = [&]() {
    for (int s = 0; s < block_iters; ++s) {
      for (int w = threadIdx.x; w < n; w += NTHREADS) {
        const int y = w / WW, i = w - y * WW;
        uint32_t g = hdilate(cur[w], word_at(cur, y, i - 1, H, WW),
                             word_at(cur, y, i + 1, H, WW));
        const uint32_t up = word_at(cur, y - 1, i, H, WW);
        const uint32_t dn = word_at(cur, y + 1, i, H, WW);
        if (conn8) {
          g |= hdilate(up, word_at(cur, y - 1, i - 1, H, WW),
                       word_at(cur, y - 1, i + 1, H, WW));
          g |= hdilate(dn, word_at(cur, y + 1, i - 1, H, WW),
                       word_at(cur, y + 1, i + 1, H, WW));
        } else {
          g |= up | dn;
        }
        nxt[w] = g & band[w];
      }
      __syncthreads();
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  };

  int prev = block_popcount(cur, n, red);
  run_block();
  int count = block_popcount(cur, n, red);
  int iters = block_iters;
  while (count != prev && iters < max_iters) {
    run_block();
    prev = count;
    count = block_popcount(cur, n, red);
    iters += block_iters;
  }

  for (int w = warp; w < n; w += NWARPS) {
    const int y = w / WW, x = (w - y * WW) * 32 + lane;
    if (x < W) mask[off + (size_t)y * W + x] = (cur[w] >> lane) & 1u;
  }
  if (threadIdx.x == 0) {
    conv[blockIdx.x] = count == prev;
    if (steps != nullptr) steps[blockIdx.x] = iters;
  }
}

}  // namespace

// Region growing over a (B, H, W) batch: image float32, seeds and valid
// uint8 (valid may be null: every pixel valid), mask uint8 out, conv int32
// (B,) out (1 = the popcount went stable before max_iters), steps int32 (B,)
// out (dilation steps each slice ran; may be null).
extern "C" int nm03_region_grow(const float* image, const uint8_t* seeds,
                                const uint8_t* valid, uint8_t* mask, int32_t* conv,
                                int32_t* steps, int B, int H, int W, float low, float high,
                                int connectivity, int block_iters, int max_iters,
                                void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || block_iters < 1 || max_iters < 1 ||
      (connectivity != 4 && connectivity != 8)) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = (3 * (size_t)H * ((W + 31) / 32) + NWARPS + 1) * sizeof(uint32_t);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(grow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  grow_kernel<<<B, NTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      image, seeds, valid, mask, conv, steps, H, W, low, high, connectivity == 8,
      block_iters, max_iters);
  return cudaGetLastError();
}
