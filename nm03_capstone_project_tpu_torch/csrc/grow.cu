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
// Design: one thread-block cluster per slice. The C CTAs of a cluster
// (C = 2, 4 or 8, chosen by the wrapper from the slice size) each own a
// band of `rows` = ceil(H / C) rows and hold it, with up to `halo` =
// min(16, rows) rows of each neighbour's band, bit-packed in their own
// shared memory, 32 pixels per word, row-major (bit b of word (y, i) is
// pixel (y, 32 i + b)): the band, and the two Jacobi region buffers,
// (3 (rows + 2 halo) ceil(W / 32) + 64) * 4 bytes a CTA. A 2048 x 2048
// canvas takes 216 KB a CTA at C = 8, within the 227 KB a block may use;
// the wrapper refuses larger slices before launch.
//
// * Packing: a thread builds a whole word from 16-byte loads (8 float4 of
//   the image, 2 uint4 each of seeds and valid, all issued before the first
//   compare) where W % 16 == 0 and the tensors are 16-byte aligned, else
//   from 32 independent scalar loads; no warp waits on one word at a time.
//   Halo rows are packed from the image too, so the first steps need no
//   exchange.
// * A step: each word is a few shifts, ORs and one AND, over every row the
//   CTA holds, ending in a block barrier. A row beyond the held ones counts
//   as 0, which is wrong only within s rows of that edge after s steps: the
//   own rows stay exact for `halo` steps (temporal blocking).
// * Every `halo` steps, and at the end of each block of block_iters steps,
//   the cluster exchanges (exchange()): each CTA writes the popcount of its
//   own rows into rank 0's shared memory, a cluster barrier, each copies its
//   neighbours' fresh edge rows into its halo rows straight from their
//   shared memory (distributed shared memory, map_shared_rank) and sums the
//   partials, then arrives at a second cluster barrier that it waits at
//   only after its next step (which writes the other buffer), so the
//   barrier's latency hides behind a step. Every CTA takes the loop test
//   from that one sum, so all run the same barriers, and none steps on rows
//   a neighbour is still copying. A 48-step slice runs 9 cluster barriers
//   where one a step would run 54.
//
// Bound on the H100: the data moved (7 bytes a pixel) and the bit
// operations are tiny; the time goes to the sequential depth, about the
// lesion's diameter in steps, and to the barriers between them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_HALO = 16;       // rows held beyond a CTA's own on each side
constexpr int SCRATCH_WORDS = 64;  // 32 per-warp partials, MAX_CLUSTER per-rank sums

// Pixel x gains x-1 and x+1; l and r are the neighbouring words of the row.
__device__ __forceinline__ uint32_t hdilate(uint32_t c, uint32_t l, uint32_t r) {
  return c | (c << 1) | (l >> 31) | (c >> 1) | (r << 31);
}

// Bit j of the result is set where byte j of x is nonzero (j < 4).
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t t = __vcmpne4(x, 0u) & 0x01010101u;
  return (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu;
}

__device__ __forceinline__ uint32_t in_band4(float4 v, float low, float high) {
  return (uint32_t)(v.x >= low && v.x <= high) | ((uint32_t)(v.y >= low && v.y <= high) << 1) |
         ((uint32_t)(v.z >= low && v.z <= high) << 2) |
         ((uint32_t)(v.w >= low && v.w <= high) << 3);
}

// Byte j of the result holds bit j of x (j < 4), as 0 or 1.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  return nonzero4(v.x) | (nonzero4(v.y) << 4) | (nonzero4(v.z) << 8) | (nonzero4(v.w) << 12);
}

// Pack band and seeds & band for `nw` words starting at global row g0 into
// band[] and cur[], one word a thread.
__device__ void pack_rows(const float* __restrict__ image, const uint8_t* __restrict__ seeds,
                          const uint8_t* __restrict__ valid, size_t off, int g0, int nw,
                          int W, int WW, float low, float high, int vec, uint32_t* band,
                          uint32_t* cur) {
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const int ly = w / WW, x0 = (w - ly * WW) * 32;
    const size_t q = off + (size_t)(g0 + ly) * W + x0;
    uint32_t bw = 0, sw = 0;
    if (vec && x0 + 32 <= W) {
      const float4* ip = reinterpret_cast<const float4*>(image + q);
      const uint4* sp = reinterpret_cast<const uint4*>(seeds + q);
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = ip[j];
      const uint4 s0 = sp[0], s1 = sp[1];
      uint32_t vw = 0xffffffffu;
      if (valid != nullptr) {
        const uint4* vp = reinterpret_cast<const uint4*>(valid + q);
        const uint4 v0 = vp[0], v1 = vp[1];
        vw = nonzero16(v0) | (nonzero16(v1) << 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) bw |= in_band4(v[j], low, high) << (4 * j);
      bw &= vw;
      sw = nonzero16(s0) | (nonzero16(s1) << 16);
    } else {
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (x0 + b < W) {
          const float v = image[q + b];
          const bool in = v >= low && v <= high && (valid == nullptr || valid[q + b] != 0);
          bw |= (uint32_t)in << b;
          sw |= (uint32_t)(seeds[q + b] != 0) << b;
        }
      }
    }
    band[w] = bw;
    cur[w] = sw & bw;
  }
}

// The two halves of a cluster barrier (cluster.sync() is both): a CTA may
// work between arriving and waiting.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's halo exchange and popcount, between blocks of local steps.
// Each CTA's own rows of `cur` are exact; this writes their popcount into
// rank 0's shared memory, waits for the cluster, copies the neighbours' own
// edge rows into its halo rows, sums the partials, and arrives at a second
// barrier. The caller waits at that barrier after its next step, which
// writes only the other buffer, so no CTA overwrites rows (or sums) a
// neighbour may still be reading. Every thread of every CTA returns the
// cluster's popcount.
struct Halo {
  int WW, rank, C, own0, nown;  // own rows start at held row own0
  int up_rows, dn_rows;         // halo rows above and below the own rows
  int up_src, dn_src;           // their first held row in the neighbour's buffer
};

__device__ int exchange(const cg::cluster_group& cluster, const Halo& hl, uint32_t* cur,
                        int* red, int* sums0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* own = cur + hl.own0 * hl.WW;
  int c = 0;
  for (int w = threadIdx.x; w < hl.nown * hl.WW; w += blockDim.x) c += __popc(own[w]);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) sums0[hl.rank] = c;  // into rank 0's shared memory
  }
  cluster.sync();
  const int nup = hl.up_rows * hl.WW, ndn = hl.dn_rows * hl.WW;
  if (nup > 0 || ndn > 0) {
    const uint32_t* up =
        nup > 0 ? cluster.map_shared_rank(cur, hl.rank - 1) + hl.up_src * hl.WW : nullptr;
    const uint32_t* dn =
        ndn > 0 ? cluster.map_shared_rank(cur, hl.rank + 1) + hl.dn_src * hl.WW : nullptr;
    uint32_t* dn_dst = cur + (hl.own0 + hl.nown) * hl.WW;
    for (int w = threadIdx.x; w < nup + ndn; w += blockDim.x) {
      if (w < nup) {
        cur[w] = up[w];
      } else {
        dn_dst[w - nup] = dn[w - nup];
      }
    }
  }
  int total = lane < hl.C ? sums0[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  __syncthreads();  // the halo rows, for this CTA's next step
  cluster_arrive();
  return total;
}

__global__ void __launch_bounds__(MAX_THREADS)
grow_kernel(const float* __restrict__ image, const uint8_t* __restrict__ seeds,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ mask,
            int32_t* __restrict__ conv, int32_t* __restrict__ steps, int H, int W, int rows,
            int halo, float low, float high, int conn8, int block_iters, int max_iters,
            int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int slice = blockIdx.x / C;
  const int WW = (W + 31) >> 5, n = (rows + 2 * halo) * WW;
  // own rows [row0, row0 + nown), held with up to `halo` rows each side
  const int row0 = rank * rows;
  const int nown = max(0, min(rows, H - row0));
  const int ext0 = nown > 0 ? max(0, row0 - halo) : row0;
  const int ext1 = nown > 0 ? min(H, row0 + nown + halo) : row0;
  const int next = ext1 - ext0, nw = next * WW;
  Halo hl;
  hl.WW = WW;
  hl.rank = rank;
  hl.C = C;
  hl.own0 = row0 - ext0;
  hl.nown = nown;
  hl.up_rows = row0 - ext0;
  hl.dn_rows = ext1 - (row0 + nown);
  hl.up_src = ext0 - max(0, row0 - rows - halo);  // rank - 1 holds rows from there
  hl.dn_src = halo;                               // rank + 1's own rows start there
  extern __shared__ uint32_t sm[];
  // the band, then the two region buffers at sm + n (1 + p), p = 0, 1
  uint32_t* band = sm;
  int* red = reinterpret_cast<int*>(sm + 3 * n);
  int* sums0 = cluster.map_shared_rank(red + 32, 0);
  const size_t off = (size_t)slice * H * W;

  // the band and the seeded region of every row held, own and halo, from
  // the image: exact, so no exchange is needed before the first step
  pack_rows(image, seeds, valid, off, ext0, nw, W, WW, low, high, vec, band, sm + n);
  cluster.sync();  // every CTA of the cluster has started before any writes another

  int p = 0;  // sm + n (1 + p) holds the current region
  // a thread's words w = threadIdx.x + m blockDim.x are at row e, word i;
  // stepped without dividing
  const int e0 = threadIdx.x / WW, i0 = threadIdx.x - e0 * WW;
  const int de = blockDim.x / WW, di = blockDim.x - de * WW;
  // block_iters Jacobi steps, exchanging halos every `halo` steps. A step
  // takes rows beyond the held ones as 0: that is exact at the canvas edge,
  // and elsewhere wrong only within s rows of the edge of what is held
  // after s steps, never in the own rows while s <= halo.
  auto run_block = [&]() -> int {
    int count = 0;
    for (int done = 0; done < block_iters;) {
      const int s = min(halo, block_iters - done);
      for (int t = 0; t < s; ++t) {
        const uint32_t* cur = sm + n * (1 + p);
        uint32_t* nxt = sm + n * (2 - p);
        for (int w = threadIdx.x, e = e0, i = i0; w < nw; w += blockDim.x, e += de, i += di) {
          if (i >= WW) {
            i -= WW;
            ++e;
          }
          // neighbours past the row's ends or the held rows are 0
          const bool has_l = i > 0, has_r = i + 1 < WW, has_u = e > 0, has_d = e + 1 < next;
          const uint32_t l = has_l ? cur[w - 1] : 0u, r = has_r ? cur[w + 1] : 0u;
          const uint32_t up = has_u ? cur[w - WW] : 0u, dn = has_d ? cur[w + WW] : 0u;
          uint32_t g = hdilate(cur[w], l, r);
          if (conn8) {
            g |= hdilate(up, has_u && has_l ? cur[w - WW - 1] : 0u,
                         has_u && has_r ? cur[w - WW + 1] : 0u);
            g |= hdilate(dn, has_d && has_l ? cur[w + WW - 1] : 0u,
                         has_d && has_r ? cur[w + WW + 1] : 0u);
          } else {
            g |= up | dn;
          }
          nxt[w] = g & band[w];
        }
        __syncthreads();
        p ^= 1;
        if (t == 0) cluster_wait();  // the last exchange's second barrier
      }
      done += s;
      count = exchange(cluster, hl, sm + n * (1 + p), red, sums0);
    }
    return count;
  };

  int prev = exchange(cluster, hl, sm + n * (1 + p), red, sums0);
  int count = run_block();
  int iters = block_iters;
  while (count != prev && iters < max_iters) {
    prev = count;
    count = run_block();
    iters += block_iters;
  }
  cluster_wait();  // no CTA leaves while a neighbour may read its memory

  const uint32_t* region = sm + n * (1 + p) + hl.own0 * WW;
  for (int w = threadIdx.x; w < nown * WW; w += blockDim.x) {
    const int ly = w / WW, x0 = (w - ly * WW) * 32;
    const size_t q = off + (size_t)(row0 + ly) * W + x0;
    const uint32_t word = region[w];
    if (vec && x0 + 32 <= W) {
      uint4* mp = reinterpret_cast<uint4*>(mask + q);
      mp[0] = make_uint4(spread4(word), spread4(word >> 4), spread4(word >> 8),
                         spread4(word >> 12));
      mp[1] = make_uint4(spread4(word >> 16), spread4(word >> 20), spread4(word >> 24),
                         spread4(word >> 28));
    } else {
      for (int b = 0; b < 32 && x0 + b < W; ++b) mask[q + b] = (word >> b) & 1u;
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    conv[slice] = count == prev;
    if (steps != nullptr) steps[slice] = iters;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Region growing over a (B, H, W) batch: image float32, seeds and valid
// uint8 (valid may be null: every pixel valid), mask uint8 out, conv int32
// (B,) out (1 = the popcount went stable before max_iters), steps int32 (B,)
// out (dilation steps each slice ran; may be null). `cluster` CTAs (1, 2,
// 4 or 8) grow each slice; a slice whose share of rows does not fit one
// CTA's shared memory returns cudaErrorInvalidConfiguration before launch.
extern "C" int nm03_region_grow(const float* image, const uint8_t* seeds,
                                const uint8_t* valid, uint8_t* mask, int32_t* conv,
                                int32_t* steps, int B, int H, int W, float low, float high,
                                int connectivity, int block_iters, int max_iters, int cluster,
                                void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || block_iters < 1 || max_iters < 1 ||
      (connectivity != 4 && connectivity != 8) || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const int rows = (H + cluster - 1) / cluster;
  const int halo = rows < MAX_HALO ? rows : MAX_HALO;
  const size_t words = (size_t)(rows + 2 * halo) * ((W + 31) / 32);  // a buffer
  const size_t bytes = (3 * words + SCRATCH_WORDS) * sizeof(uint32_t);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(grow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const int threads = (int)(words < (size_t)MAX_THREADS ? (words + 31) / 32 * 32 : MAX_THREADS);
  const int vec = W % 16 == 0 && aligned(image, 16) && aligned(seeds, 16) &&
                  aligned(mask, 16) && (valid == nullptr || aligned(valid, 16));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grow_kernel, image, seeds, valid, mask, conv, steps, H, W,
                           rows, halo, low, high, connectivity == 8 ? 1 : 0, block_iters,
                           max_iters, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
