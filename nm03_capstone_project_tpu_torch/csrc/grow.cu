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
//
// Slices past one cluster (nm03_region_grow_global, the wrapper's "global"
// route): where a slice's share of rows does not fit the shared memory of
// 8 CTAs (past about 2160 x 2048), the band and the two Jacobi region
// buffers stay bit-packed in global memory, which the wrapper allocates:
// 2 MiB each for a 4096 x 4096 slice, resident in the H100's 50 MB L2.
// One persistent cooperative grid (as many CTAs as fit the SMs at once)
// walks every word of every slice a step, reading the region through L2
// (ld.global.cg: another SM wrote it the step before), with a grid-wide
// barrier (cooperative_groups grid sync) between steps. After each block
// of block_iters steps the popcounts go to per-slice counters by atomics
// (three in rotation: this block's, the last one's, and the one being
// cleared), one thread takes each slice's loop test as the cluster kernel
// does (block j + 1 runs while count_j != count_{j-1} and (j + 1) *
// block_iters < max_iters) and writes steps and converged for a slice
// that stops; a stopped slice's words are copied, not stepped, so its
// region stays what its own loop left. The mask, converged and steps are
// the plain region_grow's bit for bit, as for the cluster kernel. Bound:
// bytes (the image, seeds and valid read once, the mask written once);
// the time goes to the steps' L2 traffic and grid barriers.

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

// The band word and the seed word of the 32 pixels from image offset q
// (canvas column x0 of a row): from 16-byte loads (8 float4 of the image, 2
// uint4 each of seeds and valid, all issued before the first compare)
// where `vec` and the word is whole, else from 32 independent scalar loads.
__device__ __forceinline__ void pack_word(const float* __restrict__ image,
                                          const uint8_t* __restrict__ seeds,
                                          const uint8_t* __restrict__ valid, size_t q, int x0,
                                          int W, float low, float high, int vec, uint32_t& bw,
                                          uint32_t& sw) {
  bw = 0;
  sw = 0;
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
    uint32_t bw, sw;
    pack_word(image, seeds, valid, q, x0, W, low, high, vec, bw, sw);
    band[w] = bw;
    cur[w] = sw & bw;
  }
}

// The 32 mask bytes of one region word at image offset q (canvas column x0).
__device__ __forceinline__ void unpack_word(uint8_t* __restrict__ mask, size_t q, int x0, int W,
                                            uint32_t word, int vec) {
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
    unpack_word(mask, q, x0, W, region[w], vec);
  }
  if (rank == 0 && threadIdx.x == 0) {
    conv[slice] = count == prev;
    if (steps != nullptr) steps[slice] = iters;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// -- slices past one cluster: the region in global memory ---------------------

constexpr int GLOBAL_THREADS = 512;

// A thread's walk over the words of the whole batch, word w = slice s, row
// y, word i, advanced by the grid's stride without dividing.
struct WordWalk {
  int64_t w;
  int s, y, i;
  __device__ WordWalk(int64_t w0, int H, int WW) : w(w0) {
    const int64_t per = (int64_t)H * WW;
    s = (int)(w0 / per);
    const int rem = (int)(w0 - (int64_t)s * per);
    y = rem / WW;
    i = rem - y * WW;
  }
  __device__ void advance(int64_t stride, int ds, int dy, int di, int H, int WW) {
    w += stride;
    s += ds;
    y += dy;
    i += di;
    if (i >= WW) {
      i -= WW;
      ++y;
    }
    if (y >= H) {
      y -= H;
      ++s;
    }
  }
};

// The popcount of words of one slice, added to cnt[s]: a warp sums first
// where its lanes share a slice.
__device__ __forceinline__ void add_count(int* cnt, int s, int c, bool live) {
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  const int s0 = __shfl_sync(lanes, s, __ffs(lanes) - 1);
  const bool same = __all_sync(lanes, s == s0);
  if (same) {
    const int total = __reduce_add_sync(lanes, c);
    if ((threadIdx.x & 31) == __ffs(lanes) - 1 && total) atomicAdd(cnt + s0, total);
  } else if (c) {
    atomicAdd(cnt + s, c);
  }
}

// Scratch (int32, zeroed by the wrapper): cnt[3][B] popcounts in rotation,
// act[B] whether a slice runs the current block, go[1] whether any does.
__global__ void __launch_bounds__(GLOBAL_THREADS)
grow_global_kernel(const float* __restrict__ image, const uint8_t* __restrict__ seeds,
                   const uint8_t* __restrict__ valid, uint8_t* __restrict__ mask,
                   int32_t* __restrict__ conv, int32_t* __restrict__ steps,
                   uint32_t* __restrict__ band, uint32_t* __restrict__ buf0,
                   uint32_t* __restrict__ buf1, int* __restrict__ scratch, int B, int H, int W,
                   float low, float high, int conn8, int block_iters, int max_iters, int vec) {
  cg::grid_group grid = cg::this_grid();
  const int WW = (W + 31) >> 5;
  const int64_t total = (int64_t)B * H * WW;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t per = (int64_t)H * WW;
  const int ds = (int)(stride / per);
  const int dy = (int)((stride - (int64_t)ds * per) / WW);
  const int di = (int)(stride - (int64_t)ds * per - (int64_t)dy * WW);
  int* cnt = scratch;           // cnt[(j mod 3) * B + s]: the count after block j
  int* act = scratch + 3 * B;   // act[s]
  int* go = scratch + 4 * B;

  // pack every word; the seeded region's popcount is the count "after
  // block -1", in cnt[2]
  for (WordWalk it(tid, H, WW);; it.advance(stride, ds, dy, di, H, WW)) {
    const bool live = it.w < total;
    int c = 0;
    if (live) {
      const int x0 = it.i * 32;
      const size_t q = ((size_t)it.s * H + it.y) * W + x0;
      uint32_t bw, sw;
      pack_word(image, seeds, valid, q, x0, W, low, high, vec, bw, sw);
      band[it.w] = bw;
      buf0[it.w] = sw & bw;
      c = __popc(sw & bw);
    }
    add_count(cnt + 2 * B, live ? it.s : 0, c, live);
    if (__all_sync(0xffffffffu, !live)) break;
  }
  for (int64_t s = tid; s < B; s += stride) act[s] = 1;
  grid.sync();

  int p = 0;  // the current region is in buf0 when p == 0
  for (int j = 0;; ++j) {
    for (int t = 0; t < block_iters; ++t) {
      const uint32_t* cur = p ? buf1 : buf0;
      uint32_t* nxt = p ? buf0 : buf1;
      for (WordWalk it(tid, H, WW); it.w < total; it.advance(stride, ds, dy, di, H, WW)) {
        const int64_t w = it.w;
        const uint32_t c = __ldcg(cur + w);
        if (!__ldcg(act + it.s)) {  // a stopped slice keeps its region
          nxt[w] = c;
          continue;
        }
        // neighbours past the row's ends or the slice's rows are 0
        const bool has_l = it.i > 0, has_r = it.i + 1 < WW;
        const bool has_u = it.y > 0, has_d = it.y + 1 < H;
        const uint32_t l = has_l ? __ldcg(cur + w - 1) : 0u;
        const uint32_t r = has_r ? __ldcg(cur + w + 1) : 0u;
        const uint32_t up = has_u ? __ldcg(cur + w - WW) : 0u;
        const uint32_t dn = has_d ? __ldcg(cur + w + WW) : 0u;
        uint32_t g = hdilate(c, l, r);
        if (conn8) {
          g |= hdilate(up, has_u && has_l ? __ldcg(cur + w - WW - 1) : 0u,
                       has_u && has_r ? __ldcg(cur + w - WW + 1) : 0u);
          g |= hdilate(dn, has_d && has_l ? __ldcg(cur + w + WW - 1) : 0u,
                       has_d && has_r ? __ldcg(cur + w + WW + 1) : 0u);
        } else {
          g |= up | dn;
        }
        nxt[w] = g & __ldcg(band + w);
      }
      grid.sync();
      p ^= 1;
    }
    // the count after block j, into cnt[j mod 3]
    const uint32_t* region = p ? buf1 : buf0;
    int* cj = cnt + (j % 3) * B;
    for (WordWalk it(tid, H, WW);; it.advance(stride, ds, dy, di, H, WW)) {
      const bool live = it.w < total;
      const int c = live ? __popc(__ldcg(region + it.w)) : 0;
      add_count(cj, live ? it.s : 0, c, live);
      if (__all_sync(0xffffffffu, !live)) break;
    }
    grid.sync();
    if (tid == 0) {
      const int* cprev = cnt + ((j + 2) % 3) * B;
      int* cfree = cnt + ((j + 1) % 3) * B;  // block j + 1 counts into it
      int any = 0;
      for (int s = 0; s < B; ++s) {
        if (__ldcg(act + s)) {
          const int c = __ldcg(cj + s), pv = __ldcg(cprev + s);
          if (c != pv && (j + 1) * block_iters < max_iters) {
            any = 1;
          } else {
            act[s] = 0;
            conv[s] = c == pv;
            if (steps != nullptr) steps[s] = (j + 1) * block_iters;
          }
        }
        cfree[s] = 0;
      }
      *go = any;
    }
    grid.sync();
    if (!__ldcg(go)) break;
  }

  const uint32_t* region = p ? buf1 : buf0;
  for (WordWalk it(tid, H, WW); it.w < total; it.advance(stride, ds, dy, di, H, WW)) {
    const int x0 = it.i * 32;
    unpack_word(mask, ((size_t)it.s * H + it.y) * W + x0, x0, W, __ldcg(region + it.w), vec);
  }
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

// Region growing of a (B, H, W) batch whose slices do not fit one
// cluster: the arguments of nm03_region_grow, plus `band`, `buf0` and
// `buf1` (B * H * ceil(W / 32) uint32 words each) and `scratch` (4 B + 1
// int32, zeroed), all allocated by the caller. One cooperative launch of
// as many CTAs as fit the SMs at once.
extern "C" int nm03_region_grow_global(const float* image, const uint8_t* seeds,
                                       const uint8_t* valid, uint8_t* mask, int32_t* conv,
                                       int32_t* steps, uint32_t* band, uint32_t* buf0,
                                       uint32_t* buf1, int32_t* scratch, int B, int H, int W,
                                       float low, float high, int connectivity,
                                       int block_iters, int max_iters, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (B <= 0 || H <= 0 || W <= 0 || block_iters < 1 || max_iters < 1 ||
      (connectivity != 4 && connectivity != 8)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grow_global_kernel,
                                                      GLOBAL_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t words = (int64_t)B * H * ((W + 31) / 32);
  int64_t ctas = (int64_t)n_sm * per_sm;
  const int64_t need = (words + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  if (need < ctas) ctas = need;
  if (ctas < 1) ctas = 1;
  const int vec = W % 16 == 0 && aligned(image, 16) && aligned(seeds, 16) &&
                  aligned(mask, 16) && (valid == nullptr || aligned(valid, 16));
  const int conn8 = connectivity == 8 ? 1 : 0;
  void* args[] = {(void*)&image, (void*)&seeds, (void*)&valid, (void*)&mask, (void*)&conv,
                  (void*)&steps, (void*)&band, (void*)&buf0, (void*)&buf1,
                  (void*)&scratch, (void*)&B, (void*)&H, (void*)&W, (void*)&low,
                  (void*)&high, (void*)&conn8, (void*)&block_iters, (void*)&max_iters,
                  (void*)&vec};
  err = cudaLaunchCooperativeKernel((const void*)grow_global_kernel, dim3((unsigned)ctas),
                                    dim3(GLOBAL_THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
