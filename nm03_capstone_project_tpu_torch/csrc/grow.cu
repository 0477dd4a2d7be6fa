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
// buffers stay bit-packed in global memory, which the wrapper allocates
// (2 MiB each for a 4096 x 4096 slice), and the steps run in shared memory
// by tiles, with the same temporal blocking as the cluster kernel.
//
// * Tiles: the wrapper cuts each slice into tiles of `tr` own rows and `tw`
//   own words (a slice wide where that is at most 128 words, else at most
//   126), as many as the SMs where they fit, and picks the shared row
//   pitch and the grid (global_tiles in ops/hopper_region_growing.py owns
//   the layout; nm03_region_grow_global only checks it). A CTA of 512
//   threads holds its tile
//   with `halo` = min(block_iters, 32, tr) rows of each neighbour and one
//   word each side: a step moves a pixel one place, so the own words stay
//   exact for `halo` steps (32 for the side words). A super-step loads the
//   held tile, runs s = min(halo, block_iters - done) Jacobi steps between
//   its two shared buffers (step t computes only the rows within s - t of
//   the own ones) and writes the own words to the other global buffer:
//   one grid barrier per super-step of up to block_iters steps.
// * A step: the held tile sits in a border of zero words, so no word
//   tests its edges. A thread walks a strip of rows down a pair of word
//   columns, keeping the rows above and below in registers: a 64-bit and
//   two 32-bit shared loads of the incoming row, a 64-bit load of the band
//   and a 64-bit store for two words. 512 threads a CTA leave it 128
//   registers (at 1024 the step spills).
// * Resident tiles: where every tile has a CTA of its own (4096 x 4096 x 2
//   on 132 SMs: 132 tiles of 63 rows, 150 KB each), the band is loaded
//   once and the own words stay in shared memory for the whole fixpoint:
//   a super-step loads only the halo rows and words, the other CTAs' own
//   words of the last super-step. Past that (8192 x 8192 x 2, 16384 x
//   16384) the CTAs walk the tiles, whole rounds of them, and load each
//   whole every super-step, from L2 or device memory.
// * Quiet tiles: growth is monotone, so a tile whose popcount and its
//   eight neighbours' did not change in the last super-step cannot change
//   in the next (every pixel a super-step can reach lies in them) and is
//   not stepped. The global buffer it would write still holds its words
//   from the super-step before (the same words, or the tile was quiet
//   then too), so nothing is copied either: only the front moves.
// * The loop test: each tile's popcount (kept per tile, a quiet tile's
//   unchanged) goes to its slice's counter at a block's end (four
//   counters in rotation: this block's, the last one's, and two cleared
//   ahead). After the block's last barrier every CTA takes every slice's
//   test alike (block j + 1 runs while count_j != count_{j-1} and (j + 1)
//   * block_iters < max_iters) into a bitmap of running slices in its
//   shared memory, so the test needs no barrier of its own; CTA 0 writes
//   steps, converged and the buffer of a slice that stops, whose tiles are
//   never stepped again. The mask, converged and steps are the plain
//   region_grow's bit for bit, as for the cluster kernel.
//
// Bound: bytes (the image, seeds and valid read once, the mask written
// once; chip_smoke.py also counts 9 bit operations a word a step, and the
// words this design steps). The time goes to a busy tile's steps (about
// 1.1 us a step on an H100 at 4096 x 4096: the shared loads and stores,
// ten warp-wide accesses a row of 64 words), far less to its halo load and
// write (about 4 us a super-step) and the grid barrier (about 1 us);
// scripts/torch_kernel_probe.py stamps the phases.

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

// -- slices past one cluster: tiles stepped in shared memory ---------------------

constexpr int GLOBAL_THREADS = 512;
constexpr int GLOBAL_MAX_HALO = 32;  // a step moves a pixel at most one place: one word
constexpr int GLOBAL_RED = 40;       // ints of reduction scratch after the active-slice bits

// The tiling, chosen by the wrapper (ops/hopper_region_growing.py,
// global_tiles) and checked by nm03_region_grow_global.
struct GlobalTiles {
  int tr, tw;      // own rows and own words of a tile (the last row and column of
                   // tiles may be smaller)
  int ty, tx;      // tiles down and across a slice
  int halo;        // rows held beyond the own ones on each side, 1..GLOBAL_MAX_HALO
  int pitch;       // words of a row in shared memory: the held words at most
                   // (min(WW, tw + 2)), rounded up to even, and 4 of border
  int rows;        // held rows at most: min(H, tr + 2 halo)
  int resident;    // every tile has a CTA of its own for the whole fixpoint
};

// Tile t's place: slice s, own rows [r0, r1) and words [c0, c1) of the slice,
// held rows [hr0, hr1) and words [hc0, hc1).
struct TilePlace {
  int s, yi, xi, r0, r1, c0, c1, hr0, hr1, hc0, hc1;
};

__device__ __forceinline__ TilePlace place_of(int t, const GlobalTiles& g, int H, int WW) {
  TilePlace p;
  const int per = g.ty * g.tx;
  p.s = t / per;
  const int rem = t - p.s * per;
  p.yi = rem / g.tx;
  p.xi = rem - p.yi * g.tx;
  p.r0 = p.yi * g.tr;
  p.r1 = min(H, p.r0 + g.tr);
  p.c0 = p.xi * g.tw;
  p.c1 = min(WW, p.c0 + g.tw);
  p.hr0 = max(0, p.r0 - g.halo);
  p.hr1 = min(H, p.r1 + g.halo);
  p.hc0 = max(0, p.c0 - 1);
  p.hc1 = min(WW, p.c1 + 1);
  return p;
}

// The sum of c over the CTA, returned to every thread.
__device__ __forceinline__ int block_sum(int c, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) red[32] = c;
  }
  __syncthreads();
  return red[32];
}

// Whether tile p or one of its eight neighbours of the slice changed its
// popcount in the last super-step (chg: that super-step's flags), to every
// thread: threads 0..8 load one flag each, so the nine loads overlap.
__device__ __forceinline__ int tile_busy(const int* chg, const TilePlace& p, const GlobalTiles& g) {
  int flag = 0;
  if (threadIdx.x < 9) {
    const int y = p.yi + (int)threadIdx.x / 3 - 1, x = p.xi + (int)threadIdx.x % 3 - 1;
    if (y >= 0 && y < g.ty && x >= 0 && x < g.tx) {
      flag = __ldcg(chg + ((size_t)p.s * g.ty + y) * g.tx + x);
    }
  }
  return __syncthreads_or(flag);
}

// Rows [y0, y1) of a held tile from global memory (src: held word (0, 0);
// rows WW words apart) into shared memory, where held word (y, x) sits at
// (y + 1) pitch + 2 + x; thread (col, strip) copies column col of every
// strips-th row.
__device__ __forceinline__ void load_rows(uint32_t* dst, const uint32_t* src, int pitch, int WW,
                                          int y0, int y1, int col, int strip, int strips) {
#pragma unroll 4
  for (int y = y0 + strip; y < y1; y += strips) {
    dst[(y + 1) * pitch + 2 + col] = __ldcg(src + (size_t)y * WW + col);
  }
}

// One Jacobi step of held rows [lo, hi): nxt = (cur dilated) & band. The
// held tile sits in a border of zero words (a row above and below, two
// words left, at least one right), so the words beyond it read as 0 with
// no test. Thread (pair, strip) walks its share of the rows down the two
// words 2 pair and 2 pair + 1, keeping the rows above and below in
// registers: a 64-bit load and two 32-bit loads of the incoming row, a
// 64-bit load of the band and a 64-bit store for two words. A pair's
// second word past the held ones has band 0, so it stays 0.
template <bool CONN8>
__device__ __forceinline__ void step_rows(const uint32_t* __restrict__ cur,
                                          uint32_t* __restrict__ nxt,
                                          const uint32_t* __restrict__ band, int pitch, int lo,
                                          int hi, int pair, int strip, int strips) {
  const int chunk = (hi - lo + strips - 1) / strips;
  const int y0 = lo + strip * chunk, y1 = min(hi, y0 + chunk);
  if (y0 >= y1) return;
  const int col = 2 + 2 * pair;
  // held row y's two words c and their horizontal dilations h
  auto row_at = [&](int y, uint2& c, uint2& h) {
    const uint32_t* row = cur + (y + 1) * pitch + col;
    c = *reinterpret_cast<const uint2*>(row);
    h.x = hdilate(c.x, row[-1], c.y);
    h.y = hdilate(c.y, c.x, row[2]);
  };
  uint2 uc, uh, mc, mh, dc, dh;
  row_at(y0 - 1, uc, uh);
  row_at(y0, mc, mh);
#pragma unroll 4
  for (int y = y0; y < y1; ++y) {
    row_at(y + 1, dc, dh);
    const int o = (y + 1) * pitch + col;
    const uint2 bd = *reinterpret_cast<const uint2*>(band + o);
    uint2 gv;
    gv.x = (mh.x | (CONN8 ? (uh.x | dh.x) : (uc.x | dc.x))) & bd.x;
    gv.y = (mh.y | (CONN8 ? (uh.y | dh.y) : (uc.y | dc.y))) & bd.y;
    *reinterpret_cast<uint2*>(nxt + o) = gv;
    uc = mc;
    uh = mh;
    mc = dc;
    mh = dh;
  }
}

// Scratch (int32, zeroed by the wrapper): cnt[4][B] popcounts after each
// block in rotation, par[B] the buffer of each slice's region when it
// stopped, pop[tiles] each tile's own popcount, chg[2][tiles] whether it
// changed in the last two super-steps.
__global__ void __launch_bounds__(GLOBAL_THREADS, 1)
grow_global_kernel(const float* __restrict__ image, const uint8_t* __restrict__ seeds,
                   const uint8_t* __restrict__ valid, uint8_t* __restrict__ mask,
                   int32_t* __restrict__ conv, int32_t* __restrict__ steps,
                   uint32_t* __restrict__ gband, uint32_t* __restrict__ buf0,
                   uint32_t* __restrict__ buf1, int* __restrict__ scratch, int B, int H, int W,
                   float low, float high, int conn8, int block_iters, int max_iters, int vec,
                   GlobalTiles g) {
  cg::grid_group grid = cg::this_grid();
  const int WW = (W + 31) >> 5;
  const int tiles = B * g.ty * g.tx, nbw = (B + 31) >> 5;
  // offsets into the scratch are 64-bit: B and the tile count multiply
  int* cnt = scratch;  // cnt[(j & 3) * B + s]: the count after block j (block -1: 3)
  int* par = scratch + (size_t)4 * B;
  int* pop = scratch + (size_t)5 * B;
  int* chg = scratch + (size_t)5 * B + tiles;  // chg[(super-step & 1) * tiles + t]
  extern __shared__ uint32_t sm[];
  const int hold = (g.rows + 2) * g.pitch;  // a tile with its border of zero words
  uint32_t* sband = sm;
  uint32_t* sreg = sm + hold;  // two region buffers, sreg + hold * q
  uint32_t* act = sm + 3 * hold;  // bit s: slice s runs the current block
  int* red = reinterpret_cast<int*>(act + nbw);
  for (int i = threadIdx.x; i < 3 * hold; i += blockDim.x) sm[i] = 0u;

  // pack every tile's own words from the image; the seeded region's
  // popcount is the count "after block -1"
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TilePlace p = place_of(t, g, H, WW);
    const int ncw = p.c1 - p.c0, nw = (p.r1 - p.r0) * ncw;
    int c = 0;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      const int y = p.r0 + w / ncw, i = p.c0 + w % ncw;
      const size_t gw = ((size_t)p.s * H + y) * WW + i;
      uint32_t bw, sw;
      pack_word(image, seeds, valid, ((size_t)p.s * H + y) * W + i * 32, i * 32, W, low, high,
                vec, bw, sw);
      gband[gw] = bw;
      buf0[gw] = sw & bw;
      c += __popc(sw & bw);
    }
    c = block_sum(c, red);
    if (threadIdx.x == 0) {
      pop[t] = c;
      if (c) atomicAdd(cnt + (size_t)3 * B + p.s, c);
    }
  }
  for (int i = threadIdx.x; i < nbw; i += blockDim.x) {
    act[i] = (i + 1) * 32 <= B ? 0xffffffffu : (1u << (B & 31)) - 1u;
  }
  grid.sync();

  int p = 0;    // the region is in buf0 when p == 0, else in buf1
  int q = 0;    // the tile's region is in sreg + hold * q
  int gs = 0;   // super-steps run
  bool loaded = false;  // a resident tile is in shared memory
  for (int j = 0;; ++j) {
    for (int done = 0; done < block_iters;) {
      const int s = min(g.halo, block_iters - done);
      const bool last = done + s == block_iters;
      const uint32_t* cur = p ? buf1 : buf0;
      uint32_t* nxt = p ? buf0 : buf1;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TilePlace tp = place_of(t, g, H, WW);
        if (!((act[tp.s >> 5] >> (tp.s & 31)) & 1u)) continue;  // a stopped slice
        if (gs == 0 || tile_busy(chg + (size_t)((gs - 1) & 1) * tiles, tp, g)) {
          const int nr = tp.hr1 - tp.hr0, nc = tp.hc1 - tp.hc0;
          const int up = tp.r0 - tp.hr0, nown = tp.r1 - tp.r0;
          const int left = tp.c0 - tp.hc0, ncw = tp.c1 - tp.c0;
          const int strips = blockDim.x / nc;
          const int col = threadIdx.x % nc, strip = (int)threadIdx.x / nc;
          const int sstrip = strip < strips ? strip : nr;  // an idle thread: no rows
          const int npair = (nc + 1) / 2, pstrips = blockDim.x / npair;
          const int pair = threadIdx.x % npair, pstrip = (int)threadIdx.x / npair;
          const int spstrip = pstrip < pstrips ? pstrip : nr;
          const size_t held = ((size_t)tp.s * H + tp.hr0) * WW + tp.hc0;
          uint32_t* reg = sreg + hold * q;
          if (!g.resident) {  // another tile's words may lie where this one's border is
            for (int i = threadIdx.x; i < 3 * hold; i += blockDim.x) sm[i] = 0u;
            __syncthreads();
          }
          if (!g.resident || !loaded) {
            load_rows(reg, cur + held, g.pitch, WW, 0, nr, col, sstrip, strips);
            load_rows(sband, gband + held, g.pitch, WW, 0, nr, col, sstrip, strips);
            loaded = true;
          } else {  // the own words are this CTA's from the last super-step
            load_rows(reg, cur + held, g.pitch, WW, 0, up, col, sstrip, strips);
            load_rows(reg, cur + held, g.pitch, WW, up + nown, nr, col, sstrip, strips);
            if (col < left || col >= left + ncw) {
              load_rows(reg, cur + held, g.pitch, WW, up, up + nown, col, sstrip, strips);
            }
          }
          __syncthreads();
          // s steps; step t2 computes the rows that still reach the own ones
          for (int t2 = 1; t2 <= s; ++t2) {
            const int lo = max(0, up - (s - t2)), hi = min(nr, up + nown + (s - t2));
            if (conn8) {
              step_rows<true>(sreg + hold * q, sreg + hold * (q ^ 1), sband, g.pitch, lo, hi,
                              pair, spstrip, pstrips);
            } else {
              step_rows<false>(sreg + hold * q, sreg + hold * (q ^ 1), sband, g.pitch, lo, hi,
                               pair, spstrip, pstrips);
            }
            __syncthreads();
            q ^= 1;
          }
          // the own words out, and their popcount
          int c = 0;
          if (col >= left && col < left + ncw) {
            const uint32_t* src = sreg + hold * q;
            for (int y = up + sstrip; y < up + nown; y += strips) {
              const uint32_t v = src[(y + 1) * g.pitch + 2 + col];
              nxt[held + (size_t)y * WW + col] = v;
              c += __popc(v);
            }
          }
          c = block_sum(c, red);
          if (threadIdx.x == 0) {
            chg[(size_t)(gs & 1) * tiles + t] = c != pop[t];
            pop[t] = c;
          }
          if (!g.resident) q = 0;
        } else if (threadIdx.x == 0) {
          chg[(size_t)(gs & 1) * tiles + t] = 0;
        }
        if (last && threadIdx.x == 0 && pop[t]) {
          atomicAdd(cnt + (size_t)(j & 3) * B + tp.s, pop[t]);
        }
      }
      grid.sync();
      p ^= 1;
      ++gs;
      done += s;
    }
    // the loop test of every slice, taken alike by every CTA: block j + 1
    // runs while count_j != count_{j-1} and (j + 1) * block_iters <
    // max_iters. CTA 0 writes the results of a slice that stops and clears
    // the counts of block j + 2.
    int any = 0;
    for (int i = threadIdx.x; i < nbw; i += blockDim.x) {
      uint32_t bits = act[i];
      for (int b = 0; b < 32 && i * 32 + b < B; ++b) {
        const int sl = i * 32 + b;
        if (blockIdx.x == 0) cnt[(size_t)((j + 2) & 3) * B + sl] = 0;
        if (!((bits >> b) & 1u)) continue;
        const int c = __ldcg(cnt + (size_t)(j & 3) * B + sl);
        const int pv = __ldcg(cnt + (size_t)((j + 3) & 3) * B + sl);
        if (c != pv && (long long)(j + 1) * block_iters < max_iters) continue;
        bits &= ~(1u << b);
        if (blockIdx.x == 0) {
          conv[sl] = c == pv;
          if (steps != nullptr) steps[sl] = (j + 1) * block_iters;
          par[sl] = p;
        }
      }
      act[i] = bits;
      any |= bits != 0u;
    }
    if (!__syncthreads_or(any)) break;
  }
  grid.sync();  // every slice's buffer in par[]

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TilePlace tp = place_of(t, g, H, WW);
    const uint32_t* region = __ldcg(par + tp.s) ? buf1 : buf0;
    const int ncw = tp.c1 - tp.c0, nw = (tp.r1 - tp.r0) * ncw;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      const int y = tp.r0 + w / ncw, i = tp.c0 + w % ncw;
      unpack_word(mask, ((size_t)tp.s * H + y) * W + i * 32, i * 32, W,
                  __ldcg(region + ((size_t)tp.s * H + y) * WW + i), vec);
    }
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
// `buf1` (B * H * ceil(W / 32) uint32 words each) and `scratch` (5 B + 3
// tiles int32, zeroed), all allocated by the caller, and the layout the
// caller chose (global_tiles): `tile_rows` own rows and `tile_words` own
// 32-pixel words a tile (tile_words = ceil(W / 32) for tiles a slice wide),
// held with `halo` rows (1..32) beyond its own on each side, `pitch` words
// a row in shared memory (even, at least the held words and a border of 4),
// and `grid` CTAs: one a tile (every tile resident) or fewer, each walking
// several. The layout is checked, not chosen, here. One cooperative launch;
// any slice size (offsets past 2^31 words and pixels are 64-bit).
extern "C" int nm03_region_grow_global(const float* image, const uint8_t* seeds,
                                       const uint8_t* valid, uint8_t* mask, int32_t* conv,
                                       int32_t* steps, uint32_t* band, uint32_t* buf0,
                                       uint32_t* buf1, int32_t* scratch, int B, int H, int W,
                                       float low, float high, int connectivity,
                                       int block_iters, int max_iters, int tile_rows,
                                       int tile_words, int halo, int pitch, int grid,
                                       void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  const int WW = (W + 31) / 32;
  if (B <= 0 || H <= 0 || W <= 0 || block_iters < 1 || max_iters < 1 ||
      (connectivity != 4 && connectivity != 8) || tile_rows < 1 || tile_words < 1 ||
      tile_words > WW || halo < 1 || halo > GLOBAL_MAX_HALO || grid < 1) {
    return cudaErrorInvalidValue;
  }
  GlobalTiles g;
  g.tr = tile_rows;
  g.tw = tile_words;
  g.ty = (H + tile_rows - 1) / tile_rows;
  g.tx = (WW + tile_words - 1) / tile_words;
  g.halo = halo;
  const int held_words = tile_words == WW ? WW : (tile_words + 2 < WW ? tile_words + 2 : WW);
  if (held_words > GLOBAL_THREADS || pitch % 2 != 0 || pitch < held_words + 4) {
    return cudaErrorInvalidValue;
  }
  g.pitch = pitch;
  g.rows = tile_rows + 2 * halo < H ? tile_rows + 2 * halo : H;
  const int64_t tiles = (int64_t)B * g.ty * g.tx;
  if (grid > tiles) return cudaErrorInvalidValue;
  const size_t bytes = (3 * (size_t)(g.rows + 2) * g.pitch + (size_t)(B + 31) / 32 + GLOBAL_RED) *
                       sizeof(uint32_t);
  int dev = 0, n_sm = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin || tiles > (int64_t)1 << 30) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(grow_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grow_global_kernel,
                                                      GLOBAL_THREADS, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || grid > (int64_t)per_sm * n_sm) return cudaErrorInvalidConfiguration;
  g.resident = tiles <= grid;
  const int vec = W % 16 == 0 && aligned(image, 16) && aligned(seeds, 16) &&
                  aligned(mask, 16) && (valid == nullptr || aligned(valid, 16));
  const int conn8 = connectivity == 8 ? 1 : 0;
  // the cooperative launch as a launch attribute, which stream capture
  // records as a cooperative kernel node: the serving graphs hold this kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(GLOBAL_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grow_global_kernel, image, seeds, valid, mask, conv, steps,
                           band, buf0, buf1, scratch, B, H, W, low, high, conn8, block_iters,
                           max_iters, vec, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
