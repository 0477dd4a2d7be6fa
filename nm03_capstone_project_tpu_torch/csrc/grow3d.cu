// Hopper kernels for the 3D seeded region growing of process_volume.
//
// Replaces no Pallas kernel: the JAX package computes the 3D growth with
// XLA ops (ops/volume.py::region_grow_3d there), and the port ran it as
// torch ops, about 11 eager launches a dilation step over the whole volume
// (a 155 x 256 x 256 study: 48 steps, ~530 launches, ~12 ms of elementwise
// kernels on the card and as long again of host launching). These kernels
// run the same fixpoint in three launches a growth: one packs the inputs,
// one cooperative launch runs every block of steps and decides on the card
// when to stop, one unpacks the mask. The host reads nothing back: the
// wrapper returns as soon as the three are enqueued.
//
// Semantics, as ops/volume.py::region_grow_3d: band = (x >= low) & (x <= high)
// & valid, low/high compared as float32 (a NaN is out of band); region0 =
// seeds & band; each step is region <- (centre | its 6 face neighbours, or
// all 26 for connectivity 26) & band, with neighbours outside the (D, H, W)
// volume 0 on all three axes; leading batch axes are independent volumes.
// Steps are Jacobi: each reads one buffer and writes the other. The
// schedule: one unconditional block of `block_iters` steps, then blocks
// while the last one changed a voxel and fewer than `max_iters` steps ran.
//
// Layout (grow3d_layout in ops/hopper_volume.py computes the same): band and
// the two region buffers bit-packed, 32 voxels a word along W (bit b of word
// i of a row is voxel 32 i + b), each row led by one zero word, each plane
// by one zero row, each volume by one zero plane, with one zero plane after
// the last volume and FRONT zero words before the first and after that:
//
//   row pitch RP = ceil(W / 32) + 1, plane pitch PL = (H + 1) RP,
//   voxel word (b, z, y, i) at FRONT + ((b (D + 1) + z + 1) (H + 1) + y + 1) RP + i + 1,
//   FRONT = RP + 33 rounded up to 32, total = 2 FRONT + (B (D + 1) + 1) PL.
//
// A neighbour past a row, plane or volume is then a zero word in its place,
// and every word of the border has band 0, so a step runs the same few
// loads and ORs on every word of [FRONT + PL, FRONT + B (D + 1) PL), rounded
// out to whole warps, with no test of where it is: the border stays 0.
// 155 x 256 x 256 takes 1.44 MB a buffer, so the band and both region
// buffers stay in the 50 MB L2 for the whole growth.
//
// A growth's state is STATE_WORDS int32 words on the card: FLAG (the number
// of the last block in which some word changed, 0 for none), STEPS (the
// steps run), CUR (the buffer that holds the region: 0 or 1) and BLOCKS
// (the blocks run). The pack zeroes them, the run writes them, the unpack
// and the wrapper's caller read them on the card.
//
// * grow3d_pack_kernel: one warp a padded row; reads the float32 volume
//   once (a lane a voxel, 128 bytes a warp), seeds and valid through their
//   element strides (expanded views of one plane are not materialised),
//   and writes the band and seeds & band into both region buffers by
//   warp ballots; every border word 0; the state 0.
// * grow3d_kernel: one cooperative launch runs the whole fixpoint, a
//   persistent grid sized to co-residency, one grid barrier after every
//   step; grow3d_block runs a block's steps. A warp steps 32 consecutive words: the row's word and its
//   horizontal dilation (neighbour words by shuffles, the warp's two edge
//   words loaded), the rows above and below, the planes before and after
//   (for 26: the horizontal dilation of all nine rows), AND the band.
//   Region reads bypass L1 (__ldcg): other SMs wrote them before the
//   barrier. The growth is monotone (region0 is in the band and a dilation
//   holds its centre), so "the popcount changed over the block" is exactly
//   "some word changed in some step": each CTA ORs its threads' and, if
//   so, writes the block's number into FLAG before the block's last
//   barrier; past it every thread reads FLAG (a volatile load) and every
//   CTA takes the same decision. The flag replaces the two popcounts of the torch loop and
//   the host's read of them.
// * grow3d_unpack_kernel: one warp a row of the (B, D, H, W) uint8 mask,
//   4 voxels a lane (one 32-bit store) where W % 4 == 0, from the buffer
//   CUR names, and the 0-d converged flag (FLAG != BLOCKS: the last block
//   changed nothing).
//
// Bound on the H100: bytes. Only the pack's read of the float32 volume (4 N
// bytes for N voxels) and the unpack's write of the mask (N) reach HBM:
// 50.8 MB at 155 x 256 x 256, 15.2 us at 3.35 TB/s. A step reads the region
// and the band and writes a region, 3 N / 8 bytes (3.81 MB there), all in
// L2. The step's work is a few ORs a word, so past the bytes the time is
// the grid barrier after each step (the fixpoint is sequential in its
// depth) and the loads' L2 latency, which the persistent grid hides with
// every warp the SMs hold. All offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PACK_THREADS = 256;
constexpr int GROW_THREADS = 512;
constexpr int UNPACK_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// The growth's state words (the top of this file).
enum { FLAG = 0, STEPS = 1, CUR = 2, BLOCKS = 3, STATE_WORDS = 4 };

struct Layout {
  long long rp, pl, front, planes, total;
  long long lo, chunks;  // the stepped words: [lo, lo + 32 chunks)
};

// The layout of the top of this file, for B volumes of D x H x W.
Layout layout_of(int B, int D, int H, int W) {
  Layout g;
  g.rp = (W + 31) / 32 + 1;
  g.pl = (long long)(H + 1) * g.rp;
  g.front = (g.rp + 33 + 31) / 32 * 32;
  g.planes = (long long)B * (D + 1) + 1;
  g.total = 2 * g.front + g.planes * g.pl;
  const long long lo = g.front + g.pl, hi = g.front + (g.planes - 1) * g.pl;
  g.lo = lo / 32 * 32;
  g.chunks = ((hi + 31) / 32 * 32 - g.lo) / 32;
  return g;
}

// Element strides of a (B, D, H, W) view.
struct Strides {
  long long b, z, y, x;
};

__device__ __forceinline__ uint32_t hdilate(uint32_t c, uint32_t l, uint32_t r) {
  return c | (c << 1) | (l >> 31) | (c >> 1) | (r << 31);
}

// Byte j of the result holds bit j of x (j < 4), as 0 or 1.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__global__ void __launch_bounds__(PACK_THREADS)
grow3d_pack_kernel(const float* __restrict__ pre, const uint8_t* __restrict__ seeds, Strides ss,
                   const uint8_t* __restrict__ valid, Strides vs, uint32_t* __restrict__ band,
                   uint32_t* __restrict__ buf0, uint32_t* __restrict__ buf1,
                   int* __restrict__ state, int B, int D, int H, int W, float low, float high,
                   Layout g) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int WW = (int)g.rp - 1;
  if (warp == 0 && lane < STATE_WORDS) state[lane] = 0;
  // the front and back margins: zero
  for (long long w = warp * 32 + lane; w < 2 * g.front; w += warps * 32) {
    const long long at = w < g.front ? w : g.total - 2 * g.front + w;
    band[at] = 0u;
    buf0[at] = 0u;
    buf1[at] = 0u;
  }
  const long long rows = g.planes * (H + 1);
  for (long long pr = warp; pr < rows; pr += warps) {
    const long long pp = pr / (H + 1);
    const int y = (int)(pr - pp * (H + 1)) - 1;
    const long long b = pp / (D + 1);
    const int z = (int)(pp - b * (D + 1)) - 1;
    const long long row = g.front + pr * g.rp;  // its zero word
    if (y < 0 || z < 0 || b >= B) {  // a border row
      for (long long i = lane; i < g.rp; i += 32) {
        band[row + i] = 0u;
        buf0[row + i] = 0u;
        buf1[row + i] = 0u;
      }
      continue;
    }
    if (lane == 0) {
      band[row] = 0u;
      buf0[row] = 0u;
      buf1[row] = 0u;
    }
    const float* px = pre + ((b * D + z) * (long long)H + y) * W;
    const uint8_t* sp = seeds + b * ss.b + z * ss.z + y * ss.y;
    const uint8_t* vp = valid != nullptr ? valid + b * vs.b + z * vs.z + y * vs.y : nullptr;
#pragma unroll 4
    for (int i = 0; i < WW; ++i) {
      const int x = i * 32 + lane;
      bool in = false, seed = false;
      if (x < W) {
        const float v = px[x];
        in = v >= low && v <= high && (vp == nullptr || vp[x * vs.x] != 0);
        seed = sp[x * ss.x] != 0;
      }
      const uint32_t bw = __ballot_sync(FULL, in);
      const uint32_t sw = __ballot_sync(FULL, seed) & bw;
      if (lane == 0) {
        band[row + 1 + i] = bw;
        buf0[row + 1 + i] = sw;
        buf1[row + 1 + i] = sw;
      }
    }
  }
}

// The word at p and its horizontal dilation, for a warp on 32 consecutive
// words: the neighbours by shuffles, the warp's two edge words loaded.
__device__ __forceinline__ uint32_t row_dilate(const uint32_t* p, int lane, uint32_t& c) {
  c = __ldcg(p);
  const uint32_t le = lane == 0 ? __ldcg(p - 1) : 0u;
  const uint32_t re = lane == 31 ? __ldcg(p + 1) : 0u;
  uint32_t l = __shfl_up_sync(FULL, c, 1);
  uint32_t r = __shfl_down_sync(FULL, c, 1);
  if (lane == 0) l = le;
  if (lane == 31) r = re;
  return hdilate(c, l, r);
}

// One block of `steps` Jacobi steps from buf_a (the region is in buf_b after
// an odd number of steps, in buf_a after an even one), one grid barrier
// between steps; whether some word of this thread changed. The parity of
// the step picks the buffers: with the buffers picked by a flag carried
// across blocks instead, a step took 4.0 us on an H100 at 155 x 256 x 256,
// against 3.1 us so.
template <bool CONN26>
__device__ __forceinline__ bool grow3d_block(const uint32_t* __restrict__ band, uint32_t* buf_a,
                                             uint32_t* buf_b, int steps, const Layout& g,
                                             cg::grid_group& grid) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  bool changed = false;
  for (int t = 0; t < steps; ++t) {
    const uint32_t* cur = (t & 1) ? buf_b : buf_a;
    uint32_t* nxt = (t & 1) ? buf_a : buf_b;
    for (long long k = warp; k < g.chunks; k += warps) {
      const long long w = g.lo + k * 32 + lane;
      uint32_t c, grown;
      if (CONN26) {
        grown = row_dilate(cur + w, lane, c);
#pragma unroll
        for (int o = 0; o < 8; ++o) {  // the other eight rows of the 3 x 3 around it
          const int at = o + (o >= 4), dz = at / 3 - 1, dy = at % 3 - 1;
          uint32_t v;
          grown |= row_dilate(cur + w + dz * g.pl + dy * g.rp, lane, v);
        }
      } else {
        const uint32_t n = __ldcg(cur + w - g.rp), s = __ldcg(cur + w + g.rp);
        const uint32_t a = __ldcg(cur + w - g.pl), z = __ldcg(cur + w + g.pl);
        grown = row_dilate(cur + w, lane, c) | n | s | a | z;
      }
      const uint32_t out = grown & __ldg(band + w);
      changed |= out != c;
      nxt[w] = out;
    }
    if (t + 1 < steps) grid.sync();
  }
  return changed;
}

template <bool CONN26>
__global__ void __launch_bounds__(GROW_THREADS)
grow3d_kernel(const uint32_t* __restrict__ band, uint32_t* buf0, uint32_t* buf1,
              int* state, int block_iters, long long max_iters, Layout g) {
  cg::grid_group grid = cg::this_grid();
  int cur = 0, block = 0;  // the region is in buf0 (cur 0) or buf1; blocks run
  long long steps = 0;
  for (;;) {
    ++block;
    const bool changed = grow3d_block<CONN26>(band, cur ? buf1 : buf0, cur ? buf0 : buf1,
                                              block_iters, g, grid);
    cur ^= block_iters & 1;
    steps += block_iters;
    if (__syncthreads_or(changed) && threadIdx.x == 0) state[FLAG] = block;
    grid.sync();
    // a volatile read, past the barrier and L1; ">=", not "==": a CTA that
    // went on may write block + 1 before a slower one reads, which it does
    // only where this block changed a word
    if (*(volatile int*)(state + FLAG) < block || steps >= max_iters) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[STEPS] = (int)steps;
    state[CUR] = cur;
    state[BLOCKS] = block;
  }
}

__global__ void __launch_bounds__(UNPACK_THREADS)
grow3d_unpack_kernel(const uint32_t* __restrict__ buf0, const uint32_t* __restrict__ buf1,
                     const int* __restrict__ state, uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ conv, int B, int D, int H, int W, int vec4, Layout g) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const uint32_t* region = state[CUR] ? buf1 : buf0;
  if (warp == 0 && lane == 0) *conv = state[FLAG] != state[BLOCKS];
  const long long rows = (long long)B * D * H;
  for (long long r = warp; r < rows; r += warps) {
    const long long bz = r / H;
    const int y = (int)(r - bz * H);
    const long long b = bz / D;
    const int z = (int)(bz - b * D);
    const uint32_t* src = region + g.front + ((b * (D + 1) + z + 1) * (H + 1) + y + 1) * g.rp + 1;
    uint8_t* dst = mask + r * W;
    if (vec4) {
      for (int x = 4 * lane; x < W; x += 128) {
        const uint32_t word = __ldcg(src + (x >> 5));
        *reinterpret_cast<uint32_t*>(dst + x) = spread4(word >> (x & 31));
      }
    } else {
      for (int x = lane; x < W; x += 32) dst[x] = (__ldcg(src + (x >> 5)) >> (x & 31)) & 1u;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Whether B volumes of D x H x W are a shape the kernels take, with `words`
// words a buffer as the layout gives them (the wrapper allocates by its own
// copy of the layout: a mismatch is refused, not written past).
bool valid_shape(int B, int D, int H, int W, long long words) {
  return B > 0 && D > 0 && H > 0 && W > 0 && words == layout_of(B, D, H, W).total;
}

// Blocks of `threads` for `warps_needed` warps, at most `cap`, at least one.
unsigned blocks_for(long long warps_needed, int threads, long long cap) {
  long long n = (warps_needed * 32 + threads - 1) / threads;
  if (n > cap) n = cap;
  return (unsigned)(n < 1 ? 1 : n);
}

}  // namespace

// Pack B volumes of D x H x W: `pre` float32 contiguous; `seeds` and
// `valid` uint8 read at b s_b + z s_z + y s_y + x s_x (valid may be null:
// every voxel valid); `band`, `buf0`, `buf1` `words` uint32 words each (the
// layout's total); `state` STATE_WORDS int32, set to 0.
extern "C" int nm03_grow3d_pack(const float* pre, const uint8_t* seeds, long long s_b,
                                long long s_z, long long s_y, long long s_x,
                                const uint8_t* valid, long long v_b, long long v_z,
                                long long v_y, long long v_x, uint32_t* band, uint32_t* buf0,
                                uint32_t* buf1, int* state, int B, int D, int H, int W,
                                long long words, float low, float high, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (!valid_shape(B, D, H, W, words)) return cudaErrorInvalidValue;
  const Layout g = layout_of(B, D, H, W);
  const Strides ss = {s_b, s_z, s_y, s_x}, vs = {v_b, v_z, v_y, v_x};
  const unsigned blocks = blocks_for(g.planes * (H + 1), PACK_THREADS, 1 << 20);
  grow3d_pack_kernel<<<blocks, PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pre, seeds, ss, valid, vs, band, buf0, buf1, state, B, D, H, W, low, high, g);
  return cudaGetLastError();
}

// The whole fixpoint from the packed region in `buf0`, connectivity 6 or
// 26: blocks of `block_iters` Jacobi steps between `buf0` and `buf1`, the
// first unconditional, the next while the last changed a word and fewer
// than `max_iters` steps ran; `state` (STATE_WORDS int32, zeroed by the
// pack) then holds the last changing block, the steps, the buffer that
// holds the region and the blocks. One cooperative launch: one warp a
// 32-word chunk, at most two CTAs an SM and as many as the SMs hold at once.
extern "C" int nm03_grow3d_run(const uint32_t* band, uint32_t* buf0, uint32_t* buf1, int* state,
                               int B, int D, int H, int W, long long words, int connectivity,
                               int block_iters, long long max_iters, void* stream) {
  (void)cudaGetLastError();
  if (!valid_shape(B, D, H, W, words) || block_iters < 1 || max_iters < 1 ||
      (connectivity != 6 && connectivity != 26)) {
    return cudaErrorInvalidValue;
  }
  const Layout g = layout_of(B, D, H, W);
  const void* fn = connectivity == 26 ? (const void*)grow3d_kernel<true>
                                      : (const void*)grow3d_kernel<false>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, GROW_THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)per_sm * n_sm;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  // two CTAs an SM at most: more make each grid barrier dearer than the
  // latency they hide (155 x 256 x 256, 16 steps: 0.081 ms at 264 CTAs,
  // 0.090 at 528)
  const long long cap = resident < 2LL * n_sm ? resident : 2LL * n_sm;
  const unsigned blocks = blocks_for(g.chunks, GROW_THREADS, cap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(GROW_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (connectivity == 26) {
    err = cudaLaunchKernelEx(&cfg, grow3d_kernel<true>, band, buf0, buf1, state, block_iters,
                             max_iters, g);
  } else {
    err = cudaLaunchKernelEx(&cfg, grow3d_kernel<false>, band, buf0, buf1, state, block_iters,
                             max_iters, g);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The uint8 {0, 1} mask of B volumes of D x H x W (contiguous) from the
// packed region in the buffer `state` names (after nm03_grow3d_run), and
// `conv` (one byte, a bool): the last block changed nothing.
extern "C" int nm03_grow3d_unpack(const uint32_t* buf0, const uint32_t* buf1, const int* state,
                                  uint8_t* mask, uint8_t* conv, int B, int D, int H, int W,
                                  long long words, void* stream) {
  (void)cudaGetLastError();
  if (!valid_shape(B, D, H, W, words)) return cudaErrorInvalidValue;
  const Layout g = layout_of(B, D, H, W);
  const int vec4 = W % 4 == 0 && aligned(mask, 4);
  const unsigned blocks = blocks_for((long long)B * D * H, UNPACK_THREADS, 1 << 20);
  grow3d_unpack_kernel<<<blocks, UNPACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      buf0, buf1, state, mask, conv, B, D, H, W, vec4, g);
  return cudaGetLastError();
}
