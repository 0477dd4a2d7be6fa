// Hopper kernels for the masks around the growth: the seed grid with the
// valid mask before it, and the final cast, dilation and valid cut after it.
//
// Replace no Pallas kernel: the JAX package computes both with XLA ops
// (ops/seeds.py::seed_mask, core/image.py::valid_mask, the dilation of
// ops/morphology.py and ops/volume.py there), and the port ran them as
// eager torch ops, about 80 launches for the seeds and valid mask and 13 to
// 31 for the final dilation, each a few bytes of work a pixel. Both are pure
// functions of the true sizes `dims`, already on the card, and of the grown
// mask; these kernels make each stage one launch.
//
// * seed_valid_kernel: P planes of H x W, plane p with true size
//   (h, w) = dims[2 p], dims[2 p + 1]; writes the bool (0/1 byte) seed mask
//   of ops/seeds.py::seed_mask and the valid mask of core/image.py::
//   valid_mask. The seeds are the reference's (test_pipeline.cpp:79-106):
//   the centre (w/2, h/2), four offsets of w/8 and h/8 along the axes, and
//   the grid over [w/4, 3w/4) x [h/4, 3h/4) at steps of w/10 and h/10 (at
//   least 1), inside the true size. The torch ops divide int32 by floor
//   division and wrap on overflow; so do these (fdiv, wadd, wsub, wmul3), so
//   every int32 size, negative and tiny ones included, gives the same bits.
// * finish_kernel: reads the grown mask (uint8, or bool bytes: 0/1), takes
//   the max over the 'cross' footprint of radius R = morph_size / 2 (the
//   offsets with |dz| + |dr| + |dc| <= R of ops/neighborhood.py::
//   footprint_offsets in 2D, ops/volume.py::footprint_offsets_3d in 3D),
//   with everything outside the grid 0, and zeroes what lies outside the
//   plane's true size: `dilate(cast_uint8(seg), k) * valid` in 2D (each
//   plane on its own, dims a plane) and `dilate3d(...) * valid` in 3D
//   (planes of one volume are neighbours through z, one dims for all).
//   The max of bytes is the torch fold's max, so the bits are the same for
//   every odd and even morph_size, 1 included (radius 0: the cast and cut).
//
// Layout: runs of 4 bytes of a row (a 32-bit store where W % 4 == 0 and
// the buffers are 4-byte aligned, else byte by byte), RUNS of them a thread,
// neighbouring threads on neighbouring runs; the grid's x over a plane's
// runs and its y over the planes (a loop past 65,535); a CTA reads its
// plane's dims once, into shared memory. A CTA's life is mostly the dims
// read and a barrier, so each takes several runs: at one run a thread a
// 155-plane batch took 9,920 CTAs.
//
// Bound on the H100: bytes, and tiny. The seeds and valid write 2 bytes a
// pixel (3.3 MB for a TCIA study of 25 x 256 x 256; one 64 KB plane pair for
// a volume); the finish reads the grown mask once from HBM and writes the
// final mask once, 2 bytes a voxel (20 MB for 155 x 256 x 256): 1 to 6 us at
// 3.35 TB/s. The point is the launches: one a stage instead of 13 to 80.
// Where W % 4 == 0 and R <= 4 the finish takes each footprint row as three
// 32-bit loads (the run and the words either side, through the read-only
// cache) and shifts them across with funnel shifts, taking the max of 4
// bytes at once (__vmaxu4); elsewhere it loads byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUNS = 4;  // 4-byte runs a thread: fewer, longer-lived CTAs
constexpr int MAX_GRID_Y = 65535;
constexpr int VEC_MAX_RADIUS = 4;

// int32 arithmetic as the torch ops do it: wrapping, and floor division
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul3(int a) { return (int)(3u * (unsigned)a); }
__device__ __forceinline__ int fdiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One plane's seed constants (ops/seeds.py::seed_mask).
struct Seeds {
  int h, w, cx, cy, xp, xm, yp, ym, sx, sy, x0, x1, y0, y1;
};

__device__ __forceinline__ Seeds seeds_of(int h, int w) {
  Seeds s;
  s.h = h;
  s.w = w;
  s.cx = fdiv(w, 2);
  s.cy = fdiv(h, 2);
  const int ox = fdiv(w, 8), oy = fdiv(h, 8);
  s.xp = wadd(s.cx, ox);
  s.xm = wsub(s.cx, ox);
  s.yp = wadd(s.cy, oy);
  s.ym = wsub(s.cy, oy);
  s.sx = max(fdiv(w, 10), 1);
  s.sy = max(fdiv(h, 10), 1);
  s.x0 = fdiv(w, 4);
  s.y0 = fdiv(h, 4);
  s.x1 = fdiv(wmul3(w), 4);
  s.y1 = fdiv(wmul3(h), 4);
  return s;
}

// Seed bits (byte j: column c0 + j) of a 4-column run of row r. The row's
// terms are taken once a run, the grid's column phase (c - x0) mod sx once
// and then stepped: no division a pixel.
__device__ __forceinline__ uint32_t seed_run(const Seeds& s, int r, int c0) {
  if (r >= s.h) return 0u;
  const bool on_cy = r == s.cy;
  const bool cross_row = on_cy || r == s.yp || r == s.ym;  // the centre column's seeds
  const bool grid_row = r >= s.y0 && r < s.y1 && wsub(r, s.y0) % s.sy == 0;
  int m = 0;  // (c - x0) mod sx, floored, for c = c0 + j
  if (grid_row) {
    m = wsub(c0, s.x0) % s.sx;
    if (m < 0) m += s.sx;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    const bool fixed = (c == s.cx && cross_row) || ((c == s.xp || c == s.xm) && on_cy);
    const bool grid = grid_row && m == 0 && c >= s.x0 && c < s.x1;
    bits |= (uint32_t)((fixed || grid) && c < s.w) << (8 * j);
    m = m + 1 == s.sx ? 0 : m + 1;
  }
  return bits;
}

__global__ void __launch_bounds__(THREADS)
seed_valid_kernel(const int* __restrict__ dims, uint8_t* __restrict__ seeds,
                  uint8_t* __restrict__ valid, int P, int H, int W, int vec4) {
  __shared__ int hw[2];
  const int runs = (W + 3) / 4;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    if (threadIdx.x < 2) hw[threadIdx.x] = dims[2 * p + threadIdx.x];
    __syncthreads();
    const Seeds s = seeds_of(hw[0], hw[1]);
    __syncthreads();  // hw is rewritten for the next plane
    for (int k = 0; k < RUNS; ++k) {
      const int run = (blockIdx.x * RUNS + k) * THREADS + threadIdx.x;  // fits: plane_fits
      if (run >= H * runs) break;
      const int r = run / runs, c0 = (run - r * runs) * 4;
      const uint32_t sw = seed_run(s, r, c0);
      uint32_t vw = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) vw |= (uint32_t)(r < s.h && c0 + j < s.w) << (8 * j);
      const long long at = ((long long)p * H + r) * W + c0;
      if (vec4) {
        *reinterpret_cast<uint32_t*>(seeds + at) = sw;
        *reinterpret_cast<uint32_t*>(valid + at) = vw;
      } else {
        for (int j = 0; j < 4 && c0 + j < W; ++j) {
          seeds[at + j] = (uint8_t)(sw >> (8 * j));
          valid[at + j] = (uint8_t)(vw >> (8 * j));
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// The max of 4 output bytes of row r (columns c0..c0+3, W % 4 == 0, R <= 4)
// over the footprint rows of plane `plane` (z within its volume).
__device__ __forceinline__ uint32_t dilate_vec4(const uint8_t* __restrict__ seg, long long plane,
                                                int z, int depth, int r, int c0, int H, int W,
                                                int R, int RZ) {
  uint32_t acc = 0u;
  for (int dz = -RZ; dz <= RZ; ++dz) {
    if (z + dz < 0 || z + dz >= depth) continue;
    const int rz = R - abs(dz);
    for (int dr = -rz; dr <= rz; ++dr) {
      const int r2 = r + dr;
      if (r2 < 0 || r2 >= H) continue;
      const uint8_t* row = seg + ((plane + dz) * H + r2) * W + c0;
      const uint32_t c = load4(row);
      acc = __vmaxu4(acc, c);
      const int reach = rz - abs(dr);
      if (reach == 0) continue;
      const uint32_t left = c0 >= 4 ? load4(row - 4) : 0u;
      const uint32_t right = c0 + 4 < W ? load4(row + 4) : 0u;
      for (int k = 1; k <= reach; ++k) {
        acc = __vmaxu4(acc, __funnelshift_rc(c, right, 8 * k));  // columns c0 + k ..
        acc = __vmaxu4(acc, __funnelshift_lc(left, c, 8 * k));   // columns c0 - k ..
      }
    }
  }
  return acc;
}

// The same for one byte at column c, any W and R.
__device__ __forceinline__ uint32_t dilate_one(const uint8_t* __restrict__ seg, long long plane,
                                               int z, int depth, int r, int c, int H, int W,
                                               int R, int RZ) {
  uint32_t acc = 0u;
  for (int dz = -RZ; dz <= RZ; ++dz) {
    if (z + dz < 0 || z + dz >= depth) continue;
    const int rz = R - abs(dz);
    for (int dr = -rz; dr <= rz; ++dr) {
      const int r2 = r + dr;
      if (r2 < 0 || r2 >= H) continue;
      const uint8_t* row = seg + ((plane + dz) * H + r2) * W;
      const int reach = rz - abs(dr);
      const int lo = max(c - reach, 0), hi = min(c + reach, W - 1);
      for (int c2 = lo; c2 <= hi; ++c2) acc = max(acc, (uint32_t)__ldg(row + c2));
    }
  }
  return acc;
}

// P planes in volumes of `depth` (1 in 2D); the plane p's true size is
// dims entry (p / depth) * dims_step (dims_step 0: one size for all).
__global__ void __launch_bounds__(THREADS)
finish_kernel(const uint8_t* __restrict__ seg, const int* __restrict__ dims, int dims_step,
              uint8_t* __restrict__ out, int P, int depth, int H, int W, int R, int RZ,
              int vec4) {
  __shared__ int hw[2];
  const int runs = (W + 3) / 4;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    if (threadIdx.x < 2) hw[threadIdx.x] = dims[2 * (p / depth) * dims_step + threadIdx.x];
    __syncthreads();
    const int h = hw[0], w = hw[1];
    __syncthreads();  // hw is rewritten for the next plane
    const int z = p % depth;
    for (int k = 0; k < RUNS; ++k) {
      const int run = (blockIdx.x * RUNS + k) * THREADS + threadIdx.x;  // fits: plane_fits
      if (run >= H * runs) break;
      const int r = run / runs, c0 = (run - r * runs) * 4;
      const long long at = ((long long)p * H + r) * W + c0;
      if (vec4) {
        uint32_t keep = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) keep |= (r < h && c0 + j < w) ? 0xffu << (8 * j) : 0u;
        const uint32_t v = keep != 0u ? dilate_vec4(seg, p, z, depth, r, c0, H, W, R, RZ) : 0u;
        *reinterpret_cast<uint32_t*>(out + at) = v & keep;
      } else {
        for (int j = 0; j < 4 && c0 + j < W; ++j) {
          const int c = c0 + j;
          out[at + j] =
              (r < h && c < w) ? (uint8_t)dilate_one(seg, p, z, depth, r, c, H, W, R, RZ) : 0;
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Whether a plane of H x W is a shape the kernels take: its 4-byte runs
// counted in an int (a plane of up to 2^33 pixels).
bool plane_fits(int H, int W) {
  return H > 0 && W > 0 && (long long)H * ((W + 3) / 4) < (1LL << 31) - RUNS * THREADS;
}

// The grid for P planes of H x W: x over a plane's 4-byte runs, y over the
// planes (at most MAX_GRID_Y; the kernels loop past it).
dim3 grid_of(int P, int H, int W) {
  const long long runs = (long long)H * ((W + 3) / 4);
  return dim3((unsigned)((runs + RUNS * THREADS - 1) / (RUNS * THREADS)),
              (unsigned)(P < MAX_GRID_Y ? P : MAX_GRID_Y));
}

}  // namespace

// The seed and valid masks of P planes of H x W from int32 `dims` (P, 2),
// contiguous bool (0/1 byte) outputs (P, H, W).
extern "C" int nm03_seed_valid(const int* dims, uint8_t* seeds, uint8_t* valid, int P, int H,
                               int W, void* stream) {
  (void)cudaGetLastError();  // clear an error already reported by an earlier call
  if (P < 1 || !plane_fits(H, W)) return cudaErrorInvalidValue;
  const int vec4 = W % 4 == 0 && aligned(seeds, 4) && aligned(valid, 4);
  seed_valid_kernel<<<grid_of(P, H, W), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dims, seeds, valid, P, H, W, vec4);
  return cudaGetLastError();
}

// The final mask of P planes of H x W in volumes of `depth` planes: the
// grown mask `seg` (uint8 or bool bytes) dilated by the cross of radius R
// in-plane and RZ (0 or R) through z, cut to each plane's true size (dims
// entry (p / depth) * dims_step), into contiguous uint8 `out`.
extern "C" int nm03_finish(const uint8_t* seg, const int* dims, int dims_step, uint8_t* out,
                           int P, int depth, int H, int W, int R, int RZ, void* stream) {
  (void)cudaGetLastError();
  if (P < 1 || !plane_fits(H, W) || depth < 1 || P % depth != 0 || R < 0 ||
      (RZ != 0 && RZ != R) || (dims_step != 0 && dims_step != 1)) {
    return cudaErrorInvalidValue;
  }
  const int vec4 = W % 4 == 0 && R <= VEC_MAX_RADIUS && aligned(seg, 4) && aligned(out, 4);
  finish_kernel<<<grid_of(P, H, W), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seg, dims, dims_step, out, P, depth, H, W, R, RZ, vec4);
  return cudaGetLastError();
}
