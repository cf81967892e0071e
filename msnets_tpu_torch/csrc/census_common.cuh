// Census descriptors and column tiles for Hopper (sm_90a), shared by
// census.cu and census_aml.cu.
//
// Replaces the descriptor packing of the TPU kernels,
// msnets_tpu/ops/pallas/census_pallas.py (_pack_descriptors): the census bits
// of each pixel (wsize x wsize window, row-major, bit k = centre <
// neighbour_k, at most 11x11 = 121 bits) in one 16-byte uint4.
//
// Design. Both cost kernels work on tiles of one image row: a block of
// kThreads threads owns kTileW output columns [c0, c0 + kTileW) of row r,
// one column per lane, and its kDGroups warp groups split the disparities
// (d = q, q + kDGroups, ...). There is no pack kernel and no descriptor
// scratch in device memory: the block builds its descriptors itself, in
// shared memory (build_tile):
//   * stage_rows copies the wsize image rows around r, over the columns the
//     descriptors need plus the window's halo, with coalesced byte loads,
//     both images under one barrier;
//   * each thread then builds whole descriptors from the staged rows
//     (descriptor: one shared-memory byte load, one subtraction and one
//     funnel shift a bit, four independent words), the kTileW left ones of
//     the tile and the kTileW + n - 1 right ones of a chunk of n <= kDChunk
//     disparities, so that a disparity shift is an index into shared memory.
// The right descriptors of neighbouring tiles overlap: a tile builds
// 2 kTileW + D - 1 descriptors for kTileW pixels (3.5 a pixel at kTileW =
// 64, D = 96, against 2 for a separate pack kernel), from shared memory.
//
// The disparities a tile needs are dk = min(ndisp, cmax - wc + 1), cmax the
// tile's last valid column; d >= dk is INVALID for every pixel of the tile,
// and a row outside [wc, H - wsize + wc) has dk = 0 (nothing is built).
//
// Build with -DMSN_PHASES=1 to record each block's phase times (MSN_PHASE,
// read by chip_smoke.py's last phase); without it they compile to nothing.
//
// Border note. JAX builds the bits with jnp.roll, which wraps around the
// image border; stage_rows clamps the row and column instead. Every entry
// inside the valid mask reads only in-image windows (valid rows
// [wc, H-w+wc) and cols [wc, W-w+wc) keep the window inside the image, and
// d <= c - wc keeps the right window inside too), so the clamp changes only
// descriptors whose costs are INVALID anyway.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace msn {

constexpr float kInvalid = 2147483648.0f;   // float32(RAND_MAX)
constexpr int kThreads = 256;
constexpr int kTileW = 64;                  // output columns per block
static_assert(kTileW % 32 == 0 && kTileW <= kThreads && kThreads % kTileW == 0,
              "a tile of whole warps, the block a whole number of tiles");
constexpr int kColGroups = kTileW / 32;     // warps across the tile
constexpr int kDGroups = kThreads / kTileW; // warps across the disparities
constexpr int kMinBlocks = 4;               // __launch_bounds__: <= 64 registers
constexpr int kDChunk = 256;                // disparities per right build
constexpr uint8_t kInvalidCost = 255;       // Hamming distances are <= 121

#ifdef MSN_PHASES
// Phase i of block b ends at g_phase[i][b] (%globaltimer, ns; thread 0).
constexpr int kPhases = 8, kPhaseBlocks = 16384;
__device__ unsigned long long g_phase[kPhases][kPhaseBlocks];
#define MSN_PHASE(i)                                                       \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < msn::kPhaseBlocks) {              \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      msn::g_phase[i][blockIdx.x] = t_;                                    \
    }                                                                      \
  } while (0)
#define MSN_PHASES_READ(fn)                                                \
  extern "C" int fn(void* dst) {                                           \
    return static_cast<int>(                                               \
        cudaMemcpyFromSymbol(dst, msn::g_phase, sizeof(msn::g_phase)));    \
  }
#else
#define MSN_PHASE(i) do {} while (0)
#define MSN_PHASES_READ(fn)
#endif

__host__ __device__ constexpr int pad16(int bytes) { return (bytes + 15) & ~15; }

// Shared-memory layout of one block (offsets in bytes, 16-aligned):
// left descriptors, right descriptors of one chunk, `fbytes` bytes of the
// kernel's own floats, the staged left and right rows, `keep` bytes.
struct Layout {
  int desc_l = 0, desc_r = 0, floats = 0, rows_l = 0, rows_r = 0, keep = 0,
      total = 0;
  __host__ __device__ constexpr Layout(int wsize, int nchunk, int fbytes,
                                       int keep_bytes) {
    const int halo = wsize - 1;
    desc_l = 0;
    desc_r = desc_l + 16 * kTileW;
    floats = desc_r + 16 * (kTileW + nchunk - 1);
    rows_l = floats + pad16(fbytes);
    rows_r = rows_l + pad16(wsize * (kTileW + halo));
    keep = rows_r + pad16(wsize * (kTileW + nchunk - 1 + halo));
    total = keep + pad16(keep_bytes);
  }
};

// The block's tile: row r, first column c0, disparities dk that hold a valid
// entry, and this thread's tile column tcol, image column c, disparity group
// q and last valid disparity dmax (-1: none).
struct Tile {
  int r, c0, dk, tcol, c, q, dmax;
};

__host__ __device__ inline int64_t tile_count(int H, int W) {
  return static_cast<int64_t>(H) * ((W + kTileW - 1) / kTileW);
}

__device__ __forceinline__ Tile tile_of(int H, int W, int ndisp, int wsize) {
  const int wc = wsize / 2;
  const unsigned tiles = (W + kTileW - 1) / kTileW;
  Tile t;
  t.r = static_cast<int>(blockIdx.x / tiles);
  t.c0 = static_cast<int>(blockIdx.x % tiles) * kTileW;
  const int warp = threadIdx.x / 32;
  t.tcol = (warp % kColGroups) * 32 + threadIdx.x % 32;
  t.q = warp / kColGroups;
  t.c = t.c0 + t.tcol;
  const bool row_ok = t.r >= wc && t.r < H - wsize + wc;
  const int col_end = W - wsize + wc;                    // valid cols [wc, col_end)
  const int cmax = min(t.c0 + kTileW, col_end) - 1;
  t.dk = row_ok && cmax >= max(t.c0, wc) ? min(ndisp, cmax - wc + 1) : 0;
  const bool pixel_ok = row_ok && t.c >= wc && t.c < col_end;
  t.dmax = pixel_ok ? min(ndisp - 1, t.c - wc) : -1;
  return t;
}

// dst[i][j] = img[clamp(r - wc + i)][clamp(x0 + j)], i < WSIZE, j < n.
template <int WSIZE>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ img,
                                           int H, int W, int r, int x0, int n,
                                           uint8_t* dst) {
  constexpr int WC = WSIZE / 2;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int c = min(max(x0 + j, 0), W - 1);
#pragma unroll
    for (int i = 0; i < WSIZE; ++i)
      dst[i * n + j] = img[static_cast<int64_t>(min(max(r - WC + i, 0), H - 1)) * W + c];
  }
}

// The descriptor whose window starts at `win` (WSIZE rows of `pitch`
// bytes). Bit k is the sign of centre - neighbour_k, shifted in from the
// word's top bit down so that it ends at k % 32; the four words are
// independent chains.
template <int WSIZE>
__device__ __forceinline__ uint4 descriptor(const uint8_t* win, int pitch) {
  constexpr int WC = WSIZE / 2;
  constexpr int kBits = WSIZE * WSIZE;
  static_assert(kBits <= 128, "descriptor holds 128 bits");
  const int centre = win[WC * pitch + WC];
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 31; b >= 0; --b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 32 * q + b;                          // compile-time
      if (k < kBits) {
        const int diff = centre - static_cast<int>(win[(k / WSIZE) * pitch + k % WSIZE]);
        w[q] = __funnelshift_l(static_cast<uint32_t>(diff), w[q], 1);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Builds the tile's descriptors for disparities [e0, e0 + n): the kTileW
// left ones (only when `left`) and the kTileW + n - 1 right ones, right
// column c - d of tile column tcol being desc_r[tcol - d + e0 + n - 1].
// Starts with a barrier (the previous readers are done) and ends with one
// (the descriptors are visible).
template <int WSIZE>
__device__ __forceinline__ void build_tile(const uint8_t* __restrict__ iml,
                                           const uint8_t* __restrict__ imr,
                                           int H, int W, const Tile& t, int e0,
                                           int n, bool left, uint8_t* rows_l,
                                           uint8_t* rows_r, uint4* desc_l,
                                           uint4* desc_r) {
  constexpr int WC = WSIZE / 2;
  const int nl = left ? kTileW : 0, nr = kTileW + n - 1;
  __syncthreads();
  if (left) stage_rows<WSIZE>(iml, H, W, t.r, t.c0 - WC, kTileW + 2 * WC, rows_l);
  stage_rows<WSIZE>(imr, H, W, t.r, t.c0 - (e0 + n - 1) - WC, nr + 2 * WC, rows_r);
  __syncthreads();
  MSN_PHASE(1);
  for (int j = threadIdx.x; j < nl + nr; j += kThreads) {
    if (j < nl) desc_l[j] = descriptor<WSIZE>(rows_l + j, kTileW + 2 * WC);
    else desc_r[j - nl] = descriptor<WSIZE>(rows_r + j - nl, nr + 2 * WC);
  }
  __syncthreads();
  MSN_PHASE(2);
}

// float(c) for 0 <= c < 2^23, exactly, in full-rate arithmetic (the
// int-to-float conversion issues at a quarter of that rate, like __popc).
__device__ __forceinline__ float to_float(int c) {
  return __int_as_float(0x4B000000 | c) - 8388608.0f;
}

__device__ __forceinline__ int hamming(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

// Shared memory a block may use without opting in to more; each kernel
// asserts that its largest layout (wsize 11, a full chunk) fits.
constexpr int kSmemBytes = 48 * 1024;

// Calls f(std::integral_constant<int, WSIZE>{}) for an odd window 1..11 and
// returns its result; cudaErrorInvalidValue for any other window.
template <class F>
cudaError_t with_wsize(int wsize, F&& f) {
  switch (wsize) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 11: return f(std::integral_constant<int, 11>{});
    default: return cudaErrorInvalidValue;
  }
}

// The launch's grid, one block per (row, tile of kTileW columns);
// cudaErrorInvalidValue past the grid's limit.
inline cudaError_t grid_blocks(int H, int W, unsigned* blocks) {
  const int64_t n = tile_count(H, W);
  if (n > 0x7fffffff) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(n);
  return cudaSuccess;
}

// Disparities of the widest tile (dk <= this for every block).
inline int max_tile_disparities(int W, int ndisp, int wsize) {
  return std::max(0, std::min(ndisp, W - wsize));
}

}  // namespace msn
