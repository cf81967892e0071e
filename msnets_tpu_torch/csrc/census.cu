// Census Hamming cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel msnets_tpu/ops/pallas/census_pallas.py
// (census_pallas, body _census_kernel, descriptors from _pack_descriptors).
// It computes the raw census cost volume that the 16-channel feature stage
// re-indexes to the right view:
//   cost[d, r, c] = popcount(dl[r, c] ^ dr[r, c - d]) summed over the 4
//                   descriptor words, as float32,
// or INVALID outside the reference valid region (rows [wc, H-w+wc), cols
// [wc, W-w+wc), d <= c - wc).
//
// Design. The Pallas version tiles rows by `row_tile` and disparities by
// `d_chunk`, and pre-shifts the right descriptors in HBM once per chunk, so
// that every shift inside the kernel is a static slice for Mosaic. Here one
// block covers one (row, tile of kTileW columns) and all of D
// (census_common.cuh): it builds the tile's descriptors in shared memory
// from staged image rows, then each warp group walks its disparities
// (d = q, q + kDGroups, ...) and writes each D-major plane coalesced along
// W, one thread per column: the valid ones, d <= dmax, as popcounts, the
// rest as INVALID without computing anything. The shift by d is an index
// into the shared right descriptors, built kDChunk disparities at a time,
// so any ndisp fits in a fixed amount of shared memory. A 148x276 image is
// 148 x 5 = 740 blocks of 256 threads.
// Integer popcounts, converted to float exactly: no fast math.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel is write-bound. At the
// serving path's shape, the half-resolution 128x256 pair plus its 10-px pad
// (H'=148, W'=276) with D=96, the float32 volume is 96 * 148 * 276 * 4 B =
// 15.7 MB, 4.7 us at 3.35 TB/s; at the KITTI bucket (212x644, D=96) it is
// 52.4 MB, 15.6 us. The popcounts issue at 16 per clock per SM (4.2 T/s at
// 1.98 GHz on 132 SMs): 4 per valid entry, 11.4 M at the serving shape,
// 2.7 us, and 45 M, 10.8 us, at the KITTI bucket: under the writes, but
// near them, and on one pipe with the int-to-float conversion that
// to_float avoids.
//
// Border note: see census_common.cuh (clamped windows against JAX's roll;
// only INVALID entries read them).

#include "census_common.cuh"

namespace {

using namespace msn;

template <int WSIZE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
census_tile(const uint8_t* __restrict__ iml, const uint8_t* __restrict__ imr,
            float* __restrict__ cost, int H, int W, int ndisp, int nchunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(WSIZE, nchunk, 0, 0);
  uint4* desc_l = reinterpret_cast<uint4*>(smem + L.desc_l);
  uint4* desc_r = reinterpret_cast<uint4*>(smem + L.desc_r);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const Tile t = tile_of(H, W, ndisp, WSIZE);
  MSN_PHASE(0);
  const bool in_image = t.c < W;
  float* out = cost + static_cast<int64_t>(t.r) * W + t.c;
  for (int e0 = 0; e0 < t.dk; e0 += nchunk) {
    const int n = min(nchunk, t.dk - e0);
    build_tile<WSIZE>(iml, imr, H, W, t, e0, n, e0 == 0, smem + L.rows_l,
                      smem + L.rows_r, desc_l, desc_r);
    const uint4 a = desc_l[t.tcol];
    const uint4* dr = desc_r + t.tcol + e0 + n - 1;        // dr[-d]
    const int dv = min(e0 + n - 1, t.dmax);                // last valid d here
    if (in_image) {
      int d = e0 + t.q;
#pragma unroll 4
      for (; d <= dv; d += kDGroups) out[d * plane] = to_float(hamming(a, dr[-d]));
      for (; d < e0 + n; d += kDGroups) out[d * plane] = kInvalid;
    }
  }
  if (in_image)
    for (int d = t.dk + t.q; d < ndisp; d += kDGroups) out[d * plane] = kInvalid;
  MSN_PHASE(3);
}

static_assert(Layout(11, kDChunk, 0, 0).total <= kSmemBytes,
              "the largest block fits the default shared memory");

template <int WSIZE>
cudaError_t launch(const uint8_t* iml, const uint8_t* imr, float* cost, int H,
                   int W, int ndisp, cudaStream_t stream) {
  const int nchunk =
      std::max(1, std::min(max_tile_disparities(W, ndisp, WSIZE), kDChunk));
  const Layout L(WSIZE, nchunk, 0, 0);
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(H, W, &blocks);
  if (err != cudaSuccess) return err;
  census_tile<WSIZE><<<blocks, kThreads, L.total, stream>>>(iml, imr, cost, H,
                                                           W, ndisp, nchunk);
  return cudaGetLastError();
}

}  // namespace

// Launches census_tile on `stream`. iml and imr are uint8 [H, W]; cost is
// [ndisp, H, W] float32. Returns cudaGetLastError() after the launch (0 on
// success; cudaErrorInvalidValue for an empty input or a window other than
// odd 1..11); does not synchronise.
extern "C" int msn_census(const void* iml, const void* imr, void* cost, int H,
                          int W, int ndisp, int wsize, void* stream) {
  if (H < 1 || W < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_wsize(wsize, [&](auto w) {
    return launch<decltype(w)::value>(static_cast<const uint8_t*>(iml),
                                      static_cast<const uint8_t*>(imr),
                                      static_cast<float*>(cost), H, W, ndisp,
                                      static_cast<cudaStream_t>(stream));
  }));
}

MSN_PHASES_READ(msn_census_phases)
