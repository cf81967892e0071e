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
// that every shift inside the kernel is a static slice for Mosaic. None of
// that is needed here:
//   * the pack kernel (census_common.cuh) writes each pixel's descriptor as
//     one 16-byte uint4;
//   * census_cost_planes gives each thread one output pixel, threads along W,
//     and walks a chunk of kDChunk disparities, writing each D-major plane
//     coalesced. blockIdx.y picks the chunk, so a 148x276 image is 160 x 6
//     blocks rather than 160, enough to fill the card's 132 SMs. The shift
//     by d is an index (drow[-d]); the right descriptors stay in L1/L2.
// Integer popcounts, one int->float conversion: exact, no fast math.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel is write-bound. At the
// serving path's shape, the half-resolution 128x256 pair plus its 10-px pad
// (H'=148, W'=276) with D=96, the float32 volume is 96 * 148 * 276 * 4 B =
// 15.7 MB, 4.7 us at 3.35 TB/s; at the KITTI bucket (212x644, D=96) it is
// 52.4 MB, 15.6 us. The ~12 integer operations per (d, pixel) are 47 M at
// the serving shape, under 1 us at the float32 rate.
//
// Border note: see census_common.cuh (clamped windows against JAX's roll;
// only INVALID entries read them).

#include "census_common.cuh"

namespace {

using msn::hamming;
using msn::kInvalid;
using msn::kThreads;

constexpr int kDChunk = 16;

// One thread per output pixel and chunk of disparities; cost is [D, H, W].
__global__ void census_cost_planes(const uint4* __restrict__ dl,
                                   const uint4* __restrict__ dr,
                                   float* __restrict__ cost, int H, int W,
                                   int ndisp, int wsize) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int d0 = static_cast<int>(blockIdx.y) * kDChunk;
  const int d1 = min(d0 + kDChunk, ndisp);
  const int r = static_cast<int>(idx / W);
  const int c = static_cast<int>(idx - static_cast<int64_t>(r) * W);
  const int wc = wsize / 2;
  const bool pixel_ok = r >= wc && r < H - wsize + wc && c >= wc &&
                        c < W - wsize + wc;
  // valid disparities are d in [0, dmax]; none when dmax < 0
  const int dmax = pixel_ok ? min(ndisp - 1, c - wc) : -1;
  const uint4 a = dl[idx];
  const uint4* drow = dr + static_cast<int64_t>(r) * W + c;   // drow[-d]
  float* out = cost + idx;
  for (int d = d0; d < d1; ++d)
    out[d * plane] = d <= dmax ? hamming(a, drow[-d]) : kInvalid;
}

}  // namespace

// Launches the pack kernel on both images, then census_cost_planes, on
// `stream`. dl and dr are caller-allocated [H, W, 4] 32-bit scratch (16-byte
// aligned); cost is [ndisp, H, W] float32. Returns cudaGetLastError() after
// the launches (0 on success); does not synchronise.
extern "C" int msn_census(const void* iml, const void* imr, void* dl,
                          void* dr, void* cost, int H, int W, int ndisp,
                          int wsize, void* stream) {
  if (H < 1 || W < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = msn::launch_pack(iml, imr, dl, dr, H, W, wsize, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  static_cast<unsigned>((ndisp + kDChunk - 1) / kDChunk));
  census_cost_planes<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(dl), static_cast<const uint4*>(dr),
      static_cast<float*>(cost), H, W, ndisp, wsize);
  return static_cast<int>(cudaGetLastError());
}
