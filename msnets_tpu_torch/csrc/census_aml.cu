// Fused census cost + AML likelihood for Hopper (sm_90a).
//
// Replaces the TPU kernel msnets_tpu/ops/pallas/census_aml_pallas.py
// (census_aml_pallas, body _kernel) together with the descriptor packing of
// msnets_tpu/ops/pallas/census_pallas.py (_pack_descriptors, shared with
// census.cu in census_common.cuh). It computes channels 0 and 4 of the
// matching-space feature volume:
//   cost[d, r, c] = clip(c_d, 0, 120) * (1 / 120)
//   aml[d, r, c]  = exp(-(c_d - min)^2 * (1 / sigma)) / sum_d exp(...)
//                   (0 where min is the INVALID sentinel)
// where c_d is the 11x11 census Hamming distance between left pixel (r, c)
// and right pixel (r, c - d), or INVALID outside the reference valid region
// (rows [wc, H-w+wc), cols [wc, W-w+wc), d <= c - wc).
//
// Design. The Pallas version walks row tiles in order on one TensorCore
// and keeps the [D, rows, W] cost tile in VMEM scratch. Here:
//   * kernel A (census_common.cuh) packs each pixel's census bits into one
//     16-byte uint4;
//   * kernel B gives each thread one output pixel, threads along W, so every
//     disparity plane is loaded and stored coalesced. It never keeps the D
//     costs: each of its three passes over d (min, sum of weights, write)
//     recomputes the Hamming distance from the descriptors, which stay in
//     L1/L2 (two images of 16 B per pixel).
// Numerics are those of the plain PyTorch version, which are XLA's: the
// divisions by the constants 120 and sigma are multiplies by their float32
// reciprocals (1/sigma comes from the caller), no fast math, the same min;
// only the order of the sum over d differs.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel is write-bound. At the
// serving path's shape, the half-resolution 128x256 pair plus its 10-px pad
// (H=148, W=276) with D=96, the two float32 outputs are
// 2 * 96 * 148 * 276 * 4 B = 31.4 MB, about 9.4 us at 3.35 TB/s; the two
// recomputing passes do ~31 M __popc, well under that time.
//
// Left for later: wgmma has no role here (no matrix product). The next
// steps are staging each row's right descriptors in shared memory, and
// writing bf16 straight into the feature volume instead of two float32
// planes that the caller trims and stacks.

#include "census_common.cuh"

namespace {

using msn::hamming;
using msn::kInvalid;
using msn::kThreads;

// Kernel B: one thread per output pixel; outputs are [D, H, W].
__global__ void census_aml_planes(const uint4* __restrict__ dl,
                                  const uint4* __restrict__ dr,
                                  float* __restrict__ cost,
                                  float* __restrict__ aml, int H, int W,
                                  int ndisp, int wsize, float inv_sigma) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int r = static_cast<int>(idx / W);
  const int c = static_cast<int>(idx - static_cast<int64_t>(r) * W);
  const int wc = wsize / 2;
  const bool pixel_ok = r >= wc && r < H - wsize + wc && c >= wc &&
                        c < W - wsize + wc;
  // valid disparities are d in [0, dmax]; none when dmax < 0
  const int dmax = pixel_ok ? min(ndisp - 1, c - wc) : -1;
  const uint4 a = dl[idx];
  const uint4* drow = dr + static_cast<int64_t>(r) * W + c;   // drow[-d]

  // pass 1: minimum over d (INVALID entries never lower it)
  float mn = kInvalid;
  for (int d = 0; d <= dmax; ++d) mn = fminf(mn, hamming(a, drow[-d]));
  const bool row_invalid = mn >= kInvalid;

  // pass 2: sum of the AML weights, invalid entries included as the plain
  // version includes them
  float s = 0.0f;
  if (!row_invalid) {
    for (int d = 0; d < ndisp; ++d) {
      const float cd = d <= dmax ? hamming(a, drow[-d]) : kInvalid;
      const float num = cd - mn;
      s += expf(-(num * num) * inv_sigma);
    }
  }

  // pass 3: write both planes
  float* cp = cost + idx;
  float* ap = aml + idx;
  for (int d = 0; d < ndisp; ++d) {
    const float cd = d <= dmax ? hamming(a, drow[-d]) : kInvalid;
    float p = 0.0f;
    if (!row_invalid) {
      const float num = cd - mn;
      p = expf(-(num * num) * inv_sigma) / s;
    }
    cp[d * plane] = fminf(fmaxf(cd, 0.0f), 120.0f) * (1.0f / 120.0f);
    ap[d * plane] = p;
  }
}

}  // namespace

// Launches kernel A on both images, then kernel B, on `stream`. dl and dr
// are caller-allocated [H, W, 4] 32-bit scratch (16-byte aligned); cost and
// aml are [ndisp, H, W] float32; inv_sigma is float32(1) / float32(sigma).
// Returns cudaGetLastError() after the launches (0 on success); does not
// synchronise.
extern "C" int msn_census_aml(const void* iml, const void* imr, void* dl,
                              void* dr, void* cost, void* aml, int H, int W,
                              int ndisp, int wsize, float inv_sigma,
                              void* stream) {
  if (H < 1 || W < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = msn::launch_pack(iml, imr, dl, dr, H, W, wsize, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const unsigned blocks = static_cast<unsigned>((plane + kThreads - 1) / kThreads);
  census_aml_planes<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(dl), static_cast<const uint4*>(dr),
      static_cast<float*>(cost), static_cast<float*>(aml), H, W, ndisp, wsize,
      inv_sigma);
  return static_cast<int>(cudaGetLastError());
}
