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
// where c_d is the census Hamming distance between left pixel (r, c) and
// right pixel (r, c - d), or INVALID outside the reference valid region
// (rows [wc, H-w+wc), cols [wc, W-w+wc), d <= c - wc).
//
// Design. One block per (row, tile of kTileW columns), one column per lane,
// the disparities split over the block's warp groups (census_common.cuh).
// Like the Pallas kernel, which keeps the masked costs in a [D, Th, W] VMEM
// scratch, it computes each Hamming distance once and keeps the D costs on
// chip:
//   1. the block builds its left and right descriptors in shared memory from
//      staged image rows (no pack kernel, no descriptor scratch);
//   2. each thread computes the distances of its valid disparities once,
//      writes the cost plane, keeps them and keeps its minimum; the
//      per-pixel minimum is reduced across the warp groups through shared
//      memory. The distances of the first kKeep disparities are kept as
//      uint8 in shared memory ([min(dk, kKeep)][kTileW]); those of later
//      ones (ndisp > kKeep on an image wider than kKeep + wsize) as floats
//      in the thread's own entries of the AML plane, which step 4
//      overwrites, so any ndisp fits in a fixed amount of shared memory;
//   3. the weight of a valid entry depends only on the integer c_d - min in
//      [0, 121], so the block computes the 122 weights expf(-(k * k) *
//      (1 / sigma)) once into a table; an INVALID entry's weight
//      exp(-(INVALID - min)^2 / sigma) is one expf per pixel. The sum over d
//      is reduced like the minimum;
//   4. the AML plane is written one D-plane at a time, coalesced along W.
// A 148x276 image is 148 x 5 = 740 blocks of 256 threads.
//
// Numerics are those of the plain PyTorch version, which are XLA's: the
// divisions by the constants 120 and sigma are multiplies by their float32
// reciprocals (1/sigma comes from the caller), w / sum is a true division,
// no fast math, the same minimum. Every INVALID entry enters the sum, as in
// the plain version (its weight is 0 for the configured sigmas, but about
// 0.01 at sigma = 1e18). A table entry is bit-identical to the per-entry
// expf, because c_d - min and its square are exact in float32. Only the
// order of the sum over d differs.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel is write-bound. At the
// serving path's shape, the half-resolution 128x256 pair plus its 10-px pad
// (H=148, W=276) with D=96, the two float32 outputs are
// 2 * 96 * 148 * 276 * 4 B = 31.4 MB, 9.4 us at 3.35 TB/s. The popcounts,
// 4 per valid entry (11.4 M), and the exponentials issue at 16 per clock
// per SM (4.2 T/s at 1.98 GHz on 132 SMs), 3.6 us: under the writes. The
// division w / sum, a reciprocal on the same quarter-rate pipe and a range
// check per entry, and the passes over the kept costs are what the kernel
// spends beyond that (PERF.md, section 6).

#include "census_common.cuh"

namespace {

using namespace msn;

constexpr int kLut = 128;      // weights of c_d - min in [0, 121]
constexpr int kKeep = 512;     // disparities kept in shared memory
constexpr int kFloatBytes = 4 * (kLut + kDGroups * kTileW);
static_assert(Layout(11, kDChunk, kFloatBytes, kKeep * kTileW).total <= kSmemBytes,
              "the largest block fits the default shared memory");

template <int WSIZE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
census_aml_tile(const uint8_t* __restrict__ iml, const uint8_t* __restrict__ imr,
                float* __restrict__ cost, float* __restrict__ aml, int H, int W,
                int ndisp, float inv_sigma, int nchunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(WSIZE, nchunk, kFloatBytes, 0);
  uint4* desc_l = reinterpret_cast<uint4*>(smem + L.desc_l);
  uint4* desc_r = reinterpret_cast<uint4*>(smem + L.desc_r);
  float* lut = reinterpret_cast<float*>(smem + L.floats);
  float* red = lut + kLut;                                  // [kDGroups][kTileW]
  uint8_t* keep = smem + L.keep;                  // [min(dk, kKeep)][kTileW]
  const int64_t plane = static_cast<int64_t>(H) * W;
  const Tile t = tile_of(H, W, ndisp, WSIZE);
  MSN_PHASE(0);
  for (int k = threadIdx.x; k < kLut; k += kThreads) {      // read after a barrier
    const float kf = static_cast<float>(k);
    lut[k] = expf(-(kf * kf) * inv_sigma);
  }
  const bool in_image = t.c < W;
  float* cp = cost + static_cast<int64_t>(t.r) * W + t.c;
  float* ap = aml + static_cast<int64_t>(t.r) * W + t.c;
  const float cost_invalid = fminf(fmaxf(kInvalid, 0.0f), 120.0f) * (1.0f / 120.0f);

  // 1-2: the distances of d <= dmax, once each, the cost plane, and this
  // thread's minimum; d > dmax is INVALID (cost 1, nothing kept). d <= dmax
  // lies in the image, so ap[d * plane] is this thread's own entry.
  int mn = kInvalidCost;
  for (int e0 = 0; e0 < t.dk; e0 += nchunk) {
    const int n = min(nchunk, t.dk - e0);
    build_tile<WSIZE>(iml, imr, H, W, t, e0, n, e0 == 0, smem + L.rows_l,
                      smem + L.rows_r, desc_l, desc_r);
    const uint4 a = desc_l[t.tcol];
    const uint4* dr = desc_r + t.tcol + e0 + n - 1;         // dr[-d]
    const int dv = min(e0 + n - 1, t.dmax);                 // last valid d here
    int d = e0 + t.q;
#pragma unroll 4
    for (; d <= dv; d += kDGroups) {
      const int cd = hamming(a, dr[-d]);
      if (d < kKeep) keep[d * kTileW + t.tcol] = static_cast<uint8_t>(cd);
      else ap[d * plane] = to_float(cd);
      mn = min(mn, cd);
      cp[d * plane] = fminf(to_float(cd), 120.0f) * (1.0f / 120.0f);
    }
    if (in_image)
      for (; d < e0 + n; d += kDGroups) cp[d * plane] = cost_invalid;
  }
  if (in_image)
    for (int d = t.dk + t.q; d < ndisp; d += kDGroups) cp[d * plane] = cost_invalid;
  red[t.q * kTileW + t.tcol] = static_cast<float>(mn);
  __syncthreads();
  MSN_PHASE(3);
  for (int g = 0; g < kDGroups; ++g)
    mn = min(mn, static_cast<int>(red[g * kTileW + t.tcol]));
  const bool row_invalid = mn == kInvalidCost;
  const float num_inv = kInvalid - static_cast<float>(mn);
  const float w_inv = row_invalid ? 0.0f : expf(-(num_inv * num_inv) * inv_sigma);
  const float* lut_mn = lut - mn;         // weight of a kept cost c: lut_mn[c]
  const uint8_t* kept = keep + t.tcol;
  const int dkeep = min(t.dmax, kKeep - 1);       // last d kept in shared memory

  // 3: the sum of the weights over d, INVALID entries included
  float s = 0.0f;
  if (!row_invalid) {
    int d = t.q;
#pragma unroll 4
    for (; d <= dkeep; d += kDGroups) s += lut_mn[kept[d * kTileW]];
    for (; d <= t.dmax; d += kDGroups) s += lut_mn[static_cast<int>(ap[d * plane])];
    for (; d < ndisp; d += kDGroups) s += w_inv;
  }
  __syncthreads();                        // every minimum is read
  red[t.q * kTileW + t.tcol] = s;
  __syncthreads();
  s = 0.0f;
  for (int g = 0; g < kDGroups; ++g) s += red[g * kTileW + t.tcol];
  MSN_PHASE(4);

  // 4: the AML plane, one D-plane at a time
  if (in_image && row_invalid) {
    for (int d = t.q; d < ndisp; d += kDGroups) ap[d * plane] = 0.0f;
  } else if (in_image) {
    int d = t.q;
#pragma unroll 4
    for (; d <= dkeep; d += kDGroups) ap[d * plane] = lut_mn[kept[d * kTileW]] / s;
    for (; d <= t.dmax; d += kDGroups)
      ap[d * plane] = lut_mn[static_cast<int>(ap[d * plane])] / s;
    const float p_inv = w_inv / s;
    for (; d < ndisp; d += kDGroups) ap[d * plane] = p_inv;
  }
  MSN_PHASE(5);
}

template <int WSIZE>
cudaError_t launch(const uint8_t* iml, const uint8_t* imr, float* cost,
                   float* aml, int H, int W, int ndisp, float inv_sigma,
                   cudaStream_t stream) {
  const int dmax = max_tile_disparities(W, ndisp, WSIZE);
  const int nchunk = std::max(1, std::min(dmax, kDChunk));
  const Layout L(WSIZE, nchunk, kFloatBytes, std::min(dmax, kKeep) * kTileW);
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(H, W, &blocks);
  if (err != cudaSuccess) return err;
  census_aml_tile<WSIZE><<<blocks, kThreads, L.total, stream>>>(
      iml, imr, cost, aml, H, W, ndisp, inv_sigma, nchunk);
  return cudaGetLastError();
}

}  // namespace

// Launches census_aml_tile on `stream`. iml and imr are uint8 [H, W]; cost
// and aml are [ndisp, H, W] float32; inv_sigma is float32(1) /
// float32(sigma). Returns cudaGetLastError() after the launch (0 on
// success; cudaErrorInvalidValue for an empty input or a window other than
// odd 1..11); does not synchronise.
extern "C" int msn_census_aml(const void* iml, const void* imr, void* cost,
                              void* aml, int H, int W, int ndisp, int wsize,
                              float inv_sigma, void* stream) {
  if (H < 1 || W < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_wsize(wsize, [&](auto w) {
    return launch<decltype(w)::value>(
        static_cast<const uint8_t*>(iml), static_cast<const uint8_t*>(imr),
        static_cast<float*>(cost), static_cast<float*>(aml), H, W, ndisp,
        inv_sigma, static_cast<cudaStream_t>(stream));
  }));
}

MSN_PHASES_READ(msn_census_aml_phases)
