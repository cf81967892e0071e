// Fused census cost + AML likelihood for Hopper (sm_90a).
//
// Replaces the TPU kernel msnets_tpu/ops/pallas/census_aml_pallas.py
// (census_aml_pallas, body _kernel) together with the descriptor packing of
// msnets_tpu/ops/pallas/census_pallas.py (_pack_descriptors). It computes
// channels 0 and 4 of the matching-space feature volume:
//   cost[d, r, c] = clip(c_d, 0, 120) / 120
//   aml[d, r, c]  = exp(-(c_d - min)^2 / sigma) / sum_d exp(...)
//                   (0 where min is the INVALID sentinel)
// where c_d is the 11x11 census Hamming distance between left pixel (r, c)
// and right pixel (r, c - d), or INVALID outside the reference valid region
// (rows [wc, H-w+wc), cols [wc, W-w+wc), d <= c - wc).
//
// Design. The Pallas version walks row tiles in order on one TensorCore
// and keeps the [D, rows, W] cost tile in VMEM scratch. Here:
//   * kernel A packs the 121 census bits of each pixel, one thread per
//     pixel, into one 16-byte uint4 (4 x 32-bit words, row-major window
//     order, bit k = centre < neighbour_k);
//   * kernel B gives each thread one output pixel, threads along W, so every
//     disparity plane is loaded and stored coalesced. It never keeps the D
//     costs: each of its three passes over d (min, sum of weights, write)
//     recomputes the Hamming distance from the descriptors, which stay in
//     L1/L2 (two images of 16 B per pixel).
// Numerics are those of the plain PyTorch version: the same float32
// operations (true division by sigma and by 120, no fast math), the same
// min; only the order of the sum over d differs.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInvalid = 2147483648.0f;   // float32(RAND_MAX)
constexpr int kThreads = 256;

// Kernel A: blockIdx.y selects the image (0 left, 1 right).
//
// JAX builds the bits with jnp.roll, which wraps around the image border.
// Every entry inside the valid mask reads only in-image windows (valid rows
// [wc, H-w+wc) and cols [wc, W-w+wc) keep the window inside the image, and
// d <= c - wc keeps the right window inside too), so clamping the
// coordinates here changes only descriptors whose costs are INVALID anyway.
template <int WSIZE>
__global__ void pack_descriptors(const uint8_t* __restrict__ iml,
                                 const uint8_t* __restrict__ imr,
                                 uint4* __restrict__ dl,
                                 uint4* __restrict__ dr, int H, int W) {
  constexpr int WC = WSIZE / 2;
  static_assert(WSIZE * WSIZE <= 128, "descriptor holds 128 bits");
  const int64_t n = static_cast<int64_t>(H) * W;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const uint8_t* img = blockIdx.y == 0 ? iml : imr;
  uint4* out = blockIdx.y == 0 ? dl : dr;
  const int r = static_cast<int>(idx / W);
  const int c = static_cast<int>(idx - static_cast<int64_t>(r) * W);
  const int centre = img[idx];
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
#pragma unroll
  for (int dy = -WC; dy <= WC; ++dy) {
    const int rr = min(max(r + dy, 0), H - 1);
    const uint8_t* row = img + static_cast<int64_t>(rr) * W;
#pragma unroll
    for (int dx = -WC; dx <= WC; ++dx) {
      const int cc = min(max(c + dx, 0), W - 1);
      const int bit = (dy + WC) * WSIZE + (dx + WC);    // compile-time
      const uint32_t b = centre < static_cast<int>(row[cc]) ? 1u : 0u;
      if (bit < 32) w0 |= b << bit;
      else if (bit < 64) w1 |= b << (bit - 32);
      else if (bit < 96) w2 |= b << (bit - 64);
      else w3 |= b << (bit - 96);
    }
  }
  out[idx] = make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ float hamming(uint4 a, uint4 b) {
  return static_cast<float>(__popc(a.x ^ b.x) + __popc(a.y ^ b.y) +
                            __popc(a.z ^ b.z) + __popc(a.w ^ b.w));
}

// Kernel B: one thread per output pixel; outputs are [D, H, W].
__global__ void census_aml_planes(const uint4* __restrict__ dl,
                                  const uint4* __restrict__ dr,
                                  float* __restrict__ cost,
                                  float* __restrict__ aml, int H, int W,
                                  int ndisp, int wsize, float sigma) {
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
      s += expf(-(num * num) / sigma);
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
      p = expf(-(num * num) / sigma) / s;
    }
    cp[d * plane] = fminf(fmaxf(cd, 0.0f), 120.0f) / 120.0f;
    ap[d * plane] = p;
  }
}

template <int WSIZE>
cudaError_t launch_pack(const uint8_t* iml, const uint8_t* imr, uint4* dl,
                        uint4* dr, int H, int W, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), 2);
  pack_descriptors<WSIZE><<<grid, kThreads, 0, stream>>>(iml, imr, dl, dr, H, W);
  return cudaGetLastError();
}

}  // namespace

// Launches kernel A on both images, then kernel B, on `stream`. dl and dr
// are caller-allocated [H, W, 4] 32-bit scratch (16-byte aligned); cost and
// aml are [ndisp, H, W] float32. Returns cudaGetLastError() after the
// launches (0 on success); does not synchronise.
extern "C" int msn_census_aml(const void* iml, const void* imr, void* dl,
                              void* dr, void* cost, void* aml, int H, int W,
                              int ndisp, int wsize, float sigma,
                              void* stream) {
  if (H < 1 || W < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto l8 = static_cast<const uint8_t*>(iml);
  auto r8 = static_cast<const uint8_t*>(imr);
  auto dl4 = static_cast<uint4*>(dl);
  auto dr4 = static_cast<uint4*>(dr);
  cudaError_t err;
  switch (wsize) {
    case 1: err = launch_pack<1>(l8, r8, dl4, dr4, H, W, s); break;
    case 3: err = launch_pack<3>(l8, r8, dl4, dr4, H, W, s); break;
    case 5: err = launch_pack<5>(l8, r8, dl4, dr4, H, W, s); break;
    case 7: err = launch_pack<7>(l8, r8, dl4, dr4, H, W, s); break;
    case 9: err = launch_pack<9>(l8, r8, dl4, dr4, H, W, s); break;
    case 11: err = launch_pack<11>(l8, r8, dl4, dr4, H, W, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const unsigned blocks = static_cast<unsigned>((plane + kThreads - 1) / kThreads);
  census_aml_planes<<<blocks, kThreads, 0, s>>>(
      dl4, dr4, static_cast<float*>(cost), static_cast<float*>(aml), H, W,
      ndisp, wsize, sigma);
  return static_cast<int>(cudaGetLastError());
}
