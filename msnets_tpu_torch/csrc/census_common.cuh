// Census descriptors for Hopper (sm_90a), shared by census.cu and
// census_aml.cu.
//
// Replaces the descriptor packing of the TPU kernels,
// msnets_tpu/ops/pallas/census_pallas.py (_pack_descriptors): the 121 census
// bits of each pixel (11x11 window, row-major, bit k = centre < neighbour_k)
// in one 16-byte uint4 (4 x 32-bit words), one thread per pixel.
//
// Border note. JAX builds the bits with jnp.roll, which wraps around the
// image border. Every entry inside the valid mask reads only in-image windows
// (valid rows [wc, H-w+wc) and cols [wc, W-w+wc) keep the window inside the
// image, and d <= c - wc keeps the right window inside too), so clamping the
// coordinates here changes only descriptors whose costs are INVALID anyway.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace msn {

constexpr float kInvalid = 2147483648.0f;   // float32(RAND_MAX)
constexpr int kThreads = 256;

// blockIdx.y selects the image (0 left, 1 right).
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

template <int WSIZE>
cudaError_t launch_pack_w(const uint8_t* iml, const uint8_t* imr, uint4* dl,
                          uint4* dr, int H, int W, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), 2);
  pack_descriptors<WSIZE><<<grid, kThreads, 0, stream>>>(iml, imr, dl, dr, H, W);
  return cudaGetLastError();
}

// Packs both images' descriptors on `stream`; cudaErrorInvalidValue for a
// window the 128-bit descriptor does not hold (odd wsize <= 11 only).
inline cudaError_t launch_pack(const void* iml, const void* imr, void* dl,
                               void* dr, int H, int W, int wsize,
                               cudaStream_t s) {
  auto l8 = static_cast<const uint8_t*>(iml);
  auto r8 = static_cast<const uint8_t*>(imr);
  auto dl4 = static_cast<uint4*>(dl);
  auto dr4 = static_cast<uint4*>(dr);
  switch (wsize) {
    case 1: return launch_pack_w<1>(l8, r8, dl4, dr4, H, W, s);
    case 3: return launch_pack_w<3>(l8, r8, dl4, dr4, H, W, s);
    case 5: return launch_pack_w<5>(l8, r8, dl4, dr4, H, W, s);
    case 7: return launch_pack_w<7>(l8, r8, dl4, dr4, H, W, s);
    case 9: return launch_pack_w<9>(l8, r8, dl4, dr4, H, W, s);
    case 11: return launch_pack_w<11>(l8, r8, dl4, dr4, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace msn
