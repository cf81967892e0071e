// Symmetric int8 quantization of a conv input, channels last, for Hopper
// (sm_90a): the first half of the port's int8 conv (models/quant.py).
//
// Replaces the JAX package's _quant_act (msnets_tpu/models/layers.py:89,
// XLA, not Pallas) together with the transpose the int8 conv needs:
//   out[n, d, h, w, c] = clamp(round(float(x[n, c, d, h, w]) / s[n]), -127,
//                              127) for c < C, 0 for C <= c < Cp
// with round half to even and a true IEEE division (rintf(__fdiv_rn(..))),
// as JAX's round(xf / scale) and torch's round(x.float() / scale) compute
// it. x is the compute-dtype NCDHW activation (bf16 or float32), s one
// float32 scale a sample (scale_stride 1) or one for all (scale_stride 0),
// Cp the channels the int8 conv takes (32, 64 or 128, a multiple of its
// k32 step).
//
// Design: one block takes a run of 128 W positions of one (n, d, h) row. Its
// threads read each channel's run along W, 16 bytes a thread where the rows
// are aligned (four loads in flight a thread), and write the quantized run
// into a [Cp][128 + 4] byte tile in shared memory; then each thread reads
// 4 W positions of 16 channel rows, transposes them with byte permutes and
// writes 16 bytes to each of the 4 positions' channel runs, which together
// make the block's 128 * Cp contiguous output bytes. Bound on an H100 SXM (3.35 TB/s): bytes, one read of x and one
// write of the int8 volume (at MS-GCNet's conv3dbn_2 input, bf16 [1, 32, 96,
// 128, 256]: 201.3 MB + 100.7 MB, 0.090 ms).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;
// a channel's row of the tile: an odd number of words, so that the 16
// channel rows a thread reads in the transpose fall in distinct banks
constexpr int kRowBytes = kTileW + 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  const float c = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(c));
}

// byte j of each of a, b, c, d, as one word
__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d, int j) {
  const uint32_t sel = j | ((j + 4) << 4);
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}

// VEC: a run of V = 16 / sizeof(T) values loads as one 16-byte word (W % V
// == 0 and x 16-byte aligned).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_quantize_tile(const T* __restrict__ x, const float* __restrict__ scale,
                   int scale_stride, int8_t* __restrict__ out, int C, int D,
                   int H, int W, int Cp) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ int4 smem4[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem4);   // [Cp][kRowBytes]
  const int tiles_w = (W + kTileW - 1) / kTileW;
  int64_t b = blockIdx.x;
  const int w0 = static_cast<int>(b % tiles_w) * kTileW;
  b /= tiles_w;
  const int h = static_cast<int>(b % H);
  b /= H;
  const int d = static_cast<int>(b % D);
  const int n = static_cast<int>(b / D);
  const int nw = min(kTileW, W - w0);
  const float s = scale[static_cast<int64_t>(n) * scale_stride];
  const int64_t plane = static_cast<int64_t>(D) * H * W;
  const T* xrow = x + static_cast<int64_t>(n) * C * plane +
                  (static_cast<int64_t>(d) * H + h) * W + w0;

  // item i: the run of V values at w = (i % kRuns) V of channel i / kRuns,
  // read along W and written to the tile's row c; each thread loads
  // kUnroll items before it quantizes any
  constexpr int kRuns = kTileW / V;
  constexpr int kUnroll = 4;
  for (int i0 = threadIdx.x; i0 < Cp * kRuns; i0 += kThreads * kUnroll) {
    T v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      const int c = i / kRuns, w = (i - c * kRuns) * V;
      const T* src = xrow + c * plane + w;
      if (VEC && c < C && w < nw) {
        const int4 word = __ldg(reinterpret_cast<const int4*>(src));
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[u][k] = reinterpret_cast<const T*>(&word)[k];
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[u][k] = c < C && w + k < nw ? src[k] : T(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= Cp * kRuns) break;
      const int c = i / kRuns, w = (i - c * kRuns) * V;
      uint32_t q[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        q[k] = c < C ? static_cast<uint8_t>(quantize(to_float(v[u][k]), s))
                     : 0u;
      int8_t* row = tile + c * kRowBytes + w;
      if constexpr (V >= 4) {
#pragma unroll
        for (int k = 0; k < V; k += 4)
          *reinterpret_cast<uint32_t*>(row + k) =
              q[k] | q[k + 1] << 8 | q[k + 2] << 16 | q[k + 3] << 24;
      } else {
        row[0] = static_cast<int8_t>(q[0]);
      }
    }
  }
  __syncthreads();
  // the run's output is nw * Cp contiguous bytes: each thread takes 4 W
  // positions x 16 channels, reads a word of 4 positions from each of the
  // 16 channel rows and transposes them with byte permutes
  const int chunks = Cp / 16;
  int4* dst = reinterpret_cast<int4*>(
      out + (((static_cast<int64_t>(n) * D + d) * H + h) * W + w0) * Cp);
  for (int i = threadIdx.x; i < (nw + 3) / 4 * chunks; i += kThreads) {
    const int w4 = i / chunks, c16 = i - w4 * chunks;
    uint32_t word[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      word[k] = *reinterpret_cast<const uint32_t*>(
          tile + (c16 * 16 + k) * kRowBytes + w4 * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (w4 * 4 + j >= nw) break;
      int4 o;
      o.x = pick(word[0], word[1], word[2], word[3], j);
      o.y = pick(word[4], word[5], word[6], word[7], j);
      o.z = pick(word[8], word[9], word[10], word[11], j);
      o.w = pick(word[12], word[13], word[14], word[15], j);
      dst[(w4 * 4 + j) * chunks + c16] = o;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, int scale_stride,
                   int8_t* out, int N, int C, int D, int H, int W, int Cp,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = static_cast<size_t>(Cp) * kRowBytes;
  const int64_t blocks =
      static_cast<int64_t>(N) * D * H * ((W + kTileW - 1) / kTileW);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  auto kernel = vec ? int8_quantize_tile<T, true> : int8_quantize_tile<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), scale, scale_stride, out, C, D, H, W, Cp);
  return cudaGetLastError();
}

}  // namespace

// x: [N, C, D, H, W] contiguous, float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1); scale: float32, N values (scale_stride 1) or one (0); out: int8 [N, D,
// H, W, Cp], Cp a multiple of 32 that is >= C. Returns the CUDA error of the
// launch (0 when it was queued).
extern "C" int msn_int8_quantize(const void* x, const void* scale,
                                 int scale_stride, void* out, int bf16, int N,
                                 int C, int D, int H, int W, int Cp,
                                 void* stream) {
  if (N < 1 || C < 1 || D < 1 || H < 1 || W < 1 || Cp < C || Cp % 32 != 0 ||
      (scale_stride != 0 && scale_stride != 1) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, s, scale_stride, o, N, C, D, H, W, Cp, st)
           : launch<float>(x, s, scale_stride, o, N, C, D, H, W, Cp, st);
  return static_cast<int>(err);
}
