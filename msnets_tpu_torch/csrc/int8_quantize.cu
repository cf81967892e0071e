// The activation half of the port's int8 conv (models/quant.py) for Hopper
// (sm_90a): the dynamic scale's per-sample max-abs, and the symmetric int8
// quantization of the conv input, written channels last.
//
// Replaces the JAX package's _quant_act (msnets_tpu/models/layers.py:89,
// XLA, not Pallas) together with the transpose the int8 conv needs.
//
// msn_int8_absmax: amax[n] = max over the sample of |float(x)|, for a
// contiguous [N, ...] tensor (bf16 or float32). It equals x.float().abs()
// .amax() bit for bit: widening to float32 is exact, clearing the sign bit
// is abs (so -0.0 gives +0.0), and the maximum is taken over the float32
// bit patterns as unsigned words, which order as the non-negative floats
// do; a NaN's bits exceed +inf's, so a sample holding a NaN gives a NaN.
// Design: a grid-stride loop over each sample (blockIdx.y), 16-byte loads,
// four in flight a thread, with a scalar head and tail where the sample's
// start is not 16-byte aligned (its stride is C*D*H*W elements); bf16 pairs
// are reduced two at a time (__vmaxu2); __reduce_max_sync in a warp, then
// one atomicMax a block into out[n], which the call zeroes first
// (cudaMemsetAsync). Bound: bytes, one read of x (at MS-GCNet's conv3dbn_2
// input, bf16 [1, 32, 96, 128, 256]: 201.3 MB, 0.060 ms at 3.35 TB/s).
//
// msn_int8_quantize:
//   out[n, d, h, w, c] = clamp(round(float(x[n, c, d, h, w]) / s[n]), -127,
//                              127) for c < C, 0 for C <= c < Cp
// with round half to even and a true IEEE division, as JAX's round(xf /
// scale) and torch's round(x.float() / scale) compute it. x is the
// compute-dtype NCDHW activation, s one float32 scale a sample (scale_stride
// 1) or one for all (scale_stride 0), Cp the channels the int8 conv takes
// (32, 64 or 128, a multiple of its k32 step).
// Arithmetic: __fdiv_rn takes a slow subroutine for a zero dividend, and
// the inputs of the int8 convs follow a ReLU (about half of them zero);
// its fast path runs in the quarter-rate units (MUFU.RCP), as do rintf and
// the float-to-int convert. So each value is y = x * fl(1/s), clamped to
// +-127 and rounded by one add of 1.5 * 2^23 (ties to even; the low byte
// of the sum's bits is the int8), all at the full float32 rate. This is
// the true division's int8: |y - fl(x / s)| <= 3 * 2^-24 * |x / s|
// (< 2.3e-5 below the clamp), so the two round to one integer unless y
// lies within 2^-14 of a half-integer; there, rarely, the value is
// recomputed with __fdiv_rn. A scale outside [1e-30, 1e30] (or NaN)
// always divides. Clamping first equals clamping after the round (+-127
// are integers); a NaN clamps to -127 either way.
// Design: x is, for each sample, a [C][S] matrix (S = D*H*W positions, the
// channel planes S apart) and out a [S][Cp] one; a tile is P consecutive
// positions x all Cp channels (P = 256, 128, 64 at Cp = 32, 64, 128: 8192
// values), whose output is P * Cp contiguous bytes. Persistent blocks walk
// the tiles; one producer warp stages each tile's [Cp][P] values into a
// ring of shared-memory stages behind mbarriers with one TMA load (a 3-D
// tensor map over [N][C][S]; its out-of-bounds fill zeroes the padded
// channels and the ragged last tile), or, where the channel planes or x
// are not 16-byte aligned (S * sizeof(T) % 16 != 0: odd shapes of the halo
// windows and the edge tests), with plain loads of its 32 lanes: the same
// kernel, another loader. Four consumer warps each take 64 positions x 32 channels of a
// tile: a lane reads 4 positions of 16 channel rows (8 or 16 bytes a row;
// a half-warp reads 128 contiguous bytes of one row, free of bank
// conflicts), quantizes them, and its byte permutes write the transpose:
// 4 x 16-byte stores of 16 channels, which the lane 16 apart completes to
// a full 32-byte sector. Bound on an H100 SXM (3.35 TB/s): bytes, one read
// of x and one write of the int8 volume (at conv3dbn_2's input: 201.3 MB
// + 100.7 MB, 0.090 ms).
//
// MSN_QUANT_ABLATE (chip_smoke.py phase 20's ablations, not the library
// the port loads): 1 only loads the tiles (no shared-memory reads,
// arithmetic or stores), 2 quantizes but stores nothing, 3 divides every
// value (__fdiv_rn, rintf, the convert).

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#ifndef MSN_QUANT_ABLATE
#define MSN_QUANT_ABLATE 0
#endif

namespace {

// ---------------------------------------------------------------- absmax

constexpr int kAbsThreads = 256;

// the float32 bits of |v|
__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ uint32_t abs_bits(__nv_bfloat16 v) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(v)) & 0x7fffu) << 16;
}

// a 16-byte word into the running maximum: float32 words one at a time,
// bf16 pairs as two 16-bit maxima (their float32 bits shifted down by 16)
template <typename T>
__device__ __forceinline__ void absmax_word(const int4& w, uint32_t& acc) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4)
      acc = max(acc, u[k] & 0x7fffffffu);
    else
      acc = __vmaxu2(acc, u[k] & 0x7fff7fffu);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAbsThreads)
int8_absmax_sample(const T* __restrict__ x, long long L,
                   unsigned int* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const T* xs = x + static_cast<long long>(blockIdx.y) * L;
  const long long head = min(
      L, static_cast<long long>(
             (16 - (reinterpret_cast<uintptr_t>(xs) & 15)) & 15) /
             static_cast<long long>(sizeof(T)));
  const long long nv = (L - head) / V;
  uint32_t acc = 0;     // float32 bits (bf16: two 16-bit halves)
  uint32_t edge = 0;    // float32 bits of the head and tail
  if (blockIdx.x == 0) {
    for (long long i = threadIdx.x; i < head; i += kAbsThreads)
      edge = max(edge, abs_bits(xs[i]));
    for (long long i = head + nv * V + threadIdx.x; i < L; i += kAbsThreads)
      edge = max(edge, abs_bits(xs[i]));
  }
  const int4* v = reinterpret_cast<const int4*>(xs + head);
  const long long stride = static_cast<long long>(gridDim.x) * kAbsThreads;
  long long i = static_cast<long long>(blockIdx.x) * kAbsThreads + threadIdx.x;
  for (; i + 3 * stride < nv; i += 4 * stride) {
    int4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = __ldcs(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) absmax_word<T>(w[u], acc);
  }
  for (; i < nv; i += stride) absmax_word<T>(__ldcs(v + i), acc);
  if constexpr (sizeof(T) == 2)
    acc = max(acc & 0xffffu, acc >> 16) << 16;
  acc = __reduce_max_sync(0xffffffffu, max(acc, edge));
  __shared__ uint32_t warp_max[kAbsThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kAbsThreads / 32 ? warp_max[threadIdx.x] : 0u;
    acc = __reduce_max_sync(0xffffffffu, acc);
    if (threadIdx.x == 0 && acc != 0) atomicMax(out + blockIdx.y, acc);
  }
}

template <typename T>
cudaError_t launch_absmax(const void* x, unsigned int* out, int N,
                          long long L, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, sizeof(unsigned int) * N, stream);
  if (err != cudaSuccess) return err;
  // eight blocks an SM over all samples, no more than a sample's words
  // four to a thread need
  constexpr int V = 16 / sizeof(T);
  const long long words = L / V + 1;
  const long long need = (words + 4LL * kAbsThreads - 1) / (4LL * kAbsThreads);
  const long long share = (8LL * sms + N - 1) / N;
  const unsigned gx =
      static_cast<unsigned>(std::max(1LL, std::min(need, share)));
  int8_absmax_sample<T><<<dim3(gx, N), kAbsThreads, 0, stream>>>(
      static_cast<const T*>(x), L, out);
  return cudaGetLastError();
}

// -------------------------------------------------------------- quantize

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);

// positions a tile: 64 a consumer warp at Cp = 32; the warps split the
// channels past 32
template <int Cp>
__host__ __device__ constexpr int tile_positions() {
  return 64 * kConsumerWarps * 32 / Cp;
}
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 4 : 3;    // 16 KB or 32 KB a stage
}
template <typename T, int Cp>
__host__ __device__ constexpr size_t quantize_smem() {
  return stages<T>() * (tile_positions<Cp>() * Cp * sizeof(T) + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// this thread's arrival, and ``bytes`` more for the phase to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_done(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity ``parity`` of ``bar`` has completed; a
// wait of seconds means an arrival was lost, and the kernel traps rather
// than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// the box of ``map`` at (c0, c1, c2) into ``dst``, completing on ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// 4 consecutive values of a staged channel row, as float32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

constexpr float kMagic = 12582912.0f;            // 1.5 * 2^23
constexpr float kTieEdge = 0.5f - 0x1p-14f;

// clamp(rint(v / s), -127, 127) by the true division, as a word whose low
// byte is the int8
__device__ __forceinline__ uint32_t quantize_exact(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(__float2int_rn(q));
}

// quantize_exact(v, s) from r = fl(1/s) (the header's arithmetic); ``fast``
// is false for a scale outside [1e-30, 1e30]
__device__ __forceinline__ uint32_t quantize(float v, float s, float r,
                                             bool fast) {
  const float yc = fminf(fmaxf(__fmul_rn(v, r), -127.f), 127.f);
  const float m = __fadd_rn(yc, kMagic);
  const float e = __fsub_rn(yc, __fsub_rn(m, kMagic));     // exact
  if (MSN_QUANT_ABLATE == 3 || !fast || fabsf(e) >= kTieEdge)
    return quantize_exact(v, s);
  return __float_as_uint(m);
}

// the low bytes of a, b, c, d as one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// TMA: the tiles arrive by ``map`` (3-D: S, C, N); otherwise the producer
// warp's lanes load them from ``x``.
template <typename T, int Cp, bool TMA>
__global__ void __launch_bounds__(kThreads)
int8_quantize_tile(const __grid_constant__ CUtensorMap map,
                   const T* __restrict__ x, const float* __restrict__ scale,
                   int scale_stride, int8_t* __restrict__ out, int C,
                   long long S, int tiles_per_sample, int tiles) {
  constexpr int P = tile_positions<Cp>();
  constexpr int kStages = stages<T>();
  constexpr int kTile = P * Cp;                 // values a stage
  extern __shared__ __align__(1024) unsigned char smem[];
  T* staged = reinterpret_cast<T*>(smem);       // [kStages][Cp][P]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kTile *
                                               sizeof(T));
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, TMA ? 1 : 32);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                 // the producer
    if (TMA && lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int st = it % kStages, ph = (it / kStages) & 1;
      const int n = t / tiles_per_sample;
      const long long p0 =
          static_cast<long long>(t - n * tiles_per_sample) * P;
      T* dst = staged + st * kTile;
      mbar_wait(empty + st, ph ^ 1);
      if constexpr (TMA) {
        mbar_expect_tx(full + st, kTile * sizeof(T));
        tma_load_3d(dst, &map, full + st, static_cast<int>(p0), 0, n);
      } else {
        const T* src = x + static_cast<long long>(n) * C * S + p0;
        constexpr int kUnroll = 8;
        for (int i0 = lane; i0 < kTile; i0 += 32 * kUnroll) {
          T v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = i0 + 32 * u, c = i / P, p = i - c * P;
            v[u] = c < C && p0 + p < S ? src[c * S + p] : T(0.f);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) dst[i0 + 32 * u] = v[u];
        }
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // a consumer warp: positions g*64.. of the tile, channels 32*pass..; a
  // lane: 4 positions (quad) x 16 channels (chunk)
  const int g = warp / (Cp / 32), pass = warp % (Cp / 32);
  const int quad = lane & 15, chunk = 2 * pass + (lane >> 4);
  uint32_t sink = 0;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int st = it % kStages, ph = (it / kStages) & 1;
    const int n = t / tiles_per_sample;
    const long long p0 = static_cast<long long>(t - n * tiles_per_sample) * P;
    const float s = __ldg(scale + static_cast<long long>(n) * scale_stride);
    const float r = __frcp_rn(s);
    const bool fast = s >= 1e-30f && s <= 1e30f;
    mbar_wait(full + st, ph);
    uint32_t q[16][4];
    if (MSN_QUANT_ABLATE != 1) {
      const T* src = staged + st * kTile + chunk * 16 * P + g * 64 + quad * 4;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float f[4];
        load4(src + k * P, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) q[k][j] = quantize(f[j], s, r, fast);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (MSN_QUANT_ABLATE == 1) continue;
    const long long p = p0 + g * 64 + quad * 4;
    int4* dst = reinterpret_cast<int4*>(out + (static_cast<long long>(n) * S +
                                               p) * Cp + chunk * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p + j >= S) break;
      int4 o;
      o.x = pack4(q[0][j], q[1][j], q[2][j], q[3][j]);
      o.y = pack4(q[4][j], q[5][j], q[6][j], q[7][j]);
      o.z = pack4(q[8][j], q[9][j], q[10][j], q[11][j]);
      o.w = pack4(q[12][j], q[13][j], q[14][j], q[15][j]);
      if (MSN_QUANT_ABLATE == 2)
        sink ^= o.x ^ o.y ^ o.z ^ o.w;
      else
        dst[j * (Cp / 16)] = o;
    }
  }
  // ablation 2 keeps its arithmetic live with a store that never happens
  if (MSN_QUANT_ABLATE == 2 &&
      sink == 0x9e3779b9u * static_cast<uint32_t>(tiles))
    out[0] = 1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda (which the CUDA runtime has loaded),
// looked up once: the library does not link against libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

template <typename T, int Cp, bool TMA>
cudaError_t launch_tiles(const CUtensorMap& map, const T* x, const float* s,
                         int scale_stride, int8_t* out, int N, int C,
                         long long S, cudaStream_t stream) {
  constexpr int P = tile_positions<Cp>();
  constexpr size_t smem = quantize_smem<T, Cp>();
  auto kernel = int8_quantize_tile<T, Cp, TMA>;
  const long long per = (S + P - 1) / P;
  if (per * N > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = static_cast<int>(per * N);
  const int grid = std::min(tiles, std::max(per_sm, 1) * sms);
  kernel<<<grid, kThreads, smem, stream>>>(map, x, s, scale_stride, out, C, S,
                                           static_cast<int>(per), tiles);
  return cudaGetLastError();
}

template <typename T, int Cp>
cudaError_t launch_quantize(const T* x, const float* s, int scale_stride,
                            int8_t* out, int N, int C, long long S,
                            cudaStream_t stream) {
  CUtensorMap map{};
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       S * sizeof(T) % 16 == 0 && S < 0x7fffffffLL;
  if (!aligned)
    return launch_tiles<T, Cp, false>(map, x, s, scale_stride, out, N, C, S,
                                      stream);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {S * sizeof(T), S * C * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(tile_positions<Cp>()),
                             static_cast<cuuint32_t>(Cp), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      &map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<T*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  return launch_tiles<T, Cp, true>(map, x, s, scale_stride, out, N, C, S,
                                   stream);
}

template <typename T>
cudaError_t dispatch_quantize(const void* x, const float* s, int scale_stride,
                              int8_t* out, int N, int C, long long S, int Cp,
                              cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  switch (Cp) {
    case 32:
      return launch_quantize<T, 32>(xt, s, scale_stride, out, N, C, S, stream);
    case 64:
      return launch_quantize<T, 64>(xt, s, scale_stride, out, N, C, S, stream);
    case 128:
      return launch_quantize<T, 128>(xt, s, scale_stride, out, N, C, S,
                                     stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [N, C, D, H, W] contiguous, float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1); scale: float32, N values (scale_stride 1) or one (0); out: int8 [N, D,
// H, W, Cp], Cp 32, 64 or 128 and >= C, 16-byte aligned. Returns the CUDA
// error of the launch (0 when it was queued).
extern "C" int msn_int8_quantize(const void* x, const void* scale,
                                 int scale_stride, void* out, int bf16, int N,
                                 int C, int D, int H, int W, int Cp,
                                 void* stream) {
  if (N < 1 || C < 1 || D < 1 || H < 1 || W < 1 || Cp < C ||
      (Cp != 32 && Cp != 64 && Cp != 128) ||
      (scale_stride != 0 && scale_stride != 1) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long S = static_cast<long long>(D) * H * W;
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_quantize<__nv_bfloat16>(x, s, scale_stride, o, N, C, S,
                                              Cp, st)
           : dispatch_quantize<float>(x, s, scale_stride, o, N, C, S, Cp, st);
  return static_cast<int>(err);
}

// x: [N, ...] contiguous, L values a sample, float32 (bf16 == 0) or
// bfloat16 (bf16 == 1); out: float32 [N], each sample's max |x| (zeroed,
// then reduced into, on ``stream``). Returns the CUDA error of the launch.
extern "C" int msn_int8_absmax(const void* x, void* out, int bf16, int N,
                               long long L, void* stream) {
  if (N < 1 || N > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<unsigned int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_absmax<__nv_bfloat16>(x, o, N, L, st)
           : launch_absmax<float>(x, o, N, L, st);
  return static_cast<int>(err);
}
