// MS-GCNet's serving head for Hopper (sm_90a): deconv5, the softmax over D
// and the soft-argmin in one pass, writing only the disparity map.
//
// Replaces no Pallas kernel: it ports the XLA math of the JAX package's
// SubpixelSoftArgminHead (msnets_tpu/models/layers.py), which computes the
// head per subpixel phase instead of building the full-resolution logit
// volume. On the card the head was cuDNN's transposed conv in TF32 writing
// a padded float32 logit volume of [2D, 2H, 2W], then a softmax and a sum
// over D reading it back (ops/cuda/subpixel_soft_argmin.py has the math):
//   disp[n, h, w] = sum_d d * softmax_d(L[n, d, h, w]),
//   L = conv_transpose3d(x, w5, stride s, padding 1, output_padding s - 1)
// for s = 2 (and 4, quarter_input); deconv5's bias cancels in the softmax.
//
// Phase taps. Along an axis, tap k of input i lands on output s*i + k - 1:
// tap 1 on phase 0 and tap 2 on phase 1 of the same input position, tap 0
// on phase s - 1 of the position before. So the tap products of one input
// voxel, summed over channels, each go to exactly one output logit; nothing
// is computed twice, and an input past the edge reads 0 (output_padding).
//
// Design. A block owns a tile of kTW input columns (one a lane) by TH input
// rows (P a thread) and so the s*s output pixels of each. It streams the
// depth slices j = 0 .. D-1 of its tile, with a one-voxel halo in H and W
// (zero-filled past the edges), through two buffers in shared memory with
// cp.async: slice j + 1 is in flight while slice j is computed. Each voxel
// of a slice is read from shared memory as 16-byte chunks, padded by one
// chunk so that neighbouring lanes hit different banks, widened from bf16
// to float32 in registers; the float32 weights sit in shared memory and are
// read as broadcasts. The taps of slice j give, for each of the thread's
// output pixels, the logits of depths s*j (tap kz 1), s*j + 1 (kz 2) and
// s*j - 1 (kz 0); the logit of depth s*j + s - 1 waits in a register for
// slice j + 1's kz 0 taps. Each output pixel keeps an online softmax in
// registers (running maximum, sum of e, sum of d*e) and writes
// sum(d*e) / sum(e) once. Nothing of size D x H x W touches device memory.
//
// Numerics: FP32 FMAs of bf16 (or float32) inputs and float32 weights, the
// exponentials as __expf (relative error ~2^-21 near the maximum, where the
// weights of the softmax are; the result moves by at most that times the
// spread of d), a true division. Only the order of the sums differs from
// the plain version.
//
// Bound on an H100 SXM at the online shape (x [1, 32, 96, 192, 624] bf16,
// s = 2): reads 736 MB (0.22 ms at 3.35 TB/s), 27 taps x 32 channels FMAs
// a voxel, 19.9 GFLOP (0.30 ms at 67 TFLOP/s FP32): bound by the FP32
// pipes. The widening, the weight broadcasts and the copies issue beside
// the FMAs (about 1 instruction in 5); the 480 blocks of 128 threads fill
// the 132 SMs in one wave at 3-4 blocks each (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;     // input columns a block, one a lane
constexpr int kWarps = 4;   // warps a block, stacked along H
constexpr int kThreads = 32 * kWarps;

// input rows a thread: two with s = 2 (they share a halo row of loads), one
// with s = 4, whose 16 output pixels a row take the registers
template <int S>
struct Plan {
  static constexpr int P = S == 2 ? 2 : 1;
  static constexpr int TH = P * kWarps;
};

// along one axis: the output phase a tap feeds, and its input offset
__host__ __device__ constexpr int phase_of(int k, int s) { return k == 0 ? s - 1 : k - 1; }
__host__ __device__ constexpr int offset_of(int k) { return k == 0 ? 1 : 0; }

// 16 bytes of one voxel's channels, widened to float32
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int K = 8;
  __device__ static void widen(uint4 u, float* f) {
    const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // element 2i in the low half
      f[2 * i] = __uint_as_float(v[i] << 16);
      f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int K = 4;
  __device__ static void widen(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// copy depth slice xj of the block's tile, halo included, into buffer dst:
// [TH + 1 rows][kTW + 1 columns][vs chunks], the chunk past nch unused
template <typename T, int TH>
__device__ void stage(const T* __restrict__ xj, uint4* dst, int h0, int w0, int H, int W,
                      int C, int nch, int vs) {
  constexpr int K = Chunk<T>::K;
  for (int v = threadIdx.y * 32 + threadIdx.x; v < (TH + 1) * (kTW + 1); v += kThreads) {
    const int r = v / (kTW + 1), col = v - r * (kTW + 1);
    const int h = h0 + r, w = w0 + col;
    const bool in = h < H && w < W;
    const T* src = in ? xj + (static_cast<size_t>(h) * W + w) * C : xj;
    const uint32_t d = smem_addr(dst + v * vs);
    for (int c = 0; c < nch; ++c) cp_async16(d + 16 * c, src + (in ? c * K : 0), in ? 16 : 0);
  }
  cp_async_commit();
}

// the online softmax of one output pixel: logits l[i] at depths d[i]
template <int M>
__device__ __forceinline__ void soft_update(float& m, float& se, float& sde, const float (&l)[M],
                                            const float (&d)[M]) {
  float mx = m;
#pragma unroll
  for (int i = 0; i < M; ++i) mx = fmaxf(mx, l[i]);
  const float f = __expf(m - mx);     // 0 while m is -inf
  float a = se * f, b = sde * f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float e = __expf(l[i] - mx);
    a += e;
    b = fmaf(d[i], e, b);
  }
  m = mx;
  se = a;
  sde = b;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
subpixel_soft_argmin_kernel(const T* __restrict__ x, const float* __restrict__ w5,
                            float* __restrict__ out, int C, int D, int H, int W) {
  constexpr int P = Plan<S>::P, TH = Plan<S>::TH, K = Chunk<T>::K;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nch = C / K;
  const int vs = nch + 1;                       // odd for C = 32: no bank conflicts
  const int slice = (TH + 1) * (kTW + 1) * vs;  // chunks a buffer
  uint4* xs = reinterpret_cast<uint4*>(smem);
  float* ws = reinterpret_cast<float*>(xs + 2 * slice);   // [27 taps][C]
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * TH, n = blockIdx.z;

  for (int i = wy * 32 + lane; i < 27 * C; i += kThreads) {
    const int tap = i / C, c = i - tap * C;
    ws[i] = w5[c * 27 + tap];                   // w5 is [C, 1, 3, 3, 3]
  }
  const size_t slice_elems = static_cast<size_t>(H) * W * C;
  const T* xn = x + static_cast<size_t>(n) * D * slice_elems;

  float m[P][S][S], se[P][S][S], sde[P][S][S], pend[P][S][S];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int q = 0; q < S; ++q) {
        m[p][r][q] = -INFINITY;
        se[p][r][q] = sde[p][r][q] = pend[p][r][q] = 0.f;
      }

  stage<T, TH>(xn, xs, h0, w0, H, W, C, nch, vs);
  for (int j = 0; j < D; ++j) {
    cp_async_wait_all();
    __syncthreads();   // slice j landed for all; slice j - 1's buffer is free
    if (j + 1 < D)
      stage<T, TH>(xn + (j + 1) * slice_elems, xs + ((j + 1) & 1) * slice, h0, w0, H, W, C, nch,
                   vs);
    const uint4* xb = xs + (j & 1) * slice;

    float acc[P][3][S][S];   // by tap kz: depths S*j - 1, S*j, S*j + 1
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kz = 0; kz < 3; ++kz)
#pragma unroll
        for (int r = 0; r < S; ++r)
#pragma unroll
          for (int q = 0; q < S; ++q) acc[p][kz][r][q] = 0.f;

    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int ox = 0; ox < 2; ++ox) {
        float xv[P + 1][K];   // rows wy*P .. wy*P + P, column lane + ox
#pragma unroll
        for (int r = 0; r <= P; ++r)
          Chunk<T>::widen(xb[((wy * P + r) * (kTW + 1) + lane + ox) * vs + c], xv[r]);
#pragma unroll
        for (int kz = 0; kz < 3; ++kz)
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              if (offset_of(kx) != ox) continue;
              float wk[K];
              const float4* wp =
                  reinterpret_cast<const float4*>(ws + ((kz * 3 + ky) * 3 + kx) * C + c * K);
#pragma unroll
              for (int i = 0; i < K / 4; ++i) {
                const float4 v = wp[i];
                wk[4 * i] = v.x;
                wk[4 * i + 1] = v.y;
                wk[4 * i + 2] = v.z;
                wk[4 * i + 3] = v.w;
              }
#pragma unroll
              for (int p = 0; p < P; ++p) {
                float a = acc[p][kz][phase_of(ky, S)][phase_of(kx, S)];
#pragma unroll
                for (int k = 0; k < K; ++k) a = fmaf(xv[p + offset_of(ky)][k], wk[k], a);
                acc[p][kz][phase_of(ky, S)][phase_of(kx, S)] = a;
              }
            }
      }
    }

    // complete now: depth S*j - 1 (the wait plus kz 0; none before slice 0)
    // and depths S*j .. S*j + S - 2 (kz 1, kz 2 with S = 4, then 0)
    float dl[S];
    dl[0] = static_cast<float>(S * j - 1);
#pragma unroll
    for (int i = 1; i < S; ++i) dl[i] = static_cast<float>(S * j + i - 1);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int q = 0; q < S; ++q) {
          float l[S];
          l[0] = j > 0 ? pend[p][r][q] + acc[p][0][r][q] : -INFINITY;
          l[1] = acc[p][1][r][q];
#pragma unroll
          for (int i = 2; i < S; ++i) l[i] = i == 2 ? acc[p][2][r][q] : 0.f;
          pend[p][r][q] = S == 2 ? acc[p][2][r][q] : 0.f;
          soft_update<S>(m[p][r][q], se[p][r][q], sde[p][r][q], l, dl);
        }
  }

  const float dlast[1] = {static_cast<float>(S * D - 1)};
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int h = h0 + wy * P + p, w = w0 + lane;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      float v[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const float l[1] = {pend[p][r][q]};
        soft_update<1>(m[p][r][q], se[p][r][q], sde[p][r][q], l, dlast);
        v[q] = sde[p][r][q] / se[p][r][q];
      }
      if (h < H && w < W) {
        float* o = out + (static_cast<size_t>(n) * S * H + S * h + r) * S * W + S * w;
        if constexpr (S == 2)
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <typename T, int S>
cudaError_t launch(const void* x, const float* w5, float* out, int N, int C, int D, int H, int W,
                   cudaStream_t stream) {
  constexpr int TH = Plan<S>::TH;
  const int vs = C / Chunk<T>::K + 1;
  const size_t smem = 2 * static_cast<size_t>(TH + 1) * (kTW + 1) * vs * 16 + 27 * C * 4;
  auto kernel = subpixel_soft_argmin_kernel<T, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTW - 1) / kTW, (H + TH - 1) / TH, N), block(32, kWarps);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(x), w5, out, C, D, H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: bfloat16 x, 1: float32 x; w5 float32 [C, 1, 3, 3, 3]; out float32
// [N, s*H, s*W]. C a multiple of 16 bytes of x's type (the wrapper checks).
extern "C" int msn_subpixel_soft_argmin(const void* x, const void* w5, void* out, int dtype, int N,
                                        int C, int D, int H, int W, int stride, void* stream) {
  if (N < 1 || C < 1 || D < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(w5);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stride == 2) return launch<__nv_bfloat16, 2>(x, w, o, N, C, D, H, W, st);
  if (dtype == 0 && stride == 4) return launch<__nv_bfloat16, 4>(x, w, o, N, C, D, H, W, st);
  if (dtype == 1 && stride == 2) return launch<float, 2>(x, w, o, N, C, D, H, W, st);
  if (dtype == 1 && stride == 4) return launch<float, 4>(x, w, o, N, C, D, H, W, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
