// Exact int8 x int8 -> int32 3-D convolution on Hopper's int8 tensor cores
// (sm_90a), with the dequantization of the port's int8 eval fused into its
// epilogue.
//
// Replaces the XLA int8 convolutions of the JAX package's int8 eval
// (msnets_tpu/models/layers.py:218-272, 333-381, 483-540, under
// preferred_element_type=jnp.int32; the activations quantized by _quant_act,
// layers.py:89, the csrc/int8_quantize.cu kernel here). The JAX package has
// no Pallas kernel for them: on the TPU they are 2-D convolutions of packed
// int8 tensors summed over the depth taps, whose integer sums equal one k3
// 3-D convolution of the same values:
//   acc[n, co, od, oh, ow] = sum over kd, kh, kw, ci of
//       xq[n, s od + kd - pd, s oh + kh - ph, s ow + kw - pw, ci]
//       * wq[co, kd, kh, kw, ci]
// with zeros outside the input (padding pd, ph, pw of 0 or 1 per dim: a
// mesh's halo windows take no padding along the dims it splits) and stride
// s of 1 or 2. The raw mode writes acc (int32); the fused modes write, in
// the order of models/quant.py's dequantization (and JAX's),
//   y = round_T(float(acc) * (sx[n] * sk[co])) + round_T(bias[co])
// rounded to T (float32 or bfloat16) once more, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA).
//
// Design: an implicit GEMM on wgmma.mma_async.m64nNk32.s32.s8.s8 (M = output
// voxels, N = Cout, 32 or 64 a block, K = 27 taps x Cp channels, Cp 32, 64
// or 128, so one tap is 1, 2 or 4 k32 steps), both operands read from
// shared memory through descriptors, without swizzle: every operand sits
// in 8-row x 16-byte core matrices of 128 contiguous bytes. A block keeps
// its output channels' whole kernel resident ([tap][k32 step][16-byte
// half][co][16 bytes]) and walks output tiles of 128 consecutive ow of one
// (n, od, oh), persistently. It is warp-specialized: one producer warp
// stages each tile's 9 input rows (kd, kh) of s*127 + 3 columns x Cp
// channels, as [16-byte chunk][column][16 bytes], into a ring of 8 rows
// (fewer at 64 and 128 channels) with cp.async, 16 bytes a lane, the zero
// padding from cp.async's src-size 0; an mbarrier a slot tells the two
// consumer warpgroups (64 ow each) that a row landed, and another tells
// the producer that the row's wgmmas are done. So the loads of the next
// rows and tiles run under the wgmmas and the epilogue, and the loop has
// no block-wide barrier. The kw taps are column-shifted views of a staged
// row (the descriptor's start moves 16 bytes a column); for stride 2 the
// row is staged with its even columns first and its odd ones after, so
// each kw reads 64 consecutive staged columns. The epilogue goes through
// shared memory, so each warp writes contiguous ow runs of one channel
// plane, 16 bytes a lane where the rows are aligned.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 int8 TOPS dense): at the 256x512
// bucket MS-GCNet's conv3dbn_2 reads a [1, 96, 128, 256, 32] int8 volume
// (100.7 MB) and, fused, writes bf16 [1, 32, 96, 128, 256] (201.3 MB): 0.090
// ms of bytes against 0.088 ms of its 173.9 G operations. The kernel takes
// several times that (PERF.md): each input row is staged 9 times from the
// L2 cache, and N = 32 is a narrow wgmma; keeping rows in shared memory
// across oh is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 128;           // output voxels (ow) a tile
constexpr int kConsumers = 256;    // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 32;   // and one producer warp
// an epilogue row: 128 values and a pad that spreads the fragment stores
// over the banks and keeps each row 16-byte aligned
template <typename T>
__host__ __device__ constexpr int eb_row() {
  return kTM + (sizeof(T) == 2 ? 8 : 4);
}

// input rows in flight: as many as the resident kernel leaves room for
__host__ __device__ constexpr int stages(int S, int KC) {
  return KC == 1 ? 8 : KC == 2 ? (S == 1 ? 8 : 4) : (S == 1 ? 4 : 3);
}

enum Mode { kRaw = 0, kF32 = 1, kBF16 = 2 };

template <int MODE> struct OutType { using T = int; };
template <> struct OutType<kF32> { using T = float; };
template <> struct OutType<kBF16> { using T = __nv_bfloat16; };

struct Params {
  const int8_t* x;      // [N, D, H, W, Cp]
  const int8_t* w;      // [Cout_pad, 27, Cp]
  void* out;            // [N, Cout, Do, Ho, Wo]
  const float* sx;      // fused: activation scale, N values or one
  const float* sk;      // fused: [Cout] kernel scales
  const float* bias;    // fused: [Cout]
  int sx_stride;
  int D, H, W, Cout, Do, Ho, Wo, pd, ph, pw, tiles_w, tiles;
  int vec_out;          // out rows start 16-byte aligned (Wo % 16 bytes)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A shared-memory matrix descriptor of wgmma, without swizzle: ``p`` the
// first 8-row x 16-byte core matrix; core matrices lie ``lbo`` bytes apart
// along K and ``sbo`` bytes apart along M (N)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// writes by this thread's cp.async and stores, seen by wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// an arrive on ``bar`` once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the consumer warpgroups' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d (+)= A (64 x 32, K-major) x B (32 x N, K-major), int8 -> int32; the
// sums are added to d when ``accumulate``, else they replace it
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the value written for sum ``acc`` of channel ``co`` (< Cout) of sample n
template <int MODE>
__device__ __forceinline__ typename OutType<MODE>::T finish(int acc, int co,
                                                           float sxn,
                                                           const Params& p) {
  if constexpr (MODE == kRaw) {
    return acc;
  } else {
    const float r =
        __fmul_rn(__int2float_rn(acc), __fmul_rn(sxn, __ldg(p.sk + co)));
    const float b = __ldg(p.bias + co);
    if constexpr (MODE == kF32) {
      return __fadd_rn(r, b);
    } else {
      const float y = __bfloat162float(__float2bfloat16_rn(r));
      const float bb = __bfloat162float(__float2bfloat16_rn(b));
      return __float2bfloat16_rn(__fadd_rn(y, bb));
    }
  }
}

// The output run of a block's i-th tile: (n, od, oh, ow0).
struct Tile {
  int n, od, oh, ow0;
};

__device__ __forceinline__ Tile tile_of(int i, const Params& p) {
  int t = blockIdx.x + i * gridDim.x;
  Tile r;
  r.ow0 = t % p.tiles_w * kTM;
  t /= p.tiles_w;
  r.oh = t % p.Ho;
  t /= p.Ho;
  r.od = t % p.Do;
  r.n = t / p.Do;
  return r;
}

// NT: n8 tiles a block (4 or 8: 32 or 64 output channels); S: the stride;
// KC: k32 steps a tap (Cp = 32 KC). Warps 0-7 are two consumer warpgroups,
// which take 64 rows (ow) of the tile each and all of the block's
// channels; warp 8 is the producer, which stages the input rows.
template <int NT, int S, int KC, int MODE>
__global__ void __launch_bounds__(kThreads)
int8_conv3d_wgmma(const Params p) {
  using OutT = typename OutType<MODE>::T;
  constexpr int kCp = KC * 32;
  constexpr int kChunks = kCp / 16;          // 16-byte pieces a column
  constexpr int kStages = stages(S, KC);
  constexpr int kCoutBlk = NT * 8;
  constexpr int kCols = S * (kTM - 1) + 3;   // staged columns a row
  constexpr int kEven = kTM + 1;             // stride 2: even columns first
  constexpr int kEbRow = eb_row<OutT>();
  constexpr int kStageBytes = kCols * kCp;
  constexpr int kStepBytes = 2 * kCoutBlk * 16;   // B of one k32 step
  constexpr int kVec = 16 / sizeof(OutT);    // outputs a 16-byte store
  extern __shared__ int4 smem4[];
  // the kernel [tap][k32 step][16-byte half][co][16 bytes]; a staged row
  // [16-byte chunk][column][16 bytes]: both in wgmma's core matrices
  int8_t* ws = reinterpret_cast<int8_t*>(smem4);
  int8_t* ring = ws + 27 * KC * kStepBytes;
  OutT* eb = reinterpret_cast<OutT*>(ring + kStages * kStageBytes);
  // full[s]: row in slot s landed; empty[s]: the consumers are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<int8_t*>(eb) + kCoutBlk * kEbRow * sizeof(OutT));
  uint64_t* empty = full + kStages;
  const int co0 = blockIdx.y * kCoutBlk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  {  // the block's kernel rows, resident for its life
    const int4* src = reinterpret_cast<const int4*>(
        p.w + static_cast<int64_t>(co0) * 27 * kCp);
    for (int i = tid; i < kCoutBlk * 27 * kChunks; i += kThreads) {
      const int co = i / (27 * kChunks), c = i - co * (27 * kChunks);
      *reinterpret_cast<int4*>(ws + (c * kCoutBlk + co) * 16) = __ldg(src + i);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kConsumers);
    }
  }
  fence_async_shared();
  __syncthreads();                           // the last block-wide barrier

  const int my_tiles =
      blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nq = my_tiles * 9;               // input rows, in order

  if (warp == kConsumers / 32) {             // the producer warp
    Tile t = tile_of(0, p);
    for (int q = 0, r = 0, ti = 0, slot = 0; q < nq; ++q) {
      mbar_wait(empty + slot, ((q / kStages) & 1) ^ 1);
      const int kd = r / 3, kh = r - 3 * kd;
      const int id = S * t.od + kd - p.pd, ih = S * t.oh + kh - p.ph;
      const bool row_ok = id >= 0 && id < p.D && ih >= 0 && ih < p.H;
      const int8_t* src_row =
          row_ok ? p.x + (static_cast<int64_t>(t.n * p.D + id) * p.H + ih) *
                             p.W * kCp
                 : p.x;
      const int iw0 = S * t.ow0 - p.pw;
      int8_t* dst = ring + slot * kStageBytes;
      for (int i = lane; i < kCols * kChunks; i += 32) {
        const int j = i / kChunks, c16 = i % kChunks;
        const int iw = iw0 + j;
        const bool ok = row_ok && iw >= 0 && iw < p.W;
        const int8_t* src = ok ? src_row + iw * kCp + c16 * 16 : p.x;
        const int pos = S == 1 ? j : ((j & 1) ? kEven + (j >> 1) : (j >> 1));
        cp_async16(dst + (c16 * kCols + pos) * 16, src, ok ? 16 : 0);
      }
      cp_async_arrive(full + slot);
      slot = slot + 1 == kStages ? 0 : slot + 1;
      if (++r == 9) {
        r = 0;
        if (++ti < my_tiles) t = tile_of(ti, p);
      }
    }
    cp_async_wait<0>();
    return;
  }

  const int wg = warp >> 2;                  // rows 64 wg of the tile
  int acc[kCoutBlk / 2];
#pragma unroll
  for (int i = 0; i < kCoutBlk / 2; ++i) acc[i] = 0;

  // a slot is released once the wgmmas that read it are done: after the
  // next row's are issued (wait_group 1), or at the tile's end
  int held = -1;
  for (int q = 0, r = 0, ti = 0, slot = 0; q < nq; ++q) {
    mbar_wait(full + slot, (q / kStages) & 1);
    fence_async_shared();
    const int8_t* st = ring + slot * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int m0 = wg * 64;
      const int pos = S == 1 ? m0 + kw
                             : (kw == 1 ? kEven + m0 : m0 + kw / 2);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint64_t a = smem_desc(st + (2 * kc * kCols + pos) * 16,
                                     kCols * 16, 128);
        const uint64_t b = smem_desc(
            ws + ((r * 3 + kw) * KC + kc) * kStepBytes, kCoutBlk * 16, 128);
        wgmma_s8<kCoutBlk>(acc, a, b, r | kw | kc);
      }
    }
    wgmma_commit();
    if (r < 8) {
      wgmma_wait<1>();
      if (held >= 0) mbar_arrive(empty + held);
      held = slot;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      ++r;
      continue;
    }
    wgmma_wait<0>();
    if (held >= 0) mbar_arrive(empty + held);
    mbar_arrive(empty + slot);
    held = -1;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    r = 0;

    // epilogue: the tile's outputs through shared memory, [co][ow]
    const Tile t = tile_of(ti++, p);
    const float sxn =
        MODE == kRaw ? 0.f : __ldg(p.sx + t.n * p.sx_stride);
    const int g = lane >> 2, t4 = lane & 3;
    consumers_sync();                        // the last tile's stores read eb
#pragma unroll
    for (int i = 0; i < kCoutBlk / 2; ++i) {
      const int m = wg * 64 + (warp & 3) * 16 + g + ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
      const int co = co0 + col;
      eb[col * kEbRow + m] =
          co < p.Cout ? finish<MODE>(acc[i], co, sxn, p) : OutT();
    }
    consumers_sync();
    const int nw = min(kTM, p.Wo - t.ow0);
    for (int col = warp; col < kCoutBlk && co0 + col < p.Cout;
         col += kConsumers / 32) {
      OutT* dst = static_cast<OutT*>(p.out) +
                  ((static_cast<int64_t>(t.n * p.Cout + co0 + col) * p.Do +
                    t.od) * p.Ho + t.oh) * p.Wo + t.ow0;
      const OutT* row = eb + col * kEbRow;
      if (p.vec_out) {                       // 16 bytes a lane
        for (int m = lane * kVec; m < nw; m += 32 * kVec)
          *reinterpret_cast<int4*>(dst + m) =
              *reinterpret_cast<const int4*>(row + m);
      } else {
        for (int m = lane; m < nw; m += 32) dst[m] = row[m];
      }
    }
  }
}

size_t smem_bytes(int nt, int stride, int kc, size_t out_size) {
  const size_t cols = stride * (kTM - 1) + 3, cp = 32 * kc;
  const size_t eb_row = kTM + (out_size == 2 ? 8 : 4);
  const size_t eb = nt * 8 * eb_row * out_size;
  return nt * 8 * 27 * cp + stages(stride, kc) * cols * cp +
         (eb + 7) / 8 * 8 + 2 * stages(stride, kc) * sizeof(uint64_t);
}

template <int NT, int S, int KC, int MODE>
cudaError_t launch(const Params& p, int cout_pad, cudaStream_t stream) {
  using OutT = typename OutType<MODE>::T;
  auto kernel = int8_conv3d_wgmma<NT, S, KC, MODE>;
  const size_t smem = smem_bytes(NT, S, KC, sizeof(OutT));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ychunks = cout_pad / (NT * 8);
  int cap = sms * per_sm / ychunks;
  if (cap < 1) cap = 1;
  const dim3 grid(p.tiles < cap ? p.tiles : cap, ychunks);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT, int S, int KC>
cudaError_t launch_mode(const Params& p, int mode, int cout_pad,
                        cudaStream_t stream) {
  if (mode == kRaw) return launch<NT, S, KC, kRaw>(p, cout_pad, stream);
  if (mode == kF32) return launch<NT, S, KC, kF32>(p, cout_pad, stream);
  return launch<NT, S, KC, kBF16>(p, cout_pad, stream);
}

template <int NT, int KC>
cudaError_t launch_stride(const Params& p, int stride, int mode,
                          int cout_pad, cudaStream_t stream) {
  return stride == 1 ? launch_mode<NT, 1, KC>(p, mode, cout_pad, stream)
                     : launch_mode<NT, 2, KC>(p, mode, cout_pad, stream);
}

}  // namespace

// x: int8 [N, D, H, W, Cp] (Cp 32, 64 or 128, 16-byte aligned); w: int8
// [Cout_pad, 27, Cp] (the kernel [Cout, 3, 3, 3, Cp] zero-padded to Cout_pad
// rows, a multiple of 32 when Cout <= 32, else of 64); mode 0 writes int32
// sums, 1 float32 and 2 bfloat16 dequantized values (sx: N float32 scales,
// sx_stride 1, or one, 0; sk, bias: Cout float32), all [N, Cout, Do, Ho,
// Wo]. Returns the CUDA error of the launch (0 when it was queued).
extern "C" int msn_int8_conv3d(const void* x, const void* w, void* out,
                               const void* sx, int sx_stride, const void* sk,
                               const void* bias, int mode, int N, int D, int H,
                               int W, int Cp, int Cout, int cout_pad, int Do,
                               int Ho, int Wo, int stride, int pd, int ph,
                               int pw, void* stream) {
  // 64 output channels a block where their kernel fits beside the ring
  const int cout_blk = Cout <= 32 || Cp > 64 ? 32 : 64;
  const int64_t tiles_w = (Wo + kTM - 1) / kTM;
  const int64_t tiles = static_cast<int64_t>(N) * Do * Ho * tiles_w;
  if (N < 1 || D < 1 || H < 1 || W < 1 ||
      (Cp != 32 && Cp != 64 && Cp != 128) ||
      Cout < 1 || cout_pad < Cout || cout_pad % cout_blk != 0 || Do < 1 ||
      Ho < 1 || Wo < 1 || (stride != 1 && stride != 2) || pd < 0 || pd > 1 ||
      ph < 0 || ph > 1 || pw < 0 || pw > 1 || mode < kRaw || mode > kBF16 ||
      (mode != kRaw && (sx == nullptr || sk == nullptr || bias == nullptr ||
                        (sx_stride != 0 && sx_stride != 1))) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || tiles > 0x7fffffff ||
      static_cast<int64_t>(N) * D > 0x7fffffff ||
      static_cast<int64_t>(N) * cout_pad > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.sx = static_cast<const float*>(sx);
  p.sk = static_cast<const float*>(sk);
  p.bias = static_cast<const float*>(bias);
  p.sx_stride = sx_stride;
  p.D = D; p.H = H; p.W = W; p.Cout = Cout;
  p.Do = Do; p.Ho = Ho; p.Wo = Wo; p.pd = pd; p.ph = ph; p.pw = pw;
  p.tiles_w = static_cast<int>(tiles_w);
  p.tiles = static_cast<int>(tiles);
  const int out_size = mode == kRaw || mode == kF32 ? 4 : 2;
  p.vec_out = Wo * out_size % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Cp == 128)
    err = launch_stride<4, 4>(p, stride, mode, cout_pad, s);
  else if (cout_blk == 32)
    err = Cp == 32 ? launch_stride<4, 1>(p, stride, mode, cout_pad, s)
                   : launch_stride<4, 2>(p, stride, mode, cout_pad, s);
  else
    err = Cp == 32 ? launch_stride<8, 1>(p, stride, mode, cout_pad, s)
                   : launch_stride<8, 2>(p, stride, mode, cout_pad, s);
  return static_cast<int>(err);
}
