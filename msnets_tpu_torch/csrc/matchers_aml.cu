// The 8-channel matching-space volume from the census planes, for Hopper
// (sm_90a): the NCC, ZSAD and SAD-of-Sobel matchers, their clip
// normalizations, their AML likelihoods and the volume's assembly, margins
// trimmed, in one launch.
//
// Replaces no TPU kernel: the JAX package computes these matchers with XLA
// (msnets_tpu/ops/matchers.py: ncc_nister, zsad, sobel, sadsob,
// extract_aml; msnets_tpu/ops/features.py: _normalize_stack). The port's
// plain PyTorch version (ops/cuda/matchers_aml.py, matchers_aml_reference)
// makes about 980 kernel launches and 3,200 host ops a sample at D = 96 (a
// slice-copy a disparity per shifted map), so the stage was paced by the
// host; this kernel writes the finished volume
//   out[0] = census cost           (the census_aml planes, trimmed, cast)
//   out[1] = (1 + clip(ncc, -1, 1)) / 2
//   out[2] = clip(sobel_sad, 0, 2^13) * 2^-13
//   out[3] = clip(zsad, 0, 2^13) * 2^-13
//   out[4] = census AML            (the census_aml planes, trimmed, cast)
//   out[5..7] = AML over d of ncc (ncc_sigma), sobel_sad and zsad (both
//               sad_sigma, as the reference does)
// as [8, D, H', W'] in float32 or bfloat16 (round to nearest even), where a
// cost is INVALID outside its window's reference valid region (rows
// [wc, H-w+wc), cols [wc, W-w+wc), d <= c - wc) and an AML is 0 where its
// minimum is INVALID.
//
// Design. One block per (output row, tile of kTileW output columns), one
// column per lane, the disparities split over the block's kGroups warps
// (d = q, q + kGroups, ...):
//   1. the block stages, as floats, the 7 image rows around its row: the
//      left over its columns and their halo, the right over every column a
//      disparity shifts them to; from the right rows it computes, once a
//      column, the Sobel responses of the 5 window rows and the NCC and ZSAD
//      window statistics (box sum, rsqrt of n*B - A^2, mean);
//   2. each thread keeps its own pixel's left windows (5x5 pixels, 5x5
//      Sobel responses) and statistics in registers and computes its three
//      costs for each d once, from shared memory; it writes channels 0-3
//      and keeps the costs on chip ([3][min(D, kKeep)][kTileW] floats in
//      shared memory; costs of d >= kKeep are computed again where they
//      are needed, with the same arithmetic);
//   3. the per-pixel minima, then the sums of the weights, are reduced across
//      the warps through shared memory, the weights taking the kept costs'
//      place;
//   4. channels 4-7 are written one disparity at a time, coalesced along W.
// No [H, W, D] intermediate reaches device memory: the kernel reads the two
// images and the two census planes and writes the volume once.
//
// Numerics are those of the plain version, step by step: box sums of
// integers (exact in float32, so in any order); ZSAD adds |T - K| in the
// (u, v) order of matchers.zsad, each term rounded, from 0; NCC is
// ((-(n*S - A_l*A_r)) * C_l) * C_r with C = rsqrtf(n*B - A^2), which is
// PyTorch's CUDA torch.rsqrt, and 1 where a C is not finite (flat window);
// divisions by constants are multiplies by float32 reciprocals
// (matchers._div_const; 1/sigma comes from the caller), each product that
// a subtraction later reads rounded on its own (__fmul_rn: no fused
// multiply-add, which would keep the exact product); AML is
// expf(-(c - min)^2 * (1/sigma)) over a true-division sum, with every
// INVALID entry in the sum, no fast math. Only the order of the AML sum
// over d differs from the plain version.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel is write-bound. At the
// serving path's shape (the 384x1248 bucket: a 212x644 padded
// half-resolution pair, D = 96, 10-px margins, a 192x624 volume) it reads
// the two images (0.27 MB) and the trimmed census planes (92.0 MB) and
// writes the bf16 volume (184.0 MB): 276.3 MB, 82.5 us at 3.35 TB/s. Its
// arithmetic, 140 float32 operations a valid 5x5 (d, pixel) entry (ZSAD 75,
// SAD-of-Sobel 50, NCC 13, 10.8 M entries) and 24 an output entry (three
// AMLs and normalizations, 11.5 M), is 1.78 G operations, 26.6 us at 67
// TFLOP/s. Beyond those, each valid entry makes 53 shared-memory loads (the
// 5x5 right window and Sobel responses, the window statistics), which
// issue at one warp-wide load a clock per SM: 10.8 M / 32 x 53 loads over
// 132 SMs at 1.98 GHz is 68 us, and they sit on the critical path of each
// warp beside the arithmetic (PERF.md, section 6).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kInvalid = 2147483648.0f;   // float32(RAND_MAX), config.INVALID
constexpr int kThreads = 256;
constexpr int kTileW = 32;                  // output columns per block
constexpr int kGroups = kThreads / kTileW;  // warps across the disparities
constexpr int kKeep = 128;                  // disparities whose costs stay on chip
constexpr int kMaxSmem = 227 * 1024;        // a block's opt-in maximum

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float pixel(const uint8_t* __restrict__ img, int H,
                                       int W, int i, int j) {
  i = min(max(i, 0), H - 1);
  j = min(max(j, 0), W - 1);
  return static_cast<float>(img[static_cast<int64_t>(i) * W + j]);
}

// matchers.sobel at image (i, j), whose pixel is p[0] of staged rows of
// `pitch` floats: 0 outside rows [1, H-2) and cols [1, W-2), as the reference
// drops the last valid row and column. Integers: exact in any order.
__device__ __forceinline__ float sobel_at(const float* p, int pitch, int i,
                                          int j, int H, int W) {
  if (i < 1 || i >= H - 2 || j < 1 || j >= W - 2) return 0.0f;
  const float* up = p - pitch;
  const float* dn = p + pitch;
  return -up[-1] + up[1] - 2.0f * p[-1] + 2.0f * p[1] - dn[-1] + dn[1];
}

// Whether offset (u, v) of a window of side 2*wh + 1 lies in its centred
// sub-window of half side `half`.
__host__ __device__ constexpr bool in_window(int u, int v, int wh, int half) {
  return u - wh >= -half && u - wh <= half && v - wh >= -half && v - wh <= half;
}

// Last valid disparity of column c in row r for a window of w (-1: none).
__device__ __forceinline__ int last_valid(int r, int c, int H, int W, int D,
                                          int w) {
  const int wc = w / 2;
  const bool ok = r >= wc && r < H - w + wc && c >= wc && c < W - w + wc;
  return ok ? min(D - 1, c - wc) : -1;
}

// Weight of a cost c in an AML whose minimum is mn: the plain version's
// exp(_div_const(-(num * num), sigma)) with num = c - mn.
__device__ __forceinline__ float weight(float c, float mn, float inv_sigma) {
  const float num = c - mn;
  return expf(__fmul_rn(-__fmul_rn(num, num), inv_sigma));
}

template <int NW, int ZW, int SW>
struct Geometry {
  static constexpr int NC = NW / 2, ZC = ZW / 2, SC = SW / 2;
  static constexpr int WH = NC > ZC ? NC : ZC;           // right window half
  static constexpr int RH = WH > SC + 1 ? WH : SC + 1;   // staged half height
  static constexpr int RS = 2 * RH + 1;                  // staged rows
  static constexpr int WN = 2 * WH + 1;                  // right window side
  static constexpr int LP = kTileW + 2 * RH;             // left row pitch
};

// Shared-memory layout (floats) for D disparities, keeping the costs of
// keep_n of them.
struct Layout {
  int nr, rp, sp, lrows, rrows, sobr, stats, red, keep, total;
  __host__ __device__ Layout(int rs, int rh, int sw, int lp, int D, int keep_n) {
    nr = kTileW + D - 1;             // right centre columns c0 - (D-1) .. c0 + kTileW - 1
    rp = nr + 2 * rh;                // right row pitch
    sp = nr + 2 * (sw / 2);          // right Sobel row pitch
    lrows = 0;
    rrows = lrows + rs * lp;
    sobr = rrows + rs * rp;
    stats = sobr + sw * sp;          // A_r, C_r, mu_r: [3][nr]
    red = stats + 3 * nr;            // [3][kGroups][kTileW]
    keep = red + 3 * kGroups * kTileW;   // [3][keep_n][kTileW]
    total = keep + 3 * keep_n * kTileW;
  }
};

template <int NW, int ZW, int SW, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
matchers_aml_tile(const uint8_t* __restrict__ iml, const uint8_t* __restrict__ imr,
                  const float* __restrict__ cen_cost,
                  const float* __restrict__ cen_aml, OutT* __restrict__ out,
                  int H, int W, int D, int bh, int bwl, int hout, int wout,
                  float inv_ncc, float inv_sad, int keep_n) {
  using G = Geometry<NW, ZW, SW>;
  constexpr int WH = G::WH, RH = G::RH, RS = G::RS, WN = G::WN, LP = G::LP;
  constexpr int SC = G::SC;
  constexpr float kN = static_cast<float>(NW * NW);
  constexpr float kInvZ = 1.0f / static_cast<float>(ZW * ZW);
  extern __shared__ __align__(16) float smem[];
  const Layout L(RS, RH, SW, LP, D, keep_n);
  float* lrows = smem + L.lrows;
  float* rrows = smem + L.rrows;
  float* sobr = smem + L.sobr;
  float* a_r = smem + L.stats;
  float* c_r = a_r + L.nr;
  float* mu_r = c_r + L.nr;
  float* red = smem + L.red;
  float* keep = smem + L.keep;

  const int ro = blockIdx.y, r = ro + bh;                // output and image row
  const int co0 = blockIdx.x * kTileW, c0 = co0 + bwl;   // first column of each
  const int tcol = threadIdx.x % kTileW, q = threadIdx.x / kTileW;
  const int co = co0 + tcol, c = c0 + tcol;
  const bool in_out = co < wout;
  const int xr0 = c0 - (D - 1);                          // first right centre

  // 1. staged rows (clamped: only entries outside the valid region read
  // past the image), then the right columns' Sobel responses and statistics
  for (int k = threadIdx.x; k < RS * LP; k += kThreads)
    lrows[k] = pixel(iml, H, W, r - RH + k / LP, c0 - RH + k % LP);
  for (int k = threadIdx.x; k < RS * L.rp; k += kThreads)
    rrows[k] = pixel(imr, H, W, r - RH + k / L.rp, xr0 - RH + k % L.rp);
  __syncthreads();
  for (int k = threadIdx.x; k < SW * L.sp; k += kThreads) {
    const int u = k / L.sp, b = k % L.sp;                // row r - SC + u, col xr0 - SC + b
    sobr[k] = sobel_at(rrows + (RH - SC + u) * L.rp + b - SC + RH, L.rp,
                       r - SC + u, xr0 - SC + b, H, W);
  }
  for (int x = threadIdx.x; x < L.nr; x += kThreads) {
    const float* w = rrows + (RH - WH) * L.rp + x + RH - WH;   // window corner
    float a = 0.0f, b = 0.0f, m = 0.0f;
#pragma unroll
    for (int u = 0; u < WN; ++u)
#pragma unroll
      for (int v = 0; v < WN; ++v) {
        const float p = w[u * L.rp + v];
        if (in_window(u, v, WH, G::NC)) {
          a += p;
          b += p * p;
        }
        if (in_window(u, v, WH, G::ZC)) m += p;
      }
    const float var = kN * b - a * a;
    a_r[x] = a;
    c_r[x] = var > 0.0f ? rsqrtf(var) : INFINITY;
    mu_r[x] = __fmul_rn(m, kInvZ);
  }

  // 2. this pixel's left windows and statistics
  float lw[WN][WN], sl[SW][SW];
  float a_l = 0.0f, b_l = 0.0f, m_l = 0.0f;
#pragma unroll
  for (int u = 0; u < WN; ++u)
#pragma unroll
    for (int v = 0; v < WN; ++v) {
      const float p = lrows[(RH - WH + u) * LP + tcol + RH - WH + v];
      lw[u][v] = p;
      if (in_window(u, v, WH, G::NC)) {
        a_l += p;
        b_l += p * p;
      }
      if (in_window(u, v, WH, G::ZC)) m_l += p;
    }
#pragma unroll
  for (int u = 0; u < SW; ++u)
#pragma unroll
    for (int v = 0; v < SW; ++v)
      sl[u][v] = sobel_at(lrows + (RH - SC + u) * LP + tcol + RH - SC + v, LP,
                          r - SC + u, c - SC + v, H, W);
  const float var_l = kN * b_l - a_l * a_l;
  const float c_l = var_l > 0.0f ? rsqrtf(var_l) : INFINITY;
  m_l = __fmul_rn(m_l, kInvZ);
  const int dn = last_valid(r, c, H, W, D, NW);
  const int ds = last_valid(r, c, H, W, D, SW);
  const int dz = last_valid(r, c, H, W, D, ZW);
  __syncthreads();                           // the right columns are ready

  // the three costs (ncc, sobel_sad, zsad) of disparity d; x indexes the
  // right centre column c - d
  auto costs = [&](int d, float cv[3]) {
    const int x = tcol + D - 1 - d;
    const float* w = rrows + (RH - WH) * L.rp + x + RH - WH;
    const float k = m_l - mu_r[x];
    float s = 0.0f, z = 0.0f, sob = 0.0f;
#pragma unroll
    for (int u = 0; u < WN; ++u)
#pragma unroll
      for (int v = 0; v < WN; ++v) {
        const float p = w[u * L.rp + v];
        if (in_window(u, v, WH, G::ZC))
          z = z + fabsf((lw[u][v] - p) - k);
        if (in_window(u, v, WH, G::NC))
          s = fmaf(lw[u][v], p, s);
      }
#pragma unroll
    for (int u = 0; u < SW; ++u)
#pragma unroll
      for (int v = 0; v < SW; ++v)
        sob += fabsf(sl[u][v] - sobr[u * L.sp + x + v]);
    const float t = kN * s - a_l * a_r[x];
    const float cr = c_r[x];
    float ncc = __fmul_rn(__fmul_rn(-t, c_l), cr);
    if (!(isfinite(c_l) && isfinite(cr))) ncc = 1.0f;
    cv[0] = d <= dn ? ncc : kInvalid;
    cv[1] = d <= ds ? sob : kInvalid;
    cv[2] = d <= dz ? z : kInvalid;
  };

  const int64_t plane = static_cast<int64_t>(H) * W;     // census planes
  const int64_t oplane = static_cast<int64_t>(hout) * wout;
  const int64_t ochan = oplane * D;
  const float* cc = cen_cost + static_cast<int64_t>(r) * W + c;
  const float* ca = cen_aml + static_cast<int64_t>(r) * W + c;
  OutT* o = out + static_cast<int64_t>(ro) * wout + co;
  float* kp = keep + tcol;                   // kp[(ch * keep_n + d) * kTileW]

  // 2. costs, channels 0-3, minima
  float mn[3] = {kInvalid, kInvalid, kInvalid};
  for (int d = q; d < D; d += kGroups) {
    float cv[3];
    costs(d, cv);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      mn[ch] = fminf(mn[ch], cv[ch]);
      if (d < keep_n) kp[(ch * keep_n + d) * kTileW] = cv[ch];
    }
    if (in_out) {
      OutT* od = o + d * oplane;
      store(od, cc[d * plane]);
      store(od + ochan, (1.0f + fminf(fmaxf(cv[0], -1.0f), 1.0f)) * 0.5f);
      store(od + 2 * ochan, fminf(fmaxf(cv[1], 0.0f), 8192.0f) * (1.0f / 8192.0f));
      store(od + 3 * ochan, fminf(fmaxf(cv[2], 0.0f), 8192.0f) * (1.0f / 8192.0f));
    }
  }
  float* rd = red + tcol;                    // rd[(ch * kGroups + g) * kTileW]
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rd[(ch * kGroups + q) * kTileW] = mn[ch];
  __syncthreads();
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    for (int g = 0; g < kGroups; ++g) mn[ch] = fminf(mn[ch], rd[(ch * kGroups + g) * kTileW]);
  const float inv[3] = {inv_ncc, inv_sad, inv_sad};

  // 3. the sums of the weights; a kept cost gives way to its weight
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int d = q; d < D; d += kGroups) {
    float cv[3];
    if (d < keep_n) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) cv[ch] = kp[(ch * keep_n + d) * kTileW];
    } else {
      costs(d, cv);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float w = weight(cv[ch], mn[ch], inv[ch]);
      sum[ch] += w;
      if (d < keep_n) kp[(ch * keep_n + d) * kTileW] = w;
    }
  }
  __syncthreads();                           // every minimum is read
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rd[(ch * kGroups + q) * kTileW] = sum[ch];
  __syncthreads();
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    sum[ch] = 0.0f;
    for (int g = 0; g < kGroups; ++g) sum[ch] += rd[(ch * kGroups + g) * kTileW];
  }

  // 4. channels 4-7
  if (!in_out) return;
  for (int d = q; d < D; d += kGroups) {
    float w[3];
    if (d < keep_n) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch] = kp[(ch * keep_n + d) * kTileW];
    } else {
      float cv[3];
      costs(d, cv);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch] = weight(cv[ch], mn[ch], inv[ch]);
    }
    OutT* od = o + d * oplane + 4 * ochan;
    store(od, ca[d * plane]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      store(od + (ch + 1) * ochan, mn[ch] >= kInvalid ? 0.0f : w[ch] / sum[ch]);
  }
}

template <int NW, int ZW, int SW, typename OutT>
cudaError_t launch(const uint8_t* iml, const uint8_t* imr, const float* cen_cost,
                   const float* cen_aml, OutT* out, int H, int W, int D, int bh,
                   int bwl, int hout, int wout, float inv_ncc, float inv_sad,
                   cudaStream_t stream) {
  using G = Geometry<NW, ZW, SW>;
  const int keep_n = std::min(D, kKeep);
  const Layout L(G::RS, G::RH, SW, G::LP, D, keep_n);
  const size_t bytes = sizeof(float) * static_cast<size_t>(L.total);
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = matchers_aml_tile<NW, ZW, SW, OutT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((wout + kTileW - 1) / kTileW, hout);
  kernel<<<grid, kThreads, bytes, stream>>>(iml, imr, cen_cost, cen_aml, out, H,
                                            W, D, bh, bwl, hout, wout, inv_ncc,
                                            inv_sad, keep_n);
  return cudaGetLastError();
}

}  // namespace

// Launches matchers_aml_tile on `stream`. iml and imr are the uint8 [H, W]
// pair; cen_cost and cen_aml the float32 [D, H, W] planes of
// msn_census_aml; out is [8, D, H - 2*board_h, W - board_w_left -
// board_w_right], bfloat16 when out_bf16 is 1, else float32; inv_ncc and
// inv_sad are float32(1) / float32(sigma). Windows: nccw 3, sadw 5,
// sobelw 5. Returns cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue for other windows, an empty volume, more rows than
// the grid takes, or a D whose layout exceeds a block's shared memory);
// does not synchronise.
extern "C" int msn_matchers_aml(const void* iml, const void* imr,
                                const void* cen_cost, const void* cen_aml,
                                void* out, int out_bf16, int H, int W, int D,
                                int nccw, int sadw, int sobelw, float inv_ncc,
                                float inv_sad, int board_h, int board_w_left,
                                int board_w_right, void* stream) {
  const int hout = H - 2 * board_h, wout = W - board_w_left - board_w_right;
  if (D < 1 || board_h < 0 || board_w_left < 0 || board_w_right < 0 ||
      hout < 1 || wout < 1 || hout > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nccw != 3 || sadw != 5 || sobelw != 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const uint8_t*>(iml);
  const auto* rr = static_cast<const uint8_t*>(imr);
  const auto* cc = static_cast<const float*>(cen_cost);
  const auto* ca = static_cast<const float*>(cen_aml);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return static_cast<int>(launch<3, 5, 5>(l, rr, cc, ca,
                                            static_cast<__nv_bfloat16*>(out), H, W,
                                            D, board_h, board_w_left, hout, wout,
                                            inv_ncc, inv_sad, s));
  return static_cast<int>(launch<3, 5, 5>(l, rr, cc, ca, static_cast<float*>(out),
                                          H, W, D, board_h, board_w_left, hout,
                                          wout, inv_ncc, inv_sad, s));
}
