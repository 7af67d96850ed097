// K4: LayerNorm-folded MLP tail backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/mlp.py:_mlp_ln_bwd_kernel
// (wrapper fused_mlp_ln_bwd_pallas, VJP _fused_mlp_ln_bwd). The forward (K3)
// is, over M token rows of width C = 128 and a hidden width H:
//     a = LN(x) * gamma + beta,  z = a W1^T + b1,  h = GELU(z)
//     out = x + ls2 * (h W2^T + b2)
// with W1 (H, C), W2 (C, H) in the torch nn.Linear layout. For the output
// gradient g this computes, with do = g * ls2, dh = do W2, dz = dh * GELU'(z),
// da = dz W1, xhat = (x - mean) * rstd:
//     dx      = g + rstd * (da*gamma - mean(da*gamma) - xhat * mean(da*gamma*xhat))
//     dgamma  = sum_rows da * xhat          dbeta = sum_rows da
//     dW1     = sum_rows dz^T a             db1   = sum_rows dz
//     dW2     = ls2 * G, G = sum_rows g^T h  db2   = ls2 * sum_rows g
//     dls2    = sum_j W2 * G + b2 * sum_rows g    (= sum_rows g * (h W2^T + b2))
// GELU and its derivative Phi(z) + z phi(z) use erf in both dtypes.
//
// Bound on the H100: the minimum is 10*M*C*H FLOP (recompute fc1, then dh,
// da, dW1 and G = g^T h; dls2 through G spares the fc2 recompute) against
// ~4*M*C elements moved: bound by operations, 9.6 GFLOP at M = 14,688 and
// H = 512, 0.144 ms at the CUDA cores' f32 rate. This kernel does 14*M*C*H:
// the weight-gradient pass recomputes fc1 and dh once more.
//
// The TPU kernel summed the parameter gradients over a sequential grid; the
// card's blocks run in no order, and dW1 alone (256 KB in f32) does not fit
// in shared memory. So three launches, and no atomics, so that reruns are
// bitwise equal. Inputs of either dtype are staged in f32 and every product
// accumulates in f32 on the CUDA cores (TF32 keeps ~3 digits and would break
// the 1e-4 the gradients are held to); only dx is rounded to the input dtype.
// Tail rows of a ragged M are loaded as zeros; their g is zero, so dh, dz
// and every contribution of theirs vanish.
//
//  1. dx pass (mlp_ln_bwd_dx_kernel): fc1 recomputed, dh, dz, da and dx; the
//     tile's partial sums of da*xhat, da and g per channel to a workspace.
//     6*M*C*H FLOP: 5.78 GFLOP at M = 14,688, H = 512, bound 0.0862 ms at
//     67 TFLOP/s (x, g in and dx out, ~23 MB in f32, take 0.007 ms).
//     - Waves: one block of 256 threads per 112-row tile, one block a SM
//       (~217 KB of shared memory, 208 registers a thread in f32):
//       ceil(14,688 / 112) = 132 blocks on the 132 SMs, one wave (64-row
//       tiles would give 230 blocks, 1.74 waves).
//     - Shared memory: aS = LN(x)*gamma + beta and dS = g*ls2, row-major at
//       a stride of C + 4 (2 x 59,136 B); zS, hS, 112 x (32 + 8) floats
//       (2 x 17,920 B); mean and rstd a row (896 B); then the weights. f32:
//       a ring of two stages, each W1 rows j0..j0+31 (stride C + 4),
//       W2[:, j0..j0+31] and b1[j0..j0+31] (33,408 B): 221,824 B. bf16: one
//       bf16 stage (16,960 B), two widened W1 chunks with their b1 and one
//       widened W2 chunk (50,432 B): 222,400 B.
//     - The ring: each chunk is copied raw with 16-byte cp.async.cg, so no
//       synchronous global load stays in the hidden loop; ls2 is folded into
//       g when the tile is staged (do = g * ls2), so W2 is copied raw. f32:
//       chunk j+1 is issued at the barrier that opens chunk j and lands
//       while chunk j is multiplied. bf16: chunk j+1 lands in the bf16 stage
//       during chunk j's products and is widened to f32 during chunk j's dz
//       step (its W2 buffer is free then, its W1 buffer is the other of
//       two), so the products read f32 in both dtypes and wait for nothing.
//     - Register-tiled products, operands read as float4s from layouts
//       padded against bank conflicts: warps 0-3 run fc1 (7 rows x 4
//       hidden columns a thread: 4 W1 + 7 a float4s per 112 FMAs), warps
//       4-7 run dh (7 x 4: 4 W2 + 7 do float4s per 112 FMAs); z + b1 and dh
//       meet in shared memory, all 256 threads take dz = dh * GELU'(z) in
//       place (14 each), and da += dz W1c runs 7 rows x 8 channels a thread
//       (8 W1 + 7 dz float4s per 224 FMAs), kept in 56 registers over the
//       whole hidden width: one shared-memory load per 10-15 FMAs. Three
//       barriers a chunk, 16 chunks at H = 512.
//     - Epilogue: the 16 lanes of a half warp hold one row's 128 channels
//       of da, so the row's two means take 4 shuffles; x and g are re-read
//       (L2), xhat from the staged mean and rstd; the per-channel sums over
//       the tile's 16 row groups are added in a fixed order.
//     Registers, spills and blocks a SM: kasf_mlp_ln_bwd_info, and
//     chip_smoke.py phase 7's report (no spill in either dtype).
//  2. weight pass (mlp_ln_bwd_w_kernel): one block per (hidden chunk of 64,
//     row split); the split's 40-row tiles in order; per tile a = LN(x) *
//     gamma + beta, z = a W1c^T + b1c, dh = g (ls2 * W2c), dz = dh * GELU'(z)
//     and h = GELU(z) recomputed, and dW1c += dz^T a, G_c += g^T h and db1c
//     += dz accumulated in registers over all of the split's tiles, then
//     written to the workspace as the split's partial. 8*M*C*H FLOP: 7.70
//     GFLOP at M = 14,688, H = 512, bound 0.1149 ms at 67 TFLOP/s.
//     - Grid: H / 64 chunks x splits, splits = min(tiles, 132 / chunks): 8 x
//       16 = 128 blocks at H = 512 on the 132 SMs, one block a SM (4 SMs
//       idle, 3 %: 132 blocks need a chunk count that divides 132, and a
//       chunk of 128 needs 128 accumulators a thread). A split takes
//       ceil(tiles / splits) consecutive tiles (trailing splits may be empty
//       and write zeros). 40-row tiles: 368 at M = 14,688, exactly 23 a
//       split, 920 rows a block against the ideal 918 (48-row tiles give 20
//       of 960; 64-row ones do not fit beside the stage).
//     - Shared memory (floats): aS = LN(x) * gamma + beta and gS = g,
//       row-major at a stride of C + 4 (2 x 21,120 B); zS, hS and the second
//       channel half's zS2, hS2, 40 x (64 + 8) (4 x 11,520 B); the chunk's
//       W1^T and ls2 * W2, both channel-major [c][j] (2 x 32,768 B), and b1,
//       staged and widened once a block; a raw stage of the next tile's x
//       and g rows in the input dtype (40,960 B in f32, 20,480 in bf16) and
//       its mbarrier: 195,080 B in f32, 174,600 in bf16.
//     - Row staging off the critical path: one thread copies tile t+1's x
//       and g rows (two contiguous runs) into the stage with two bulk copies
//       (cp.async.bulk on the TMA engine, completing on an mbarrier) while
//       tile t is multiplied. 16-byte cp.async (2,560 a tile in f32) cost
//       ~600 cycles a tile in whichever phase issued them, and 20-36 more
//       registers a thread. At the top of a tile each warp normalises five
//       rows from the stage (lane l holds channels 4l..4l+3, gamma and beta
//       in registers; the five rows' shuffle sums interleaved, rsqrtf) into
//       aS and widens g into gS; rows >= M are zeros (a = beta, g = 0), so
//       their dz and g vanish. Each of a split's 8 chunk blocks reads its
//       rows once, from L2.
//     - fc1 and dh each split their 128 channels over two warp pairs
//       (warps 0-1 | 2-3 fc1, 4-5 | 6-7 dh), so a thread holds 5 rows x 8
//       hidden columns: 8 weight and 5 a (or g) float4s per 160 FMAs (12.3
//       FMAs a load; 5 x 4 over all channels gave 8.9 and took ~9.4k cycles
//       a tile where this takes ~8.1k). W1 is staged transposed, like ls2 *
//       W2, so one function serves both (fc1 reading W1 row-major paired
//       a.k with w.k, both from float4s in one register bank, and ran ~15 %
//       behind dh). A four-way split with 8 x 8 tiles at 32 rows (16 FMAs a
//       load) gave the same cycles a row: the products issue FMAs at 63-75 %
//       of the pipe's rate, not bound by shared loads.
//       z = zS + zS2 + b1 and dh = hS + hS2; then every thread takes 10
//       elements, h and dz from one erff and one expf each (gelu_and_grad),
//       and sums its dz into db1; then warps 0-3 accumulate dW1c (8 hidden x
//       8 channels a thread) and warps 4-7 G_c (8 channels x 8 hidden), each
//       reading 4 float4s per row for 64 FMAs (16) into 64 registers kept
//       over the whole split. Four barriers a tile; float4 loads touch 4 or
//       8 distinct rows, or neighbouring float4s of one row, so no shared
//       bank conflicts and no transposed store.
//     - Epilogue: float4 stores of dW1c and G_c; db1c summed over the 8 row
//       groups in order.
//     Registers, spills and blocks a SM of both passes: kasf_mlp_ln_bwd_info
//     and chip_smoke.py phase 7's report (a spill in either fails it); a
//     tile's split by phase: scripts/k4_weight_pass_probe.py.
//  3. reduce pass: sum the partials in a fixed order (the dx pass's per
//     tile, the weight pass's per split) and finish dgamma, dbeta, dW1, db1,
//     dW2, db2 and dls2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kC = 128;  // model width
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- 1. dx pass: its own tile (the helpers above belong to the weight pass)
namespace dxp {

using bf16 = __nv_bfloat16;
using kasf_mma::cp_async16;

constexpr int kR = 112;          // rows a tile: ceil(14,688 / 112) = 132 blocks
constexpr int kKC = 32;          // hidden columns a chunk
constexpr int kT = 256;          // threads a block: 8 warps
constexpr int kRG = 16;          // row groups; group q owns rows q + 16 i
constexpr int kRT = kR / kRG;    // 7 rows a thread
constexpr int kLdA = kC + 4;     // aS, dS rows: LN(x) * gamma + beta, g * ls2
constexpr int kLdZ = kKC + 8;    // zS, hS rows: z + b1 (then dz), dh
constexpr int kLdW1 = kC + 4;    // W1 chunk rows in f32, as in memory
constexpr int kLdW1h = kC + 8;   // W1 chunk rows in bf16
// a chunk in f32 (floats): W1 rows | W2 columns (C rows of kKC) | b1
constexpr int kW1F = kKC * kLdW1, kW2F = kC * kKC, kStageF = kW1F + kW2F + kKC;
// a chunk in bf16 (elements), the same order
constexpr int kW1H = kKC * kLdW1h, kW2H = kC * kKC, kStageH = kW1H + kW2H + kKC;
// shared memory in floats: aS, dS | zS, hS | mean, rstd | ring. In f32 the
// ring is two stages; in bf16 two widened W1 chunks (each with its b1), one
// widened W2 chunk and one bf16 stage
constexpr int kOffZ = 2 * kR * kLdA;
constexpr int kOffStat = kOffZ + 2 * kR * kLdZ;
constexpr int kOffRing = kOffStat + 2 * kR;
constexpr int kW1B = kW1F + kKC;         // a widened W1 chunk and its b1
constexpr int kOffW2f = 2 * kW1B;        // from kOffRing
constexpr int kOffStageH = kOffW2f + kW2F;
static_assert(kR % kRG == 0 && kR % (2 * kT / 32) == 0 && kKC * kC % (4 * kT) == 0 &&
                  kR * kKC % (2 * kT) == 0,
              "the threads divide the tile, the chunk and the dz step evenly");
static_assert(kOffStat % 4 == 0 && kOffRing % 4 == 0 && kStageF % 4 == 0 && kW1B % 4 == 0 &&
                  kOffStageH % 4 == 0 && kW1H % 8 == 0 && kW2H % 8 == 0,
              "16-byte alignment of the shared buffers");
static_assert(kRG * 3 * kC <= 2 * kR * kLdA, "the epilogue's sums fit in aS and dS");

template <typename T>
constexpr size_t smem_bytes() {
  return std::is_same<T, float>::value
             ? sizeof(float) * (kOffRing + 2 * kStageF)
             : sizeof(float) * (kOffRing + kOffStageH) + sizeof(bf16) * kStageH;
}
static_assert(smem_bytes<float>() <= 232448 && smem_bytes<bf16>() <= 232448,
              "a block fits the H100's 227 KB");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// four neighbouring elements of a row in device memory, as f32
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(kasf_mma::bf16_lo(v.x), kasf_mma::bf16_hi(v.x), kasf_mma::bf16_lo(v.y),
                     kasf_mma::bf16_hi(v.y));
}
__device__ __forceinline__ void store4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(kasf_mma::pack_bf16(v.x, v.y), kasf_mma::pack_bf16(v.z, v.w));
}

// Start copying hidden chunk j0 (W1 rows j0.., W2 columns j0.., b1) into a
// ring stage, raw, in 16-byte pieces; one group (empty past the last chunk)
__device__ __forceinline__ void fetch_chunk(float* st, const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b1, int j0, int H,
                                            int tid) {
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < kKC * kC / 4 / kT; ++i) {
      const int e = tid + i * kT, j = e / (kC / 4), c4 = e % (kC / 4);
      cp_async16(st + j * kLdW1 + c4 * 4, w1 + (j0 + j) * kC + c4 * 4);
    }
#pragma unroll
    for (int i = 0; i < kC * kKC / 4 / kT; ++i) {
      const int e = tid + i * kT, c = e / (kKC / 4), j4 = e % (kKC / 4);
      cp_async16(st + kW1F + c * kKC + j4 * 4, w2 + c * H + j0 + j4 * 4);
    }
    if (tid < kKC / 4) cp_async16(st + kW1F + kW2F + tid * 4, b1 + j0 + tid * 4);
  }
  kasf_mma::cp_async_commit();
}
__device__ __forceinline__ void fetch_chunk(bf16* st, const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2,
                                            const bf16* __restrict__ b1, int j0, int H,
                                            int tid) {
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < kKC * kC / 8 / kT; ++i) {
      const int e = tid + i * kT, j = e / (kC / 8), c8 = e % (kC / 8);
      cp_async16(st + j * kLdW1h + c8 * 8, w1 + (j0 + j) * kC + c8 * 8);
    }
#pragma unroll
    for (int i = 0; i < kC * kKC / 8 / kT; ++i) {
      const int e = tid + i * kT, c = e / (kKC / 8), j8 = e % (kKC / 8);
      cp_async16(st + kW1H + c * kKC + j8 * 8, w2 + c * H + j0 + j8 * 8);
    }
    if (tid < kKC / 8) cp_async16(st + kW1H + kW2H + tid * 8, b1 + j0 + tid * 8);
  }
  kasf_mma::cp_async_commit();
}

// eight bf16 of shared memory widened (exactly) to f32
__device__ __forceinline__ void widen8(float* dst, const bf16* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  st4(dst, make_float4(kasf_mma::bf16_lo(v.x), kasf_mma::bf16_hi(v.x), kasf_mma::bf16_lo(v.y),
                       kasf_mma::bf16_hi(v.y)));
  st4(dst + 4, make_float4(kasf_mma::bf16_lo(v.z), kasf_mma::bf16_hi(v.z),
                           kasf_mma::bf16_lo(v.w), kasf_mma::bf16_hi(v.w)));
}

// A landed bf16 chunk widened (all threads): W1 rows to w1f (b1 after
// them, at kW1F), W2 columns to w2f, in the f32 chunk's layouts
__device__ __forceinline__ void widen_chunk(float* w1f, float* w2f, const bf16* st, int tid) {
#pragma unroll
  for (int i = 0; i < kKC * kC / 8 / kT; ++i) {
    const int e = tid + i * kT, j = e / (kC / 8), c8 = e % (kC / 8);
    widen8(w1f + j * kLdW1 + c8 * 8, st + j * kLdW1h + c8 * 8);
  }
#pragma unroll
  for (int i = 0; i < kC * kKC / 8 / kT; ++i) {
    const int e = tid + i * kT;
    widen8(w2f + e * 8, st + kW1H + e * 8);
  }
  if (tid < kKC / 8) widen8(w1f + kW1F + tid * 8, st + kW1H + kW2H + tid * 8);
}

// Stage the tile: aS = LN(x) * gamma + beta, dS = g * ls2 (row-major), and
// each row's mean and rstd. Warp w takes rows w, w + 8, ...; lane l holds
// channels 4l..4l+3. Tail rows (>= M) are zeros: a = beta, do = 0.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, const T* __restrict__ g,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ ls2, float* aS,
                                           float* dS, float* sMean, float* sRstd,
                                           long long row0, long long M, float eps, int warp,
                                           int lane) {
  constexpr int kHalf = kR / (kT / 32) / 2;  // 7 rows of a warp's 14 at a time
  const float4 gm = ld4(gamma + 4 * lane), bt = ld4(beta + 4 * lane), ls = ld4(ls2 + 4 * lane);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float4 xv[kHalf], gv[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {  // the loads of 7 rows in flight together
      const long long row = row0 + warp + (kT / 32) * (h * kHalf + i);
      xv[i] = row < M ? load4(x + row * kC + 4 * lane) : zero;
      gv[i] = row < M ? load4(g + row * kC + 4 * lane) : zero;
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int r = warp + (kT / 32) * (h * kHalf + i);
      const float4 v = xv[i];
      const float mean = warp_sum((v.x + v.y) + (v.z + v.w)) * (1.0f / kC);
      const float4 xc = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
      const float sq = (xc.x * xc.x + xc.y * xc.y) + (xc.z * xc.z + xc.w * xc.w);
      const float rstd = 1.0f / sqrtf(warp_sum(sq) * (1.0f / kC) + eps);
      st4(aS + r * kLdA + 4 * lane,
          make_float4(fmaf(xc.x * rstd, gm.x, bt.x), fmaf(xc.y * rstd, gm.y, bt.y),
                      fmaf(xc.z * rstd, gm.z, bt.z), fmaf(xc.w * rstd, gm.w, bt.w)));
      st4(dS + r * kLdA + 4 * lane, make_float4(gv[i].x * ls.x, gv[i].y * ls.y,
                                                gv[i].z * ls.z, gv[i].w * ls.w));
      if (lane == 0) {
        sMean[r] = mean;
        sRstd[r] = rstd;
      }
    }
  }
}

// fc1 of the chunk, z = a W1c^T + b1c, into zS. Thread (row group q of 16,
// column group p of 8): rows q + 16i, hidden columns p + 8u (u < 4); each
// step of four channels reads 4 W1 and 7 a float4s for 112 FMAs.
__device__ __forceinline__ void fc1_chunk(const float* aS, const float* w1c, const float* b1c,
                                          float* zS, int q, int p) {
  float acc[kRT][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll 2
  for (int c = 0; c < kC; c += 4) {
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld4(w1c + (p + 8 * u) * kLdW1 + c);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float4 a = ld4(aS + (q + kRG * i) * kLdA + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][u] = fmaf(a.x, w[u].x, acc[i][u]);
        acc[i][u] = fmaf(a.y, w[u].y, acc[i][u]);
        acc[i][u] = fmaf(a.z, w[u].z, acc[i][u]);
        acc[i][u] = fmaf(a.w, w[u].w, acc[i][u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float bias = b1c[p + 8 * u];
#pragma unroll
    for (int i = 0; i < kRT; ++i) zS[(q + kRG * i) * kLdZ + p + 8 * u] = acc[i][u] + bias;
  }
}

// dh of the chunk, dh = do W2c, into hS. Thread (q, p): rows q + 16i,
// hidden columns 4p..4p+3; each step of four channels reads 4 W2 and 7 do
// float4s for 112 FMAs.
__device__ __forceinline__ void dh_chunk(const float* dS, const float* w2c, float* hS, int q,
                                         int p) {
  float acc[kRT][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
#pragma unroll 2
  for (int c = 0; c < kC; c += 4) {
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld4(w2c + (c + u) * kKC + 4 * p);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float4 d = ld4(dS + (q + kRG * i) * kLdA + c);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[i][v] = fmaf(d.x, lane4(w[0], v), acc[i][v]);
        acc[i][v] = fmaf(d.y, lane4(w[1], v), acc[i][v]);
        acc[i][v] = fmaf(d.z, lane4(w[2], v), acc[i][v]);
        acc[i][v] = fmaf(d.w, lane4(w[3], v), acc[i][v]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    st4(hS + (q + kRG * i) * kLdZ + 4 * p,
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// da += dz W1c. Thread (row group q, channel group p of 16): rows q + 16i,
// channels 4p..4p+3 and 64 + 4p..; each step of four hidden columns reads 8
// W1 and 7 dz float4s for 224 FMAs.
__device__ __forceinline__ void da_chunk(const float* zS, const float* w1c,
                                         float (&da)[kRT][8], int q, int p) {
#pragma unroll 2
  for (int j = 0; j < kKC; j += 4) {
    float4 wa[4], wb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wa[u] = ld4(w1c + (j + u) * kLdW1 + 4 * p);
      wb[u] = ld4(w1c + (j + u) * kLdW1 + kC / 2 + 4 * p);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float4 d = ld4(zS + (q + kRG * i) * kLdZ + j);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        da[i][v] = fmaf(d.x, lane4(wa[0], v), da[i][v]);
        da[i][v] = fmaf(d.y, lane4(wa[1], v), da[i][v]);
        da[i][v] = fmaf(d.z, lane4(wa[2], v), da[i][v]);
        da[i][v] = fmaf(d.w, lane4(wa[3], v), da[i][v]);
        da[i][4 + v] = fmaf(d.x, lane4(wb[0], v), da[i][4 + v]);
        da[i][4 + v] = fmaf(d.y, lane4(wb[1], v), da[i][4 + v]);
        da[i][4 + v] = fmaf(d.z, lane4(wb[2], v), da[i][4 + v]);
        da[i][4 + v] = fmaf(d.w, lane4(wb[3], v), da[i][4 + v]);
      }
    }
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace dxp

// One block per 112-row tile; the hidden width in chunks of 32 through a
// cp.async ring; warps 0-3 run fc1 and warps 4-7 dh, then all take dz and
// da; dx and the tile's partial sums at the end. bf16 weights land in one
// bf16 stage and are widened during the previous chunk's dz step, so the
// products read f32 chunks in both dtypes.
template <typename T>
__global__ void __launch_bounds__(dxp::kT, 1)
mlp_ln_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ ls2,
                     T* __restrict__ dx, float* __restrict__ part, long long M, int H,
                     float eps) {
  using namespace dxp;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* dS = aS + kR * kLdA;
  float* zS = aS + kOffZ;
  float* hS = zS + kR * kLdZ;
  float* sMean = aS + kOffStat;
  float* sRstd = sMean + kR;
  float* ring = aS + kOffRing;
  // f32: stages at ring and ring + kStageF. bf16: the widened W1 chunks (with
  // b1) at ring and ring + kW1B, the W2 chunk at ring + kOffW2f, the bf16
  // stage after it
  T* st0 = reinterpret_cast<T*>(kF32 ? ring : ring + kOffStageH);
  T* st1 = reinterpret_cast<T*>(ring + kStageF);  // f32 only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kR;
  fetch_chunk(st0, w1, w2, b1, 0, H, tid);
  stage_rows(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, row0, M, eps, warp, lane);
  if constexpr (!kF32) {
    kasf_mma::cp_async_wait<0>();
    __syncthreads();
    widen_chunk(ring, ring + kOffW2f, st0, tid);
    __syncthreads();  // the bf16 stage is free
    fetch_chunk(st0, w1, w2, b1, kKC, H, tid);
  }

  // fc1 / dh layout: row group 4 (warp % 4) + lane / 8, column group lane % 8;
  // da layout: row group 2 warp + lane / 16, channel group lane % 16
  const int q1 = (warp & 3) * 4 + (lane >> 3), p1 = lane & 7;
  const int q4 = warp * 2 + (lane >> 4), p4 = lane & 15;
  float da[kRT][8];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) da[i][k] = 0.f;

  for (int j0 = 0, s = 0; j0 < H; j0 += kKC, s ^= 1) {
    // this chunk's W1, W2 and b1 in f32
    const float* w1c =
        kF32 ? reinterpret_cast<const float*>(s ? st1 : st0) : ring + s * kW1B;
    const float* w2c = kF32 ? w1c + kW1F : ring + kOffW2f;
    const float* b1c = w1c + (kF32 ? kW1F + kW2F : kW1F);
    if constexpr (kF32) kasf_mma::cp_async_wait<0>();
    __syncthreads();  // this chunk is in; the last chunk's zS and stage are consumed
    if constexpr (kF32) fetch_chunk(s ? st0 : st1, w1, w2, b1, j0 + kKC, H, tid);
    if (warp < 4)
      fc1_chunk(aS, w1c, b1c, zS, q1, p1);
    else
      dh_chunk(dS, w2c, hS, q1, p1);
    if constexpr (!kF32) kasf_mma::cp_async_wait<0>();
    __syncthreads();  // z and dh in; bf16: the next chunk landed, W2's buffer free
    // dz = dh * GELU'(z + b1) in place of z, 14 elements a thread
#pragma unroll
    for (int i = 0; i < kR * kKC / 2 / kT; ++i) {
      const int e = tid + i * kT, r = e / (kKC / 2), j2 = e % (kKC / 2) * 2;
      const float2 z = *reinterpret_cast<const float2*>(zS + r * kLdZ + j2);
      const float2 h = *reinterpret_cast<const float2*>(hS + r * kLdZ + j2);
      *reinterpret_cast<float2*>(zS + r * kLdZ + j2) =
          make_float2(h.x * gelu_erf_grad(z.x), h.y * gelu_erf_grad(z.y));
    }
    if constexpr (!kF32)  // the next chunk
      if (j0 + kKC < H) widen_chunk(ring + (s ^ 1) * kW1B, ring + kOffW2f, st0, tid);
    __syncthreads();  // dz in; bf16: the next chunk widened, the bf16 stage free
    if constexpr (!kF32) fetch_chunk(st0, w1, w2, b1, j0 + 2 * kKC, H, tid);
    da_chunk(zS, w1c, da, q4, p4);
  }

  // ---- dx per row (the 16 lanes of a half warp hold a row's 128 channels)
  // and the thread's sums of da * xhat, da and g over its valid rows
  const float4 gma = ld4(gamma + 4 * p4), gmb = ld4(gamma + kC / 2 + 4 * p4);
  const float gam[8] = {gma.x, gma.y, gma.z, gma.w, gmb.x, gmb.y, gmb.z, gmb.w};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float sx[8], sd[8], sg[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sx[k] = sd[k] = sg[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = q4 + kRG * i;
    const long long row = row0 + r;
    const bool valid = row < M;
    const float mean = sMean[r], rstd = sRstd[r];
    const T* xr = x + row * kC + 4 * p4;
    const T* gr = g + row * kC + 4 * p4;
    const float4 xa = valid ? load4(xr) : zero, xb = valid ? load4(xr + kC / 2) : zero;
    const float4 ga = valid ? load4(gr) : zero, gb = valid ? load4(gr + kC / 2) : zero;
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    float xh[8], dxh[8], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      xh[k] = (xv[k] - mean) * rstd;
      dxh[k] = da[i][k] * gam[k];
      m1 += dxh[k];
      m2 = fmaf(dxh[k], xh[k], m2);
    }
    m1 = half_warp_sum(m1) * (1.0f / kC);
    m2 = half_warp_sum(m2) * (1.0f / kC);
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = gv[k] + rstd * (dxh[k] - m1 - xh[k] * m2);
    if (valid) {
      store4(dx + row * kC + 4 * p4, make_float4(o[0], o[1], o[2], o[3]));
      store4(dx + row * kC + kC / 2 + 4 * p4, make_float4(o[4], o[5], o[6], o[7]));
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sx[k] = fmaf(da[i][k], xh[k], sx[k]);
        sd[k] += da[i][k];
        sg[k] += gv[k];
      }
    }
  }
  // the tile's sums over the 16 row groups, in order; aS and dS are free
  // (last read before the final chunk's second barrier)
  float* red = aS + q4 * 3 * kC + 4 * p4;  // [row group][3][C]
  st4(red, make_float4(sx[0], sx[1], sx[2], sx[3]));
  st4(red + kC / 2, make_float4(sx[4], sx[5], sx[6], sx[7]));
  st4(red + kC, make_float4(sd[0], sd[1], sd[2], sd[3]));
  st4(red + kC + kC / 2, make_float4(sd[4], sd[5], sd[6], sd[7]));
  st4(red + 2 * kC, make_float4(sg[0], sg[1], sg[2], sg[3]));
  st4(red + 2 * kC + kC / 2, make_float4(sg[4], sg[5], sg[6], sg[7]));
  __syncthreads();
  if (tid < kC) {
    float t[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < kRG; ++q)
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) t[k3] += aS[(q * 3 + k3) * kC + tid];
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
      part[(static_cast<long long>(blockIdx.x) * 3 + k3) * kC + tid] = t[k3];
  }
}

// ---- 2. weight pass: its own tile and helpers
namespace wp {

using bf16 = __nv_bfloat16;
using dxp::ld4;
using dxp::load4;
using dxp::st4;

constexpr int kR = 40;           // rows a tile: 368 tiles at M = 14,688, 23 a split
constexpr int kJ = 64;           // hidden columns a block (its chunk)
constexpr int kT = 256;          // threads a block: 8 warps
constexpr int kRG = kT / 32;     // row groups: group q owns rows q + 8 i
constexpr int kRT = kR / kRG;    // 5 rows a thread
constexpr int kSMs = 132;        // the H100's: splits = min(tiles, 132 / chunks)
constexpr int kLdA = kC + 4;     // aS, gS rows: LN(x) * gamma + beta, g
constexpr int kLdZ = kJ + 8;     // zS, hS rows: z (then h), dh (then dz)
constexpr int kLdW = kJ;         // W1 chunk transposed and ls2 * W2 chunk,
                                 // channel-major: [c][j]
constexpr int kKH = kC / 2;      // channels a half of fc1 or dh
// shared memory in floats: aS, gS | zS, hS, then their second halves' sums
// zS2, hS2 | W1^T, ls2 * W2, b1 of the chunk | the raw stage of the next
// tile's x and g rows, in the input dtype
constexpr int kOffZ = 2 * kR * kLdA;
constexpr int kOffW1 = kOffZ + 4 * kR * kLdZ;
constexpr int kOffW2 = kOffW1 + kC * kLdW;
constexpr int kOffB1 = kOffW2 + kC * kLdW;
constexpr int kOffRaw = kOffB1 + kJ;
static_assert(kR % kRG == 0 && kRG == 8 && kJ == 64 && kC == 128,
              "the thread layouts below assume 8 warps, 64 columns and C = 128");
static_assert(kOffZ % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 && kOffRaw % 4 == 0 &&
                  kLdA % 4 == 0 && kLdZ % 4 == 0,
              "16-byte alignment of the shared buffers");
static_assert(kRG * kJ <= kR * kLdA, "the epilogue's db1 sums fit in aS");

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * kOffRaw + sizeof(T) * 2 * kR * kC + sizeof(unsigned long long);
}
static_assert(smem_bytes<float>() <= 232448 && smem_bytes<bf16>() <= 232448,
              "a block fits the H100's 227 KB");

__host__ __device__ inline long long tiles(long long M) { return (M + kR - 1) / kR; }
inline int splits(long long M, int H) {
  const long long s = kSMs / (H / kJ), t = tiles(M);
  return static_cast<int>(s < 1 ? 1 : s < t ? s : t);
}

// GELU(z) and GELU'(z) = Phi(z) + z phi(z) from one erff and one expf
__device__ __forceinline__ float2 gelu_and_grad(float z) {
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752f));
  return make_float2(z * cdf, cdf + z * expf(-0.5f * z * z) * 0.39894228040143268f);
}

using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;

// One thread: copy the tile's rows row0.. (those < M) of x and of g, each a
// contiguous run in device memory, raw into the stage by two bulk copies
// (the TMA engine; no per-thread copy instructions) that complete on bar.
template <typename T>
__device__ __forceinline__ void fetch_rows(T* raw, const T* __restrict__ x,
                                           const T* __restrict__ g, long long row0,
                                           long long M, unsigned long long* bar) {
  const long long n = M - row0 < kR ? M - row0 : kR;
  const unsigned bytes = static_cast<unsigned>(n * kC * sizeof(T));
  kasf_mma::mbar_expect(bar, 2 * bytes);
  kasf_mma::bulk_load(raw, x + row0 * kC, bytes, bar);
  kasf_mma::bulk_load(raw + kR * kC, g + row0 * kC, bytes, bar);
}

// Stage the chunk's weights once, widened and channel-major: w1t[c][j] =
// W1[j0 + j][c], w2s[c][j] = ls2[c] * W2[c][j0 + j], and b1[j0..]
template <typename T>
__device__ __forceinline__ void stage_weights(float* w1t, float* w2s, float* b1s,
                                              const T* __restrict__ w1,
                                              const T* __restrict__ w2,
                                              const T* __restrict__ b1,
                                              const float* __restrict__ ls2, int j0, int H,
                                              int tid) {
  constexpr int kN = kJ * kC / 4 / kT;  // float4s a thread, of each matrix
  float4 v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {  // a warp's lanes on neighbouring j
    const int e = tid + i * kT, j = e % kJ, c4 = e / kJ;
    v[i] = load4(w1 + static_cast<long long>(j0 + j) * kC + 4 * c4);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, j = e % kJ, c4 = e / kJ;
    float* col = w1t + 4 * c4 * kLdW + j;
    col[0] = v[i].x;
    col[kLdW] = v[i].y;
    col[2 * kLdW] = v[i].z;
    col[3 * kLdW] = v[i].w;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, c = e / (kJ / 4), j4 = e % (kJ / 4);
    v[i] = load4(w2 + static_cast<long long>(c) * H + j0 + 4 * j4);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, c = e / (kJ / 4), j4 = e % (kJ / 4);
    const float s = ls2[c];
    st4(w2s + c * kLdW + 4 * j4, make_float4(v[i].x * s, v[i].y * s, v[i].z * s, v[i].w * s));
  }
  if (tid < kJ) b1s[tid] = to_f(b1[j0 + tid]);
}

// four neighbouring elements of a staged row, as f32
__device__ __forceinline__ float4 raw4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 raw4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(kasf_mma::bf16_lo(v.x), kasf_mma::bf16_hi(v.x), kasf_mma::bf16_lo(v.y),
                     kasf_mma::bf16_hi(v.y));
}

// each of the warp's row sums over its 32 lanes (warp_sum's order)
__device__ __forceinline__ void rows_sum(float (&s)[kRT]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kRT; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
}

// aS = LN(x) * gamma + beta and gS = g from the raw stage. Warp w takes rows
// w + 8i; lane l holds channels 4l..4l+3. Rows >= M are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* raw, float* aS, float* gS, float4 gm,
                                           float4 bt, long long row0, long long M, float eps,
                                           int warp, int lane) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[kRT], gv[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = warp + kRG * i;
    const bool valid = row0 + r < M;
    xv[i] = valid ? raw4(raw + r * kC + 4 * lane) : zero;
    gv[i] = valid ? raw4(raw + (kR + r) * kC + 4 * lane) : zero;
  }
  // the rows' statistics reduce together, one shuffle of each row a step,
  // so their latencies overlap; rsqrtf has no branch to serialise them
  float s[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) s[i] = (xv[i].x + xv[i].y) + (xv[i].z + xv[i].w);
  rows_sum(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const float mean = s[i] * (1.0f / kC);
    xv[i] = make_float4(xv[i].x - mean, xv[i].y - mean, xv[i].z - mean, xv[i].w - mean);
    s[i] = (xv[i].x * xv[i].x + xv[i].y * xv[i].y) + (xv[i].z * xv[i].z + xv[i].w * xv[i].w);
  }
  rows_sum(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = warp + kRG * i;
    const float4 xc = xv[i];
    const float rstd = rsqrtf(s[i] * (1.0f / kC) + eps);
    st4(aS + r * kLdA + 4 * lane,
        make_float4(fmaf(xc.x * rstd, gm.x, bt.x), fmaf(xc.y * rstd, gm.y, bt.y),
                    fmaf(xc.z * rstd, gm.z, bt.z), fmaf(xc.w * rstd, gm.w, bt.w)));
    st4(gS + r * kLdA + 4 * lane, gv[i]);
  }
}

// out = X Wc over the channel half kh, for fc1 (X = a, Wc = W1c^T: z
// without b1) and dh (X = g, Wc = ls2 * W2c). Thread (row group q, column
// group p of 8): rows q + 8i, hidden columns 4p..4p+3 and 32 + 4p..; each
// step of four channels reads 8 Wc and 5 X float4s for 160 FMAs.
__device__ __forceinline__ void half_product(const float* X, const float* Wc, float* out,
                                             int kh, int q, int p) {
  float acc[kRT][8];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[i][v] = 0.f;
#pragma unroll 2
  for (int c = kh * kKH; c < kh * kKH + kKH; c += 4) {
    float4 w[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = ld4(Wc + (c + u) * kLdW + 4 * p);
      w[4 + u] = ld4(Wc + (c + u) * kLdW + kJ / 2 + 4 * p);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float4 d = ld4(X + (q + kRG * i) * kLdA + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float& o = acc[i][4 * h + v];
          o = fmaf(d.x, dxp::lane4(w[4 * h], v), o);
          o = fmaf(d.y, dxp::lane4(w[4 * h + 1], v), o);
          o = fmaf(d.z, dxp::lane4(w[4 * h + 2], v), o);
          o = fmaf(d.w, dxp::lane4(w[4 * h + 3], v), o);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    float* row = out + (q + kRG * i) * kLdZ + 4 * p;
    st4(row, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    st4(row + kJ / 2, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// acc[a][b] += P[r][a] Q[r][b] over the tile's rows, where the thread's a
// are 4 neighbours at P and 4 at P + kHalfP, its b likewise at Q: dW1c
// (P = dz, Q = a) or G_c (P = g, Q = h). 4 float4s a row for 64 FMAs.
template <int kLdP, int kHalfP, int kLdQ, int kHalfQ>
__device__ __forceinline__ void outer_tile(const float* P, const float* Q,
                                           float (&acc)[8][8]) {
#pragma unroll 4
  for (int r = 0; r < kR; ++r) {
    const float4 p0 = ld4(P + r * kLdP), p1 = ld4(P + r * kLdP + kHalfP);
    const float4 q0 = ld4(Q + r * kLdQ), q1 = ld4(Q + r * kLdQ + kHalfQ);
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(pv[a], qv[b], acc[a][b]);
  }
}

}  // namespace wp

// One block per (hidden chunk of 64, row split); the split's 40-row tiles
// through a raw stage that one thread fills by bulk copies; warps 0-3 run
// fc1 and warps 4-7 dh, each over two channel halves, all take GELU and dz,
// then warps 0-3 accumulate dW1c and warps 4-7 G_c in registers; the
// split's partial at the end.
template <typename T>
__global__ void __launch_bounds__(wp::kT, 1)
mlp_ln_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const float* __restrict__ ls2,
                    float* __restrict__ part, long long M, int H, float eps) {
  using namespace wp;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* gS = aS + kR * kLdA;
  float* zS = aS + kOffZ;
  float* hS = zS + kR * kLdZ;
  float* zS2 = hS + kR * kLdZ;
  float* hS2 = zS2 + kR * kLdZ;
  float* w1t = aS + kOffW1;
  float* w2s = aS + kOffW2;
  float* b1s = aS + kOffB1;
  T* raw = reinterpret_cast<T*>(aS + kOffRaw);
  auto* bar = reinterpret_cast<unsigned long long*>(raw + 2 * kR * kC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJ;
  const long long n_tiles = tiles(M);
  const long long per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const long long t_begin = blockIdx.y * per;
  const long long t_end = t_begin + per < n_tiles ? t_begin + per : n_tiles;
  if (tid == 0) mbar_init(bar);
  __syncthreads();  // the barrier is initialised
  if (tid == 0 && t_begin < t_end) fetch_rows(raw, x, g, t_begin * kR, M, bar);
  stage_weights(w1t, w2s, b1s, w1, w2, b1, ls2, j0, H, tid);
  __syncthreads();  // the weights are staged
  const float4 gm = ld4(gamma + 4 * lane), bt = ld4(beta + 4 * lane);
  const float2 b1p = *reinterpret_cast<const float2*>(b1s + 2 * lane);  // GELU's columns

  // fc1 / dh: channel half w4 / 2, row group 4 (w4 & 1) + lane / 8 (= g8),
  // column group lane % 8. Products: g16 = 8 (w4 / 2) + lane % 8; warps 0-3
  // hold dW1c[4 g8 + v (+32)][4 g16 + v (+64)], warps 4-7
  // G_c[4 g16 + v (+64)][4 g8 + v (+32)]
  const int w4 = warp & 3, kh = w4 >> 1;
  const int g8 = 4 * (w4 & 1) + (lane >> 3), g16 = 8 * kh + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float db1a[2] = {0.f, 0.f};  // columns 2 lane, 2 lane + 1 over rows warp + 8i

  for (long long t = t_begin; t < t_end; ++t) {
    mbar_wait(bar, static_cast<unsigned>((t - t_begin) & 1));
    __syncthreads();  // tile t's rows landed; the last tile's products are done
    stage_rows(raw, aS, gS, gm, bt, t * kR, M, eps, warp, lane);
    __syncthreads();  // a and g in; the stage is free
    if (tid == 0 && t + 1 < t_end) fetch_rows(raw, x, g, (t + 1) * kR, M, bar);
    if (warp < 4)
      half_product(aS, w1t, kh ? zS2 : zS, kh, g8, lane & 7);
    else
      half_product(gS, w2s, kh ? hS2 : hS, kh, g8, lane & 7);
    __syncthreads();  // both halves of z and of dh in
    // z + b1 and dh from their halves; h = GELU(z) in place of z, dz = dh *
    // GELU'(z) in place of dh, 5 pairs a thread
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int o = (warp + kRG * i) * kLdZ + 2 * lane;
      float* zp = zS + o;
      float* hp = hS + o;
      const float2 z0 = *reinterpret_cast<const float2*>(zp);
      const float2 z1 = *reinterpret_cast<const float2*>(zS2 + o);
      const float2 d0 = *reinterpret_cast<const float2*>(hp);
      const float2 d1 = *reinterpret_cast<const float2*>(hS2 + o);
      const float2 z = make_float2(z0.x + z1.x + b1p.x, z0.y + z1.y + b1p.y);
      const float2 d = make_float2(d0.x + d1.x, d0.y + d1.y);
      const float2 e0 = gelu_and_grad(z.x), e1 = gelu_and_grad(z.y);
      const float2 dz = make_float2(d.x * e0.y, d.y * e1.y);
      *reinterpret_cast<float2*>(zp) = make_float2(e0.x, e1.x);
      *reinterpret_cast<float2*>(hp) = dz;
      db1a[0] += dz.x;
      db1a[1] += dz.y;
    }
    __syncthreads();  // h and dz in
    if (warp < 4)
      outer_tile<kLdZ, kJ / 2, kLdA, kC / 2>(hS + 4 * g8, aS + 4 * g16, acc);
    else
      outer_tile<kLdA, kC / 2, kLdZ, kJ / 2>(gS + 4 * g16, zS + 4 * g8, acc);
  }

  // the split's partial: dW1c rows, G_c columns, db1c
  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * kC + H);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float4 lo = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    const float4 hi = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    if (warp < 4) {
      const int j = 4 * g8 + (a & 3) + (a < 4 ? 0 : kJ / 2);
      float* row = base + static_cast<long long>(j0 + j) * kC + 4 * g16;
      st4(row, lo);
      st4(row + kC / 2, hi);
    } else {
      const int c = 4 * g16 + (a & 3) + (a < 4 ? 0 : kC / 2);
      float* row = base + static_cast<long long>(H) * kC + static_cast<long long>(c) * H +
                   j0 + 4 * g8;
      st4(row, lo);
      st4(row + kJ / 2, hi);
    }
  }
  __syncthreads();  // aS is free
  float* red = aS;  // [row group][kJ]
  *reinterpret_cast<float2*>(red + warp * kJ + 2 * lane) = make_float2(db1a[0], db1a[1]);
  __syncthreads();
  if (tid < kJ) {
    float s = 0.f;
    for (int q = 0; q < kRG; ++q) s += red[q * kJ + tid];
    base[2LL * H * kC + j0 + tid] = s;
  }
}

// ---- 3. reduce pass: blocks 0..C-1 take channel c (G row, dW2, dls2, db2,
// dgamma, dbeta), blocks C..C+H-1 take hidden unit j (dW1 row, db1); every
// sum runs over the partials in index order
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mlp_ln_bwd_reduce_kernel(const float* __restrict__ part_dx, long long n_dx,
                         const float* __restrict__ part_w, int n_w,
                         const T* __restrict__ w2, const T* __restrict__ b2,
                         const float* __restrict__ ls2, float* __restrict__ dgamma,
                         float* __restrict__ dbeta, float* __restrict__ dw1,
                         float* __restrict__ db1, float* __restrict__ dw2,
                         float* __restrict__ db2, float* __restrict__ dls2, int H) {
  __shared__ float red[kReduceThreads / 32];
  const int tid = threadIdx.x;
  const long long stride = 2LL * H * kC + H;
  if (blockIdx.x < kC) {
    const int c = blockIdx.x;
    float t = 0.f;
    for (int j = tid; j < H; j += kReduceThreads) {
      float gs = 0.f;
      for (int s = 0; s < n_w; ++s)
        gs += part_w[s * stride + static_cast<long long>(H) * kC +
                     static_cast<long long>(c) * H + j];
      dw2[static_cast<long long>(c) * H + j] = ls2[c] * gs;
      t = fmaf(to_f(w2[static_cast<long long>(c) * H + j]), gs, t);
    }
    t = warp_sum(t);
    if ((tid & 31) == 0) red[tid >> 5] = t;
    __syncthreads();
    if (tid == 0) {
      float tw = 0.f;
      for (int w = 0; w < kReduceThreads / 32; ++w) tw += red[w];
      float sg = 0.f, sb = 0.f, sgsum = 0.f;
      for (long long n = 0; n < n_dx; ++n) {
        sg += part_dx[(n * 3 + 0) * kC + c];
        sb += part_dx[(n * 3 + 1) * kC + c];
        sgsum += part_dx[(n * 3 + 2) * kC + c];
      }
      dgamma[c] = sg;
      dbeta[c] = sb;
      db2[c] = ls2[c] * sgsum;
      dls2[c] = tw + to_f(b2[c]) * sgsum;
    }
  } else {
    const int j = blockIdx.x - kC;
    for (int c = tid; c < kC; c += kReduceThreads) {
      float s1 = 0.f;
      for (int s = 0; s < n_w; ++s) s1 += part_w[s * stride + static_cast<long long>(j) * kC + c];
      dw1[static_cast<long long>(j) * kC + c] = s1;
    }
    if (tid == 0) {
      float s1 = 0.f;
      for (int s = 0; s < n_w; ++s) s1 += part_w[s * stride + 2LL * H * kC + j];
      db1[j] = s1;
    }
  }
}

struct Args {
  const void *x, *g, *w1, *b1, *w2, *b2;
  const float *gamma, *beta, *ls2;
  void* dx;
  float *dgamma, *dbeta, *dw1, *db1, *dw2, *db2, *dls2, *work;
};

template <typename T>
cudaError_t launch(const Args& a, long long M, int H, float eps, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_dx_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dxp::smem_bytes<T>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_ln_bwd_w_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wp::smem_bytes<T>()));
  if (err != cudaSuccess) return err;
  const long long tiles = (M + dxp::kR - 1) / dxp::kR;  // the dx pass's tiles
  const int splits = wp::splits(M, H);
  float* part_dx = a.work;
  float* part_w = a.work + tiles * 3 * kC;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  mlp_ln_bwd_dx_kernel<T><<<static_cast<unsigned>(tiles), dxp::kT, dxp::smem_bytes<T>(),
                            stream>>>(
      x, g, a.gamma, a.beta, w1, b1, w2, a.ls2, static_cast<T*>(a.dx), part_dx, M, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_ln_bwd_w_kernel<T><<<dim3(H / wp::kJ, splits), wp::kT, wp::smem_bytes<T>(), stream>>>(
      x, g, a.gamma, a.beta, w1, b1, w2, a.ls2, part_w, M, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_ln_bwd_reduce_kernel<T><<<kC + H, kReduceThreads, 0, stream>>>(
      part_dx, tiles, part_w, splits, w2, static_cast<const T*>(a.b2), a.ls2, a.dgamma,
      a.dbeta, a.dw1, a.db1, a.dw2, a.db2, a.dls2, H);
  return cudaGetLastError();
}

// A kernel's threads a block, registers and local memory (spills) a thread,
// and blocks resident a SM at `smem` bytes of dynamic shared memory, into
// info[0], info[1], info[2], info[3]; false where the runtime refuses
template <typename K>
bool describe(K kernel, int threads, int smem, int* info) {
  cudaFuncAttributes attr{};
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return false;
  info[0] = threads;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = per_sm;
  return true;
}

// info[0..5]: the dx pass as {threads, rows a block, registers, shared
// memory bytes, spill bytes, blocks a SM}; info[6..13]: the weight pass as
// {threads, rows a tile, hidden columns a block, row splits for M rows and
// hidden H, registers, shared memory bytes, spill bytes, blocks a SM}
template <typename T>
void describe_both(long long M, int H, int* info) {
  int d[4];
  const int smem_dx = static_cast<int>(dxp::smem_bytes<T>());
  if (describe(mlp_ln_bwd_dx_kernel<T>, dxp::kT, smem_dx, d)) {
    const int v[6] = {d[0], dxp::kR, d[1], smem_dx, d[2], d[3]};
    for (int i = 0; i < 6; ++i) info[i] = v[i];
  }
  const int smem_w = static_cast<int>(wp::smem_bytes<T>());
  if (describe(mlp_ln_bwd_w_kernel<T>, wp::kT, smem_w, d)) {
    const int v[8] = {d[0], wp::kR, wp::kJ, wp::splits(M, H), d[1], smem_w, d[2], d[3]};
    for (int i = 0; i < 8; ++i) info[6 + i] = v[i];
  }
}

}  // namespace

extern "C" {

// Floats of workspace kasf_mlp_ln_bwd needs for M rows and hidden H: the dx
// pass's partials, one a tile, then the weight pass's, one a row split.
long long kasf_mlp_ln_bwd_workspace(long long M, int H) {
  const long long tiles = (M + dxp::kR - 1) / dxp::kR;
  return tiles * 3 * kC + static_cast<long long>(wp::splits(M, H)) * (2LL * H * kC + H);
}

// dtype: 0 = float32, 1 = bfloat16 (x, g, w1, b1, w2, b2, dx); gamma, beta,
// ls2, the parameter gradients and the workspace are float32. All tensors
// contiguous and 16-byte aligned: x, g, dx (M, 128); w1 and dw1 (H, 128);
// w2 and dw2 (128, H) with H a multiple of 64. Returns cudaGetLastError()
// after the last of the three launches (0 on success).
int kasf_mlp_ln_bwd(int dtype, const void* x, const void* g, const void* gamma,
                    const void* beta, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* ls2, void* dx, void* dgamma, void* dbeta,
                    void* dw1, void* db1, void* dw2, void* db2, void* dls2, void* work,
                    long long M, int C, int H, float eps, void* stream) {
  if (M < 1 || C != kC || H < wp::kJ || H % wp::kJ != 0) return cudaErrorInvalidValue;
  Args a{x, g, w1, b1, w2, b2,
         static_cast<const float*>(gamma), static_cast<const float*>(beta),
         static_cast<const float*>(ls2), dx,
         static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(dw1),
         static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
         static_cast<float*>(dls2), static_cast<float*>(work)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, M, H, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, M, H, eps, s);
  return cudaErrorInvalidValue;
}

// Both passes' instantiations for (dtype, C) on the current device at M rows
// and hidden H, for reports, into info[14] as describe_both lays it out.
// Left untouched for a width or dtype there is none of (C = 128 only), or
// where the runtime refuses the query.
void kasf_mlp_ln_bwd_info(int dtype, int C, long long M, int H, int* info) {
  if (C != kC || M < 1 || H < wp::kJ || H % wp::kJ != 0) return;
  if (dtype == 0) describe_both<float>(M, H, info);
  if (dtype == 1) describe_both<__nv_bfloat16>(M, H, info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
