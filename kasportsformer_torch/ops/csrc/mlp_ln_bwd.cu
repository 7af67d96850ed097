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
//  2. weight pass, one block per (hidden chunk of 64, row split): keep the
//     chunk's weights (W1 rows, ls2 * W2 columns) in shared memory, walk
//     the split's 64-row tiles, recompute z, dh, dz and h for the chunk, and
//     accumulate dW1c = dz^T a, G_c = g^T h and db1c in registers; write
//     them to the workspace.
//  3. reduce pass: sum the partials in a fixed order (the dx pass's per
//     tile, the weight pass's per split) and finish dgamma, dbeta, dW1, db1,
//     dW2, db2 and dls2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kC = 128;        // model width
constexpr int kChunk = 64;     // hidden columns per chunk
constexpr int kRows = 64;      // token rows per tile of the weight pass
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLdT = kRows + 4;    // aT, gT rows (channel-major)
constexpr int kLdW1 = kC + 1;      // w1s rows: W1 chunk rows as in memory
constexpr int kLdW2 = kChunk;      // w2s rows: ls2 * W2[:, chunk]
constexpr int kLdJ = kChunk + 4;   // dzS, hS rows (row-major)
constexpr int kReduceThreads = 256;

constexpr size_t kSmemW = sizeof(float) * (2 * kC * kLdT + kChunk * kLdW1 +
                                           kC * kLdW2 + 2 * kRows * kLdJ);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm statistics of one row by one warp (lane holds channels
// lane + 32u): xv becomes xhat
__device__ __forceinline__ float warp_normalise(float (&xv)[kC / 32], float eps) {
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) sum += xv[u];
  const float mean = warp_sum(sum) * (1.0f / kC);
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) {
    xv[u] -= mean;
    sq += xv[u] * xv[u];
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) * (1.0f / kC) + eps);
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) xv[u] *= rstd;
  return rstd;
}

// Stage a 64-row tile: aT[c][r] = LN(x) * gamma + beta, gT[c][r] = g.
template <typename T>
__device__ void stage_tile(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, float* aT, float* gT,
                           long long row0, long long M, float eps, int warp, int lane) {
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long row = row0 + r;
    const bool valid = row < M;
    float xv[kC / 32];
#pragma unroll
    for (int u = 0; u < kC / 32; ++u)
      xv[u] = valid ? to_f(x[row * kC + lane + 32 * u]) : 0.f;
    warp_normalise(xv, eps);
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) {
      const int c = lane + 32 * u;
      aT[c * kLdT + r] = xv[u] * gamma[c] + beta[c];
      gT[c * kLdT + r] = valid ? to_f(g[row * kC + c]) : 0.f;
    }
  }
}

// Stage hidden chunk j0: w1s[j][c] = W1[j0 + j][c], w2s[c][j] = ls2[c] * W2[c][j0 + j].
template <typename T>
__device__ void stage_weights(const T* __restrict__ w1, const T* __restrict__ w2,
                              const float* __restrict__ ls2, float* w1s, float* w2s,
                              int j0, int H, int tid) {
  for (int e = tid; e < kChunk * kC; e += kThreads) {
    const int j = e / kC, c = e % kC;
    w1s[j * kLdW1 + c] = to_f(w1[static_cast<long long>(j0 + j) * kC + c]);
  }
  for (int e = tid; e < kC * kChunk; e += kThreads) {
    const int c = e / kChunk, j = e % kChunk;
    w2s[c * kLdW2 + j] = to_f(w2[static_cast<long long>(c) * H + j0 + j]) * ls2[c];
  }
}

// Thread (ty, tx) of 16 x 16: rows ty*4 + i (i < 4), chunk columns
// tx + 16u (u < 4). z = a W1c^T (no bias), dh = g (ls2 * W2c), K = C.
__device__ __forceinline__ void fc1_and_dh(const float* aT, const float* gT,
                                           const float* w1s, const float* w2s, int ty,
                                           int tx, float (&z)[4][4], float (&dh)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) z[i][u] = dh[i][u] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kC; ++c) {
    const float4 a4 = *reinterpret_cast<const float4*>(aT + c * kLdT + ty * 4);
    const float4 g4 = *reinterpret_cast<const float4*>(gT + c * kLdT + ty * 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float w1v = w1s[(tx + 16 * u) * kLdW1 + c];
      const float w2v = w2s[c * kLdW2 + tx + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z[i][u] = fmaf(av[i], w1v, z[i][u]);
        dh[i][u] = fmaf(gv[i], w2v, dh[i][u]);
      }
    }
  }
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

// ---- 2. weight pass: block (hidden chunk, row split)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_ln_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const float* __restrict__ ls2,
                    float* __restrict__ part, long long M, int H, float eps) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);
  float* gT = aT + kC * kLdT;
  float* w1s = gT + kC * kLdT;
  float* w2s = w1s + kChunk * kLdW1;
  float* dzS = w2s + kC * kLdW2;  // rows x chunk
  float* hS = dzS + kRows * kLdJ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * kChunk;
  const long long tiles = (M + kRows - 1) / kRows;
  const long long per = (tiles + gridDim.y - 1) / gridDim.y;
  const long long t_begin = blockIdx.y * per;
  const long long t_end = t_begin + per < tiles ? t_begin + per : tiles;
  stage_weights(w1, w2, ls2, w1s, w2s, j0, H, tid);

  // dW1[j0 + ty*4 + i][tx + 16u]; G[c(v)][j0 + tx + 16u] with
  // c(v) = ty*4 + v (v < 4) or 64 + ty*4 + v - 4; db1[j0 + ty*4 + i]
  float dw1[4][8], gacc[8][4], db1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db1[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) dw1[i][u] = 0.f;
  }
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) gacc[v][u] = 0.f;

  for (long long t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous tile is consumed (and the weights staged)
    stage_tile(x, g, gamma, beta, aT, gT, t * kRows, M, eps, warp, lane);
    __syncthreads();
    float z[4][4], dh[4][4];
    fc1_and_dh(aT, gT, w1s, w2s, ty, tx, z, dh);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 16 * u;
      const float bias = to_f(b1[j0 + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zz = z[i][u] + bias;
        dzS[(ty * 4 + i) * kLdJ + j] = dh[i][u] * gelu_erf_grad(zz);
        hS[(ty * 4 + i) * kLdJ + j] = gelu_erf(zz);
      }
    }
    __syncthreads();
    for (int r = 0; r < kRows; r += 4) {
      // dW1 += dz^T a and db1 += dz over rows r..r+3
      float dzv[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 d4 = *reinterpret_cast<const float4*>(dzS + (r + v) * kLdJ + ty * 4);
        dzv[v][0] = d4.x; dzv[v][1] = d4.y; dzv[v][2] = d4.z; dzv[v][3] = d4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) db1[i] += dzv[0][i] + dzv[1][i] + dzv[2][i] + dzv[3][i];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 a4 = *reinterpret_cast<const float4*>(aT + (tx + 16 * u) * kLdT + r);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int i = 0; i < 4; ++i) dw1[i][u] = fmaf(dzv[v][i], av[v], dw1[i][u]);
      }
      // G += g^T h over rows r..r+3
      float hv[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) hv[v][u] = hS[(r + v) * kLdJ + tx + 16 * u];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int c = (w < 4 ? 0 : 64) + ty * 4 + (w & 3);
        const float4 g4 = *reinterpret_cast<const float4*>(gT + c * kLdT + r);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 4; ++u) gacc[w][u] = fmaf(gv[v], hv[v][u], gacc[w][u]);
      }
    }
  }

  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * kC + H);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u)
      base[static_cast<long long>(j0 + ty * 4 + i) * kC + tx + 16 * u] = dw1[i][u];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int c = (w < 4 ? 0 : 64) + ty * 4 + (w & 3);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      base[static_cast<long long>(H) * kC + static_cast<long long>(c) * H + j0 + tx +
           16 * u] = gacc[w][u];
  }
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) base[2LL * H * kC + j0 + ty * 4 + i] = db1[i];
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
cudaError_t launch(const Args& a, long long M, int H, int splits, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_dx_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dxp::smem_bytes<T>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_ln_bwd_w_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemW));
  if (err != cudaSuccess) return err;
  const long long tiles = (M + dxp::kR - 1) / dxp::kR;  // the dx pass's tiles
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
  mlp_ln_bwd_w_kernel<T><<<dim3(H / kChunk, splits), kThreads, kSmemW, stream>>>(
      x, g, a.gamma, a.beta, w1, b1, w2, a.ls2, part_w, M, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_ln_bwd_reduce_kernel<T><<<kC + H, kReduceThreads, 0, stream>>>(
      part_dx, tiles, part_w, splits, w2, static_cast<const T*>(a.b2), a.ls2, a.dgamma,
      a.dbeta, a.dw1, a.db1, a.dw2, a.db2, a.dls2, H);
  return cudaGetLastError();
}

template <typename T>
void describe_dx(int* info) {
  cudaFuncAttributes attr{};
  int per_sm = 0;
  const int smem = static_cast<int>(dxp::smem_bytes<T>());
  if (cudaFuncSetAttribute(mlp_ln_bwd_dx_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, mlp_ln_bwd_dx_kernel<T>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_ln_bwd_dx_kernel<T>, dxp::kT,
                                                    smem) != cudaSuccess)
    return;
  info[0] = dxp::kT;
  info[1] = dxp::kR;
  info[2] = attr.numRegs;
  info[3] = smem;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = per_sm;
}

}  // namespace

extern "C" {

// Floats of workspace kasf_mlp_ln_bwd needs for M rows, hidden H and
// `splits` row splits of the weight pass.
long long kasf_mlp_ln_bwd_workspace(long long M, int H, int splits) {
  const long long tiles = (M + dxp::kR - 1) / dxp::kR;  // the dx pass's partials
  return tiles * 3 * kC + static_cast<long long>(splits) * (2LL * H * kC + H);
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
                    long long M, int C, int H, int splits, float eps, void* stream) {
  if (M < 1 || C != kC || H < kChunk || H % kChunk != 0 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  Args a{x, g, w1, b1, w2, b2,
         static_cast<const float*>(gamma), static_cast<const float*>(beta),
         static_cast<const float*>(ls2), dx,
         static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(dw1),
         static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
         static_cast<float*>(dls2), static_cast<float*>(work)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, M, H, splits, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, M, H, splits, eps, s);
  return cudaErrorInvalidValue;
}

// The dx pass's instantiation for (dtype, C) on the current device, for
// reports: info = {threads a block, rows a block, registers a thread, dynamic
// shared memory a block in bytes, local memory (spills) a thread in bytes,
// blocks resident a SM}. Left untouched for a width or dtype there is none
// of (C = 128 only), or where the runtime refuses the query.
void kasf_mlp_ln_bwd_info(int dtype, int C, int* info) {
  if (C != kC) return;
  if (dtype == 0) describe_dx<float>(info);
  if (dtype == 1) describe_dx<__nv_bfloat16>(info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
