// The hidden-chunk MLP tile shared by K3 (csrc/mlp_ln.cu, LayerNorm and the
// residual on) and K5 (csrc/mlp.cu, both off), for Hopper (sm_90a).
//
// Over M token rows of width C in {64, 128, 256, 512}:
//     LN:   out = x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)
//     else: out =            GELU(x W1^T + b1) W2^T + b2
// with LayerNorm statistics in f32, exact-erf GELU on the f32 accumulator
// (rounded once to the compute dtype), and W1 (H, C), W2 (C, H) in the torch
// nn.Linear layout. The hidden width H is a multiple of 64.
//
// Bound on the H100: 4*M*C*H FLOP against ~2*M*C elements moved, i.e.
// ~C*H/(2*itemsize) FLOP per byte: bound by operations at every shape the
// models use. In f32 that is the CUDA cores' 67 TFLOP/s; in bf16 the tensor
// cores' 989 TFLOP/s.
//
// Design (simple and right first; wgmma and TMA come later). A block takes a
// tile of rows; tail rows of a ragged M are masked (loaded as zeros, never
// stored), so any M works. It loads its rows once (LN on: one warp per row,
// f32 statistics, rounded to the compute dtype as the plain version does)
// and keeps them in shared memory for the whole tile. It then walks the
// hidden width in chunks: stage W1's and W2's chunks in shared memory,
// compute the hidden tile h = GELU(a W1c^T + b1c), round it to the compute
// dtype, and accumulate out += h W2c^T in registers. The hidden never reaches
// device memory. Epilogue: out + b2, and with LN on x + ls2 * (out + b2), x
// re-read (an L2 hit). Each width is one instantiation; the tile shrinks as
// C grows so that the tile, the weight chunks and the accumulators fit:
//  * float32 (mlp_f32_kernel): 256 threads as TY x TX, each owning 4*RG rows
//    (row groups of 4, 4*TY apart) and C/TX output channels; fmaf on the CUDA
//    cores, operands read as float4s; each weight chunk is copied with
//    cp.async while the other product runs. C = 128 is the flagship's tile:
//    128 rows, 8 x 4 (fc1) and 8 x 8 (fc2) outputs a thread.
//  * bfloat16 (mlp_bf16_tc_kernel): WR x WC warps, 16 rows per warp row; the
//    WC warps of a row split the chunk's hidden columns in fc1 and the output
//    channels in fc2; warp-level 16x16x16 bf16 MMA (nvcuda::wmma) with f32
//    accumulators. C = 128 is the flagship's tile: 64 rows, 4 warps each
//    owning 16 rows and all 128 channels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cmath>

namespace kasf_tile {

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm of one row by one warp, f32 statistics: lane holds channels
// lane + 32u in xv on entry and LN(x) * gamma + beta on exit
template <int C>
__device__ __forceinline__ void warp_layer_norm(float (&xv)[C / 32], int lane,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                float eps) {
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < C / 32; ++u) sum += xv[u];
  const float mean = warp_sum(sum) * (1.0f / C);
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < C / 32; ++u) {
    xv[u] -= mean;
    sq += xv[u] * xv[u];
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) * (1.0f / C) + eps);
#pragma unroll
  for (int u = 0; u < C / 32; ++u) {
    const int c = lane + 32 * u;
    xv[u] = xv[u] * rstd * gamma[c] + beta[c];
  }
}

// ---- float32 on the CUDA cores

template <int C> struct F32Tile;  // TY thread rows, RG row groups, KCH chunk
template <> struct F32Tile<64> { static constexpr int TY = 16, RG = 2, KCH = 64; };
template <> struct F32Tile<128> { static constexpr int TY = 16, RG = 2, KCH = 64; };
template <> struct F32Tile<256> { static constexpr int TY = 16, RG = 1, KCH = 64; };
template <> struct F32Tile<512> { static constexpr int TY = 8, RG = 1, KCH = 32; };

constexpr int kThreadsF = 256;

template <int C>
struct F32Shape {
  static constexpr int TY = F32Tile<C>::TY, RG = F32Tile<C>::RG, KCH = F32Tile<C>::KCH;
  static constexpr int TX = kThreadsF / TY;
  static constexpr int R = 4 * TY * RG;  // rows a block
  static constexpr int RT = 4 * RG;      // rows a thread
  static constexpr int JJ = KCH / TX;    // fc1 hidden columns a thread
  static constexpr int U = C / TX;       // fc2 output channels a thread
  static constexpr int LdT = R + 4;      // aT, hT row stride (floats)
  static constexpr int LdW1 = C + 4;     // w1s row stride: W1 chunk rows as in memory
  static constexpr int LdW2 = KCH + 4;   // w2s row stride: W2 rows, chunk columns
  static constexpr size_t kSmem =
      sizeof(float) * (C * LdT +      // aT: the rows' inputs^T, C x rows
                       KCH * LdW1 +   // w1s: W1[j0:j0+KCH, :]
                       KCH * LdT +    // hT: hidden tile^T, chunk x rows
                       C * LdW2);     // w2s: W2[:, j0:j0+KCH]
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying W1 rows j0..j0+KCH-1 (all C channels) into w1s; one group.
template <int C>
__device__ __forceinline__ void fetch_w1(float* w1s, const float* __restrict__ w1,
                                         int j0, int H, int tid) {
  using S = F32Shape<C>;
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < S::KCH * C / 4 / kThreadsF; ++i) {
      const int e = tid + i * kThreadsF;
      const int j = e / (C / 4), c4 = e % (C / 4);
      cp_async16(w1s + j * S::LdW1 + c4 * 4,
                 w1 + static_cast<long long>(j0 + j) * C + c4 * 4);
    }
  }
  cp_async_commit();  // an empty group past the last chunk keeps the count
}

// Start copying W2[:, j0:j0+KCH] (all C rows) into w2s; one group.
template <int C>
__device__ __forceinline__ void fetch_w2(float* w2s, const float* __restrict__ w2,
                                         int j0, int H, int tid) {
  using S = F32Shape<C>;
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < C * S::KCH / 4 / kThreadsF; ++i) {
      const int e = tid + i * kThreadsF;
      const int c = e / (S::KCH / 4), j4 = e % (S::KCH / 4);
      cp_async16(w2s + c * S::LdW2 + j4 * 4,
                 w2 + static_cast<long long>(c) * H + j0 + j4 * 4);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float lane4(const float4& w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}

// Thread (ty, tx) owns rows g*4*TY + ty*4 + {0..3} (g < RG) of the tile,
// hidden columns tx + TX*{0..JJ-1} in fc1 and channels tx + TX*{0..U-1} in
// fc2. The weight chunks sit in shared memory as they lie in device memory,
// copied with cp.async while the other product runs: W1's chunk loads during
// fc2, W2's during fc1.
template <int C, bool LN>
__global__ void __launch_bounds__(kThreadsF)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ ls2,
               float* __restrict__ out, long long M, int H, float eps) {
  using S = F32Shape<C>;
  constexpr int TY = S::TY, TX = S::TX, RT = S::RT, RG = S::RG;
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);
  float* w1s = aT + C * S::LdT;
  float* hT = w1s + S::KCH * S::LdW1;
  float* w2s = hT + S::KCH * S::LdT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * S::R;

  fetch_w1<C>(w1s, w1, 0, H, tid);
  fetch_w2<C>(w2s, w2, 0, H, tid);

  // ---- the rows' inputs (LN on: normalised), transposed: warp w takes
  // rows w, w+8, ...
  for (int r = warp; r < S::R; r += kThreadsF / 32) {
    const long long row = row0 + r;
    float xv[C / 32];
#pragma unroll
    for (int u = 0; u < C / 32; ++u)
      xv[u] = row < M ? x[row * C + lane + 32 * u] : 0.f;
    if constexpr (LN) warp_layer_norm<C>(xv, lane, gamma, beta, eps);
#pragma unroll
    for (int u = 0; u < C / 32; ++u) aT[(lane + 32 * u) * S::LdT + r] = xv[u];
  }

  const int ty = tid / TX;
  const int tx = tid % TX;
  float acc2[RT][S::U];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < S::U; ++c) acc2[r][c] = 0.f;

  for (int j0 = 0; j0 < H; j0 += S::KCH) {
    cp_async_wait_all_but_one();  // W1's chunk has landed (W2's may not)
    __syncthreads();

    // fc1: h = a W1c^T, four channels of W1 a step
    float acc[RT][S::JJ];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int jj = 0; jj < S::JJ; ++jj) acc[r][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C; c += 4) {
      float4 w[S::JJ];
#pragma unroll
      for (int jj = 0; jj < S::JJ; ++jj)
        w[jj] = *reinterpret_cast<const float4*>(w1s + (tx + TX * jj) * S::LdW1 + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float av[RT];
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(
              aT + (c + u) * S::LdT + g * 4 * TY + ty * 4);
          av[4 * g] = a.x; av[4 * g + 1] = a.y; av[4 * g + 2] = a.z; av[4 * g + 3] = a.w;
        }
#pragma unroll
        for (int jj = 0; jj < S::JJ; ++jj) {
          const float wv = lane4(w[jj], u);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][jj] = fmaf(av[r], wv, acc[r][jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < S::JJ; ++jj) {
      const int j = tx + TX * jj;
      const float bias = b1[j0 + j];
#pragma unroll
      for (int g = 0; g < RG; ++g)
        *reinterpret_cast<float4*>(hT + j * S::LdT + g * 4 * TY + ty * 4) = make_float4(
            gelu_erf(acc[4 * g][jj] + bias), gelu_erf(acc[4 * g + 1][jj] + bias),
            gelu_erf(acc[4 * g + 2][jj] + bias), gelu_erf(acc[4 * g + 3][jj] + bias));
    }
    __syncthreads();  // hT complete; w1s free
    fetch_w1<C>(w1s, w1, j0 + S::KCH, H, tid);
    cp_async_wait_all_but_one();  // W2's chunk has landed
    __syncthreads();

    // fc2: out += h W2c^T, four hidden columns a step
#pragma unroll 2
    for (int j = 0; j < S::KCH; j += 4) {
      float4 w[S::U];
#pragma unroll
      for (int u = 0; u < S::U; ++u)
        w[u] = *reinterpret_cast<const float4*>(w2s + (tx + TX * u) * S::LdW2 + j);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float hv[RT];
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const float4 h = *reinterpret_cast<const float4*>(
              hT + (j + v) * S::LdT + g * 4 * TY + ty * 4);
          hv[4 * g] = h.x; hv[4 * g + 1] = h.y; hv[4 * g + 2] = h.z; hv[4 * g + 3] = h.w;
        }
#pragma unroll
        for (int u = 0; u < S::U; ++u) {
          const float wv = lane4(w[u], v);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc2[r][u] = fmaf(hv[r], wv, acc2[r][u]);
        }
      }
    }
    __syncthreads();  // w2s and hT free
    fetch_w2<C>(w2s, w2, j0 + S::KCH, H, tid);
  }

  // ---- epilogue: out + b2 (LN on: x + ls2 * (out + b2)), tail rows masked
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const long long row = row0 + (r >> 2) * 4 * TY + ty * 4 + (r & 3);
    if (row >= M) continue;
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      const int c = tx + TX * u;
      const float y = acc2[r][u] + b2[c];
      out[row * C + c] = LN ? x[row * C + c] + ls2[c] * y : y;
    }
  }
}

// ---- bfloat16 on the tensor cores
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

template <int C> struct TcTile;  // WR warp rows of 16 rows, WC warps a row
template <> struct TcTile<64> { static constexpr int WR = 4, WC = 1; };
template <> struct TcTile<128> { static constexpr int WR = 4, WC = 1; };
template <> struct TcTile<256> { static constexpr int WR = 4, WC = 2; };
template <> struct TcTile<512> { static constexpr int WR = 2, WC = 4; };

constexpr int kChunkTc = 64;  // hidden columns per chunk

template <int C>
struct TcShape {
  static constexpr int WR = TcTile<C>::WR, WC = TcTile<C>::WC;
  static constexpr int R = 16 * WR;             // rows a block
  static constexpr int kWarps = WR * WC;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int HW = kChunkTc / WC;      // fc1 hidden columns a warp
  static constexpr int OW = C / WC;             // fc2 output channels a warp
  static constexpr int LdA = C + 8;             // aS, w1S row stride (bf16)
  static constexpr int LdW2 = kChunkTc + 8;     // w2S, hS row stride (bf16): 144 B
  static constexpr int LdH = kChunkTc + 4;      // hF row stride (f32)
  static constexpr int LdO = C + 4;             // oF row stride (f32)
  // every region starts on a 32-byte boundary, as wmma loads require; oF
  // (the epilogue's staging) reuses w1S and w2S once the last chunk is done
  static constexpr size_t kW1Off = sizeof(bf16) * R * LdA;
  static constexpr size_t kHsOff = kW1Off + sizeof(bf16) * (kChunkTc * LdA + C * LdW2);
  static constexpr size_t kHfOff = kHsOff + sizeof(bf16) * R * LdW2;
  static constexpr size_t kSmem = kHfOff + sizeof(float) * R * LdH;
  static_assert(sizeof(float) * R * LdO <= kHsOff - kW1Off, "oF must fit in w1S + w2S");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int C, bool LN>
__global__ void __launch_bounds__(TcShape<C>::kThreads)
mlp_bf16_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ b2, const float* __restrict__ ls2,
                   bf16* __restrict__ out, long long M, int H, float eps) {
  using S = TcShape<C>;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  bf16* aS = reinterpret_cast<bf16*>(base);
  bf16* w1S = reinterpret_cast<bf16*>(base + S::kW1Off);
  bf16* w2S = w1S + kChunkTc * S::LdA;
  bf16* hS = reinterpret_cast<bf16*>(base + S::kHsOff);
  float* hF = reinterpret_cast<float*>(base + S::kHfOff);
  float* oF = reinterpret_cast<float*>(base + S::kW1Off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wrow = (warp / S::WC) * 16;  // this warp's 16 rows of the tile
  const int wc = warp % S::WC;
  const long long row0 = static_cast<long long>(blockIdx.x) * S::R;

  // ---- the rows' inputs (LN on: normalised with f32 statistics), in bf16
  for (int r = warp; r < S::R; r += S::kWarps) {
    const long long row = row0 + r;
    float xv[C / 32];
#pragma unroll
    for (int u = 0; u < C / 32; ++u)
      xv[u] = row < M ? __bfloat162float(x[row * C + lane + 32 * u]) : 0.f;
    if constexpr (LN) warp_layer_norm<C>(xv, lane, gamma, beta, eps);
#pragma unroll
    for (int u = 0; u < C / 32; ++u)
      aS[r * S::LdA + lane + 32 * u] = __float2bfloat16(xv[u]);
  }

  FragC oacc[S::OW / 16];
#pragma unroll
  for (int n = 0; n < S::OW / 16; ++n) wmma::fill_fragment(oacc[n], 0.0f);

  for (int j0 = 0; j0 < H; j0 += kChunkTc) {
    __syncthreads();  // the previous chunk's w1S / w2S / hS are consumed
    // W1 rows j0..j0+63 (each C bf16) and W2[:, j0:j0+64] in 16-byte copies,
    // at most eight of each a thread in flight before their stores
    constexpr int kVec = kChunkTc * C / 8 / S::kThreads;  // uint4s per thread
    constexpr int kPass = kVec < 8 ? kVec : 8;
#pragma unroll
    for (int p0 = 0; p0 < kVec; p0 += kPass) {
      uint4 v1[kPass], v2[kPass];
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int e = tid + (p0 + i) * S::kThreads;
        const int j = e / (C / 8), c8 = e % (C / 8);
        v1[i] = *reinterpret_cast<const uint4*>(
            w1 + static_cast<long long>(j0 + j) * C + c8 * 8);
        const int c = e / (kChunkTc / 8), j8 = e % (kChunkTc / 8);
        v2[i] = *reinterpret_cast<const uint4*>(
            w2 + static_cast<long long>(c) * H + j0 + j8 * 8);
      }
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int e = tid + (p0 + i) * S::kThreads;
        const int j = e / (C / 8), c8 = e % (C / 8);
        *reinterpret_cast<uint4*>(w1S + j * S::LdA + c8 * 8) = v1[i];
        const int c = e / (kChunkTc / 8), j8 = e % (kChunkTc / 8);
        *reinterpret_cast<uint4*>(w2S + c * S::LdW2 + j8 * 8) = v2[i];
      }
    }
    __syncthreads();

    // fc1: h[16 rows x HW] = aS[rows, :] W1c[cols]^T on the tensor cores
    FragC hacc[S::HW / 16];
#pragma unroll
    for (int n = 0; n < S::HW / 16; ++n) wmma::fill_fragment(hacc[n], 0.0f);
#pragma unroll
    for (int k = 0; k < C / 16; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, aS + wrow * S::LdA + k * 16, S::LdA);
#pragma unroll
      for (int n = 0; n < S::HW / 16; ++n) {
        FragB b;  // B(k=c, n=j) = W1[j0+j][c]: W1's rows are B's columns
        wmma::load_matrix_sync(b, w1S + (wc * S::HW + n * 16) * S::LdA + k * 16, S::LdA);
        wmma::mma_sync(hacc[n], a, b, hacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < S::HW / 16; ++n)
      wmma::store_matrix_sync(hF + wrow * S::LdH + wc * S::HW + n * 16, hacc[n], S::LdH,
                              wmma::mem_row_major);
    __syncwarp();
    // bias + exact GELU in f32, rounded to bf16 as the A operand of fc2
    for (int e = lane; e < 16 * S::HW; e += 32) {
      const int r = wrow + e / S::HW, j = wc * S::HW + e % S::HW;
      const float z = hF[r * S::LdH + j] + __bfloat162float(b1[j0 + j]);
      hS[r * S::LdW2 + j] = __float2bfloat16(gelu_erf(z));
    }
    if constexpr (S::WC == 1) {
      __syncwarp();
    } else {
      __syncthreads();  // a row's hidden comes from all WC warps of the row
    }

    // fc2: out[16 rows x OW] += hS[rows, :] W2c[channels]^T
#pragma unroll
    for (int k = 0; k < kChunkTc / 16; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, hS + wrow * S::LdW2 + k * 16, S::LdW2);
#pragma unroll
      for (int n = 0; n < S::OW / 16; ++n) {
        FragB b;  // B(k=j, n=c) = W2[c][j0+j]: W2's rows are B's columns
        wmma::load_matrix_sync(b, w2S + (wc * S::OW + n * 16) * S::LdW2 + k * 16, S::LdW2);
        wmma::mma_sync(oacc[n], a, b, oacc[n]);
      }
    }
  }

  // ---- epilogue: out + b2 (LN on: x + ls2 * (out + b2)), tail rows masked
  __syncthreads();  // w1S and w2S are consumed: oF takes their place
#pragma unroll
  for (int n = 0; n < S::OW / 16; ++n)
    wmma::store_matrix_sync(oF + wrow * S::LdO + wc * S::OW + n * 16, oacc[n], S::LdO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int r = warp; r < S::R; r += S::kWarps) {
    const long long row = row0 + r;
    if (row >= M) break;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const int c = lane + 32 * u;
      const float y = oF[r * S::LdO + c] + __bfloat162float(b2[c]);
      out[row * C + c] = __float2bfloat16(
          LN ? __bfloat162float(x[row * C + c]) + ls2[c] * y : y);
    }
  }
}

// ---- launchers

template <int C, bool LN>
cudaError_t launch_f32(const void* x, const float* gamma, const float* beta,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const float* ls2, void* out, long long M, int H, float eps,
                       cudaStream_t stream) {
  using S = F32Shape<C>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(mlp_f32_kernel<C, LN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(S::kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const unsigned blocks = static_cast<unsigned>((M + S::R - 1) / S::R);
  mlp_f32_kernel<C, LN><<<blocks, kThreadsF, S::kSmem, stream>>>(
      static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), ls2, static_cast<float*>(out), M, H, eps);
  return cudaGetLastError();
}

template <int C, bool LN>
cudaError_t launch_bf16(const void* x, const float* gamma, const float* beta,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const float* ls2, void* out, long long M, int H, float eps,
                        cudaStream_t stream) {
  using S = TcShape<C>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(mlp_bf16_tc_kernel<C, LN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(S::kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const unsigned blocks = static_cast<unsigned>((M + S::R - 1) / S::R);
  mlp_bf16_tc_kernel<C, LN><<<blocks, S::kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), gamma, beta, static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), ls2, static_cast<bf16*>(out), M, H, eps);
  return cudaGetLastError();
}

template <int C, bool LN>
cudaError_t launch_dtype(int dtype, const void* x, const float* gamma, const float* beta,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const float* ls2, void* out, long long M, int H, float eps,
                         cudaStream_t s) {
  if (dtype == 0) return launch_f32<C, LN>(x, gamma, beta, w1, b1, w2, b2, ls2, out, M, H, eps, s);
  if (dtype == 1)
    return launch_bf16<C, LN>(x, gamma, beta, w1, b1, w2, b2, ls2, out, M, H, eps, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w1, b1, w2, b2, out); gamma, beta and
// ls2 are float32 (read only with LN on). All tensors contiguous and 16-byte
// aligned; x and out are (M, C), w1 is (H, C), w2 is (C, H), with C in
// {64, 128, 256, 512} and H a multiple of 64 up to 2048.
template <bool LN>
cudaError_t launch(int dtype, const void* x, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* ls2, void* out, long long M, int C, int H, float eps,
                   void* stream) {
  if (M < 1 || H < kChunkTc || H > 2048 || H % kChunkTc != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* ls = static_cast<const float*>(ls2);
  switch (C) {
    case 64: return launch_dtype<64, LN>(dtype, x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
    case 128: return launch_dtype<128, LN>(dtype, x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
    case 256: return launch_dtype<256, LN>(dtype, x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
    case 512: return launch_dtype<512, LN>(dtype, x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kasf_tile
