// K3: LayerNorm-folded MLP tail forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/mlp.py:_mlp_ln_kernel
// (wrapper fused_mlp_ln_pallas). Over M token rows of width C = 128:
//     out = x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)
// with LayerNorm statistics in f32, exact-erf GELU, and W1 (H, C), W2 (C, H)
// in the torch nn.Linear layout. The hidden width H is a multiple of 64.
//
// Bound on the H100: 4*M*C*H FLOP (15.4 GFLOP at M = 58,752, H = 512) against
// ~2*M*C elements moved, i.e. ~128 FLOP per f32 byte: bound by operations.
// In f32 that is the CUDA cores' 67 TFLOP/s (~230 us per call at that M); in
// bf16 the tensor cores' 989 TFLOP/s (~16 us).
//
// Design (simple and right first; wgmma and TMA come later). A block takes a
// tile of rows; tail rows of a ragged M are masked (loaded as zeros, never
// stored), so any M works. It normalises its rows once (one warp per row, f32
// statistics), rounds LN(x) to the compute dtype as the plain version does,
// and keeps it in shared memory for the whole tile. It then walks the hidden
// width in chunks of 64: stage W1's and W2's chunks in shared memory, compute
// the hidden tile h = GELU(a W1c^T + b1c), round it to the compute dtype, and
// accumulate out += h W2c^T in registers. The 512-wide hidden never reaches
// device memory. Epilogue: x + ls2 * (out + b2), x re-read (an L2 hit).
//  * float32 (mlp_ln_f32_kernel): 128 rows and 256 threads a block, fmaf on
//    the CUDA cores, 8 x 4 (fc1) and 8 x 8 (fc2) outputs a thread, operands
//    read as float4s; each weight chunk is copied with cp.async while the
//    other product runs.
//  * bfloat16 (mlp_ln_bf16_tc_kernel): 64 rows and 4 warps a block, each
//    warp owning 16 rows, both products on the tensor cores with warp-level
//    16x16x16 bf16 MMA (nvcuda::wmma) and f32 accumulators.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cmath>

namespace {

constexpr int kC = 128;       // model width
constexpr int kChunk = 64;    // hidden columns per chunk

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
__device__ __forceinline__ void warp_layer_norm(float (&xv)[kC / 32], int lane,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                float eps) {
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
  for (int u = 0; u < kC / 32; ++u) {
    const int c = lane + 32 * u;
    xv[u] = xv[u] * rstd * gamma[c] + beta[c];
  }
}

// ---- float32 on the CUDA cores
constexpr int kRowsF = 128;          // token rows per block
constexpr int kThreadsF = 256;       // 16 x 16 threads
constexpr int kLdT = kRowsF + 4;     // aT, hT row stride (floats)
constexpr int kLdW1 = kC + 4;        // w1s row stride: W1 chunk rows as in memory
constexpr int kLdW2 = kChunk + 4;    // w2s row stride: W2 rows, chunk columns
constexpr size_t kSmemBytesF =
    sizeof(float) * (kC * kLdT +         // aT: LN(x)^T, C x rows
                     kChunk * kLdW1 +    // w1s: W1[j0:j0+64, :]
                     kChunk * kLdT +     // hT: hidden tile^T, chunk x rows
                     kC * kLdW2);        // w2s: W2[:, j0:j0+64]

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

// Start copying W1 rows j0..j0+63 (all C channels) into w1s; one group.
__device__ __forceinline__ void fetch_w1(float* w1s, const float* __restrict__ w1,
                                         int j0, int H, int tid) {
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < kChunk * kC / 4 / kThreadsF; ++i) {
      const int e = tid + i * kThreadsF;
      const int j = e / (kC / 4), c4 = e % (kC / 4);
      cp_async16(w1s + j * kLdW1 + c4 * 4,
                 w1 + static_cast<long long>(j0 + j) * kC + c4 * 4);
    }
  }
  cp_async_commit();  // an empty group past the last chunk keeps the count
}

// Start copying W2[:, j0:j0+64] (all C rows) into w2s; one group.
__device__ __forceinline__ void fetch_w2(float* w2s, const float* __restrict__ w2,
                                         int j0, int H, int tid) {
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < kC * kChunk / 4 / kThreadsF; ++i) {
      const int e = tid + i * kThreadsF;
      const int c = e / (kChunk / 4), j4 = e % (kChunk / 4);
      cp_async16(w2s + c * kLdW2 + j4 * 4,
                 w2 + static_cast<long long>(c) * H + j0 + j4 * 4);
    }
  }
  cp_async_commit();
}

// Thread (ty, tx) of 16 x 16 owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}
// of the 128-row tile, hidden columns tx + 16*{0..3} in fc1 and channels
// tx + 16*{0..7} in fc2 (8 x 4 and 8 x 8 outputs). The weight chunks sit in
// shared memory as they lie in device memory, copied with cp.async while the
// other product runs: W1's chunk loads during fc2, W2's during fc1.
__global__ void __launch_bounds__(kThreadsF)
mlp_ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ ls2,
                  float* __restrict__ out, long long M, int H, float eps) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);
  float* w1s = aT + kC * kLdT;
  float* hT = w1s + kChunk * kLdW1;
  float* w2s = hT + kChunk * kLdT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsF;

  fetch_w1(w1s, w1, 0, H, tid);
  fetch_w2(w2s, w2, 0, H, tid);

  // ---- LayerNorm: warp w normalises rows w, w+8, ...
  for (int r = warp; r < kRowsF; r += kThreadsF / 32) {
    const long long row = row0 + r;
    float xv[kC / 32];
#pragma unroll
    for (int u = 0; u < kC / 32; ++u)
      xv[u] = row < M ? x[row * kC + lane + 32 * u] : 0.f;
    warp_layer_norm(xv, lane, gamma, beta, eps);
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) aT[(lane + 32 * u) * kLdT + r] = xv[u];
  }

  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc2[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc2[r][c] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    cp_async_wait_all_but_one();  // W1's chunk has landed (W2's may not)
    __syncthreads();

    // fc1: h = LN(x) W1c^T, four channels of W1 a step
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[r][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float4 w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        w[jj] = *reinterpret_cast<const float4*>(w1s + (tx + 16 * jj) * kLdW1 + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a0 = *reinterpret_cast<const float4*>(aT + (c + u) * kLdT + ty * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(aT + (c + u) * kLdT + 64 + ty * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float wv = u == 0 ? w[jj].x : u == 1 ? w[jj].y : u == 2 ? w[jj].z : w[jj].w;
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][jj] = fmaf(av[r], wv, acc[r][jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = tx + 16 * jj;
      const float bias = b1[j0 + j];
      float hv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) hv[r] = gelu_erf(acc[r][jj] + bias);
      *reinterpret_cast<float4*>(hT + j * kLdT + ty * 4) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(hT + j * kLdT + 64 + ty * 4) =
          make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();  // hT complete; w1s free
    fetch_w1(w1s, w1, j0 + kChunk, H, tid);
    cp_async_wait_all_but_one();  // W2's chunk has landed
    __syncthreads();

    // fc2: out += h W2c^T, four hidden columns a step
#pragma unroll 2
    for (int j = 0; j < kChunk; j += 4) {
      float4 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        w[u] = *reinterpret_cast<const float4*>(w2s + (tx + 16 * u) * kLdW2 + j);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 h0 = *reinterpret_cast<const float4*>(hT + (j + v) * kLdT + ty * 4);
        const float4 h1 =
            *reinterpret_cast<const float4*>(hT + (j + v) * kLdT + 64 + ty * 4);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float wv = v == 0 ? w[u].x : v == 1 ? w[u].y : v == 2 ? w[u].z : w[u].w;
#pragma unroll
          for (int r = 0; r < 8; ++r) acc2[r][u] = fmaf(hv[r], wv, acc2[r][u]);
        }
      }
    }
    __syncthreads();  // w2s and hT free
    fetch_w2(w2s, w2, j0 + kChunk, H, tid);
  }

  // ---- epilogue: x + ls2 * (out + b2), tail rows masked
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long row = row0 + (r < 4 ? 0 : 64) + ty * 4 + (r & 3);
    if (row >= M) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = tx + 16 * u;
      out[row * kC + c] = x[row * kC + c] + ls2[c] * (acc2[r][u] + b2[c]);
    }
  }
}

// ---- bfloat16 on the tensor cores
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kRowsTc = 64;         // token rows per block
constexpr int kTcThreads = 128;     // 4 warps x 16 rows
constexpr int kLdATc = kC + 8;      // aS, w1S row stride (bf16): 272 B
constexpr int kLdW2Tc = kChunk + 8; // w2S, hS row stride (bf16): 144 B
constexpr int kLdHTc = kChunk + 4;  // hF row stride (f32)
constexpr int kLdOTc = kC + 4;      // oF row stride (f32)
// every region starts on a 32-byte boundary, as wmma loads require
constexpr size_t kTcSmemBytes =
    sizeof(bf16) * (kRowsTc * kLdATc +    // aS: LN(x), rows x C (A of fc1)
                    kChunk * kLdATc +     // w1S: W1 chunk, chunk x C (B of fc1)
                    kC * kLdW2Tc +        // w2S: W2 chunk, C x chunk (B of fc2)
                    kRowsTc * kLdW2Tc) +  // hS: GELU(h), rows x chunk (A of fc2)
    sizeof(float) * (kRowsTc * kLdHTc +   // hF: fc1 accumulators
                     kRowsTc * kLdOTc);   // oF: fc2 accumulators, for the epilogue

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kTcThreads)
mlp_ln_bf16_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ b2, const float* __restrict__ ls2,
                      bf16* __restrict__ out, long long M, int H, float eps) {
  extern __shared__ float4 smem4[];
  bf16* aS = reinterpret_cast<bf16*>(smem4);
  bf16* w1S = aS + kRowsTc * kLdATc;
  bf16* w2S = w1S + kChunk * kLdATc;
  bf16* hS = w2S + kC * kLdW2Tc;
  float* hF = reinterpret_cast<float*>(hS + kRowsTc * kLdW2Tc);
  float* oF = hF + kRowsTc * kLdHTc;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wrow = warp * 16;  // this warp's 16 rows of the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsTc;

  // ---- LayerNorm of this warp's rows, f32 statistics, rounded to bf16
  for (int r = wrow; r < wrow + 16; ++r) {
    const long long row = row0 + r;
    float xv[kC / 32];
#pragma unroll
    for (int u = 0; u < kC / 32; ++u)
      xv[u] = row < M ? __bfloat162float(x[row * kC + lane + 32 * u]) : 0.f;
    warp_layer_norm(xv, lane, gamma, beta, eps);
#pragma unroll
    for (int u = 0; u < kC / 32; ++u)
      aS[r * kLdATc + lane + 32 * u] = __float2bfloat16(xv[u]);
  }

  FragC oacc[kC / 16];
#pragma unroll
  for (int n = 0; n < kC / 16; ++n) wmma::fill_fragment(oacc[n], 0.0f);

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    __syncthreads();  // the previous chunk's w1S / w2S are consumed
    // W1 rows j0..j0+63 (each C bf16) and W2[:, j0:j0+64] in 16-byte copies,
    // all of a thread's loads issued before its stores
    constexpr int kVec = kChunk * kC / 8 / kTcThreads;  // uint4s per thread
    uint4 v1[kVec], v2[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = tid + i * kTcThreads;
      const int j = e / (kC / 8), c8 = e % (kC / 8);
      v1[i] = *reinterpret_cast<const uint4*>(
          w1 + static_cast<long long>(j0 + j) * kC + c8 * 8);
      const int c = e / (kChunk / 8), j8 = e % (kChunk / 8);
      v2[i] = *reinterpret_cast<const uint4*>(
          w2 + static_cast<long long>(c) * H + j0 + j8 * 8);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = tid + i * kTcThreads;
      const int j = e / (kC / 8), c8 = e % (kC / 8);
      *reinterpret_cast<uint4*>(w1S + j * kLdATc + c8 * 8) = v1[i];
      const int c = e / (kChunk / 8), j8 = e % (kChunk / 8);
      *reinterpret_cast<uint4*>(w2S + c * kLdW2Tc + j8 * 8) = v2[i];
    }
    __syncthreads();

    // fc1: h[16 rows x 64] = aS[rows, :] W1c^T on the tensor cores
    FragC hacc[kChunk / 16];
#pragma unroll
    for (int n = 0; n < kChunk / 16; ++n) wmma::fill_fragment(hacc[n], 0.0f);
#pragma unroll
    for (int k = 0; k < kC / 16; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, aS + wrow * kLdATc + k * 16, kLdATc);
#pragma unroll
      for (int n = 0; n < kChunk / 16; ++n) {
        FragB b;  // B(k=c, n=j) = W1[j0+j][c]: W1's rows are B's columns
        wmma::load_matrix_sync(b, w1S + n * 16 * kLdATc + k * 16, kLdATc);
        wmma::mma_sync(hacc[n], a, b, hacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk / 16; ++n)
      wmma::store_matrix_sync(hF + wrow * kLdHTc + n * 16, hacc[n], kLdHTc,
                              wmma::mem_row_major);
    __syncwarp();
    // bias + exact GELU in f32, rounded to bf16 as the A operand of fc2
    for (int e = lane; e < 16 * kChunk; e += 32) {
      const int r = wrow + e / kChunk, j = e % kChunk;
      const float z = hF[r * kLdHTc + j] + __bfloat162float(b1[j0 + j]);
      hS[r * kLdW2Tc + j] = __float2bfloat16(gelu_erf(z));
    }
    __syncwarp();

    // fc2: out[16 rows x C] += hS[rows, :] W2c^T
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, hS + wrow * kLdW2Tc + k * 16, kLdW2Tc);
#pragma unroll
      for (int n = 0; n < kC / 16; ++n) {
        FragB b;  // B(k=j, n=c) = W2[c][j0+j]: W2's rows are B's columns
        wmma::load_matrix_sync(b, w2S + n * 16 * kLdW2Tc + k * 16, kLdW2Tc);
        wmma::mma_sync(oacc[n], a, b, oacc[n]);
      }
    }
  }

  // ---- epilogue: x + ls2 * (out + b2) for this warp's rows, tail masked
#pragma unroll
  for (int n = 0; n < kC / 16; ++n)
    wmma::store_matrix_sync(oF + wrow * kLdOTc + n * 16, oacc[n], kLdOTc,
                            wmma::mem_row_major);
  __syncwarp();
  for (int r = wrow; r < wrow + 16; ++r) {
    const long long row = row0 + r;
    if (row >= M) break;
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) {
      const int c = lane + 32 * u;
      const float y = oF[r * kLdOTc + c] + __bfloat162float(b2[c]);
      out[row * kC + c] =
          __float2bfloat16(__bfloat162float(x[row * kC + c]) + ls2[c] * y);
    }
  }
}

cudaError_t launch_f32(const void* x, const float* gamma, const float* beta,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const float* ls2, void* out, long long M, int H, float eps,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytesF));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((M + kRowsF - 1) / kRowsF);
  mlp_ln_f32_kernel<<<blocks, kThreadsF, kSmemBytesF, stream>>>(
      static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), ls2, static_cast<float*>(out), M, H, eps);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const float* gamma, const float* beta,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const float* ls2, void* out, long long M, int H, float eps,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_ln_bf16_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTcSmemBytes));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((M + kRowsTc - 1) / kRowsTc);
  mlp_ln_bf16_tc_kernel<<<blocks, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(x), gamma, beta, static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), ls2, static_cast<bf16*>(out), M, H, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1, b1, w2, b2, out); gamma, beta and
// ls2 are float32. All tensors contiguous and 16-byte aligned; x and out are
// (M, 128), w1 is (H, 128), w2 is (128, H) with H a multiple of 64. Returns
// cudaGetLastError() after the launch (0 on success).
int kasf_mlp_ln(int dtype, const void* x, const void* gamma, const void* beta,
                const void* w1, const void* b1, const void* w2, const void* b2,
                const void* ls2, void* out, long long M, int C, int H, float eps,
                void* stream) {
  if (M < 1 || C != kC || H < kChunk || H % kChunk != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* ls = static_cast<const float*>(ls2);
  if (dtype == 0) return launch_f32(x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
  if (dtype == 1) return launch_bf16(x, g, be, w1, b1, w2, b2, ls, out, M, H, eps, s);
  return cudaErrorInvalidValue;
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
