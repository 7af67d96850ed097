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
// Design (simple and right first; wgmma and TMA come later). The TPU kernel
// summed the parameter gradients over a sequential grid; the card's blocks
// run in no order, and dW1 alone (256 KB in f32) does not fit in shared
// memory. So three launches, and no atomics, so that reruns are bitwise equal:
//  1. dx pass, one block per 64-row tile: stage LN(x) and g (f32, transposed)
//     in shared memory, walk the hidden width in chunks of 64 (stage the W1
//     and ls2*W2 chunks; z and dh with K = C; dz; da += dz W1c with K = 64),
//     so the hidden never reaches device memory; then dx per row, one warp a
//     row, and the block's partial sums of da*xhat, da and g per channel to a
//     workspace.
//  2. weight pass, one block per (hidden chunk, row split): keep the chunk's
//     weights in shared memory, walk the split's 64-row tiles, recompute z,
//     dh, dz and h for the chunk, and accumulate dW1c = dz^T a, G_c = g^T h
//     and db1c in registers; write them to the workspace.
//  3. reduce pass: sum the partials in a fixed order and finish dgamma,
//     dbeta, dW1, db1, dW2, db2 and dls2.
// Tail rows of a ragged M are loaded as zeros; their g is zero, so dh, dz
// and every contribution of theirs vanish. Inputs of either dtype are staged
// in f32 and every product accumulates in f32 on the CUDA cores; only dx is
// rounded to the input dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>

namespace {

constexpr int kC = 128;        // model width
constexpr int kChunk = 64;     // hidden columns per chunk
constexpr int kRows = 64;      // token rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLdT = kRows + 4;    // aT, gT, dzT rows (channel- or hidden-major)
constexpr int kLdW1 = kC + 1;      // w1s rows: W1 chunk rows as in memory
constexpr int kLdW2 = kChunk;      // w2s rows: ls2 * W2[:, chunk]
constexpr int kLdJ = kChunk + 4;   // dzS, hS rows (row-major)
constexpr int kReduceThreads = 256;

constexpr size_t kSmemDx = sizeof(float) * (2 * kC * kLdT + kChunk * kLdW1 +
                                            kC * kLdW2 + kChunk * kLdT);
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

// ---- 1. dx pass: one block per 64-row tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_ln_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ ls2,
                     T* __restrict__ dx, float* __restrict__ part, long long M, int H,
                     float eps) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);
  float* gT = aT + kC * kLdT;
  float* w1s = gT + kC * kLdT;
  float* w2s = w1s + kChunk * kLdW1;
  float* dzT = w2s + kC * kLdW2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  stage_tile(x, g, gamma, beta, aT, gT, row0, M, eps, warp, lane);

  float da[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) da[i][u] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    __syncthreads();  // the tile is staged; the previous chunk is consumed
    stage_weights(w1, w2, ls2, w1s, w2s, j0, H, tid);
    __syncthreads();
    float z[4][4], dh[4][4];
    fc1_and_dh(aT, gT, w1s, w2s, ty, tx, z, dh);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 16 * u;
      const float bias = to_f(b1[j0 + j]);
      *reinterpret_cast<float4*>(dzT + j * kLdT + ty * 4) = make_float4(
          dh[0][u] * gelu_erf_grad(z[0][u] + bias), dh[1][u] * gelu_erf_grad(z[1][u] + bias),
          dh[2][u] * gelu_erf_grad(z[2][u] + bias), dh[3][u] * gelu_erf_grad(z[3][u] + bias));
    }
    __syncthreads();
    // da[r][c] += sum_j dz[r][j] W1[j0 + j][c]: rows ty*4 + i, channels tx + 16u
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dzT + j * kLdT + ty * 4);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float w = w1s[j * kLdW1 + tx + 16 * u];
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i][u] = fmaf(dv[i], w, da[i][u]);
      }
    }
  }
  __syncthreads();  // w1s, w2s free: w2s holds da, w1s the per-warp sums
  float* daS = w2s;  // rows x C
  float* red = w1s;  // (warps x 3) x C
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) daS[(ty * 4 + i) * kC + tx + 16 * u] = da[i][u];
  __syncthreads();

  float s_gam[kC / 32], s_bet[kC / 32], s_g[kC / 32];
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) s_gam[u] = s_bet[u] = s_g[u] = 0.f;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long row = row0 + r;
    if (row >= M) break;  // warp-uniform
    float xv[kC / 32], gv[kC / 32], dxh[kC / 32];
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) xv[u] = to_f(x[row * kC + lane + 32 * u]);
    const float rstd = warp_normalise(xv, eps);  // xv = xhat
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) {
      const int c = lane + 32 * u;
      const float dav = daS[r * kC + c];
      gv[u] = to_f(g[row * kC + c]);
      dxh[u] = dav * gamma[c];
      m1 += dxh[u];
      m2 += dxh[u] * xv[u];
      s_gam[u] = fmaf(dav, xv[u], s_gam[u]);
      s_bet[u] += dav;
      s_g[u] += gv[u];
    }
    m1 = warp_sum(m1) * (1.0f / kC);
    m2 = warp_sum(m2) * (1.0f / kC);
#pragma unroll
    for (int u = 0; u < kC / 32; ++u)
      put(dx + row * kC + lane + 32 * u, gv[u] + rstd * (dxh[u] - m1 - xv[u] * m2));
  }
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) {
    const int c = lane + 32 * u;
    red[(warp * 3 + 0) * kC + c] = s_gam[u];
    red[(warp * 3 + 1) * kC + c] = s_bet[u];
    red[(warp * 3 + 2) * kC + c] = s_g[u];
  }
  __syncthreads();
  if (tid < kC) {
    float t[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < kThreads / 32; ++w)
#pragma unroll
      for (int q = 0; q < 3; ++q) t[q] += red[(w * 3 + q) * kC + tid];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      part[(static_cast<long long>(blockIdx.x) * 3 + q) * kC + tid] = t[q];
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
                                         static_cast<int>(kSmemDx));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_ln_bwd_w_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemW));
  if (err != cudaSuccess) return err;
  const long long tiles = (M + kRows - 1) / kRows;
  float* part_dx = a.work;
  float* part_w = a.work + tiles * 3 * kC;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  mlp_ln_bwd_dx_kernel<T><<<static_cast<unsigned>(tiles), kThreads, kSmemDx, stream>>>(
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

}  // namespace

extern "C" {

// Floats of workspace kasf_mlp_ln_bwd needs for M rows, hidden H and
// `splits` row splits of the weight pass.
long long kasf_mlp_ln_bwd_workspace(long long M, int H, int splits) {
  const long long tiles = (M + kRows - 1) / kRows;
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

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
