// K2: per-head masked attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/attention.py:_attn_bwd_kernel
// (wrapper masked_sdpa_bwd_pallas, VJP _masked_sdpa_bwd). For every (b, g)
// sequence of (B, G, N, C) inputs and every head h of width D = C / H, from the
// residuals q, k, v and the output gradient g alone:
//     P  = softmax(q_h k_h^T * scale)                  (recomputed)
//     dV = P^T g_h,  dP = g_h v_h^T
//     dS = P * (dP - rowsum(P * dP)) * scale
//     dq = dS k_h,   dk = dS^T q_h
//
// Bound on the H100: 7 tensors of B*G*N*C elements move (q, k, v, g in; dq,
// dk, dv out) against ~10*N*N*C FLOP per sequence: at N = 17 or 27 that is a
// few FLOP per byte, far below the card's ridge point, so it is bound by
// device-memory bytes.
//
// Design (simple and right first):
//  * One block per (b, g) sequence. q, k, v and g (N x C) are staged once in
//    shared memory as f32, from strided views: four leading strides each,
//    channel stride 1, every row starting on a 4-element boundary (the
//    wrapper copies an operand that does not), as K1 takes them.
//  * Pass 1, one thread per (head, query row): recompute the logits with the
//    exact per-head max (no head can underflow to 0/0, nothing needs a
//    guard), P, dP and the row sum of P * dP in registers; write P and dS of
//    all heads to shared memory (H*N*N f32 each: 32 KB at N = 32, H = 8) and
//    dq, which needs only this row, to device memory.
//  * Pass 2, one thread per (head, key row): dv and dk sum over the query
//    rows of the staged P and dS, so no two threads write one element and no
//    atomics are needed.
//  * Everything accumulates in f32 for f32 and bf16 inputs; only dq, dk and
//    dv are rounded to the input dtype. They come out contiguous (B, G, N, C).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kMaxN = 32;
constexpr int kD = 16;  // head width

struct BwdStrides {
  long long q[4], k[4], v[4], g[4];
};

__device__ __forceinline__ void load4(const float* p, float (&d)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&d)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  d[0] = lo.x; d[1] = lo.y; d[2] = hi.x; d[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&d)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&d)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(d[0], d[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(d[2], d[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// one D-wide head row of a staged (N x C) f32 tile
__device__ __forceinline__ void head_row(const float* tile, int row, int C, int h,
                                         float (&r)[kD]) {
  const float4* p = reinterpret_cast<const float4*>(tile + row * C + h * kD);
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 v = p[d4];
    r[4 * d4] = v.x; r[4 * d4 + 1] = v.y; r[4 * d4 + 2] = v.z; r[4 * d4 + 3] = v.w;
  }
}

__device__ __forceinline__ float dot_head(const float (&a)[kD], const float* tile,
                                          int row, int C, int h) {
  const float4* p = reinterpret_cast<const float4*>(tile + row * C + h * kD);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 v = p[d4];
    acc = fmaf(a[4 * d4], v.x, acc);
    acc = fmaf(a[4 * d4 + 1], v.y, acc);
    acc = fmaf(a[4 * d4 + 2], v.z, acc);
    acc = fmaf(a[4 * d4 + 3], v.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy_head(float s, const float* tile, int row, int C,
                                          int h, float (&acc)[kD]) {
  const float4* p = reinterpret_cast<const float4*>(tile + row * C + h * kD);
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 v = p[d4];
    acc[4 * d4] = fmaf(s, v.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(s, v.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(s, v.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(s, v.w, acc[4 * d4 + 3]);
  }
}

template <typename T>
__device__ __forceinline__ void store_head(T* row, const float (&r)[kD]) {
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float o4[4] = {r[4 * d4], r[4 * d4 + 1], r[4 * d4 + 2], r[4 * d4 + 3]};
    store4(row + 4 * d4, o4);
  }
}

template <typename T>
__global__ void masked_sdpa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const T* __restrict__ g,
                                       T* __restrict__ dq, T* __restrict__ dk,
                                       T* __restrict__ dv, BwdStrides st, int G, int N,
                                       int C, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // N x C each
  float* ks = qs + N * C;
  float* vs = ks + N * C;
  float* gs = vs + N * C;
  float* ps = gs + N * C;   // H x N x N: P
  float* dss = ps + H * N * N;  // H x N x N: dS

  const long long seq = blockIdx.x;
  const long long b = seq / G;
  const long long gi = seq - b * G;
  const T* qb = q + b * st.q[0] + gi * st.q[1];
  const T* kb = k + b * st.k[0] + gi * st.k[1];
  const T* vb = v + b * st.v[0] + gi * st.v[1];
  const T* gb = g + b * st.g[0] + gi * st.g[1];
  for (int e = threadIdx.x; e < N * C / 4; e += blockDim.x) {
    const int j = e / (C / 4);
    const int c = 4 * (e - j * (C / 4));
    float t4[4];
    load4(qb + j * st.q[2] + c, t4);
    store4(qs + j * C + c, t4);
    load4(kb + j * st.k[2] + c, t4);
    store4(ks + j * C + c, t4);
    load4(vb + j * st.v[2] + c, t4);
    store4(vs + j * C + c, t4);
    load4(gb + j * st.g[2] + c, t4);
    store4(gs + j * C + c, t4);
  }
  __syncthreads();

  const int t = threadIdx.x;
  const bool active = t < H * N;
  const int h = active ? t / N : 0;
  const int r = active ? t - h * N : 0;
  const long long out_base = seq * N * C;  // outputs are contiguous (B, G, N, C)

  // ---- pass 1: thread (h, i = r) -> P, dS rows of this head, and dq
  if (active) {
    float qr[kD], gr[kD];
    head_row(qs, r, C, h, qr);
    head_row(gs, r, C, h, gr);
    float s[kMaxN], dp[kMaxN];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        s[j] = dot_head(qr, ks, j, C, h) * scale;
        m = fmaxf(m, s[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        s[j] = expf(s[j] - m);
        l += s[j];
      }
    }
    const float inv = 1.f / l;  // l >= 1: the max logit contributes exp(0)
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        s[j] *= inv;
        dp[j] = dot_head(gr, vs, j, C, h);
        rowsum = fmaf(s[j], dp[j], rowsum);
      }
    }
    float dqr[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) dqr[d] = 0.f;
    float* prow = ps + (h * N + r) * N;
    float* dsrow = dss + (h * N + r) * N;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        const float ds = s[j] * (dp[j] - rowsum) * scale;
        prow[j] = s[j];
        dsrow[j] = ds;
        axpy_head(ds, ks, j, C, h, dqr);
      }
    }
    store_head(dq + out_base + static_cast<long long>(r) * C + h * kD, dqr);
  }
  __syncthreads();

  // ---- pass 2: thread (h, j = r) -> dv = P^T g, dk = dS^T q
  if (active) {
    float dvr[kD], dkr[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      dvr[d] = 0.f;
      dkr[d] = 0.f;
    }
    const float* pcol = ps + h * N * N + r;
    const float* dscol = dss + h * N * N + r;
    for (int i = 0; i < N; ++i) {
      axpy_head(pcol[i * N], gs, i, C, h, dvr);
      axpy_head(dscol[i * N], qs, i, C, h, dkr);
    }
    const long long off = out_base + static_cast<long long>(r) * C + h * kD;
    store_head(dv + off, dvr);
    store_head(dk + off, dkr);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const BwdStrides& st, int B, int G, int N, int C,
                   int H, float scale, cudaStream_t stream) {
  const std::uintptr_t align = 4 * sizeof(T);
  for (const void* p : {q, k, v, g, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv)})
    if (reinterpret_cast<std::uintptr_t>(p) % align != 0) return cudaErrorMisalignedAddress;
  for (int a = 0; a < 3; ++a)
    if (st.q[a] % 4 || st.k[a] % 4 || st.v[a] % 4 || st.g[a] % 4)
      return cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float) * (4 * static_cast<size_t>(N) * C +
                                       2 * static_cast<size_t>(H) * N * N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_sdpa_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = ((H * N + 31) / 32) * 32;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * G);
  masked_sdpa_bwd_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), st, G, N, C, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. C = 16 H. strides: 16 int64 in elements,
// the four leading strides of q, k, v and g in that order (channel stride
// 1); the three outer ones and every pointer 4-element aligned. dq, dk, dv
// are contiguous (B, G, N, C). Returns cudaGetLastError() after the launch.
int kasf_masked_sdpa_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv,
                         const long long* strides, int B, int G, int N, int C, int H,
                         float scale, void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kMaxN || H < 1 || C != kD * H || H * N > 1024)
    return cudaErrorInvalidValue;
  BwdStrides st;
  for (int a = 0; a < 4; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[4 + a];
    st.v[a] = strides[8 + a];
    st.g[a] = strides[12 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
