// K1: per-head masked attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/attention.py:_attn_kernel
// (wrapper masked_sdpa_pallas). For every (b, g) sequence of (B, G, N, C)
// inputs it computes, per head h of width D = C / H,
//     out[b, g, :, h] = softmax(q_h k_h^T * scale) v_h      (softmax over N)
//
// Bound on the H100: the flagship calls it at N = 17 or 27 and D = 16 (the
// only head width built: the flagship's C = 128 over 8 heads), so a
// sequence holds ~4*N*N*C = 0.1-0.4 MFLOP against 4*N*C elements moved; at
// ~4 FLOP per byte (f32) it sits far below the card's ridge point and is
// bound by device-memory bytes (q, k, v read once, out written once).
//
// Design:
//  * One block per (b, g) sequence. K and V (N x C) are staged once in shared
//    memory as f32; each thread owns one (head, query row) pair and keeps its
//    D-wide query row, its N logits and its D-wide output in registers.
//  * The TPU kernel expanded K and V against a (C, H) head mask so both dots
//    contracted over all 128 channels (the MXU's width), and subtracted the
//    row-global max, re-running with an exact per-head max when a head
//    underflowed. Here each thread contracts over its own head's D channels
//    only, so there is no expansion, and it subtracts the exact max of its own
//    head's logits: no head can underflow to 0/0, nothing needs a guard.
//  * Softmax and both products accumulate in f32 for f32 and bf16 inputs.
//  * q, k, v may be strided views (column slices of a fused qkv projection,
//    or the temporal (B,T,J,C)->(B,J,T,C) permutation); the launcher takes the
//    four leading strides of each tensor in elements, channel stride 1.
//  * Global loads stage through shared memory with neighbouring threads on
//    neighbouring channels, four channels an access (16 bytes in f32, 8 in
//    bf16); every row of q, k, v and out must start on such a boundary (the
//    wrapper copies an operand that does not). Shared reads are float4 and
//    broadcast across the threads of one head.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kMaxN = 32;
constexpr int kD = 16;  // head width

struct SdpaStrides {
  long long q[4], k[4], v[4], o[4];
};

// four consecutive elements as floats, in one 16-byte (f32) or 8-byte
// (bf16) access; kasf_masked_sdpa checks the alignment
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

template <typename T>
__global__ void masked_sdpa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, T* __restrict__ out,
                                   SdpaStrides st, int G, int N, int C, int H,
                                   float scale) {
  constexpr int D = kD;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // N x C
  float* vs = ks + N * C;                       // N x C

  const long long seq = blockIdx.x;
  const long long b = seq / G;
  const long long g = seq - b * G;
  const T* kb = k + b * st.k[0] + g * st.k[1];
  const T* vb = v + b * st.v[0] + g * st.v[1];
  for (int e = threadIdx.x; e < N * C / 4; e += blockDim.x) {
    const int j = e / (C / 4);
    const int c = 4 * (e - j * (C / 4));
    float kk[4], vv[4];
    load4(kb + j * st.k[2] + c, kk);
    load4(vb + j * st.v[2] + c, vv);
    store4(ks + j * C + c, kk);
    store4(vs + j * C + c, vv);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= H * N) return;
  const int h = t / N;
  const int i = t - h * N;

  const T* qrow = q + b * st.q[0] + g * st.q[1] + i * st.q[2] + h * D;
  float qr[D];
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float q4[4];
    load4(qrow + 4 * d4, q4);
#pragma unroll
    for (int u = 0; u < 4; ++u) qr[4 * d4 + u] = q4[u];
  }

  // logits of this head's query row, and their exact max
  float s[kMaxN];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * C + h * D);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        acc = fmaf(qr[4 * d4 + 0], kk.x, acc);
        acc = fmaf(qr[4 * d4 + 1], kk.y, acc);
        acc = fmaf(qr[4 * d4 + 2], kk.z, acc);
        acc = fmaf(qr[4 * d4 + 3], kk.w, acc);
      }
      s[j] = acc * scale;
      m = fmaxf(m, s[j]);
    }
  }

  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      const float p = expf(s[j] - m);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * C + h * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        o[4 * d4 + 0] = fmaf(p, vv.x, o[4 * d4 + 0]);
        o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
      }
    }
  }

  const float inv = 1.f / l;  // l >= 1: the max logit contributes exp(0)
  T* orow = out + b * st.o[0] + g * st.o[1] + i * st.o[2] + h * D;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float o4[4] = {o[4 * d4] * inv, o[4 * d4 + 1] * inv,
                         o[4 * d4 + 2] * inv, o[4 * d4 + 3] * inv};
    store4(orow + 4 * d4, o4);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const SdpaStrides& st, int B, int G, int N, int C, int H,
                   float scale, cudaStream_t stream) {
  // every row of q, k, v and out starts on a 4-element boundary
  const std::uintptr_t align = 4 * sizeof(T);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<std::uintptr_t>(p) % align != 0) return cudaErrorMisalignedAddress;
  for (int a = 0; a < 3; ++a)
    if (st.q[a] % 4 || st.k[a] % 4 || st.v[a] % 4 || st.o[a] % 4)
      return cudaErrorMisalignedAddress;
  const size_t smem = 2 * static_cast<size_t>(N) * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_sdpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = ((H * N + 31) / 32) * 32;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * G);
  masked_sdpa_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st, G, N, C, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. C = 16 H. strides: 16 int64 in elements,
// the four leading strides of q, k, v and out in that order (channel stride
// is 1); the three outer ones and every pointer 4-element aligned. Returns
// cudaGetLastError() after the launch (0 on success).
int kasf_masked_sdpa(int dtype, const void* q, const void* k, const void* v, void* out,
                     const long long* strides, int B, int G, int N, int C, int H,
                     float scale, void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kMaxN || H < 1 || C != kD * H || H * N > 1024)
    return cudaErrorInvalidValue;
  SdpaStrides st;
  for (int a = 0; a < 4; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[4 + a];
    st.v[a] = strides[8 + a];
    st.o[a] = strides[12 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, st, B, G, N, C, H, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, st, B, G, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
