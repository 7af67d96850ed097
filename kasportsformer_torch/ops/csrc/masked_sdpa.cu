// K1: per-head masked attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/attention.py:_attn_kernel
// (wrapper masked_sdpa_pallas). For every (b, g) sequence of (B, G, N, C)
// inputs it computes, per head h of width D = C / H,
//     out[b, g, :, h] = softmax(q_h k_h^T * scale) v_h      (softmax over N)
//
// Bound on the H100: a sequence holds ~4*N*N*C FLOP against 4*N*C elements
// moved; at N <= 32 that is at most ~8 FLOP per byte (f32), far below the
// card's ridge point: bound by device-memory bytes (q, k, v read once, out
// written once).
//
// Design:
//  * One block per (b, g) sequence. K and V (N x C) are staged once in shared
//    memory as f32 (2*N*C*4 bytes: 110.6 KB at N = 27, C = 512, so above 48 KB
//    the launcher raises the block's dynamic shared-memory limit).
//  * Head widths D in {8, 16, 32, 64}, one template instantiation each; the
//    flagship's D = 16 is one of them. A thread owns DS = min(D, 16) channels
//    of one (head, query row) pair: for D <= 16 the whole head, for D = 32
//    and 64 a slice, and the P = D / DS neighbouring lanes of the pair sum
//    their partial logits with warp shuffles. So a thread keeps at most 16
//    query values, 16 outputs and N logits in registers at every width.
//  * The TPU kernel expanded K and V against a (C, H) head mask so both dots
//    contracted over all 128 channels (the MXU's width), and subtracted the
//    row-global max, re-running with an exact per-head max when a head
//    underflowed. Here each thread contracts over its own head's channels
//    only, so there is no expansion, and it subtracts the exact max of its own
//    head's logits: no head can underflow to 0/0, nothing needs a guard.
//  * Softmax and both products accumulate in f32 for f32 and bf16 inputs.
//  * q, k, v may be strided views (column slices of a fused qkv projection,
//    the temporal (B,T,J,C)->(B,J,T,C) permutation, DSTFormer's grouped
//    (B*F,J,C)->(B,J,F,C) view, or a flat (M,N,C) stream as (1,M,N,C)); the
//    launcher takes the four leading strides of each tensor in elements,
//    channel stride 1.
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

// DS channels a thread owns, the P lanes that share one (head, query row),
// and the most threads a block may have: 1024 (so at most 64 registers a
// thread) where a head is split, which MixSTE's 8 heads x 27 frames x 4 lanes
// need; 512 otherwise, which leaves the flagship's D = 16 its registers
template <int D>
struct HeadSplit {
  static constexpr int DS = D < 16 ? D : 16;
  static constexpr int P = D / DS;
  static constexpr int kMaxThreads = P > 1 ? 1024 : 512;
};

template <typename T, int D>
__global__ void __launch_bounds__(HeadSplit<D>::kMaxThreads)
masked_sdpa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, SdpaStrides st,
                   int G, int N, int C, int H, float scale) {
  constexpr int DS = HeadSplit<D>::DS;
  constexpr int P = HeadSplit<D>::P;
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

  // lanes past the last pair exit when a pair is one lane; when it is
  // several they stay (on pair 0) for the shuffles and store nothing
  int pair = threadIdx.x / P;
  const bool valid = pair < H * N;
  if constexpr (P == 1) {
    if (!valid) return;
  } else {
    if (!valid) pair = 0;
  }
  const int h = pair / N;
  const int i = pair - h * N;
  const int c0 = h * D + (threadIdx.x % P) * DS;  // this thread's channels

  const T* qrow = q + b * st.q[0] + g * st.q[1] + i * st.q[2] + c0;
  float qr[DS];
#pragma unroll
  for (int d4 = 0; d4 < DS / 4; ++d4) {
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
      const float4* kr = reinterpret_cast<const float4*>(ks + j * C + c0);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DS / 4; ++d4) {
        const float4 kk = kr[d4];
        acc = fmaf(qr[4 * d4 + 0], kk.x, acc);
        acc = fmaf(qr[4 * d4 + 1], kk.y, acc);
        acc = fmaf(qr[4 * d4 + 2], kk.z, acc);
        acc = fmaf(qr[4 * d4 + 3], kk.w, acc);
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1)  // the pair's lanes are neighbours
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      s[j] = acc * scale;
      m = fmaxf(m, s[j]);
    }
  }

  float o[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) o[d] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      const float p = expf(s[j] - m);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * C + c0);
#pragma unroll
      for (int d4 = 0; d4 < DS / 4; ++d4) {
        const float4 vv = vr[d4];
        o[4 * d4 + 0] = fmaf(p, vv.x, o[4 * d4 + 0]);
        o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
      }
    }
  }
  if (!valid) return;

  const float inv = 1.f / l;  // l >= 1: the max logit contributes exp(0)
  T* orow = out + b * st.o[0] + g * st.o[1] + i * st.o[2] + c0;
#pragma unroll
  for (int d4 = 0; d4 < DS / 4; ++d4) {
    const float o4[4] = {o[4 * d4] * inv, o[4 * d4 + 1] * inv,
                         o[4 * d4 + 2] * inv, o[4 * d4 + 3] * inv};
    store4(orow + 4 * d4, o4);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const SdpaStrides& st, int B, int G, int N, int C, int H,
                   float scale, cudaStream_t stream) {
  const int threads = ((H * N * HeadSplit<D>::P + 31) / 32) * 32;
  if (threads > HeadSplit<D>::kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(N) * C * sizeof(float);
  static size_t configured = 48 * 1024;  // the limit every kernel has
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_sdpa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * G);
  masked_sdpa_kernel<T, D><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st, G, N, C, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* out,
                         const SdpaStrides& st, int B, int G, int N, int C, int H,
                         float scale, cudaStream_t stream) {
  // every row of q, k, v and out starts on a 4-element boundary
  const std::uintptr_t align = 4 * sizeof(T);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<std::uintptr_t>(p) % align != 0) return cudaErrorMisalignedAddress;
  for (int a = 0; a < 3; ++a)
    if (st.q[a] % 4 || st.k[a] % 4 || st.v[a] % 4 || st.o[a] % 4)
      return cudaErrorMisalignedAddress;
  switch (C / H) {
    case 8: return launch<T, 8>(q, k, v, out, st, B, G, N, C, H, scale, stream);
    case 16: return launch<T, 16>(q, k, v, out, st, B, G, N, C, H, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, st, B, G, N, C, H, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, st, B, G, N, C, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. C = D H with a head width D of 8, 16,
// 32 or 64, C <= 512, and H N <= 512 for D <= 16, C N / 16 <= 1024 for wider
// heads (one thread per 16 channels of a query row). strides: 16 int64 in elements,
// the four leading strides of q, k, v and out in that order (channel stride
// is 1); the three outer ones and every pointer 4-element aligned. Returns
// cudaGetLastError() after the launch (0 on success).
int kasf_masked_sdpa(int dtype, const void* q, const void* k, const void* v, void* out,
                     const long long* strides, int B, int G, int N, int C, int H,
                     float scale, void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kMaxN || H < 1 || C % H || C > 512)
    return cudaErrorInvalidValue;
  SdpaStrides st;
  for (int a = 0; a < 4; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[4 + a];
    st.v[a] = strides[8 + a];
    st.o[a] = strides[12 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_width<float>(q, k, v, out, st, B, G, N, C, H, scale, s);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, out, st, B, G, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
