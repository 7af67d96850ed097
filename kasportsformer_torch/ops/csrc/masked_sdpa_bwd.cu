// K2: per-head masked attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/attention.py:_attn_bwd_kernel
// (wrapper masked_sdpa_bwd_pallas, VJP _masked_sdpa_bwd). For every (b, g)
// sequence of (B, G, N, C) inputs and every head h of width D = C / H, from the
// residuals q, k, v and the output gradient g alone:
//     P  = softmax(q_h k_h^T * scale)                  (recomputed, exact max)
//     dV = P^T g_h,  dP = g_h v_h^T
//     dS = P * (dP - rowsum(P * dP)) * scale
//     dq = dS k_h,   dk = dS^T q_h
//
// Bound on the H100: 7 tensors of B*G*N*C elements move (q, k, v, g in; dq,
// dk, dv out): 52.6 MB in f32 at (32, 27, 17, 128), 15.7 us at 3.35 TB/s.
// Beside them, the five products (S, dP, dV, dq, dk) are 5*N*N*C FMAs a
// sequence: 160 M spatially (N = 17), 4.8 us at the full f32 FMA rate, and
// 254 M temporally (N = 27), 7.6 us. So it is bound by bytes, but the work
// is not small beside them: only copies kept in flight while the products
// run come near the byte bound.
//
// Design:
//  * Unit of work: one (sequence, head group) tile, HG = 64 / D heads (W = 64
//    channels; a last group of fewer heads, C not a multiple of W, loads and
//    computes only its heads). Persistent blocks (SMs x 2, at most one a
//    tile) walk the tiles in order through a two-stage ring: while tile t
//    computes, the block's last warp copies tile t + grid into the other
//    stage by 16-byte cp.async.cg copies (kasf_mma::cp_async16) and each of
//    its lanes arrives on the stage's mbarrier once its copies have landed
//    (cp.async.mbarrier.arrive); the other warps compute no tile indices
//    but the output offset. A stage holds q, k, v and g of a tile, 32 rows
//    (N padded; 4 NB at D = 8) x W channels, each row padded by 16 bytes;
//    padded rows are zeroed once and never written again. The loader takes all four leading
//    strides of each operand (column slices of one qkv projection, the
//    (B,T,J,C)->(B,J,T,C) permutation, a transposed gradient), channel
//    stride 1, rows on 16-byte boundaries.
//    Why four heads and not eight: an 8-head tile's ring and P/dS take
//    ~200 KB, one block a SM, a 4-head tile's ~107 KB, two blocks a SM, so
//    one block's barriers and loads overlap the other's products; the
//    8-head tile measured 10-20 % slower (scripts/k2_tile_stamps.py
//    --heads 8, both with stamps).
//    Why cp.async from one warp: copies issued by every thread held every
//    warp at the issue (~2k cycles a tile in the stamps); one bulk copy a
//    row (4 N a tile) measured no better than this.
//  * Exact f32 on the CUDA cores from either dtype (TF32 would put ~5e-4 on
//    each logit), but bf16 at D = 16 (below). bf16 is copied as bf16 (half
//    the bytes) and widened to an f32 copy of the stage once a tile, so no
//    product widens its operands; only dq, dk and dv are rounded. So bf16 at
//    D = 8, 32 and 64 computes more exactly than _attn_bwd_kernel, which
//    rounds P and dS to bf16 for their products (no config trains those
//    widths in bf16).
//  * bf16 at D = 16 (the flagship's, which the JAX package's bench trains in
//    bf16) is masked_sdpa_bwd_mma_kernel, on the tensor cores: it rounds P
//    and dS where _attn_bwd_kernel does, and its design is written beside
//    it. Its bound is 26.3 MB at (32, 27, 17, 128), 7.9 us; its products,
//    10 x 32^2 x C a sequence with the padding, ~1 us at the dense bf16
//    rate: bound by bytes.
//  * A tile's time goes to shared-memory reads and their latency more than
//    to FMAs, so every product runs on register tiles (each float read feeds
//    2 to 4 FMAs, every read 16 bytes wide) and each warp has 16 or more
//    independent accumulators.
//  * Pass 1, a group of four lanes per (head, block of four query rows),
//    packed over the tile's heads x ceil(N / 4) blocks (no group on a block
//    that is all padding): lane jb takes the keys jb + 4k and forms S and dP
//    of the four rows x its keys (4 x NB register tiles, NB = ceil(N / 4),
//    an instantiation each, so no loop has a guard). A head of D = 32 or 64
//    takes 4 D / 16 lanes, lane kl the keys kl + 4 (D / 16) k over the whole
//    head width: a lane holds ceil(NB 16 / D) keys (fewer registers than
//    D / 16 quads each over 16 channels, whose S and dP sums spilled at
//    NB = 7, 8), the row reductions take one or two more shuffles, and the
//    tile keeps its 256 threads. The row softmax takes
//    two butterfly shuffles a reduction, the four rows side by side; the
//    exponential is 2^((t - m) log2 e), with t - m formed in f32 first.
//    P and dS go to shared memory transposed (key-major), one 16-byte store
//    a key and a lane.
//  * Pass 2, from P^T and dS^T: lanes (head, four keys, four channels) sum
//    dV = P^T g and dK = dS^T q over the rows, four rows a step (4 x 4
//    register tiles, two 16-byte reads of P^T and dS^T a step); lanes from
//    the next warp on (head, four rows, eight channels) sum dq = dS k over
//    the keys. Padded rows and keys read zeros (or finite P, dS times zero
//    rows), so the sums need no guard; each output element is one sum in a
//    fixed order: no atomics, reruns bitwise equal.
//  * P and dS are kept (5 products) rather than recomputed from per-row
//    statistics (7 products): shared memory reads set the pace, and
//    recomputing would read k and v once more for every key of every row.
//  * Head width D is a template parameter, instantiated at D = 16 (the
//    flagship's: four heads a tile), 32 (DSTFormer: two) and 64 (MixSTE:
//    one), every NB and both dtypes: a tile is 64 channels, so the ring,
//    its loader, the stages and the block of 256 threads are the same at
//    every D (P^T and dS^T shrink with the heads), and pass 2's lanes (16 NB
//    and 8 NB of them) too.
//  * D = 8 (MotionAGFormer-XS and hierarchical: C = 64 over 8 heads) takes
//    a tile of eight heads, one sequence's 64 channels, so the launch walks
//    as many tiles as sequences, each of D = 16's bytes. A tile's time is
//    set by its lanes' chains of dependent shared-memory reads, not by its
//    FMAs, and the chains are as long at eight heads as at four: pass 1
//    gives a (head, row block) four lanes, each over the whole 8-channel
//    head (two float4 dots a key and row: 160 lanes at N = 17, 224 at 27),
//    pass 2 2 NB dV, dK lanes a head, as D = 16's four heads have. What kept
//    eight heads out was shared memory: P^T, dS^T and the ring sized by the
//    32-row stage took ~144 KB, one block a SM. At D = 8 they are sized by
//    the instantiation's 4 NB rows (kRows): 70,416 B at N = 17 and 112,912 B
//    at N = 27 in f32 (114,704 B in bf16), so two blocks a SM overlap one's
//    loads with the other's products up to N = 28; N = 29..32 takes ~145 KB,
//    one block a SM. Eight heads put a warp's pass-2 lanes on 16 (head, key
//    block) pairs, whose reads of P^T and dS^T fell on two groups of banks
//    (8-way conflicts: a block of four keys is 4 x pitch floats, a multiple
//    of 16); a float4 of padding a key block and heads 4 mod 8 floats apart
//    spread them over all eight. Pass 1 packs its groups row blocks
//    fastest there, so a quarter warp's two groups read the same keys, and
//    pass 2's dq lanes take four channels, so its lanes fill all eight
//    warps. 0.0175 / 0.0199 ms spatial / temporal in f32 at batch 32 (XS's
//    step) against 0.0257 / 0.0250 for four heads a tile, on an H100 80GB
//    HBM3 at 700 W. The instantiations at D = 16, 32 and 64 compute what
//    they did before D = 8 was added, bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using kasf_mma::bf16_hi;
using kasf_mma::bf16_lo;
using kasf_mma::cp_async16;
using kasf_mma::cp_async_arrive;
using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;
using kasf_mma::pack_bf16;

constexpr int kMaxN = 32;   // the longest N; rows a stage holds at D >= 16
constexpr int kMaxC = 512;  // the widest model's channels
constexpr int kStages = 2;  // the ring of cp.async copies
constexpr int kMaxDevices = 64;
constexpr int kSmemPerSM = 233472;  // the H100's shared memory a SM: 228 KB

struct BwdStrides {
  long long q[4], k[4], v[4], g[4];
};

template <typename T, int D, int NB>
struct Tile {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64, "heads of 8, 16, 32 or 64 channels");
  static_assert(NB >= 1 && 4 * NB <= kMaxN, "blocks of four rows");
  static constexpr int HG = 64 / D;                // heads a group
  static constexpr int W = HG * D;                 // channels a group: 64
  static constexpr int kSplit = D == 8 ? 1 : D / 16;  // pass 1's lanes a (head, row block): 4 kSplit
  static constexpr int kThreads = 256;
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // 16 bytes
  // rows a stage holds, N padded: at D = 8 the instantiation's 4 NB, so that
  // two blocks a SM hold eight heads' P^T, dS^T and ring up to N = 28; at
  // D = 16, 32 and 64 the 32 of every NB
  static constexpr int kRows = D == 8 ? 4 * NB : kMaxN;
  static constexpr int kRingPitch = W + kChunk;    // elements a ring row
  static constexpr int kRingStage = 4 * kRows * kRingPitch;  // q, k, v, g
  static constexpr int kPitch = W + 4;             // floats a row of the f32 stage
  static constexpr int kStage = 4 * kRows * kPitch;
  // floats a key of P^T, dS^T: 4 mod 8, so a lane's four keys of one store
  // lie in four distinct groups of four banks (kRows + 4 at 32 rows)
  static constexpr int kPPitch = D == 8 ? 4 * (NB | 1) : kMaxN + 4;
  // floats a block of four keys: at D = 8 one float4 more (20 mod 32), so
  // the key blocks of a warp's pass-2 reads of P^T and dS^T fall on
  // distinct banks; a head's keys 4 mod 8 floats apart there (16 banks
  // apart at D >= 16)
  static constexpr int kPBlock = 4 * kPPitch + (D == 8 ? 4 : 0);
  static constexpr int kPKeys = kRows / 4 * kPBlock;
  static constexpr int kPHead = D == 8 ? kPKeys + (kPKeys % 8 == 4 ? 0 : 4)
                                       : kPKeys + (48 - kPKeys % 32) % 32;
  // key j's offset in a head's P^T or dS^T
  __host__ __device__ static constexpr int key(int j) {
    return (j >> 2) * kPBlock + (j & 3) * kPPitch;
  }
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRingBytes = kStages * kRingStage * static_cast<int>(sizeof(T));
  static constexpr int kPBytes = 2 * HG * kPHead * 4;  // P^T and dS^T
  static constexpr int kBarBytes = 16;             // an mbarrier a ring stage
  static constexpr int kStageBytes = kF32 ? 0 : kStage * 4;  // bf16: the widened copy
  static constexpr int kSmem = kRingBytes + kStageBytes + kPBytes + kBarBytes;
  // blocks a SM, as shared memory allows (1 KB of it reserved a block):
  // two, or one at D = 8 and N > 28, which may then take 255 registers
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= kSmemPerSM ? 2 : 1;
  static_assert(kF32 == (kRingPitch == kPitch), "an f32 ring stage is the f32 stage");
  static_assert(D % 8 == 0, "dq's lanes take four or eight channels of a head");
};

// bf16 at heads of 16 (the flagship's) runs masked_sdpa_bwd_mma_kernel
template <typename T, int D>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && D == 16;

// leading stride a (0..2) of operand z (q, k, v, g)
__device__ __forceinline__ long long stride(const BwdStrides& st, int z, int a) {
  return z == 0 ? st.q[a] : z == 1 ? st.k[a] : z == 2 ? st.v[a] : st.g[a];
}

// a tile: its sequence, head group, the heads the group has, and the
// element offset of its first channel in row 0 of the contiguous outputs
struct TileBase {
  long long o;
  int seq, grp, heads;
};

template <int HG, int W>
__device__ __forceinline__ TileBase tile_base(int t, int groups, int N, int C, int H) {
  TileBase tb;
  tb.seq = t / groups;
  tb.grp = t - tb.seq * groups;
  tb.o = static_cast<long long>(tb.seq) * N * C + tb.grp * W;
  tb.heads = min(HG, H - tb.grp * HG);
  return tb;
}

// One warp: q, k, v and g rows 0..N-1 of a tile's head group into a ring
// stage by 16-byte cp.async copies (lane l takes chunk l % R of rows
// l / R, l / R + 32 / R, ..., R the chunks a row), then one arrival each on
// the stage's mbarrier once its copies have landed
template <typename T, int D, int NB>
__device__ __forceinline__ void load_tile(T* stage, unsigned long long* bar,
                                          const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v, const T* __restrict__ g,
                                          const BwdStrides& st, const TileBase& tb, int G,
                                          int N, int lane) {
  using Tl = Tile<T, D, NB>;
  constexpr int kRowChunks = Tl::W / Tl::kChunk;
  constexpr int kRowStep = 32 / kRowChunks;  // rows a pass of the warp
  const int ch = lane % kRowChunks;
  if (ch < tb.heads * D / Tl::kChunk) {  // not past a short last group
    const int row = lane / kRowChunks;
    const long long b = tb.seq / G;
    const long long gi = tb.seq - b * G;
    const long long c0 = tb.grp * Tl::W + ch * Tl::kChunk;
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      const long long rs = stride(st, z, 2);
      const T* src = (z == 0 ? q : z == 1 ? k : z == 2 ? v : g) + b * stride(st, z, 0) +
                     gi * stride(st, z, 1) + row * rs + c0;
      T* dst = stage + (z * Tl::kRows + row) * Tl::kRingPitch + ch * Tl::kChunk;
#pragma unroll 4
      for (int u = 0; u < (Tl::kRows + kRowStep - 1) / kRowStep; ++u)
        if (row + u * kRowStep < N)
          cp_async16(dst + u * kRowStep * Tl::kRingPitch, src + u * kRowStep * rs);
    }
  }
  cp_async_arrive(bar);
}

// bf16: rows 0..N-1 of a landed ring stage widened into the f32 stage (its
// padded rows stay zero); a thread widens four channels at a time,
// neighbouring threads on neighbouring 16-byte stores
template <int D, int NB>
__device__ __forceinline__ void widen_tile(const __nv_bfloat16* ring, float* stage,
                                           int heads, int N) {
  using Tl = Tile<__nv_bfloat16, D, NB>;
  constexpr int kRowQuads = Tl::W / 4;
  constexpr int kRowStep = Tl::kThreads / kRowQuads;
  const int c4 = threadIdx.x % kRowQuads;
  if (c4 >= heads * D / 4) return;
#pragma unroll
  for (int u = 0; u < (Tl::kRows + kRowStep - 1) / kRowStep; ++u) {
    const int row = threadIdx.x / kRowQuads + u * kRowStep;
    if (row < N) {
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const uint2 w = *reinterpret_cast<const uint2*>(
            ring + (z * Tl::kRows + row) * Tl::kRingPitch + 4 * c4);
        *reinterpret_cast<float4*>(stage + (z * Tl::kRows + row) * Tl::kPitch + 4 * c4) =
            make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      }
    }
  }
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 1/x in one MUFU.RCP (1 ulp), for a softmax sum x >= 1
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}
// acc + a . b, one chain of four FMAs
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// 4 f32 or 4 bf16 (8 bytes) from four floats
__device__ __forceinline__ void store4(float* dst, const float4& x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float4& x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// ---- pass 1: a group of L = 4 S lanes (S = D / 16) per (head h, row
// block ib) of the tile's heads x NB blocks, packed with the heads fastest
// (at D = 16 the two groups of a quarter warp read and write 16 banks
// apart); lane kl of the group takes the keys kl + L k over the head's whole
// width, so a wider head spreads its keys over more lanes and a lane holds
// NK = ceil(NB / S) of them. S and dP of rows 4 ib .. +3 x its keys, the row
// softmax (log2 L shuffles a reduction, within the group), then P^T and
// dS^T of its keys to shared memory, one 16-byte store a key: padded rows
// (q, g zero) give finite values there that pass 2 multiplies by zero rows
// or never stores, padded keys give zeros
template <typename T, int D, int NB>
__device__ __forceinline__ void pass1(const float* stage, float* pt, float* dst, int heads,
                                      int N, float scale) {
  using Tl = Tile<T, D, NB>;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int S = Tl::kSplit;
  constexpr int L = 4 * S;              // lanes a (head, row block)
  constexpr int NK = (NB + S - 1) / S;  // keys a lane: kl + L k < 4 S NK <= kRows
  static_assert(L * NK <= Tl::kRows, "a lane's keys lie in the stage's rows");
  const int groups = heads * NB;
  if (static_cast<int>(threadIdx.x >> 5) * 8 >= groups * S) return;  // the whole warp is idle
  const int grp = threadIdx.x / L;
  const bool valid = grp < groups;  // invalid groups compute group 0, store nothing
  // heads fastest (at D = 16 a quarter warp's two groups 16 banks apart), at
  // D = 8 row blocks fastest (a quarter warp's two groups read the same keys)
  const int ib = !valid ? 0 : D == 8 ? grp % NB : grp / heads;
  const int h = !valid ? 0 : D == 8 ? grp / NB : grp - ib * heads;
  const int kl = threadIdx.x % L;
  const float* qs = stage + 4 * ib * Tl::kPitch + h * D;
  const float* gs = qs + 3 * Tl::kRows * Tl::kPitch;
  const float* ks = stage + (Tl::kRows + kl) * Tl::kPitch + h * D;
  const float* vs = ks + Tl::kRows * Tl::kPitch;

  float s[4][NK], dp[4][NK];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < NK; ++k) s[r][k] = dp[r][k] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = reinterpret_cast<const float4*>(qs + r * Tl::kPitch)[d4];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float4 b = reinterpret_cast<const float4*>(ks + L * k * Tl::kPitch)[d4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][k] = dot4(a[r], b, s[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = reinterpret_cast<const float4*>(gs + r * Tl::kPitch)[d4];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float4 b = reinterpret_cast<const float4*>(vs + L * k * Tl::kPitch)[d4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dp[r][k] = dot4(a[r], b, dp[r][k]);
    }
  }

  // the four rows side by side, so that their shuffles overlap: the exact
  // max of each row's scaled logits (padded keys masked), then
  // p = 2^((t - m) log2 e) (t - m is formed before the conversion, so large
  // logits lose nothing to it), the sum and rowsum(P * dP); butterflies, so
  // every lane of the group forms the same sums
  float m[4], l[4], rs[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      s[r][k] = kl + L * k < N ? s[r][k] * scale : -INFINITY;
      m[r] = fmaxf(m[r], s[r][k]);
    }
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      s[r][k] = fast_exp2((s[r][k] - m[r]) * kLog2e);  // padded keys: 2^-inf = 0
      l[r] += s[r][k];
    }
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = fast_rcp(l[r]);  // l >= 1: the max logit contributes 2^0
    rs[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      s[r][k] *= inv;
      rs[r] = fmaf(s[r][k], dp[r][k], rs[r]);
    }
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], o);
  if (!valid) return;
  float* pj = pt + h * Tl::kPHead + 4 * ib;
  float* dj = dst + h * Tl::kPHead + 4 * ib;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    float4 ds;
    ds.x = s[0][k] * (dp[0][k] - rs[0]) * scale;
    ds.y = s[1][k] * (dp[1][k] - rs[1]) * scale;
    ds.z = s[2][k] * (dp[2][k] - rs[2]) * scale;
    ds.w = s[3][k] * (dp[3][k] - rs[3]) * scale;
    *reinterpret_cast<float4*>(pj + Tl::key(kl + L * k)) =
        make_float4(s[0][k], s[1][k], s[2][k], s[3][k]);
    *reinterpret_cast<float4*>(dj + Tl::key(kl + L * k)) = ds;
  }
}

// pass 2's operands of a step of four rows 4 ic .. +3: of four keys of P^T
// or dS^T (pitch PP) and four channels of g or q (pitch P)
template <int PP, int P>
__device__ __forceinline__ void load_rows(const float* keys, const float* rows, int ic,
                                          float4 (&w)[4], float4 (&x)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    w[t] = *reinterpret_cast<const float4*>(keys + t * PP + 4 * ic);
    x[t] = *reinterpret_cast<const float4*>(rows + (4 * ic + t) * P);
  }
}
// acc[t] += sum_e w[t][e] x[e]
__device__ __forceinline__ void outer_step(float4 (&acc)[4], const float4 (&w)[4],
                                           const float4 (&x)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    fma4(acc[t], w[t].x, x[0]);
    fma4(acc[t], w[t].y, x[1]);
    fma4(acc[t], w[t].z, x[2]);
    fma4(acc[t], w[t].w, x[3]);
  }
}
// dq's operands of step j2 (keys 2 j2, 2 j2 + 1): dS^T of the four rows
// (key j at Tl::key(j)), 4 Q channels of k (pitch P)
template <typename Tl, int P, int Q>
__device__ __forceinline__ void load_keys(const float* ds, const float* ks, int j2,
                                          float4 (&w)[2], float4 (&x)[2][Q]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = 2 * j2 + e;
    w[e] = *reinterpret_cast<const float4*>(ds + Tl::key(j));
#pragma unroll
    for (int c = 0; c < Q; ++c) x[e][c] = *reinterpret_cast<const float4*>(ks + j * P + 4 * c);
  }
}
template <int Q>
__device__ __forceinline__ void dq_step(float4 (&acc)[4][Q], const float4 (&w)[2],
                                        const float4 (&x)[2][Q]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float wt[4] = {w[e].x, w[e].y, w[e].z, w[e].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < Q; ++c) fma4(acc[t][c], wt[t], x[e][c]);
  }
}

// ---- pass 2, from P^T and dS^T: lanes 0 .. nA - 1 take (head, key block
// of four, four channels) and sum dV = P^T g and dK = dS^T q over the rows,
// four rows a step (16-byte reads of P^T and dS^T), the next step's reads
// issued before this step's FMAs; from the next warp on, lanes take
// (head, row block of four, 4 Q channels: eight, four at D = 8) and sum
// dq = dS k over the keys. At D = 8 the four-channel dq lanes fill warps
// 4-7 about as the dV, dK lanes fill warps 0-3, so each scheduler issues
// one warp of each (eight-channel ones left two schedulers two full warps
// of the tile's longest chains). Every sum runs over the padded rows or
// keys in order (their entries are zero, or finite P and dS of a padded
// row times a zero row): no guard, no atomics, each output element one
// fixed sum
template <typename T, int D, int NB>
__device__ __forceinline__ void pass2(const float* stage, const float* pt, const float* dst,
                                      T* __restrict__ dq, T* __restrict__ dk,
                                      T* __restrict__ dv, const TileBase& tb, int N, int C) {
  using Tl = Tile<T, D, NB>;
  const int nA = tb.heads * NB * (D / 4);
  const int offB = (nA + 31) & ~31;
  constexpr int Q = D == 8 ? 1 : 2;  // dq's float4s a lane
  const int nB = tb.heads * NB * (D / (4 * Q));
  const int u = threadIdx.x;
  if (u < nA) {
    const int c4 = u % (D / 4);
    const int hk = u / (D / 4);
    const int h = hk / NB;
    const int kb = hk - h * NB;
    const float* pth = pt + h * Tl::kPHead + kb * Tl::kPBlock;
    const float* dsh = dst + h * Tl::kPHead + kb * Tl::kPBlock;
    const float* qs = stage + h * D + 4 * c4;
    const float* gs = qs + 3 * Tl::kRows * Tl::kPitch;
    // four rows a step, (P^T, g) then (dS^T, q): the next half's reads
    // are issued before this half's FMAs
    float4 dva[4], dka[4], wa[4], xa[4], wb[4], xb[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) dva[t] = dka[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    load_rows<Tl::kPPitch, Tl::kPitch>(pth, gs, 0, wa, xa);
#pragma unroll
    for (int ic = 0; ic < NB; ++ic) {
      load_rows<Tl::kPPitch, Tl::kPitch>(dsh, qs, ic, wb, xb);
      outer_step(dva, wa, xa);
      if (ic + 1 < NB) load_rows<Tl::kPPitch, Tl::kPitch>(pth, gs, ic + 1, wa, xa);
      outer_step(dka, wb, xb);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * kb + t;
      if (j < N) {
        const long long off = tb.o + static_cast<long long>(j) * C + h * D + 4 * c4;
        store4(dv + off, dva[t]);
        store4(dk + off, dka[t]);
      }
    }
  } else if (u >= offB && u - offB < nB) {
    const int cq = (u - offB) % (D / (4 * Q));
    const int hr = (u - offB) / (D / (4 * Q));
    const int h = hr / NB;
    const int rb = hr - h * NB;
    const float* dsh = dst + h * Tl::kPHead + 4 * rb;
    const float* ks = stage + Tl::kRows * Tl::kPitch + h * D + 4 * Q * cq;
    // two keys a step, the next step's reads issued before this step's FMAs
    float4 acc[4][Q], wa[2], ka[2][Q], wb[2], kb2[2][Q];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < Q; ++c) acc[t][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    load_keys<Tl, Tl::kPitch, Q>(dsh, ks, 0, wa, ka);
#pragma unroll
    for (int j2 = 0; j2 < 2 * NB; j2 += 2) {
      load_keys<Tl, Tl::kPitch, Q>(dsh, ks, j2 + 1, wb, kb2);
      dq_step<Q>(acc, wa, ka);
      if (j2 + 2 < 2 * NB) load_keys<Tl, Tl::kPitch, Q>(dsh, ks, j2 + 2, wa, ka);
      dq_step<Q>(acc, wb, kb2);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * rb + t;
      if (i < N) {
        const long long off = tb.o + static_cast<long long>(i) * C + h * D + 4 * Q * cq;
#pragma unroll
        for (int c = 0; c < Q; ++c) store4(dq + off + 4 * c, acc[t][c]);
      }
    }
  }
}

// ------------------------------------------------------------------ kernel

template <typename T, int D, int NB>
__global__ void __launch_bounds__(Tile<T, D, NB>::kThreads, Tile<T, D, NB>::kMinBlocks)
masked_sdpa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                       BwdStrides st, int tiles, int groups, int G, int N, int C, int H,
                       float scale) {
  using Tl = Tile<T, D, NB>;
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  T* ring = reinterpret_cast<T*>(smem);
  float* wide = reinterpret_cast<float*>(base + Tl::kRingBytes);
  float* pt = reinterpret_cast<float*>(base + Tl::kRingBytes + Tl::kStageBytes);
  float* dst = pt + Tl::HG * Tl::kPHead;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(base + Tl::kSmem -
                                                                  Tl::kBarBytes);
  const int lane = threadIdx.x & 31;
  const bool loader = threadIdx.x >> 5 == Tl::kThreads / 32 - 1;  // the last warp copies

  // zero everything once: padded rows of the stages and the P^T, dS^T entries
  // of padded rows and keys stay zero, since nothing of a launch writes them
  for (int e = threadIdx.x; e < (Tl::kSmem - Tl::kBarBytes) / 16; e += Tl::kThreads)
    smem[e] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {  // one arrival a loader lane
    mbar_init(bar, 32);
    mbar_init(bar + 1, 32);
  }
  __syncthreads();

  int t = blockIdx.x;  // the grid has at most one block a tile
  TileBase cur = tile_base<Tl::HG, Tl::W>(t, groups, N, C, H);
  if (loader) load_tile<T, D, NB>(ring, bar, q, k, v, g, st, cur, G, N, lane);
  for (int it = 0;; ++it) {
    const int next = t + gridDim.x;
    TileBase nb = cur;
    if (next < tiles) {
      nb = tile_base<Tl::HG, Tl::W>(next, groups, N, C, H);
      if (loader)
        load_tile<T, D, NB>(ring + ((it + 1) % kStages) * Tl::kRingStage,
                            bar + (it + 1) % kStages,
                            q, k, v, g, st, nb, G, N, lane);
    }
    mbar_wait(bar + it % kStages, (it / kStages) & 1);  // the tile has landed
    const T* landed = ring + (it % kStages) * Tl::kRingStage;
    const float* stage;
    if constexpr (Tl::kF32) {
      stage = landed;
    } else {
      widen_tile<D, NB>(landed, wide, cur.heads, N);
      __syncthreads();
      stage = wide;
    }
    pass1<T, D, NB>(stage, pt, dst, cur.heads, N, scale);
    __syncthreads();  // P^T and dS^T complete
    pass2<T, D, NB>(stage, pt, dst, dq, dk, dv, cur, N, C);
    __syncthreads();  // the stage, P^T and dS^T are free before they refill
    if (next >= tiles) break;
    t = next;
    cur = nb;
  }
}

// ------------------------------------------- bf16 at heads of 16: the tensor cores
//
// masked_sdpa_bwd_mma_kernel<NT>, NT = ceil(N / 8) key n-tiles. A tile is
// the (sequence, 64-channel head group) of masked_sdpa_bwd_kernel at D = 16,
// copied by its loader into its ring (bf16, never widened); each of the
// group's four heads is one warp's, and a warp needs no other warp's data:
//  * S = q k^T and dP = g v^T on mma.sync m16n8k16 (one k-step: D = 16),
//    rows padded to 16 MT (MT = ceil(NT / 2) m-tiles, zero rows of the
//    stage), keys to 8 NT; q, g by ldmatrix as A, k, v by ldmatrix as B.
//  * The softmax in the accumulators' layout: a lane holds two keys of each
//    n-tile for rows g and g + 8, so a row's max, sum and rowsum(P dP) are
//    its own values and two quad shuffles. Padded keys are masked to -inf,
//    so P and dS are exactly 0 there.
//  * P (for dV) and dS rounded to bf16 where _attn_bwd_kernel rounds them;
//    dS's accumulators, packed, are the A fragments of dq = dS k (B = k by
//    ldmatrix.trans; an odd last n-tile a k8 step). P and dS go to the
//    warp's own 2 KB each of shared memory (rows of 32 keys, 16-byte chunks
//    XOR-swizzled by row, so the fragment stores and the transposed loads
//    are free of bank conflicts), and ldmatrix.trans reads them back as
//    the A fragments P^T, dS^T of dV = P^T g and dk = dS^T q (B = g, q by
//    ldmatrix.trans). Storing them in bf16 is exact: they are rounded there.
//  * dq, dk, dv summed in f32 accumulators, rounded once at the store, each
//    element one chain of mma in a fixed order: reruns are bitwise equal.
// 128 threads and 53,264 B a block: four blocks a SM.
namespace mm {

using bf16 = __nv_bfloat16;
using Ring = Tile<bf16, 16, 1>;  // the ring, its loader and its stage's layout
constexpr int kHeads = Ring::HG;  // four, a warp each
constexpr int kThreads = 32 * kHeads;
constexpr int kPRow = 32;                // bf16 a row of a head's P or dS: 32 keys
constexpr int kPHead = kMaxN * kPRow;    // 2 KB
constexpr int kPBytes = 2 * kHeads * kPHead * 2;
constexpr int kBarBytes = 16;
constexpr int kSmem = Ring::kRingBytes + kPBytes + kBarBytes;
constexpr int kMinBlocks = 4;
static_assert(kMinBlocks * (kSmem + 1024) <= kSmemPerSM, "four blocks a SM");

// element offset of (row r, key j) in a head's P or dS: 16-byte chunk j / 8
// of the row XORed with (r / 2) % 4, so eight rows' same chunk (an
// ldmatrix.trans) and a fragment's eight rows of 4 bytes (a store) each
// fall on distinct banks
__device__ __forceinline__ int pidx(int r, int j) {
  return r * kPRow + ((((j >> 3) ^ (r >> 1)) & 3) << 3) + (j & 7);
}

// one head of a landed tile: h's 16 channels of q, k, v, g in `stage`, its
// own P and dS buffers `pw`, `dw`; dq, dk, dv rows 0..N-1 from element `o`
template <int NT>
__device__ __forceinline__ void head_bwd(const bf16* stage, bf16* pw, bf16* dw, int h,
                                         bf16* __restrict__ dq, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, long long o, int N, int C,
                                         float scale, int lane) {
  constexpr int MT = (NT + 1) / 2;  // m-tiles of 16 rows, and of 16 keys for dV, dk
  constexpr int P = Ring::kRingPitch;
  constexpr float kLog2e = 1.4426950408889634f;
  using kasf_mma::ldsm_x2;
  using kasf_mma::ldsm_x2_trans;
  using kasf_mma::ldsm_x4;
  using kasf_mma::ldsm_x4_trans;
  using kasf_mma::mma_k16;
  using kasf_mma::mma_k8;
  const bf16* qs = stage + h * 16;
  const bf16* ks = qs + Ring::kRows * P;
  const bf16* vs = ks + Ring::kRows * P;
  const bf16* gs = vs + Ring::kRows * P;
  const int gq = lane >> 2, tq = lane & 3;
  const int l7 = lane & 7, l8 = ((lane >> 3) & 1) << 3, l16 = (lane >> 4) << 3;

  // ---- S = q k^T, dP = g v^T: B fragments of k and v a pair of n-tiles
  // (keys 16 p ..) at a time, then each m-tile's A of q and g
  uint32_t bk[NT][2], bv[NT][2];
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    uint32_t r[4];
    const int off = (16 * p + l7 + l16) * P + l8;
    ldsm_x4(r, ks + off);
    bk[2 * p][0] = r[0], bk[2 * p][1] = r[1], bk[2 * p + 1][0] = r[2], bk[2 * p + 1][1] = r[3];
    ldsm_x4(r, vs + off);
    bv[2 * p][0] = r[0], bv[2 * p][1] = r[1], bv[2 * p + 1][0] = r[2], bv[2 * p + 1][1] = r[3];
  }
  if constexpr (NT % 2 == 1) {
    uint32_t r[2];
    const int off = (8 * (NT - 1) + l7) * P + l8;
    ldsm_x2(r, ks + off);
    bk[NT - 1][0] = r[0], bk[NT - 1][1] = r[1];
    ldsm_x2(r, vs + off);
    bv[NT - 1][0] = r[0], bv[NT - 1][1] = r[1];
  }
  float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][j][e] = dp[mi][j][e] = 0.f;
    uint32_t a[4];
    const int off = (16 * mi + (lane & 15)) * P + l16;
    ldsm_x4(a, qs + off);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k16(s[mi][j], a, bk[j][0], bk[j][1]);
    ldsm_x4(a, gs + off);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k16(dp[mi][j], a, bv[j][0], bv[j][1]);
  }

  // ---- the softmax of each of the lane's 2 MT rows (16 mi + gq + 8 hf), the
  // rows side by side so that their shuffles overlap: the scaled logits'
  // exact max (padded keys -inf), p = 2^((t - m) log2 e) with t - m formed
  // first, P = p / sum, rowsum(P dP), then dS = P (dP - rowsum) scale in
  // place of dP
  float m[MT][2], l[MT][2], rs[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mi][hf] = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mi][j][2 * hf + e];
          x = 8 * j + 2 * tq + e < N ? x * scale : -INFINITY;
          m[mi][hf] = fmaxf(m[mi][hf], x);
        }
    }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        m[mi][hf] = fmaxf(m[mi][hf], __shfl_xor_sync(0xffffffffu, m[mi][hf], o2));
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[mi][hf] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mi][j][2 * hf + e];
          x = fast_exp2((x - m[mi][hf]) * kLog2e);  // padded keys: 2^-inf = 0
          l[mi][hf] += x;
        }
    }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        l[mi][hf] += __shfl_xor_sync(0xffffffffu, l[mi][hf], o2);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float inv = fast_rcp(l[mi][hf]);  // l >= 1: the max logit contributes 2^0
      rs[mi][hf] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mi][j][2 * hf + e] *= inv;
          rs[mi][hf] = fmaf(s[mi][j][2 * hf + e], dp[mi][j][2 * hf + e], rs[mi][hf]);
        }
    }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rs[mi][hf] += __shfl_xor_sync(0xffffffffu, rs[mi][hf], o2);

  // ---- P and dS rounded to bf16: both to the warp's buffers, dS also kept
  // packed as dq's A fragments ([mi][j][hf]: row 16 mi + gq + 8 hf, keys
  // 8 j + 2 tq, + 1)
  uint32_t ads[MT][NT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* p = s[mi][j] + 2 * hf;
        float* d = dp[mi][j] + 2 * hf;
        d[0] = p[0] * (d[0] - rs[mi][hf]) * scale;
        d[1] = p[1] * (d[1] - rs[mi][hf]) * scale;
        ads[mi][j][hf] = pack_bf16(d[0], d[1]);
        const int at = pidx(16 * mi + gq + 8 * hf, 8 * j + 2 * tq);
        *reinterpret_cast<uint32_t*>(pw + at) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dw + at) = ads[mi][j][hf];
      }
  __syncwarp();

  // ---- dq = dS k over the keys, k16 steps (B = k by ldmatrix.trans), an odd
  // last n-tile of keys a k8 step
  float aq[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[mi][c][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t b[4];
    ldsm_x4_trans(b, ks + (16 * kk + l7 + l8) * P + l16);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint32_t a[4] = {ads[mi][2 * kk][0], ads[mi][2 * kk][1], ads[mi][2 * kk + 1][0],
                             ads[mi][2 * kk + 1][1]};
      mma_k16(aq[mi][0], a, b[0], b[1]);
      mma_k16(aq[mi][1], a, b[2], b[3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, ks + (8 * (NT - 1) + l7) * P + l8);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint32_t a[2] = {ads[mi][NT - 1][0], ads[mi][NT - 1][1]};
      mma_k8(aq[mi][0], a, b[0]);
      mma_k8(aq[mi][1], a, b[1]);
    }
  }

  // ---- dV = P^T g and dk = dS^T q over the rows, k16 steps: A = P^T, dS^T
  // by ldmatrix.trans of the warp's buffers (keys 16 km ..; keys past 8 NT
  // read the zeros they were set to), B = g, q by ldmatrix.trans
  float av[MT][2][4], ak[MT][2][4];
#pragma unroll
  for (int km = 0; km < MT; ++km)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[km][c][e] = ak[km][c][e] = 0.f;
#pragma unroll
  for (int rr = 0; rr < MT; ++rr) {
    uint32_t bg[4], bq[4];
    const int off = (16 * rr + l7 + l8) * P + l16;
    ldsm_x4_trans(bg, gs + off);
    ldsm_x4_trans(bq, qs + off);
#pragma unroll
    for (int km = 0; km < MT; ++km) {
      uint32_t a[4];
      const int at = pidx(16 * rr + l7 + l16, 16 * km + l8);
      ldsm_x4_trans(a, pw + at);
      mma_k16(av[km][0], a, bg[0], bg[1]);
      mma_k16(av[km][1], a, bg[2], bg[3]);
      ldsm_x4_trans(a, dw + at);
      mma_k16(ak[km][0], a, bq[0], bq[1]);
      mma_k16(ak[km][1], a, bq[2], bq[3]);
    }
  }

  // ---- each result rounded once: a lane's two channels of rows (dq) or
  // keys (dk, dv) 16 i + gq + 8 hf below N
  const long long oh = o + h * 16 + 2 * tq;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * i + gq + 8 * hf;
      if (r < N) {
        const long long at = oh + static_cast<long long>(r) * C;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* x = aq[i][c] + 2 * hf;
          const float* y = ak[i][c] + 2 * hf;
          const float* z = av[i][c] + 2 * hf;
          *reinterpret_cast<uint32_t*>(dq + at + 8 * c) = pack_bf16(x[0], x[1]);
          *reinterpret_cast<uint32_t*>(dk + at + 8 * c) = pack_bf16(y[0], y[1]);
          *reinterpret_cast<uint32_t*>(dv + at + 8 * c) = pack_bf16(z[0], z[1]);
        }
      }
    }
}

}  // namespace mm

template <int NT>
__global__ void __launch_bounds__(mm::kThreads, mm::kMinBlocks)
masked_sdpa_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           BwdStrides st, int tiles, int groups, int G, int N, int C, int H,
                           float scale) {
  using mm::Ring;
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(base + Ring::kRingBytes);
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(base + mm::kSmem - mm::kBarBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool loader = warp == mm::kHeads - 1;  // the last head's warp copies too

  // zero everything once: the stage's padded rows and P's, dS's padded keys
  // are never written by the launch
  for (int e = threadIdx.x; e < (mm::kSmem - mm::kBarBytes) / 16; e += mm::kThreads)
    smem[e] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {  // one arrival a loader lane
    mbar_init(bar, 32);
    mbar_init(bar + 1, 32);
  }
  __syncthreads();

  int t = blockIdx.x;  // at most one block a tile
  TileBase cur = tile_base<Ring::HG, Ring::W>(t, groups, N, C, H);
  if (loader) load_tile<__nv_bfloat16, 16, 1>(ring, bar, q, k, v, g, st, cur, G, N, lane);
  for (int it = 0;; ++it) {
    const int next = t + gridDim.x;
    const bool more = next < tiles;
    const TileBase nb = more ? tile_base<Ring::HG, Ring::W>(next, groups, N, C, H) : cur;
    if (more && loader)
      load_tile<__nv_bfloat16, 16, 1>(ring + ((it + 1) % kStages) * Ring::kRingStage,
                                      bar + (it + 1) % kStages, q, k, v, g, st, nb, G, N, lane);
    mbar_wait(bar + it % kStages, (it / kStages) & 1);  // tile `it` is in its stage
    if (warp < cur.heads)
      mm::head_bwd<NT>(ring + (it % kStages) * Ring::kRingStage, pbuf + warp * mm::kPHead,
                       pbuf + (mm::kHeads + warp) * mm::kPHead, warp, dq, dk, dv, cur.o, N, C,
                       scale, lane);
    __syncthreads();  // every warp is done with the stage (and its P, dS) before it refills
    if (!more) break;
    cur = nb;
    t = next;
  }
}

// blocks of one kernel resident at once on a device (SMs x blocks a SM),
// found once per device and kept in `cached` (an array per kernel); the
// dynamic shared-memory limit is raised there first
template <typename Kernel>
cudaError_t resident_on_device(Kernel kernel, int threads, int smem, int* cached, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <typename T, int D, int NB>
cudaError_t resident_blocks(int* blocks) {
  using Tl = Tile<T, D, NB>;
  static int cached[kMaxDevices];  // one array per instantiation
  return resident_on_device(masked_sdpa_bwd_kernel<T, D, NB>, Tl::kThreads, Tl::kSmem, cached,
                            blocks);
}

// one launch of `kernel` (either kernel: the same arguments), its grid the
// `resident` blocks the device holds or one a tile, whichever is fewer;
// `err` is that count's query
template <typename T, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, cudaError_t err, int resident, int threads, int smem,
                         int heads_a_tile, const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv, const BwdStrides& st,
                         int B, int G, int N, int C, int H, float scale, cudaStream_t stream) {
  if (err != cudaSuccess) return err;
  const int groups = (H + heads_a_tile - 1) / heads_a_tile;
  const long long tiles = static_cast<long long>(B) * G * groups;
  if (tiles > INT32_MAX - resident) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), st, static_cast<int>(tiles), groups, G, N, C, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, int NB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const BwdStrides& st, int B, int G, int N, int C,
                   int H, float scale, cudaStream_t stream) {
  using Tl = Tile<T, D, NB>;
  int resident = 0;
  const cudaError_t err = resident_blocks<T, D, NB>(&resident);
  return launch_tiles<T>(masked_sdpa_bwd_kernel<T, D, NB>, err, resident, Tl::kThreads,
                         Tl::kSmem, Tl::HG, q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale,
                         stream);
}

template <int NT>
cudaError_t resident_mma(int* blocks) {
  static int cached[kMaxDevices];  // one array per instantiation
  return resident_on_device(masked_sdpa_bwd_mma_kernel<NT>, mm::kThreads, mm::kSmem, cached,
                            blocks);
}

template <int NT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, const BwdStrides& st, int B, int G, int N, int C,
                       int H, float scale, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_mma<NT>(&resident);
  return launch_tiles<__nv_bfloat16>(masked_sdpa_bwd_mma_kernel<NT>, err, resident,
                                     mm::kThreads, mm::kSmem, mm::kHeads, q, k, v, g, dq, dk,
                                     dv, st, B, G, N, C, H, scale, stream);
}

// the instantiation for N: bf16 at D = 16 the tensor-core kernel for its
// key n-tiles, else the one for its blocks of four rows
template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, const BwdStrides& st, int B, int G, int N, int C,
                        int H, float scale, cudaStream_t stream) {
  using Tl = Tile<T, D, 1>;  // the copy unit, as at every NB
  // every row of q, k, v, g and the outputs starts on a 16-byte boundary
  for (const void* p : {q, k, v, g, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  for (int a = 0; a < 3; ++a)
    if (st.q[a] % Tl::kChunk || st.k[a] % Tl::kChunk || st.v[a] % Tl::kChunk ||
        st.g[a] % Tl::kChunk)
      return cudaErrorMisalignedAddress;
  if constexpr (kMma<T, D>) {  // bf16 at heads of 16: the tensor cores, N's key n-tiles
#define KASF_KEYS(nt) \
  case nt: return launch_mma<nt>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    switch ((N + 7) / 8) {
      KASF_KEYS(1) KASF_KEYS(2) KASF_KEYS(3) KASF_KEYS(4)
      default: return cudaErrorInvalidValue;
    }
#undef KASF_KEYS
  } else {
#define KASF_ROWS(nb) \
  case nb: return launch<T, D, nb>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    switch ((N + 3) / 4) {
      KASF_ROWS(1) KASF_ROWS(2) KASF_ROWS(3) KASF_ROWS(4)
      KASF_ROWS(5) KASF_ROWS(6) KASF_ROWS(7) KASF_ROWS(8)
      default: return cudaErrorInvalidValue;
    }
#undef KASF_ROWS
  }
}

// kasf_masked_sdpa_bwd_info's fields of `kernel`, whose launches hold
// `resident` blocks on the current device (`err`: that count's query)
template <typename Kernel>
void describe_kernel(Kernel kernel, cudaError_t err, int resident, int threads, int smem,
                     int heads_a_tile, int rows, int mma, int* info) {
  cudaFuncAttributes attr{};
  if (err != cudaSuccess || cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  info[0] = threads;
  info[1] = attr.numRegs;
  info[2] = smem;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = resident / sms;
  info[5] = heads_a_tile;
  info[6] = rows;
  info[7] = resident;
  info[8] = mma;
}

template <typename T, int D, int NB>
void describe(int* info) {
  using Tl = Tile<T, D, NB>;
  int resident = 0;
  const cudaError_t err = resident_blocks<T, D, NB>(&resident);
  describe_kernel(masked_sdpa_bwd_kernel<T, D, NB>, err, resident, Tl::kThreads, Tl::kSmem,
                  Tl::HG, 4 * NB, 0, info);
}

template <int NT>
void describe_mma(int* info) {
  int resident = 0;
  const cudaError_t err = resident_mma<NT>(&resident);
  describe_kernel(masked_sdpa_bwd_mma_kernel<NT>, err, resident, mm::kThreads, mm::kSmem,
                  mm::kHeads, 8 * NT, 1, info);
}

template <typename T, int D>
void describe_rows(int n, int* info) {
  if constexpr (kMma<T, D>) {
    switch ((n + 7) / 8) {
      case 1: describe_mma<1>(info); break;
      case 2: describe_mma<2>(info); break;
      case 3: describe_mma<3>(info); break;
      case 4: describe_mma<4>(info); break;
      default: break;
    }
  } else {
#define KASF_ROWS(nb) \
  case nb: describe<T, D, nb>(info); break;
    switch ((n + 3) / 4) {
      KASF_ROWS(1) KASF_ROWS(2) KASF_ROWS(3) KASF_ROWS(4)
      KASF_ROWS(5) KASF_ROWS(6) KASF_ROWS(7) KASF_ROWS(8)
      default: break;
    }
#undef KASF_ROWS
  }
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v, const void* g, void* dq,
                         void* dk, void* dv, const BwdStrides& st, int B, int G, int N, int C,
                         int H, float scale, cudaStream_t stream) {
  switch (C / H) {
    case 8: return launch_rows<T, 8>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    case 16: return launch_rows<T, 16>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    case 32: return launch_rows<T, 32>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    case 64: return launch_rows<T, 64>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
void describe_width(int d, int n, int* info) {
  if (d == 8) describe_rows<T, 8>(n, info);
  if (d == 16) describe_rows<T, 16>(n, info);
  if (d == 32) describe_rows<T, 32>(n, info);
  if (d == 64) describe_rows<T, 64>(n, info);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Heads of D = C / H in {8, 16, 32, 64},
// C <= 512, 1 <= N <= 32, any B G.
// strides: 16 int64 in elements, the four leading strides of q, k, v and g
// in that order (channel stride 1); every pointer and the three outer
// strides of each operand 16-byte aligned. dq, dk, dv are contiguous
// (B, G, N, C). Returns cudaGetLastError() after the launch (0 on success).
int kasf_masked_sdpa_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv,
                         const long long* strides, int B, int G, int N, int C, int H,
                         float scale, void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kMaxN || H < 1 || C % H || C > kMaxC)
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
    return launch_width<float>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, s);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, B, G, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}

// The instantiation for (dtype, head width d, N) on the current device, for reports:
// info = {threads a block, registers a thread, dynamic shared memory a block
// in bytes, local memory (spills) a thread in bytes, blocks resident a SM,
// heads a tile, rows a tile (N padded to a multiple of 4; of 8, its keys,
// for the tensor-core kernel), the persistent grid (blocks resident on the
// device: a launch of more tiles has this many blocks), 1 for
// masked_sdpa_bwd_mma_kernel (bf16 at d = 16) and 0 for
// masked_sdpa_bwd_kernel}. Left untouched for a dtype, d or N there is none of.
void kasf_masked_sdpa_bwd_info(int dtype, int d, int n, int* info) {
  if (dtype == 0) describe_width<float>(d, n, info);
  if (dtype == 1) describe_width<__nv_bfloat16>(d, n, info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
