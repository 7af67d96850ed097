// K1: per-head masked attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/attention.py:_attn_kernel
// (wrapper masked_sdpa_pallas). For every (b, g) sequence of (B, G, N, C)
// inputs it computes, per head h of width D = C / H,
//     out[b, g, :, h] = softmax(q_h k_h^T * scale) v_h      (softmax over N)
// with the exact per-head max subtracted and the softmax statistics in f32.
//
// Bound on the H100: a sequence holds ~4*N*N*C FLOP against 4*N*C elements
// moved; at N <= 32 that is at most ~8 FLOP per byte (f32), far below the
// card's ridge point: bound by device-memory bytes (q, k, v read once, out
// written once). So the design keeps loads in flight at all times.
//
// Design:
//  * Unit of work: one (sequence, head group) tile. A head group is
//    HG = min(8, 128 / D) heads, W = HG * D channels: 128 (64 at D = 8, the
//    8 heads of MotionAGFormer's C = 64). A stage holds q, k and
//    v of one tile, 32 rows (N padded) x W channels: 48 KB in f32, 24 KB in
//    bf16 (half that at D = 8), each row padded by 16 bytes so that rows start
//    four banks apart. Rows N..31 are zeroed once and never written again,
//    so padded keys and queries never see stale data; padded keys are also
//    masked to -inf before the max, and padded query rows are not stored. A
//    last group of fewer than HG heads (C not a multiple of W) loads and
//    computes only its heads.
//  * Persistent blocks (SMs x resident blocks a SM, at most one a tile) walk
//    the tiles in order through a two-stage ring of 16-byte cp.async.cg
//    copies: tile i+1 is in flight while tile i computes. q, k, v are read in
//    place as strided views (column slices of one qkv projection, the
//    (B,T,J,C)->(B,J,T,C) permutation, DSTFormer's grouped view, a flat
//    (M,N,C) stream as (1,M,N,C)): the loader takes all four leading strides
//    of each operand, channel stride 1, and every row must start on a
//    16-byte boundary (the wrapper copies an operand that does not).
//  * bf16 on the tensor cores: 4 warps, each one item at a time: a head's
//    16-query m-tile, or at D <= 16 both of a head's m-tiles (they share
//    the K and V fragments, and two dependency chains interleave). S = Q K^T with mma.sync m16n8k16 (m16n8k8 at D = 8),
//    bf16 in, f32 accumulate; Q and K fragments by ldmatrix (K stored by key
//    is already the "col" operand). The row max and sum reduce inside the
//    quad by two shuffles, the exponential in f32. P, unnormalised and rounded to bf16
//    as _attn_kernel rounds e, goes straight from the accumulator fragment
//    into the A fragment of O = P V (V by ldmatrix.trans); O is divided by
//    the f32 row sum at the end and rounded once. (wgmma's 64-row tiles
//    would be mostly padding at 17-27 queries.)
//  * f32 on the CUDA cores (TF32 would put ~5e-4 on each logit): 256 threads,
//    P = D / 16 neighbouring lanes per (head, query row), the pairs
//    packed over the tile's heads x N valid rows (no lane spent on a padded
//    row; 8 N pairs of P lanes fill at most 256 threads). A lane takes every
//    P-th key: it forms those logits in 16-channel chunks of the head (no
//    shuffle per logit), the pair's max and sum take log2 P shuffles per
//    row. In O = P V each lane takes DS / P channels of every chunk over
//    all keys, a key's probability passed by one shuffle from the lane that
//    holds it, and stores them. Shared-memory reads of K and V rows are
//    16-byte broadcasts within a pair.
//  * Both paths take the max of the raw dot products and the exponential as
//    2^(s c - m c) with c = scale * log2(e) (one FMA and one MUFU.EX2 a
//    key), and skip key tiles that are all padding. Per tile the
//    indices are computed once (32-bit) and shared by the loader and the
//    compute: at these sizes the integer work is a sizeable part of a tile.
//  * f32 at D = 8 (MotionAGFormer-XS and hierarchical: C = 64 over 8 heads)
//    has a kernel of its own, masked_sdpa_h8_kernel. The f32 tile above gave
//    a lane a (head, row) there (120 of 256 threads idle at N = 17) and
//    padded every stage to 32 rows. Timed apart on an H100 80GB HBM3 at
//    700 W (scripts/k1_variants.py: copies only, compute only), its compute
//    took longer than its copies, and the compute was the stage's reads:
//    each lane read the whole K and V rows of every key, 16-byte vectors
//    that a quarter warp serves in one pass each. So a lane there takes a
//    (head, pair of query rows), each K and V row read once for both rows
//    (half the passes), 8 ceil(N / 2) lanes in whole warps, its logits in
//    2 x 4 NB registers (NB = ceil(N / 4), one instantiation a block of four
//    rows, the stage's rows N padded to 4 NB only). A tile is still one
//    (sequence, head group): tiles of two or four sequences (the bytes of a
//    128-channel tile or more) and a third stage in flight measured slower,
//    since neither the copies in flight nor a tile's fixed cost set the
//    pace. Its walk divides by the head groups and by G by multiply-highs.
//    bf16 at D = 8 keeps the tensor-core items above: no layout tried beat
//    them (PERF.md, K1 at heads of 8).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using kasf_mma::cp_async16;
using kasf_mma::cp_async_commit;
using kasf_mma::cp_async_wait;
using kasf_mma::ldsm_x2;
using kasf_mma::ldsm_x2_trans;
using kasf_mma::ldsm_x4;
using kasf_mma::ldsm_x4_trans;
using kasf_mma::mma_k16;
using kasf_mma::mma_k8;
using kasf_mma::pack_bf16;

constexpr int kMaxN = 32;   // rows a stage holds: N padded
constexpr int kStages = 2;  // the cp.async ring
constexpr int kMaxDevices = 64;

struct SdpaStrides {
  long long q[4], k[4], v[4], o[4];
};

template <typename T, int D>
struct Tile {
  static constexpr int HG = D < 16 ? 8 : 128 / D;  // heads a group
  static constexpr int W = HG * D;                 // channels a group
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // a cp.async
  static constexpr int kPitch = W + kChunk;        // elements a stage row
  static constexpr int kStage = 3 * kMaxN * kPitch;  // q, k, v
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(T));
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kThreads = kF32 ? 256 : 128;
  static constexpr int kMinBlocks = kF32 ? 2 : 4;  // a SM, as shared memory allows
};

// where a tile's operands start: element offsets of its head group's first
// channel in row 0 of q, k, v and out, and the heads the group has
struct TileBase {
  long long q, k, v, o;
  int heads;
};

template <int HG, int W>
__device__ __forceinline__ TileBase tile_base(int t, int groups, int G, int H,
                                              const SdpaStrides& st) {
  const int seq = t / groups;
  const int grp = t - seq * groups;
  const long long b = seq / G;
  const long long g = seq - b * G;
  const int c0 = grp * W;
  TileBase tb;
  tb.q = b * st.q[0] + g * st.q[1] + c0;
  tb.k = b * st.k[0] + g * st.k[1] + c0;
  tb.v = b * st.v[0] + g * st.v[1] + c0;
  tb.o = b * st.o[0] + g * st.o[1] + c0;
  tb.heads = min(HG, H - grp * HG);
  return tb;
}

// q, k and v rows 0..N-1 of a tile's head group into a stage. A thread keeps
// one 16-byte chunk column of a row and steps down the rows, so the block
// reads whole rows, neighbouring threads on neighbouring addresses
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* stage, const T* __restrict__ q,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const SdpaStrides& st, const TileBase& tb,
                                          int N) {
  using Tl = Tile<T, D>;
  constexpr int kRowChunks = Tl::W / Tl::kChunk;
  constexpr int kRowStep = Tl::kThreads / kRowChunks;  // rows a pass
  static_assert(Tl::kThreads % kRowChunks == 0, "whole rows a pass");
  const int ch = threadIdx.x % kRowChunks;
  if (ch >= tb.heads * D / Tl::kChunk) return;  // past a short last group
  const int row = threadIdx.x / kRowChunks;
#pragma unroll
  for (int z = 0; z < 3; ++z) {
    const long long rs = z == 0 ? st.q[2] : (z == 1 ? st.k[2] : st.v[2]);
    const T* src = (z == 0 ? q + tb.q : (z == 1 ? k + tb.k : v + tb.v)) + row * rs +
                   ch * Tl::kChunk;
    T* dst = stage + (z * kMaxN + row) * Tl::kPitch + ch * Tl::kChunk;
#pragma unroll
    for (int u = 0; u < kMaxN / kRowStep; ++u)
      if (row + u * kRowStep < N)
        cp_async16(dst + u * kRowStep * Tl::kPitch, src + u * kRowStep * rs);
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

// ---------------------------------------------------------------- f32 tile

template <int D>
__device__ __forceinline__ void compute_f32(const float* stage, float* __restrict__ out,
                                            const TileBase& tb, long long ostride,
                                            int N, float scale_log2) {
  using Tl = Tile<float, D>;
  constexpr int DS = 16;               // channels a chunk
  constexpr int P = D / DS;            // lanes a (head, query row)
  constexpr int KJ = kMaxN / P;        // keys a lane in S: j = jj * P + r
  const int pairs = tb.heads * N;
  if (static_cast<int>(threadIdx.x & ~31u) / P >= pairs) return;  // the whole warp is idle
  // lanes past the last pair compute pair 0 for the shuffles, store nothing
  const bool valid = static_cast<int>(threadIdx.x) / P < pairs;
  const int pair = valid ? threadIdx.x / P : 0;
  const int hl = pair / N;  // head within the group
  const int i = pair - hl * N;  // query row
  const int r = threadIdx.x % P;

  const float* qs = stage + i * Tl::kPitch + hl * D;
  const float* ks = stage + kMaxN * Tl::kPitch + hl * D;
  const float* vs = stage + 2 * kMaxN * Tl::kPitch + hl * D;

  // keys in blocks of four (block b: keys 4b..4b+3, JB of them a lane), a
  // block skipped when all padding; rows past N are zero, so a block's
  // padded keys need no guard here. Each key's dot product runs as four
  // partial chains (one a float4 component), so a lane has 16 / P chains in
  // flight
  constexpr int JB = 4 / P;
  float s[KJ];
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) s[jj] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += DS) {
    float4 qc[DS / 4];
#pragma unroll
    for (int d4 = 0; d4 < DS / 4; ++d4) qc[d4] = reinterpret_cast<const float4*>(qs + c)[d4];
#pragma unroll
    for (int blk = 0; blk < KJ / JB; ++blk) {
      if (4 * blk < N) {
        float4 part[JB];
#pragma unroll
        for (int u = 0; u < JB; ++u) part[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int d4 = 0; d4 < DS / 4; ++d4)
#pragma unroll
          for (int u = 0; u < JB; ++u) {
            const float4 kk = reinterpret_cast<const float4*>(
                ks + ((blk * JB + u) * P + r) * Tl::kPitch + c)[d4];
            part[u].x = fmaf(qc[d4].x, kk.x, part[u].x);
            part[u].y = fmaf(qc[d4].y, kk.y, part[u].y);
            part[u].z = fmaf(qc[d4].z, kk.z, part[u].z);
            part[u].w = fmaf(qc[d4].w, kk.w, part[u].w);
          }
#pragma unroll
        for (int u = 0; u < JB; ++u)
          s[blk * JB + u] += (part[u].x + part[u].y) + (part[u].z + part[u].w);
      }
    }
  }

  // the exact max of this head's logits, then unnormalised probabilities
  // 2^(s c - m c), c = scale log2(e) > 0: one FMA and one ex2 a key
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj)
    if (jj * P + r < N) m = fmaxf(m, s[jj]);
#pragma unroll
  for (int off = 1; off < P; off <<= 1)  // the pair's lanes are neighbours
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float mc = m * scale_log2;
  float l = 0.f;
#pragma unroll
  for (int jj = 0; jj < KJ; ++jj) {
    s[jj] = jj * P + r < N ? fast_exp2(fmaf(s[jj], scale_log2, -mc)) : 0.f;
    l += s[jj];
  }
#pragma unroll
  for (int off = 1; off < P; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv = fast_rcp(l);  // l >= 1: the max logit contributes 2^0

  // O = P V: lane r of a pair takes channels r * DS / P .. of every chunk
  // over all keys, each key's probability fetched from the lane that holds
  // it (one shuffle a key; none at P = 1)
  constexpr int DL = DS / P;  // channels a lane a chunk
  float o[D / DS][DL];
#pragma unroll
  for (int cc = 0; cc < D / DS; ++cc)
#pragma unroll
    for (int d = 0; d < DL; ++d) o[cc][d] = 0.f;
  const int owner = threadIdx.x & ~(P - 1) & 31;  // lane r = 0 of the pair
#pragma unroll
  for (int blk = 0; blk < kMaxN / 4; ++blk) {
    if (4 * blk < N) {  // a padded key's probability is 0, its row 0
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * blk + u;
        const float p = P == 1 ? s[j] : __shfl_sync(0xffffffffu, s[j / P], owner | (j % P));
        const float* vr = vs + j * Tl::kPitch + r * DL;
#pragma unroll
        for (int cc = 0; cc < D / DS; ++cc)
#pragma unroll
          for (int d4 = 0; d4 < DL / 4; ++d4) {
            const float4 vv = reinterpret_cast<const float4*>(vr + cc * DS)[d4];
            o[cc][4 * d4 + 0] = fmaf(p, vv.x, o[cc][4 * d4 + 0]);
            o[cc][4 * d4 + 1] = fmaf(p, vv.y, o[cc][4 * d4 + 1]);
            o[cc][4 * d4 + 2] = fmaf(p, vv.z, o[cc][4 * d4 + 2]);
            o[cc][4 * d4 + 3] = fmaf(p, vv.w, o[cc][4 * d4 + 3]);
          }
      }
    }
  }
  if (valid) {
    float* orow = out + tb.o + i * ostride + hl * D + r * DL;
#pragma unroll
    for (int cc = 0; cc < D / DS; ++cc)
#pragma unroll
      for (int d4 = 0; d4 < DL / 4; ++d4)
        reinterpret_cast<float4*>(orow + cc * DS)[d4] =
            make_float4(o[cc][4 * d4] * inv, o[cc][4 * d4 + 1] * inv,
                        o[cc][4 * d4 + 2] * inv, o[cc][4 * d4 + 3] * inv);
  }
}

// --------------------------------------------------------------- bf16 tile

template <int D>
__device__ __forceinline__ void compute_bf16(const __nv_bfloat16* stage,
                                             __nv_bfloat16* __restrict__ out,
                                             const TileBase& tb, long long ostride,
                                             int N, float scale_log2) {
  using Tl = Tile<__nv_bfloat16, D>;
  constexpr int kWarps = Tl::kThreads / 32;
  constexpr int NT = D / 8;  // output n-tiles of 8 channels
  // m-tiles a warp item: at D <= 16 both of a head's (they share its K and V
  // fragments and interleave two dependency chains), else one
  constexpr int MG = D <= 16 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qr = lane >> 2;  // the fragment's row (and row + 8)
  const int qc = lane & 3;   // the fragment's column pair
  const int mtiles = (N + 15) / 16;  // N <= 32: one or two
  const int split = MG == 1 && mtiles == 2;  // a head's m-tiles in two items

  for (int item = warp; item < tb.heads << split; item += kWarps) {
    const int hl = item >> split;
    const int mt0 = item & split;  // the item's first m-tile
    const __nv_bfloat16* qs = stage + mt0 * 16 * Tl::kPitch + hl * D;
    const __nv_bfloat16* ks = stage + kMaxN * Tl::kPitch + hl * D;
    const __nv_bfloat16* vs = stage + 2 * kMaxN * Tl::kPitch + hl * D;

    // S = Q K^T: 16 queries an m-tile x 32 keys as four n-tiles of 8 keys
    float sc[MG][4][4];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mg][nt][e] = 0.f;
    if constexpr (D == 8) {
      uint32_t b[4];
      ldsm_x4(b, ks + lane * Tl::kPitch);  // matrix m: keys 8m..8m+7
#pragma unroll
      for (int mg = 0; mg < MG; ++mg)
        if (mt0 + mg < mtiles) {
          uint32_t a[2];
          ldsm_x2(a, qs + (mg * 16 + (lane & 15)) * Tl::kPitch);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (nt * 8 < N) mma_k8(sc[mg][nt], a, b[nt]);
        }
    } else {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[MG][4];
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
          if (mt0 + mg < mtiles)
            ldsm_x4(a[mg], qs + (mg * 16 + (lane & 15)) * Tl::kPitch + kd * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (np * 16 < N) {
            uint32_t b[4];  // b[0..1]: keys 16np..+7, b[2..3]: keys 16np+8..+15
            ldsm_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * Tl::kPitch +
                           kd * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mg = 0; mg < MG; ++mg)
              if (mt0 + mg < mtiles) {
                mma_k16(sc[mg][2 * np], a[mg], b[0], b[1]);
                if (np * 16 + 8 < N) mma_k16(sc[mg][2 * np + 1], a[mg], b[2], b[3]);
              }
          }
        }
      }
    }

    // exact per-row max over the valid keys (quad shuffles), then
    // p = 2^(s c - m c), c = scale log2(e) > 0: one FMA and one ex2 a key.
    // Key tiles past N are all padding and skipped; only a tile that N cuts
    // is masked to -inf. Rows 0..7 and 8..15 of an m-tile: l[mg][0..1]
    float l[MG][2];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      l[mg][0] = l[mg][1] = 1.f;
      if (mt0 + mg >= mtiles) continue;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt * 8 < N) {
          if (nt * 8 + 8 > N) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (nt * 8 + 2 * qc + e >= N) sc[mg][nt][e] = sc[mg][nt][2 + e] = -INFINITY;
          }
          m0 = fmaxf(m0, fmaxf(sc[mg][nt][0], sc[mg][nt][1]));
          m1 = fmaxf(m1, fmaxf(sc[mg][nt][2], sc[mg][nt][3]));
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt * 8 < N) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[mg][nt][e] = fast_exp2(fmaf(sc[mg][nt][e], scale_log2, -mc0));  // -inf -> 0
            sc[mg][nt][2 + e] = fast_exp2(fmaf(sc[mg][nt][2 + e], scale_log2, -mc1));
            l0 += sc[mg][nt][e];
            l1 += sc[mg][nt][2 + e];
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      l[mg][0] = l0;
      l[mg][1] = l1;
    }

    // O = P V: P's accumulator fragments are the A fragments of this product
    float o[MG][NT][4];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mg][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk * 16 < N) {
        uint32_t a[MG][4];
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          a[mg][0] = pack_bf16(sc[mg][2 * kk][0], sc[mg][2 * kk][1]);
          a[mg][1] = pack_bf16(sc[mg][2 * kk][2], sc[mg][2 * kk][3]);
          a[mg][2] = pack_bf16(sc[mg][2 * kk + 1][0], sc[mg][2 * kk + 1][1]);
          a[mg][3] = pack_bf16(sc[mg][2 * kk + 1][2], sc[mg][2 * kk + 1][3]);
        }
        if constexpr (D == 8) {
          uint32_t b[2];
          ldsm_x2_trans(b, vs + (kk * 16 + (lane & 15)) * Tl::kPitch);
#pragma unroll
          for (int mg = 0; mg < MG; ++mg)
            if (mt0 + mg < mtiles) mma_k16(o[mg][0], a[mg], b[0], b[1]);
        } else {
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];  // b[0..1]: channels 16dp..+7, b[2..3]: 16dp+8..+15
            ldsm_x4_trans(b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                      Tl::kPitch +
                                  dp * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mg = 0; mg < MG; ++mg)
              if (mt0 + mg < mtiles) {
                mma_k16(o[mg][2 * dp], a[mg], b[0], b[1]);
                mma_k16(o[mg][2 * dp + 1], a[mg], b[2], b[3]);
              }
          }
        }
      }
    }

#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      if (mt0 + mg >= mtiles) continue;
      const float inv0 = fast_rcp(l[mg][0]), inv1 = fast_rcp(l[mg][1]);
      const int row0 = (mt0 + mg) * 16 + qr, row1 = row0 + 8;
      __nv_bfloat16* o0 = out + tb.o + row0 * ostride + hl * D + 2 * qc;
      __nv_bfloat16* o1 = o0 + 8 * ostride;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (row0 < N)
          *reinterpret_cast<uint32_t*>(o0 + nt * 8) =
              pack_bf16(o[mg][nt][0] * inv0, o[mg][nt][1] * inv0);
        if (row1 < N)
          *reinterpret_cast<uint32_t*>(o1 + nt * 8) =
              pack_bf16(o[mg][nt][2] * inv1, o[mg][nt][3] * inv1);
      }
    }
  }
}

// ------------------------------------------------------------------ kernel

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads, Tile<T, D>::kMinBlocks)
masked_sdpa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, SdpaStrides st,
                   int tiles, int groups, int G, int N, int H, float scale_log2) {
  using Tl = Tile<T, D>;
  extern __shared__ uint4 smem[];
  T* stages = reinterpret_cast<T*>(smem);

  // zero both stages once: rows N..31 stay zero, cp.async writes rows < N
  for (int e = threadIdx.x; e < Tl::kSmem / 16; e += Tl::kThreads)
    smem[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  int t = blockIdx.x;  // the grid has at most one block a tile
  TileBase cur = tile_base<Tl::HG, Tl::W>(t, groups, G, H, st);
  load_tile<T, D>(stages, q, k, v, st, cur, N);
  cp_async_commit();
  for (int i = 0;; ++i) {
    const int next = t + gridDim.x;
    TileBase nb = cur;
    if (next < tiles) {
      nb = tile_base<Tl::HG, Tl::W>(next, groups, G, H, st);
      load_tile<T, D>(stages + ((i + 1) % kStages) * Tl::kStage, q, k, v, st, nb, N);
    }
    cp_async_commit();  // possibly empty: wait_group 1 then still means tile t
    cp_async_wait<1>();
    __syncthreads();
    const T* stage = stages + (i % kStages) * Tl::kStage;
    if constexpr (Tl::kF32)
      compute_f32<D>(stage, out, cur, st.o[2], N, scale_log2);
    else
      compute_bf16<D>(stage, out, cur, st.o[2], N, scale_log2);
    __syncthreads();  // every warp is done with this stage before it refills
    if (next >= tiles) break;
    t = next;
    cur = nb;
  }
}

// blocks of one instantiation resident at once on a device (SMs x blocks a
// SM), found once per device; the dynamic shared-memory limit is raised
// there first
template <typename T, int D>
cudaError_t resident_blocks(int* blocks) {
  using Tl = Tile<T, D>;
  static int cached[kMaxDevices];  // one array per instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaFuncSetAttribute(masked_sdpa_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_sdpa_kernel<T, D>, Tl::kThreads, Tl::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const SdpaStrides& st, int B, int G, int N, int H, float scale,
                   cudaStream_t stream) {
  using Tl = Tile<T, D>;
  int resident = 0;
  cudaError_t err = resident_blocks<T, D>(&resident);
  if (err != cudaSuccess) return err;
  const int groups = (H + Tl::HG - 1) / Tl::HG;
  const long long tiles = static_cast<long long>(B) * G * groups;
  if (tiles > INT32_MAX - resident) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  constexpr float kLog2e = 1.4426950408889634f;
  masked_sdpa_kernel<T, D><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st, static_cast<int>(tiles), groups, G, N, H,
      scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------------------- f32 heads of 8

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift, d >= 1
// fixed for a launch and its magic number found on the host: the tile
// walk's divisions by the head groups and by G
struct FastDiv {
  unsigned m = 1;
  int l = 0;
  FastDiv() = default;
  explicit FastDiv(unsigned d) {
    while ((1ull << l) < d) ++l;
    m = static_cast<unsigned>((((1ull << l) - d) << 32) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, m) + n) >> l; }
};

// The walk of an f32 launch at D = 8: tiles are (sequence, head group of
// eight heads) pairs, seq * groups + group
struct Walk8 {
  int tiles, groups, G, H;
  FastDiv by_groups, by_G;
};

// tile_base of a tile at D = 8, its divisions by multiply-highs
__device__ __forceinline__ TileBase tile_base8(int t, const Walk8& w, const SdpaStrides& st) {
  const int seq = static_cast<int>(w.by_groups.div(t));
  const int grp = t - seq * w.groups;
  const long long b = w.by_G.div(seq);
  const long long g = seq - b * w.G;
  const int c0 = grp * 64;
  TileBase tb;
  tb.q = b * st.q[0] + g * st.q[1] + c0;
  tb.k = b * st.k[0] + g * st.k[1] + c0;
  tb.v = b * st.v[0] + g * st.v[1] + c0;
  tb.o = b * st.o[0] + g * st.o[1] + c0;
  tb.heads = min(8, w.H - grp * 8);
  return tb;
}

constexpr int kSmemPerSM = 233472;  // the H100's shared memory a SM: 228 KB

// An f32 tile at D = 8 for N <= 4 NB: one sequence's head group, 64
// channels, its q, k and v one after another in a stage, rows N padded to
// 4 NB (a lane's keys: no guard in its loops); padded rows are zeroed once
// and never written. A lane a (head, pair of query rows): 8 ceil(N / 2)
// lanes, the block's threads rounded up to a whole warp
template <int NB>
struct Tile8 {
  static constexpr int kRows = 4 * NB;
  static constexpr int kPitch = 64 + 4;          // floats a stage row
  static constexpr int kOperand = kRows * kPitch;  // q, k or v
  static constexpr int kStage = 3 * kOperand;
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));
  static constexpr int kMaxThreads = 32 * ((16 * NB + 31) / 32);
  // blocks a SM as shared memory allows (1 KB of it reserved a block), at
  // most as many as leave a lane's two rows 128 registers
  static constexpr int kBySmem = kSmemPerSM / (kSmem + 1024);
  static constexpr int kByRegs = 65536 / (128 * kMaxThreads);
  static constexpr int kMinBlocks = kBySmem < kByRegs ? kBySmem : kByRegs;
  static_assert(kSmem + 1024 <= kSmemPerSM, "a stage ring fits a SM");
};

// q, k and v rows 0..N-1 of a tile into a stage: a thread keeps one 16-byte
// chunk column and steps down the rows, so the block reads whole rows,
// neighbouring threads on neighbouring addresses
template <int NB>
__device__ __forceinline__ void load_tile8(float* stage, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v, const SdpaStrides& st,
                                           const TileBase& tb, int N) {
  using Tl = Tile8<NB>;
  const int ch = threadIdx.x % 16;
  if (ch >= tb.heads * 2) return;  // past a short last group
  const int r0 = threadIdx.x / 16, step = blockDim.x / 16;
#pragma unroll
  for (int z = 0; z < 3; ++z) {
    const long long rs = z == 0 ? st.q[2] : (z == 1 ? st.k[2] : st.v[2]);
    const float* src = (z == 0 ? q + tb.q : (z == 1 ? k + tb.k : v + tb.v)) + ch * 4;
    float* dst = stage + z * Tl::kOperand + ch * 4;
    for (int row = r0; row < N; row += step)
      cp_async16(dst + row * Tl::kPitch, src + row * rs);
  }
}

// the 8 channels of a head's row in a stage
__device__ __forceinline__ void row8(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
// a head's 8 output channels of one row, times inv
__device__ __forceinline__ void store8(float* p, const float (&o)[8], float inv) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4] * inv, o[5] * inv, o[6] * inv, o[7] * inv);
}
// a row's logit against a key: its 8 products as four chains of two, summed
// pairwise
__device__ __forceinline__ float dot8(const float (&q)[8], const float (&k)[8]) {
  return (fmaf(q[4], k[4], q[0] * k[0]) + fmaf(q[5], k[5], q[1] * k[1])) +
         (fmaf(q[6], k[6], q[2] * k[2]) + fmaf(q[7], k[7], q[3] * k[3]));
}

// lane (h, r) of 8 heads x ceil(N / 2) row pairs, on the CUDA cores: rows
// i = 2 r and i + 1 against the 4 NB keys of the stage (rows past N are
// zero), each K and V row read once for both rows, so the stage's reads
// (16-byte vectors, quarter-warp broadcasts) are half of a lane a row's; the
// exact max over the N valid keys, 2^(s c - m c), and O = P V over all keys
// (a padded key's probability and V row are 0). Row i + 1 = N (odd N) is
// the zero row: computed, not stored
template <int NB>
__device__ __forceinline__ void compute8_f32(const float* stage, float* __restrict__ out,
                                             const TileBase& tb, int h, int i, bool live,
                                             long long ostride, int N, float scale_log2) {
  using Tl = Tile8<NB>;
  constexpr int KJ = 4 * NB;
  const float* qs = stage + i * Tl::kPitch + h * 8;
  const float* ks = stage + Tl::kOperand + h * 8;
  const float* vs = stage + 2 * Tl::kOperand + h * 8;
  float q0[8], q1[8];
  row8(q0, qs);
  row8(q1, qs + Tl::kPitch);
  float s0[KJ], s1[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    float k[8];
    row8(k, ks + j * Tl::kPitch);
    s0[j] = dot8(q0, k);
    s1[j] = dot8(q1, k);
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (j < N) {
      m0 = fmaxf(m0, s0[j]);
      m1 = fmaxf(m1, s1[j]);
    }
  const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    s0[j] = j < N ? fast_exp2(fmaf(s0[j], scale_log2, -mc0)) : 0.f;
    s1[j] = j < N ? fast_exp2(fmaf(s1[j], scale_log2, -mc1)) : 0.f;
    l0 += s0[j];
    l1 += s1[j];
  }
  float o0[8], o1[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) o0[d] = o1[d] = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    float v[8];
    row8(v, vs + j * Tl::kPitch);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      o0[d] = fmaf(s0[j], v[d], o0[d]);
      o1[d] = fmaf(s1[j], v[d], o1[d]);
    }
  }
  if (live) {
    float* orow = out + tb.o + i * ostride + h * 8;
    store8(orow, o0, fast_rcp(l0));  // l >= 1: the max logit contributes 2^0
    if (i + 1 < N) store8(orow + ostride, o1, fast_rcp(l1));
  }
}

// Persistent blocks walk the tiles in order through the two-stage ring, as
// masked_sdpa_kernel does
template <int NB>
__global__ void __launch_bounds__(Tile8<NB>::kMaxThreads, Tile8<NB>::kMinBlocks)
masked_sdpa_h8_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, SdpaStrides st,
                      Walk8 w, int N, float scale_log2) {
  using Tl = Tile8<NB>;
  extern __shared__ uint4 smem[];
  float* stages = reinterpret_cast<float*>(smem);

  // zero the ring once: padded rows stay zero, cp.async writes rows < N
  for (int e = threadIdx.x; e < Tl::kSmem / 16; e += blockDim.x)
    smem[e] = make_uint4(0u, 0u, 0u, 0u);
  // this lane's head and pair of query rows, the same in every tile; the
  // lanes past the last pair (a warp's rounding) compute nothing
  const int pairs = (N + 1) / 2;
  const bool lane_valid = static_cast<int>(threadIdx.x) < 8 * pairs;
  const int lane_head = static_cast<int>(threadIdx.x) / pairs;
  const int lane_row = 2 * (static_cast<int>(threadIdx.x) - lane_head * pairs);
  __syncthreads();

  int t = blockIdx.x;  // the grid has at most one block a tile
  TileBase cur = tile_base8(t, w, st);
  load_tile8<NB>(stages, q, k, v, st, cur, N);
  cp_async_commit();
  for (int i = 0;; ++i) {
    const int next = t + gridDim.x;
    TileBase nb = cur;
    if (next < w.tiles) {
      nb = tile_base8(next, w, st);
      load_tile8<NB>(stages + ((i + 1) % kStages) * Tl::kStage, q, k, v, st, nb, N);
    }
    cp_async_commit();  // possibly empty: wait_group 1 then still means tile t
    cp_async_wait<1>();
    __syncthreads();
    if (lane_valid)
      compute8_f32<NB>(stages + (i % kStages) * Tl::kStage, out, cur, lane_head, lane_row,
                       lane_head < cur.heads, st.o[2], N, scale_log2);
    __syncthreads();  // every warp is done with this stage before it refills
    if (next >= w.tiles) break;
    t = next;
    cur = nb;
  }
}

// blocks of the instantiation resident at once on a device, as
// resident_blocks finds them
template <int NB>
cudaError_t resident_blocks8(int* blocks) {
  using Tl = Tile8<NB>;
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaFuncSetAttribute(masked_sdpa_h8_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_sdpa_h8_kernel<NB>, Tl::kMaxThreads, Tl::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <int NB>
cudaError_t launch8(const void* q, const void* k, const void* v, void* out,
                    const SdpaStrides& st, int B, int G, int N, int H, float scale,
                    cudaStream_t stream) {
  using Tl = Tile8<NB>;
  int resident = 0;
  cudaError_t err = resident_blocks8<NB>(&resident);
  if (err != cudaSuccess) return err;
  const int groups = (H + 7) / 8;
  const long long tiles = static_cast<long long>(B) * G * groups;
  if (tiles > INT32_MAX - resident) return cudaErrorInvalidValue;
  Walk8 w;
  w.tiles = static_cast<int>(tiles);
  w.groups = groups;
  w.G = G;
  w.H = H;
  w.by_groups = FastDiv(groups);
  w.by_G = FastDiv(G);
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  const unsigned threads = 32u * ((8 * ((N + 1) / 2) + 31) / 32);
  constexpr float kLog2e = 1.4426950408889634f;
  masked_sdpa_h8_kernel<NB><<<grid, threads, Tl::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), st, w, N, scale * kLog2e);
  return cudaGetLastError();
}

// K1 at D = 8 in f32: one instantiation a block of four rows N is padded to
cudaError_t launch8_rows(const void* q, const void* k, const void* v, void* out,
                         const SdpaStrides& st, int B, int G, int N, int H, float scale,
                         cudaStream_t stream) {
  switch ((N + 3) / 4) {
    case 1: return launch8<1>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 2: return launch8<2>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 3: return launch8<3>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 4: return launch8<4>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 5: return launch8<5>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 6: return launch8<6>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 7: return launch8<7>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 8: return launch8<8>(q, k, v, out, st, B, G, N, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* out,
                         const SdpaStrides& st, int B, int G, int N, int C, int H,
                         float scale, cudaStream_t stream) {
  // every row of q, k, v and out starts on a 16-byte boundary
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const long long chunk = 16 / sizeof(T);
  for (int a = 0; a < 3; ++a)
    if (st.q[a] % chunk || st.k[a] % chunk || st.v[a] % chunk || st.o[a] % chunk)
      return cudaErrorMisalignedAddress;
  switch (C / H) {
    case 8:
      if constexpr (std::is_same<T, float>::value)
        return launch8_rows(q, k, v, out, st, B, G, N, H, scale, stream);
      else
        return launch<T, 8>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 16: return launch<T, 16>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, st, B, G, N, H, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, st, B, G, N, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
void describe(int* info) {
  using Tl = Tile<T, D>;
  cudaFuncAttributes attr{};
  int resident = 0;
  if (cudaFuncGetAttributes(&attr, masked_sdpa_kernel<T, D>) != cudaSuccess ||
      resident_blocks<T, D>(&resident) != cudaSuccess)
    return;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int v[7] = {Tl::kThreads, attr.numRegs, Tl::kSmem, static_cast<int>(attr.localSizeBytes),
                    resident / sms, kMaxN, kStages};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
}

template <int NB>
void describe8(int* info) {
  using Tl = Tile8<NB>;
  cudaFuncAttributes attr{};
  int resident = 0;
  if (cudaFuncGetAttributes(&attr, masked_sdpa_h8_kernel<NB>) != cudaSuccess ||
      resident_blocks8<NB>(&resident) != cudaSuccess)
    return;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int v[7] = {Tl::kMaxThreads, attr.numRegs, Tl::kSmem,
                    static_cast<int>(attr.localSizeBytes), resident / sms, Tl::kRows, kStages};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
}

template <typename T>
void describe_width(int d, int n, int* info) {
  if (d == 8) {
    if constexpr (std::is_same<T, float>::value) {
      switch ((n + 3) / 4) {
        case 1: describe8<1>(info); break;
        case 2: describe8<2>(info); break;
        case 3: describe8<3>(info); break;
        case 4: describe8<4>(info); break;
        case 5: describe8<5>(info); break;
        case 6: describe8<6>(info); break;
        case 7: describe8<7>(info); break;
        case 8: describe8<8>(info); break;
        default: break;
      }
    } else {
      describe<T, 8>(info);
    }
  }
  if (d == 16) describe<T, 16>(info);
  if (d == 32) describe<T, 32>(info);
  if (d == 64) describe<T, 64>(info);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. C = D H with a head width D of 8, 16,
// 32 or 64, C <= 512, 1 <= N <= 32, any B G. strides: 16 int64 in elements,
// the four leading strides of q, k, v and out in that order (channel stride
// is 1); every pointer and the three outer strides of each operand 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success).
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

// The instantiation for (dtype, head width d, and at d = 8 in float32 the
// rows N) on the current device, for reports: info = {threads a block (at
// most: at d = 8 in float32 a launch takes 8 ceil(N / 2) rounded up to a
// warp), registers a thread, dynamic shared memory a block in bytes, local
// memory (spills) a thread in bytes, blocks resident a SM, rows a stage
// holds of q, k or v, stages of the ring}. Left untouched for a width, N or
// dtype there is none of.
void kasf_masked_sdpa_info(int dtype, int d, int n, int* info) {
  if (n < 1 || n > kMaxN) return;
  if (dtype == 0) describe_width<float>(d, n, info);
  if (dtype == 1) describe_width<__nv_bfloat16>(d, n, info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
