// The hidden-chunk MLP tile shared by K3 (csrc/mlp_ln.cu, LayerNorm and the
// residual on) and K5 (csrc/mlp.cu, both off), for Hopper (sm_90a).
//
// Over M token rows of width C in {64, 128, 256, 512}:
//     LN:   out = x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)
//     else: out =            GELU(x W1^T + b1) W2^T + b2
// with LayerNorm statistics in f32, exact-erf GELU on the f32 accumulator
// (rounded once to the compute dtype), and W1 (H, C), W2 (C, H) in the torch
// nn.Linear layout. The hidden width H is a multiple of 64 up to 2048.
//
// Bound on the H100: 4*M*C*H FLOP against ~2*M*C elements moved, i.e.
// ~C*H/(2*itemsize) FLOP per byte: bound by operations at every shape the
// models use. In f32 that is the CUDA cores' 67 TFLOP/s; in bf16 the tensor
// cores' 989 TFLOP/s.
//
// Design. A block (f32 at C >= 256: a cluster of two) takes tiles of R
// rows; tail rows of a ragged M are masked (loaded as zeros, never
// stored), so any M works. It loads a tile's rows
// once (LN on: f32 statistics, rounded to the compute dtype as the plain
// version does) into shared memory and keeps them there for the whole tile.
// It then walks the hidden width in chunks of 64 columns: h = GELU(a W1c^T +
// b1c), rounded to the compute dtype, and out += h W2c^T in registers. The
// hidden never reaches device memory. Epilogue: out + b2, and with LN on
// x + ls2 * (out + b2), x re-read (an L2 hit). Each width is one
// instantiation. Every tile streams all of W1 and W2 from L2, so the rows a
// tile set the L2 reads of a launch: ceil(M / R) * 2*C*H*itemsize.
//
//  * bfloat16 (mlp_bf16_tc_kernel): mma.sync m16n8k16 (bf16 in, f32
//    accumulate) with ldmatrix fragments (csrc/mma_sm90.cuh).
//    - C <= 128: R = 128 rows, 4 warps of 32 rows (two m-tiles) and every
//      output channel (oacc 128 f32 registers a lane at C = 128, 64 at 64).
//      fc1 runs in slices of 16 hidden columns; each slice's accumulators,
//      after b1, exact GELU and the bf16 pack, are directly the A fragment
//      of fc2's k16 step (two n8 tiles per k16): the hidden stays in
//      registers. Two m-tiles a warp let each B fragment feed two MMAs.
//    - C >= 256: 8 warps, R = 128 at C = 256 and 64 at C = 512. In fc1 a
//      warp takes 16 rows x (64 or 32) hidden columns; the bf16 hidden is
//      exchanged once through shared memory (hS); in fc2 a warp takes 32
//      rows x 128 channels (oacc 128 registers a lane).
//    - The weight chunks come through a ring of 16-byte cp.async.cg copies
//      straight into shared memory. At C <= 128 a stage holds a chunk of W1
//      and of W2 (2 stages at C = 128, 3 at C = 64): chunk j+1 lands while
//      chunk j is multiplied, one barrier a chunk. At C >= 256 one W1 and
//      one W2 buffer alternate (W2c loads during fc1, W1c+1 during fc2), one
//      barrier a product; the one before fc2 also publishes hS.
//    - Prologue: C/32 neighbouring lanes a row, 32 channels a lane, so a
//      row's two sums take log2(C/32) shuffles and all of a warp's rows
//      reduce together. Epilogue: the f32 outputs are staged row-major in
//      shared memory and written out a row at a time in 16-byte pieces.
//    L2 weight reads a launch at M = 58,752 (459 tiles of 128 rows, 918 of
//    64): C/H 64/256 30 MB, 128/512 120 MB, 256/1024 481 MB, 512/1024
//    1.93 GB.
//  * float32 on the CUDA cores (TF32 would put ~1e-3 on each output), fmaf
//    on float4 operands.
//    - C <= 128 (mlp_f32_persistent_kernel): persistent blocks, at most one
//      wave (132 on the H100, one a SM: 212,504 B of shared memory at
//      C = 128), each walking the tiles blockIdx.x, + gridDim.x, ... 112-row
//      tiles fill whole waves at both main-path Ms: 525 tiles at M = 58,752
//      (3.98 waves; 128-row tiles gave 3.48, the last wave with 63 of 132
//      SMs busy) and 132 at 14,688 (one).
//      Rows: one thread copies the block's next tile (a contiguous run of x)
//      into a raw stage by one bulk copy (cp.async.bulk, the TMA engine, on
//      an mbarrier) while the tile is multiplied. LN once a tile, from the
//      stage into aS (row-major, stride C + 4): a lane holds 4 neighbouring
//      channels (gamma, beta in registers), the 14 rows of a warp reduce
//      together (their shuffles interleave) and rsqrtf has no branch.
//      Weights: mlp_f32_stage_weights_kernel first writes W1 and W2
//      transposed into a workspace, W1 as [H/64][C][64] and W2 as (H, C), so
//      each 64-column chunk of either is one contiguous run of 32 KB (at
//      C = 128) that one thread brings in by one bulk copy. (4-byte cp.async
//      copies that transposed in flight cost ~21k of a tile's ~212k cycles
//      in issue alone.) One buffer each: the barrier that opens chunk j
//      starts W2t(j), the one after fc1 starts W1t(j + 1), and the last
//      chunk starts the next tile's first, so the weights stream across
//      tiles without a break and no tile starts cold.
//      Products: fc1 and fc2 are one function, X row-major (a, then the
//      hidden) times W k-major (W1t, W2t), a thread 7 rows x 8 columns: 15
//      float4 loads per 224 FMAs, none with a bank conflict. fc1 splits the
//      channels over two warp groups (over all of them a thread's 7 x 4
//      tile read a float4 per 10 FMAs: ~103k cycles a tile against ~97k);
//      each group hands the other the partial sums of the other's 32
//      columns through hS and finishes its own (+ b1, GELU) in place. fc2
//      keeps out over the whole hidden width in 56 registers (C = 128).
//      Epilogue: the loads of x all issued before the first store (~3k
//      cycles a tile fewer).
//      Sums run in a fixed order, without atomics: reruns are bitwise equal.
//      A tile at M = 58,752, C/H 128/512 (scripts/k3_tile_stamps.py on an
//      H100 80GB HBM3 at 700 W): ~186k cycles, of which fc1 with GELU
//      ~95k (exact GELU ~11k of them), fc2 ~75k, against 114.7k of FMA issue
//      at the pipe's full rate.
//    - C = 256 and 512 (mlp_f32_cluster_kernel): a thread-block cluster of
//      two blocks takes a tile, block b the channels CS b .. CS b + CS - 1
//      (CS = C/2): 112-row tiles of 128 channels a block at C = 256 (the
//      C = 128 block's shape), 56-row tiles of 256 channels at C = 512. A
//      block's rows x channels (14,336) are the C = 128 block's at both,
//      so are aS, the 7 x 8 register tiles and the 56 accumulators of out.
//      Clusters are persistent: at most as many as the card holds at once
//      (cudaOccupancyMaxActiveClusters: 66 of two, every SM), each walking
//      the tiles clusterid, + nclusterid, ...
//      Why two blocks of C/2 at C = 512 and not four of 128: a first
//      version used four 128-channel blocks of 112 rows; the card held
//      only 30 clusters of four (120 SMs: a cluster lives in one GPC), 525
//      tiles made 17.5 waves, a block sent 43 KB a chunk through DSMEM,
//      and it ran 3.57-3.96 ms against 2.93 for this layout (same M, an
//      H100 80GB HBM3 at 700 W): 1,050 tiles of 56 rows on 66 clusters
//      make 15.9 waves on all 132 SMs, a block sends 14 KB a chunk.
//      Rows: each block loads its slice of the tile straight from x (the
//      previous tile prefetched the rows into L2 with cp.async.bulk.
//      prefetch, a share a block). LN's statistics span the cluster: each
//      block sums its slice of each row and stores the sums into both
//      blocks' shared memory (DSMEM); after a cluster barrier each sums the
//      two in rank order, so both get the same bits. The squared
//      deviations from that mean go the same way (two exchanges, as the
//      plain version forms the variance).
//      fc1 is split over the channels: a block's partial sums of a chunk's
//      64 columns over its CS channels, the lanes splitting those in groups
//      of 64 (7 x 8 register tiles) and a fixed tree of shuffles summing
//      the groups, go to the block that finishes their columns (32 a
//      block), which adds the two partials in rank order, adds b1, applies
//      exact GELU and stores the finished columns into both blocks' hS: a
//      reduce-scatter and an all-gather, each an st.async store into the
//      other block's shared memory that completes bytes on its mbarrier,
//      so a block waits on its own mbarrier for its data and no cluster
//      barrier or release fence sits in the chunk loop (cluster barriers
//      there, the first design, cost ~1k cycles an arrive). fc1 of the next
//      chunk runs while the hidden travels. fc2 then runs over the whole
//      chunk into the block's own CS output channels, and the epilogue
//      writes those channels. Exact GELU runs once per hidden value in the
//      cluster, not once per block.
//      Weights: the staging kernel writes W2 as [C/CS][H][CS], so a block's
//      slice of a chunk of either transposed copy is one bulk copy (32 KB
//      at C = 256, 64 KB at 512), one buffer each; the block barrier of
//      chunk g (after which no thread reads W1t(g) or W2t(g - 1)) starts
//      W1t(g + 1) and W2t(g), the last chunk of a tile the next tile's
//      first.
//      Shared memory a block: aS 60,928 B (rows of CS + 4 CS/64 floats),
//      hS 112 or 56 rows of 68 floats, the partial sums' receive buffer
//      (two slots of R x 32), W1t and W2t, the LN exchange: 187,424 B at
//      C = 256, 222,496 at 512 (of 232,448; the C <= 128 tile's raw stage
//      of rows does not fit beside them, hence the loads from L2).
//      Sums run in a fixed order, without atomics: reruns are bitwise equal.
//      A tile at M = 58,752 (scripts/k3_tile_stamps.py --c 512, the same
//      card): ~371k cycles a block at 512/1024, of which fc1 ~163k, fc2
//      ~158k, the exchanges and their waits ~25k, against 229k of FMA issue
//      at the pipe's full rate.
//    L2 weight reads a launch at M = 58,752 (each cluster reads the weights
//    once a tile, each block its slice): 69 MB at 64/256, 275 MB at 128/512,
//    1.10 GB at 256/1024, 4.40 GB at 512/1024 (56-row tiles).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_sm90.cuh"

namespace kasf_tile {

using kasf_mma::cp_async16;
using kasf_mma::cp_async_commit;

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
}

// the sums over groups of L neighbouring lanes of N values at once: their
// shuffles interleave
template <int L, int N>
__device__ __forceinline__ void group_sums(float (&v)[N]) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

// ---- float32 on the CUDA cores, C <= 128: persistent row tiles

template <int C>
struct F32Rows {
  static constexpr int R = 112;       // rows a tile: 525 at M = 58,752, 132 at 14,688
  static constexpr int J = 64;        // hidden columns a chunk
  static constexpr int kThreads = 256;
  static constexpr int RS = 16;       // row sets: set q holds rows q + 16 i
  static constexpr int RT = R / RS;   // 7 rows a thread
  static constexpr int CG = J / 4;    // column groups: group p, columns 4p + 64 h + v
  static constexpr int NH = C / 64;   // fc2: float4s of output channels a thread
  static constexpr int LdA = C + 4;   // aS rows: LN(x) * gamma + beta (K5: x)
  static constexpr int LdH = J + 4;   // hS rows: GELU(z) of the chunk
  // the chunk's W1t [c][j] (stride J) and W2t [j][c] (stride C), each one
  // contiguous run of the transposed copies, as they lie there
  static constexpr int kOffH = R * LdA;  // floats: aS | hS | W1t | W2t | raw | mbarriers
  static constexpr int kOffW1 = kOffH + R * LdH;
  static constexpr int kOffW2 = kOffW1 + C * J;
  static constexpr int kOffRaw = kOffW2 + J * C;
  static constexpr int kOffBar = kOffRaw + R * C;
  static constexpr unsigned kChunkBytes = sizeof(float) * C * J;  // a matrix's chunk
  // mbarriers: the raw stage's, W1t's and W2t's
  static constexpr size_t kSmem = sizeof(float) * kOffBar + 3 * sizeof(unsigned long long);
  static constexpr int kRowsW = R / (kThreads / 32);  // the LN step: 14 rows a warp
  static constexpr int L = C / 4;                     // ... L lanes a row, 4 channels a lane
  static_assert(C == 64 || C == 128, "the unsplit widths");
  static_assert(RS * CG == kThreads && R % RS == 0 && kRowsW % (32 / L) == 0,
                "the thread layouts cover the tile");
  static_assert(kOffH % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 && kOffRaw % 4 == 0 &&
                    kOffBar % 2 == 0 && LdA % 4 == 0 && LdH % 4 == 0,
                "16-byte alignment of the copies' targets and float4s, 8 of the mbarriers");
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ float lane4(const float4& w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// One thread: the tile's rows row0.. (those < M), one contiguous run of x,
// into the raw stage by one bulk copy completing on bar
template <int C>
__device__ __forceinline__ void fetch_rows_f32(float* raw, const float* __restrict__ x,
                                               long long row0, long long M,
                                               unsigned long long* bar) {
  const long long n = M - row0 < F32Rows<C>::R ? M - row0 : F32Rows<C>::R;
  const unsigned bytes = static_cast<unsigned>(n * C * sizeof(float));
  kasf_mma::mbar_expect(bar, bytes);
  kasf_mma::bulk_load(raw, x + row0 * C, bytes, bar);
}

// The transposed weights a launch reads its chunks from, written once a
// launch into the workspace: w1t [H/64][C][64] (each hidden chunk's W1
// transposed) and w2t [C/S][H][S] (W2^T, cut into slices of S = slice
// channels, the channels a block multiplies: C at C <= 128, where the one
// slice is (H, C) = W2^T, and C/2 at 256 and 512), so the chunk of either
// matrix that a block multiplies is one contiguous run of S * 64 floats. A
// block a 32 x 32 tile, through shared memory (both its reads and its
// writes in 128-byte rows).
__global__ void __launch_bounds__(256)
mlp_f32_stage_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                             float* __restrict__ w1t, float* __restrict__ w2t, int C, int H,
                             int slice) {
  __shared__ float tile[32][33];
  const int tiles1 = H / 32 * (C / 32);  // W1's tiles, then W2's
  int b = blockIdx.x;
  const float* src;
  float* dst;
  int ld_src, ld_dst;
  if (b < tiles1) {  // W1 rows j.., channels c..: to w1t[j / 64][c][j % 64]
    const int jt = b / (C / 32), ct = b % (C / 32);
    src = w1 + static_cast<long long>(jt) * 32 * C + ct * 32;
    dst = w1t + static_cast<long long>(jt / 2) * C * 64 + ct * 32 * 64 + jt % 2 * 32;
    ld_src = C;
    ld_dst = 64;
  } else {  // W2 rows c.., hidden columns j..: to w2t[c / S][j][c % S]
    b -= tiles1;
    const int ct = b / (H / 32), jt = b % (H / 32);
    src = w2 + static_cast<long long>(ct) * 32 * H + jt * 32;
    dst = w2t + static_cast<long long>(ct * 32 / slice) * H * slice +
          static_cast<long long>(jt) * 32 * slice + ct * 32 % slice;
    ld_src = H;
    ld_dst = slice;
  }
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) tile[r][tx] = src[static_cast<long long>(r) * ld_src + tx];
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) dst[static_cast<long long>(r) * ld_dst + tx] = tile[tx][r];
}

// One thread: a chunk of a transposed matrix (C * 64 floats, contiguous)
// into its buffer by one bulk copy completing on bar
template <int C>
__device__ __forceinline__ void fetch_chunk(float* buf, const float* __restrict__ wt, int chunk,
                                            unsigned long long* bar) {
  constexpr unsigned kBytes = F32Rows<C>::kChunkBytes;
  kasf_mma::mbar_expect(bar, kBytes);
  kasf_mma::bulk_load(buf, wt + static_cast<long long>(chunk) * C * F32Rows<C>::J, kBytes, bar);
}

// aS from the raw stage: LN(x) * gamma + beta with f32 statistics (LN on) or
// x. Warp w takes rows 14w..14w+13, 32 / L of them a pass; a lane holds 4
// neighbouring channels (gamma, beta in gm, bt). All the warp's rows reduce
// together (their shuffles interleave) and rsqrtf has no branch, so the
// step is not a chain of latencies. Rows >= M are zeros (LN: beta).
template <int C, bool LN>
__device__ __forceinline__ void stage_rows_f32(const float* raw, float* aS, float4 gm, float4 bt,
                                               long long row0, long long M, float eps,
                                               int warp, int lane) {
  using S = F32Rows<C>;
  constexpr int L = S::L, P = 32 / L, kPass = S::kRowsW / P;
  const int ch = 4 * (lane % L);
  const int r0 = warp * S::kRowsW + lane / L;
  float4 xv[kPass];
#pragma unroll
  for (int i = 0; i < kPass; ++i) {
    const int r = r0 + i * P;
    xv[i] = row0 + r < M ? ld4(raw + r * C + ch) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (LN) {
    float s[kPass];
#pragma unroll
    for (int i = 0; i < kPass; ++i) s[i] = (xv[i].x + xv[i].y) + (xv[i].z + xv[i].w);
    group_sums<L>(s);
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const float mean = s[i] * (1.0f / C);
      xv[i] = make_float4(xv[i].x - mean, xv[i].y - mean, xv[i].z - mean, xv[i].w - mean);
      s[i] = (xv[i].x * xv[i].x + xv[i].y * xv[i].y) + (xv[i].z * xv[i].z + xv[i].w * xv[i].w);
    }
    group_sums<L>(s);
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const float rstd = rsqrtf(s[i] * (1.0f / C) + eps);
      const float4 v = xv[i];
      xv[i] = make_float4(fmaf(v.x * rstd, gm.x, bt.x), fmaf(v.y * rstd, gm.y, bt.y),
                          fmaf(v.z * rstd, gm.z, bt.z), fmaf(v.w * rstd, gm.w, bt.w));
    }
  }
#pragma unroll
  for (int i = 0; i < kPass; ++i) st4(aS + (r0 + i * P) * S::LdA + ch, xv[i]);
}

// acc[i][4h + v] += sum_{k < K} X[RS i][k] W[k][G h + v]: X is the thread's
// first row (row-major, stride LdX; its rows RS apart), W its first column
// (k-major, stride LdW). A step of four k reads RT X and 4 NH W float4s for 16 RT NH FMAs; a
// warp's X loads touch 2 or 4 rows and its W loads 8 or 16 neighbouring
// float4s of a row, so no load has a bank conflict. fc1 (X = aS, W = W1t,
// over half the channels) and fc2 (X = hS, W = W2t) both run it; every sum
// runs over k in order.
template <int K, int NH, int G, int LdX, int LdW, int RT, int RS = 16>
__device__ __forceinline__ void row_product(const float* X, const float* W,
                                            float (&acc)[RT][4 * NH]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 w[4][NH];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < NH; ++h) w[u][h] = ld4(W + (k + u) * LdW + G * h);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 d = ld4(X + i * RS * LdX + k);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float& o = acc[i][4 * h + v];
          o = fmaf(d.x, lane4(w[0][h], v), o);
          o = fmaf(d.y, lane4(w[1][h], v), o);
          o = fmaf(d.z, lane4(w[2][h], v), o);
          o = fmaf(d.w, lane4(w[3][h], v), o);
        }
    }
  }
}

// Blocks walk the tiles blockIdx.x, + gridDim.x, ... (a grid of at most one
// wave). Per tile: the rows from the raw stage into aS, then per hidden
// chunk fc1 (+ b1, GELU) into hS and fc2 into the registers, then out. The
// weight chunks come from the transposed copies w1t, w2t by bulk copies,
// one buffer each: the barrier that opens chunk j (W1t(j) landed, hS and
// W2t free) starts W2t(j), the one after fc1 (hS complete, W1t free) starts
// W1t of the next chunk, the next tile's chunk 0 after the last: the
// weights stream across tiles without a break. The first barrier of a tile
// also starts the bulk copy of the block's next tile into the raw stage.
// The n-th copy into a buffer completes its mbarrier's phase n: parity n & 1.
template <int C, bool LN>
__global__ void __launch_bounds__(F32Rows<C>::kThreads, 1)
mlp_f32_persistent_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* __restrict__ w1t,
                          const float* __restrict__ b1, const float* __restrict__ w2t,
                          const float* __restrict__ b2, const float* __restrict__ ls2,
                          float* __restrict__ out, long long M, int H, float eps) {
  using S = F32Rows<C>;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* hS = aS + S::kOffH;
  float* w1s = aS + S::kOffW1;
  float* w2s = aS + S::kOffW2;
  float* raw = aS + S::kOffRaw;
  auto* bar = reinterpret_cast<unsigned long long*>(aS + S::kOffBar);  // rows, W1t, W2t

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // fc2: rows q + 16 i, channels 4p + 64 h + v. fc1: warps 4kh.. take the
  // channel half kh, rows q1 + 16 i and hidden columns 4 p1 + v, 32 + 4 p1 + v
  const int p = tid % S::CG, q = tid / S::CG;
  const int kh = warp >> 2, p1 = tid % 8, q1 = (tid & 127) >> 3;
  const long long tiles = (M + S::R - 1) / S::R;
  const long long step = gridDim.x;
  const int chunks = H / S::J;
  long long t = blockIdx.x;

  if (tid == 0) {
    for (int k = 0; k < 3; ++k) kasf_mma::mbar_init(bar + k);
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0) {
    fetch_rows_f32<C>(raw, x, t * S::R, M, bar);
    fetch_chunk<C>(w1s, w1t, 0, bar + 1);
  }
  float4 gm = make_float4(0.f, 0.f, 0.f, 0.f), bt = gm;
  if constexpr (LN) {
    gm = ld4(gamma + 4 * (lane % S::L));
    bt = ld4(beta + 4 * (lane % S::L));
  }

  unsigned n = 0;  // the block's chunks so far, over its tiles
  for (unsigned parity = 0; t < tiles; t += step, parity ^= 1u) {
    const long long row0 = t * S::R;
    const bool next_tile = t + step < tiles;
    kasf_mma::mbar_wait(bar, parity);  // the tile's rows have landed
    stage_rows_f32<C, LN>(raw, aS, gm, bt, row0, M, eps, warp, lane);
    float oacc[S::RT][4 * S::NH];
#pragma unroll
    for (int i = 0; i < S::RT; ++i)
#pragma unroll
      for (int v = 0; v < 4 * S::NH; ++v) oacc[i][v] = 0.f;

    for (int j = 0; j < chunks; ++j, ++n) {
      const float4 bias = ld4(b1 + j * S::J + 32 * kh + 4 * p1);
      kasf_mma::mbar_wait(bar + 1, n & 1);  // W1t(j) has landed
      __syncthreads();  // aS staged; hS, W2t and the stage free
      if (tid == 0) {
        if (j == 0 && next_tile) fetch_rows_f32<C>(raw, x, row0 + step * S::R, M, bar);
        fetch_chunk<C>(w2s, w2t, j, bar + 2);
      }
      float z[S::RT][8];
#pragma unroll
      for (int i = 0; i < S::RT; ++i)
#pragma unroll
        for (int v = 0; v < 8; ++v) z[i][v] = 0.f;
      row_product<C / 2, 2, 32, S::LdA, S::J>(aS + q1 * S::LdA + kh * (C / 2),
                                              w1s + kh * (C / 2) * S::J + 4 * p1, z);
      // each half hands the other the partial sums of the other's 32
      // columns through hS, then finishes its own: z + b1, GELU, in place
#pragma unroll
      for (int i = 0; i < S::RT; ++i)
        st4(hS + (q1 + S::RS * i) * S::LdH + 32 * (1 - kh) + 4 * p1,
            kh ? make_float4(z[i][0], z[i][1], z[i][2], z[i][3])
               : make_float4(z[i][4], z[i][5], z[i][6], z[i][7]));
      __syncthreads();  // the partial sums exchanged
#pragma unroll
      for (int i = 0; i < S::RT; ++i) {
        float* hp = hS + (q1 + S::RS * i) * S::LdH + 32 * kh + 4 * p1;
        const float4 o = ld4(hp);
        const float4 m = kh ? make_float4(z[i][4], z[i][5], z[i][6], z[i][7])
                            : make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
        st4(hp, make_float4(gelu_erf(m.x + o.x + bias.x), gelu_erf(m.y + o.y + bias.y),
                            gelu_erf(m.z + o.z + bias.z), gelu_erf(m.w + o.w + bias.w)));
      }
      kasf_mma::mbar_wait(bar + 2, n & 1);  // W2t(j) has landed
      __syncthreads();  // hS complete; W1t free
      if (tid == 0 && (j + 1 < chunks || next_tile))
        fetch_chunk<C>(w1s, w1t, j + 1 < chunks ? j + 1 : 0, bar + 1);
      row_product<S::J, S::NH, 64, S::LdH, C>(hS + q * S::LdH, w2s + 4 * p, oacc);
    }

    // out + b2 (LN on: x + ls2 * (out + b2), x re-read), tail rows masked
    float4 xr[S::RT][S::NH];
    if constexpr (LN) {
#pragma unroll
      for (int i = 0; i < S::RT; ++i)
#pragma unroll
        for (int h = 0; h < S::NH; ++h) {
          const long long row = row0 + q + S::RS * i;
          xr[i][h] = row < M ? ld4(x + row * C + 4 * p + 64 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
#pragma unroll
    for (int h = 0; h < S::NH; ++h) {
      const int c = 4 * p + 64 * h;
      const float4 bb = ld4(b2 + c);
      float4 ls = bb;
      if constexpr (LN) ls = ld4(ls2 + c);
#pragma unroll
      for (int i = 0; i < S::RT; ++i) {
        const long long row = row0 + q + S::RS * i;
        if (row >= M) continue;
        float4 y = make_float4(oacc[i][4 * h] + bb.x, oacc[i][4 * h + 1] + bb.y,
                               oacc[i][4 * h + 2] + bb.z, oacc[i][4 * h + 3] + bb.w);
        if constexpr (LN) {
          const float4 xv = xr[i][h];
          y = make_float4(xv.x + ls.x * y.x, xv.y + ls.y * y.y, xv.z + ls.z * y.z,
                          xv.w + ls.w * y.w);
        }
        st4(out + row * C + c, y);
      }
    }
  }
}

// ---- float32 on the CUDA cores, C = 256 and 512: a cluster of two blocks a
// tile, each over half the channels

template <int C>
struct F32Cluster {
  static constexpr int NB = 2;                   // blocks a cluster; block b holds
  static constexpr int CS = C / NB;              // channels CS b .. CS b + CS - 1
  static constexpr int R = 14336 / CS;           // rows a tile: 112 at C = 256, 56 at 512
  static constexpr int J = 64;                   // hidden columns a chunk
  static constexpr int kThreads = 256;
  static constexpr int RT = 7;                   // rows a thread
  static constexpr int RS = R / RT;              // row sets: set q holds rows q + RS i
  static constexpr int CG = CS / 8;              // fc2: column groups, channels 4p + CS/2 h + v
  static constexpr int KS = CS / 64;             // fc1: channel groups of 64 (lanes split K)
  static constexpr int LPK = 32 / KS;            // ... lanes a group in a warp
  static constexpr int FW = 8 / KS;              // fc1's columns a thread finishes
  static constexpr int W = J / NB;               // a chunk's columns block b finishes: W b..
  static constexpr int NV = CS / 128;            // LN: float4s of a row a lane
  // aS rows: the slice of LN(x) * gamma + beta, each group of 64 channels 68
  // floats on from the last, so fc1's channel groups read distinct banks
  static constexpr int LdA = CS + 4 * KS;
  static constexpr int LdH = J + 4;              // hS rows: GELU(z) of the chunk, all columns
  static constexpr int LdR = W;                  // recv rows: fc1's partial sums of W columns
  // floats: aS | hS | recv [NB][R][LdR] (slot s: block s's partial sums) |
  // W1t [CS][J] | W2t [J][CS] | stats [2][NB][R] (the rows' sums, then their
  // squared deviations, slot s from block s) | mbarriers
  static constexpr int kOffH = R * LdA;
  static constexpr int kOffRecv = kOffH + R * LdH;
  static constexpr int kOffW1 = kOffRecv + NB * R * LdR;
  static constexpr int kOffW2 = kOffW1 + CS * J;
  static constexpr int kOffStats = kOffW2 + J * CS;
  static constexpr int kOffBar = kOffStats + 2 * NB * R;
  static constexpr unsigned kChunkBytes = sizeof(float) * CS * J;  // a block's slice of a chunk
  // bytes a chunk's exchanges bring in: into recv from the other block (a
  // block writes its own slot itself), into hS from both
  static constexpr unsigned kRecvBytes = sizeof(float) * (NB - 1) * R * W;
  static constexpr unsigned kHsBytes = sizeof(float) * R * J;
  // mbarriers: W1t's, W2t's, recv's, hS's
  static constexpr int kBars = 4;
  static constexpr size_t kSmem = sizeof(float) * kOffBar + kBars * sizeof(unsigned long long);
  static constexpr int kRowsW = R / (kThreads / 32);  // LN: rows a warp
  static constexpr int kTasks = R * W / 4;            // float4s of hidden a block finishes a chunk
  static constexpr int kTasksT = (kTasks + kThreads - 1) / kThreads;  // ... a thread, at most
  static_assert(C == 256 || C == 512, "the cluster widths");
  static_assert(RS * CG == kThreads && RS * 8 * KS == kThreads && R % (kThreads / 32) == 0 &&
                    CG % 16 == 0 && W == 32,
                "the thread layouts cover the tile");
  static_assert(kOffH % 4 == 0 && kOffRecv % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 &&
                    kOffBar % 2 == 0 && LdA % 4 == 0,
                "16-byte alignment of the copies' targets and float4s, 8 of the mbarriers");
  static_assert(kSmem <= 232448, "shared memory");
};

// aS from x: the block's slice of the tile's rows, loaded straight from
// global memory (L2 hits: the previous tile prefetched them), as LN(x) *
// gamma + beta with f32 statistics over all C channels (LN on) or as x.
// Warp w takes rows kRowsW w.., a lane channels 4 lane + 128 u, all the
// warp's rows reducing together. Each block sums its slice of a row and
// sends the sum to both blocks of the cluster; after a cluster barrier each
// sums the two in rank order, so both get the same bits. The squared
// deviations from that mean go the same way (two exchanges, as the plain
// version forms the variance: a one-pass sum of squares loses digits on
// nearly constant rows). Rows >= M are zeros (LN: beta).
template <int C, bool LN>
__device__ __forceinline__ void stage_rows_cluster(const float* __restrict__ x, float* aS,
                                                   const float* stats,
                                                   const float4 (&gm)[F32Cluster<C>::NV],
                                                   const float4 (&bt)[F32Cluster<C>::NV],
                                                   long long row0, long long M, float eps,
                                                   unsigned rank, int warp, int lane) {
  using S = F32Cluster<C>;
  constexpr int N = S::kRowsW, NV = S::NV;
  const int r0 = warp * N;
  float4 xv[N][NV];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const long long row = row0 + r0 + i;
      xv[i][u] = row < M ? ld4(x + row * C + rank * S::CS + 4 * lane + 128 * u)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  if constexpr (LN) {
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) s[i] += (xv[i][u].x + xv[i][u].y) + (xv[i][u].z + xv[i][u].w);
    }
    kasf_mma::cluster_row_sums<S::NB>(s, stats, S::R, r0, rank, lane);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float mean = s[i] * (1.0f / C);
      s[i] = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        float4& v = xv[i][u];
        v = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
        s[i] += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
    }
    kasf_mma::cluster_row_sums<S::NB>(s, stats + S::NB * S::R, S::R, r0, rank, lane);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float rstd = rsqrtf(s[i] * (1.0f / C) + eps);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float4 v = xv[i][u];
        xv[i][u] = make_float4(
            fmaf(v.x * rstd, gm[u].x, bt[u].x), fmaf(v.y * rstd, gm[u].y, bt[u].y),
            fmaf(v.z * rstd, gm[u].z, bt[u].z), fmaf(v.w * rstd, gm[u].w, bt[u].w));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int ch = 4 * lane + 128 * u;
#pragma unroll
    for (int i = 0; i < N; ++i) st4(aS + (r0 + i) * S::LdA + ch + 4 * (ch >> 6), xv[i][u]);
  }
}

// fc1's partial sums of a chunk (W1t in w1s) over one group of 64 of the
// block's channels, kg: a thread's 7 rows (q1 + RS i) x 8 columns (4 p1 + v,
// 32 + 4 p1 + v); the KS lanes that hold the same rows and columns over the
// KS groups are summed by combine_groups.
template <int C>
__device__ __forceinline__ void cluster_fc1(float (&z)[F32Cluster<C>::RT][8], const float* aS,
                                            const float* w1s, int kg, int p1, int q1) {
  using S = F32Cluster<C>;
#pragma unroll
  for (int i = 0; i < S::RT; ++i)
#pragma unroll
    for (int v = 0; v < 8; ++v) z[i][v] = 0.f;
  row_product<64, 2, 32, S::LdA, S::J, S::RT, S::RS>(aS + q1 * S::LdA + 68 * kg,
                                                  w1s + kg * 64 * S::J + 4 * p1, z);
}

// fc2 over a chunk (the hidden in hS, W2t in w2s) into out: rows q + RS i,
// channels 4p + CS/2 h + v of the block's
template <int C>
__device__ __forceinline__ void cluster_fc2(float (&oacc)[F32Cluster<C>::RT][8], const float* hS,
                                            const float* w2s, int p, int q) {
  using S = F32Cluster<C>;
  row_product<S::J, 2, S::CS / 2, S::LdH, S::CS, S::RT, S::RS>(hS + q * S::LdH, w2s + 4 * p, oacc);
}

// The KS lanes lane ^ LPK ... hold the same 7 x 8 partial sums over the KS
// channel groups: a fixed tree of shuffles leaves each with the block's sum
// over all its channels for FW = 8 / KS columns: group kg keeps columns
// 32 (kg / (KS / 2)) + 4 p1 + FW (kg % (KS / 2)) + v, v < FW.
template <int KS, int RT>
__device__ __forceinline__ void combine_groups(float (&zf)[RT][8 / KS], const float (&z)[RT][8],
                                               int kg) {
  constexpr int LPK = 32 / KS;
  // level 1 (the top bit of kg): the halves of the 8 columns
  const bool hi = kg >= KS / 2;
  float h4[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float other = __shfl_xor_sync(0xffffffffu, hi ? z[i][v] : z[i][4 + v], LPK * KS / 2);
      h4[i][v] = (hi ? z[i][4 + v] : z[i][v]) + other;
    }
  if constexpr (KS == 2) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) zf[i][v] = h4[i][v];
  } else {  // level 2 (the low bit of kg): the halves of those 4
    static_assert(KS == 4, "two or four channel groups");
    const bool odd = kg & 1;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float other = __shfl_xor_sync(0xffffffffu, odd ? h4[i][v] : h4[i][2 + v], LPK);
        zf[i][v] = (odd ? h4[i][2 + v] : h4[i][v]) + other;
      }
  }
}

// FW (4 or 2) floats into shared memory, of this block or (st.async) of a
// block of the cluster
template <int FW>
__device__ __forceinline__ void st_local(float* p, const float* v) {
  if constexpr (FW == 4) st4(p, make_float4(v[0], v[1], v[2], v[3]));
  else *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int FW>
__device__ __forceinline__ void st_remote(unsigned addr, const float* v, unsigned bar) {
  if constexpr (FW == 4) kasf_mma::st_async4(addr, make_float4(v[0], v[1], v[2], v[3]), bar);
  else kasf_mma::st_async2(addr, make_float2(v[0], v[1]), bar);
}

// Clusters of two blocks walk the tiles clusterid, + nclusterid, ... (a grid
// of at most as many clusters as the card holds at once); block b of a
// cluster takes the tile's channels CS b .. CS b + CS - 1 (CS = C / 2). Per
// tile: the rows (LN's statistics summed across the cluster), then per
// hidden chunk g:
//  * fc1 over the block's channels: the lanes split them in groups of 64
//    and a fixed tree of shuffles sums the groups, leaving partial sums of
//    all 64 columns over the block's channels; a thread's all belong to one
//    block's W = 32 columns and go to slot rank of that block's recv.
//  * reduce-scatter: block b waits for its recv to fill, sums its W
//    columns' two partial sums in rank order, adds b1, applies exact GELU
//    and stores the finished columns into both blocks' hS (all-gather).
//  * fc1 of chunk g + 1 (it reads only aS and W1t) while the other block's
//    columns arrive; then fc2 of chunk g over the whole chunk into the
//    block's own CS output channels, 56 registers a thread.
// Both exchanges are st.async stores into the other block's shared memory
// that complete bytes on its mbarrier (recv's, hS's), so a block waits on
// its own mbarrier for its data and no cluster barrier or release fence
// sits in the chunk loop; a block writes its own slot of recv with plain
// stores before a block barrier. Thread 0 arms each phase
// (arrive.expect_tx) once the last has completed for it; bytes may land
// before it. The write-after-read hazards follow from the data flow: a
// block sends its partial sums of chunk g + 1 only after its hS of chunk g
// is complete, which needs both blocks' finished columns of chunk g, which
// each block computed from its recv (so it has read recv); and a block
// sends partial sums only after a block barrier that each of its threads
// reaches after its fc2 of the previous chunk, so no block finishes
// columns into an hS that is still being read.
// Every sum runs in a fixed order, without atomics: reruns are bitwise equal.
// Weights: the block's slice of each chunk of the transposed copies is one
// bulk copy into one buffer each. The block barrier of chunk g (no thread
// reads W1t(g) or W2t(g - 1) after it) starts W1t(g + 1) and W2t(g); the
// last chunk of a tile starts the next tile's first, so the weights stream
// across tiles. The n-th copy into a buffer, the n-th chunk's exchange,
// completes its mbarrier's phase n: parity n & 1.
template <int C, bool LN>
__global__ void __launch_bounds__(F32Cluster<C>::kThreads, 1)
mlp_f32_cluster_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ w1t,
                       const float* __restrict__ b1, const float* __restrict__ w2t,
                       const float* __restrict__ b2, const float* __restrict__ ls2,
                       float* __restrict__ out, long long M, int H, float eps) {
  using S = F32Cluster<C>;
  using namespace kasf_mma;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* hS = aS + S::kOffH;
  float* recv = aS + S::kOffRecv;
  float* w1s = aS + S::kOffW1;
  float* w2s = aS + S::kOffW2;
  float* stats = aS + S::kOffStats;
  auto* bar = reinterpret_cast<unsigned long long*>(aS + S::kOffBar);  // W1t, W2t, recv, hS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // fc2: rows q + RS i, channels CS rank + 4p + CS/2 h + v (a warp: 2 row
  // sets x 16 column groups). fc1: channel group kg, rows q1 + RS i,
  // columns 4 p1 + v and 32 + 4 p1 + v (a warp: KS groups x 32/KS/8 row
  // sets x 8 column groups)
  const int p = tid % 16 + 16 * (warp % (S::CG / 16));
  const int q = 2 * (warp / (S::CG / 16)) + (tid / 16) % 2;
  const int kg = lane / S::LPK, p1 = lane % 8, q1 = warp * (S::LPK / 8) + (lane % S::LPK) / 8;
  const unsigned rank = cluster_rank();
  const long long cid = cluster_index(), ncl = cluster_count();
  const long long tiles = (M + S::R - 1) / S::R;
  const int chunks = H / S::J;
  const long long my_tiles = cid < tiles ? (tiles - 1 - cid) / ncl + 1 : 0;
  const long long total = my_tiles * chunks;  // chunks the block multiplies
  // the block's slice of each chunk: W1t [H/64][C][64] rows CS rank..,
  // W2t [C/CS][H][CS] slice rank
  const float* w1b = w1t + rank * S::CS * S::J;
  const float* w2b = w2t + static_cast<long long>(rank) * H * S::CS;

  if (tid == 0) {
    for (int k = 0; k < S::kBars; ++k) mbar_init(bar + k);
    mbar_arm(bar + 2, S::kRecvBytes);  // chunk 0's exchanges
    mbar_arm(bar + 3, S::kHsBytes);
  }
  cluster_sync();  // both blocks of the cluster run, their mbarriers initialised
  if (tid == 0 && total > 0) {
    mbar_expect(bar, S::kChunkBytes);
    bulk_load(w1s, w1b, S::kChunkBytes, bar);
  }
  float4 gm[S::NV], bt[S::NV];
#pragma unroll
  for (int u = 0; u < S::NV; ++u) {
    gm[u] = bt[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (LN) {
      gm[u] = ld4(gamma + rank * S::CS + 4 * lane + 128 * u);
      bt[u] = ld4(beta + rank * S::CS + 4 * lane + 128 * u);
    }
  }
  // where this thread's partial sums go (the block that finishes their
  // columns, slot rank, and that block's recv mbarrier), and both blocks'
  // hS at this block's columns and hS mbarrier
  const int col = 32 * (kg / (S::KS / 2)) + 4 * p1 + S::FW * (kg % (S::KS / 2));
  const int owner = col / S::W;
  float* const recv_own = recv + (rank * S::R + q1) * S::LdR + col - owner * S::W;
  const unsigned recv_at = map_rank(recv_own, owner);
  const unsigned recv_bar = map_rank(bar + 2, owner);
  unsigned hs_at[S::NB], hs_bar[S::NB];
#pragma unroll
  for (int b = 0; b < S::NB; ++b) {
    hs_at[b] = map_rank(hS + rank * S::W, b);
    hs_bar[b] = map_rank(bar + 3, b);
  }
  // the reduce step's tasks: tr, tr + 256, ... (warp 0, which starts the
  // weight copies, gets the fewest)
  const int tr = S::kThreads - 1 - tid;

  long long g = 0;  // the block's chunks so far, over its tiles
  for (long long k = 0; k < my_tiles; ++k) {
    const long long row0 = (cid + k * ncl) * S::R;
    if (tid == 0 && k + 1 < my_tiles) {  // the next tile's rows into L2, a share a block
      const long long next0 = row0 + ncl * S::R;
      const long long n = M - next0 < S::R ? M - next0 : S::R;
      const long long per = (n + S::NB - 1) / S::NB;
      const long long first = rank * per, rows = n - first < per ? n - first : per;
      if (rows > 0)
        bulk_prefetch_l2(x + (next0 + first) * C, static_cast<unsigned>(rows * C * sizeof(float)));
    }
    stage_rows_cluster<C, LN>(x, aS, stats, gm, bt, row0, M, eps, rank, warp, lane);
    __syncthreads();  // aS staged
    float oacc[S::RT][8];
#pragma unroll
    for (int i = 0; i < S::RT; ++i)
#pragma unroll
      for (int v = 0; v < 8; ++v) oacc[i][v] = 0.f;
    float z[S::RT][8], zf[S::RT][S::FW];
    mbar_wait(bar, static_cast<unsigned>(g) & 1u);  // W1t(g) has landed
    cluster_fc1<C>(z, aS, w1s, kg, p1, q1);
    combine_groups<S::KS>(zf, z, kg);

    for (int j = 0; j < chunks; ++j, ++g) {
      float4 bias[S::kTasksT];  // b1 of the thread's tasks: tr + 256 u
#pragma unroll
      for (int u = 0; u < S::kTasksT; ++u) {
        const int task = tr + u * S::kThreads;
        bias[u] = task < S::kTasks
                      ? ld4(b1 + j * S::J + rank * S::W + 4 * (task % (S::W / 4)))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (j > 0) {
        mbar_wait(bar + 1, static_cast<unsigned>(g - 1) & 1u);  // W2t(g - 1) has landed
        cluster_fc2<C>(oacc, hS, w2s, p, q);
      }
      if (owner == static_cast<int>(rank)) {  // the block's own slot, by plain stores
#pragma unroll
        for (int i = 0; i < S::RT; ++i) st_local<S::FW>(recv_own + i * S::RS * S::LdR, zf[i]);
      }
      __syncthreads();  // the block is past fc2(g - 1) and fc1(g): hS, W2t, W1t free
      // (each thread's reads of them have returned, so the copies need no
      // proxy fence); its own slot of recv is in
      if (tid == 0) {
        if (g + 1 < total) {
          mbar_arm(bar, S::kChunkBytes);
          bulk_load(w1s, w1b + ((j + 1) % chunks) * static_cast<long long>(C) * S::J,
                    S::kChunkBytes, bar);
        }
        mbar_arm(bar + 1, S::kChunkBytes);
        bulk_load(w2s, w2b + static_cast<long long>(j) * S::J * S::CS, S::kChunkBytes, bar + 1);
      }
      if (owner != static_cast<int>(rank)) {
#pragma unroll
        for (int i = 0; i < S::RT; ++i)
          st_remote<S::FW>(recv_at + sizeof(float) * i * S::RS * S::LdR, zf[i], recv_bar);
      }
      mbar_wait_cluster(bar + 2, static_cast<unsigned>(g) & 1u);  // every partial sum is in
      if (tid == 0) mbar_arm(bar + 2, S::kRecvBytes);  // the next chunk's
      // this block's W columns: the two partial sums in rank order, + b1,
      // exact GELU, into both blocks' hS (all the thread's loads first, then
      // its GELUs, then its stores)
      float4 h[S::kTasksT];
#pragma unroll
      for (int u = 0; u < S::kTasksT; ++u) {
        const int task = tr + u * S::kThreads;
        h[u] = bias[u];
        if (task < S::kTasks) {
          const float* pr = recv + task / (S::W / 4) * S::LdR + 4 * (task % (S::W / 4));
          float4 s = ld4(pr);
#pragma unroll
          for (int b = 1; b < S::NB; ++b) {
            const float4 o = ld4(pr + b * S::R * S::LdR);
            s = make_float4(s.x + o.x, s.y + o.y, s.z + o.z, s.w + o.w);
          }
          h[u] = make_float4(gelu_erf(s.x + h[u].x), gelu_erf(s.y + h[u].y),
                             gelu_erf(s.z + h[u].z), gelu_erf(s.w + h[u].w));
        }
      }
#pragma unroll
      for (int u = 0; u < S::kTasksT; ++u) {
        const int task = tr + u * S::kThreads;
        if (task < S::kTasks) {
          const unsigned off =
              sizeof(float) * (task / (S::W / 4) * S::LdH + 4 * (task % (S::W / 4)));
#pragma unroll
          for (int b = 0; b < S::NB; ++b) st_async4(hs_at[b] + off, h[u], hs_bar[b]);
        }
      }
      if (j + 1 < chunks) {  // fc1 of chunk g + 1 while the hidden arrives
        mbar_wait(bar, static_cast<unsigned>(g + 1) & 1u);  // W1t(g + 1) has landed
        cluster_fc1<C>(z, aS, w1s, kg, p1, q1);
        combine_groups<S::KS>(zf, z, kg);
      }
      mbar_wait_cluster(bar + 3, static_cast<unsigned>(g) & 1u);  // every column is in hS
      if (tid == 0) mbar_arm(bar + 3, S::kHsBytes);  // the next chunk's
    }
    mbar_wait(bar + 1, static_cast<unsigned>(g - 1) & 1u);  // the tile's last W2t
    cluster_fc2<C>(oacc, hS, w2s, p, q);

    // out + b2 (LN on: x + ls2 * (out + b2), x re-read), the block's
    // channels, tail rows masked
    float4 xr[S::RT][2];
    if constexpr (LN) {
#pragma unroll
      for (int i = 0; i < S::RT; ++i)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = row0 + q + S::RS * i;
          xr[i][h2] = row < M ? ld4(x + row * C + rank * S::CS + 4 * p + S::CS / 2 * h2)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = rank * S::CS + 4 * p + S::CS / 2 * h2;
      const float4 bb = ld4(b2 + c);
      float4 ls = bb;
      if constexpr (LN) ls = ld4(ls2 + c);
#pragma unroll
      for (int i = 0; i < S::RT; ++i) {
        const long long row = row0 + q + S::RS * i;
        if (row >= M) continue;
        float4 y = make_float4(oacc[i][4 * h2] + bb.x, oacc[i][4 * h2 + 1] + bb.y,
                               oacc[i][4 * h2 + 2] + bb.z, oacc[i][4 * h2 + 3] + bb.w);
        if constexpr (LN) {
          const float4 xv = xr[i][h2];
          y = make_float4(xv.x + ls.x * y.x, xv.y + ls.y * y.y, xv.z + ls.z * y.z,
                          xv.w + ls.w * y.w);
        }
        st4(out + row * C + c, y);
      }
    }
  }
}

// ---- bfloat16 on the tensor cores
using bf16 = __nv_bfloat16;

// R rows and kWarps warps a block, kStages ring stages, kMinBlocks blocks a
// SM the registers are capped for. Without the split (C <= 128) a warp owns
// its rows from fc1 to the output; with it (C >= 256) the warps share the
// hidden through hS.
template <int C> struct TcTile;
template <> struct TcTile<64> {
  static constexpr bool kSplit = false;
  static constexpr int R = 128, kWarps = 4, kStages = 3, kMinBlocks = 3;
};
template <> struct TcTile<128> {
  static constexpr bool kSplit = false;
  static constexpr int R = 128, kWarps = 4, kStages = 2, kMinBlocks = 2;
};
template <> struct TcTile<256> {
  static constexpr bool kSplit = true;
  static constexpr int R = 128, kWarps = 8, kStages = 1, kMinBlocks = 1;
};
template <> struct TcTile<512> {
  static constexpr bool kSplit = true;
  static constexpr int R = 64, kWarps = 8, kStages = 1, kMinBlocks = 1;
};

constexpr int kChunkTc = 64;  // hidden columns per chunk
constexpr int kSliceTc = 16;  // without the split: fc1's hidden columns at a time
constexpr int kMW = 2;        // m-tiles of 16 rows a warp: a B fragment feeds two MMAs

template <int C>
struct TcShape {
  using T = TcTile<C>;
  static constexpr int R = T::R, kWarps = T::kWarps, MW = kMW;
  static constexpr int kStages = T::kStages, kMinBlocks = T::kMinBlocks;
  static constexpr int kThreads = 32 * kWarps;
  // without the split a warp keeps its rows' hidden in registers from fc1
  // to fc2; with it the hidden goes through hS
  static constexpr bool kSplit = T::kSplit;
  // the ring's pieces: a chunk's W1 and W2 together, or (split) one each
  static constexpr int kPieces = kSplit ? 2 : 1;
  static constexpr int kAhead = kStages * kPieces - 1;  // pieces in flight
  // split: fc1 gives each warp 16 rows x HW of the chunk's hidden columns
  static constexpr int HW = kSplit ? kChunkTc * (R / 16) / kWarps : kChunkTc;
  // fc2: a warp takes MW m-tiles x OW output channels
  static constexpr int OW = C * (R / (16 * MW)) / kWarps;
  // row pitches (bf16) 16 bytes past a multiple of 128: the eight rows of an
  // ldmatrix land on distinct banks
  static constexpr int LdA = C + 8;             // aS, W1 chunk (hidden rows)
  static constexpr int LdW2 = kChunkTc + 8;     // W2 chunk (channel rows), hS
  static constexpr int kW1 = kChunkTc * LdA;    // a stage: W1 chunk, then W2
  static constexpr int kStage = kW1 + C * LdW2;
  static constexpr int kRingOff = R * LdA;      // aS, the ring, hS (split)
  static constexpr int kHsOff = kRingOff + kStages * kStage;
  static constexpr size_t kSmem = sizeof(bf16) * (kHsOff + (kSplit ? R * LdW2 : 0));
  // the epilogue stages the f32 outputs, R rows of C + 8 (8 words past a
  // multiple of 32: a half-warp's float2 fragment stores hit 32 banks),
  // over aS and the ring
  static constexpr int LdO = C + 8;
  static constexpr int kCopies = kChunkTc * C / 8 / kThreads;  // a thread, a matrix
  static constexpr int kRowsW = R / kWarps;     // rows a warp in the prologue, epilogue
  static_assert(kAhead >= 1 && kCopies >= 1 && kThreads % (C / 8) == 0 &&
                    kChunkTc * C / 8 % kThreads == 0,
                "the ring copies whole 16-byte pieces, as many a thread");
  static_assert(kSplit ? HW % 16 == 0 && (R / 16) * (kChunkTc / HW) == kWarps &&
                             (R / (16 * MW)) * (C / OW) == kWarps
                       : R == 16 * MW * kWarps,
                "fc1 and fc2 tiles cover the block's");
  static_assert(OW % 16 == 0, "n8 tiles in pairs");
  static_assert(kRowsW % (1024 / C) == 0, "whole prologue passes");
  static_assert(sizeof(float) * R * LdO <= kSmem && kSmem <= 232448, "shared memory");
};

// Start copying ring piece q (chunk q / kPieces) into its stage; one group
// (an empty one past the last piece keeps the count). W1 rows j0..j0+63 lie
// contiguous in memory; W2[:, j0:j0+64] is C rows of 128 bytes. A thread
// copies 16-byte pieces of W1 chunk rows r0 + i*dr and of W2 rows c0 + i*dc:
// one base address each, plus multiples of a fixed stride. The thread index
// is read anew on each call, not kept across the chunk loop, where every
// register is taken.
template <int C>
__device__ __forceinline__ void issue_piece(bf16* ring, const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2, int q, int H) {
  using S = TcShape<C>;
  constexpr int dr = S::kThreads / (C / 8), dc = S::kThreads / (kChunkTc / 8);
  if (q < H / kChunkTc * S::kPieces) {
    int tid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    const int j = q / S::kPieces;
    const int part = q - j * S::kPieces;
    bf16* stage = ring + (j % S::kStages) * S::kStage;
    const int j0 = j * kChunkTc;
    if (part == 0) {
      const int r0 = tid / (C / 8), c8 = tid % (C / 8);
      const bf16* src = w1 + static_cast<long long>(j0 + r0) * C + c8 * 8;
#pragma unroll
      for (int i = 0; i < S::kCopies; ++i)
        cp_async16(stage + r0 * S::LdA + c8 * 8 + i * dr * S::LdA, src + i * dr * C);
    }
    if (S::kPieces == 1 || part == 1) {
      const int c0 = tid / (kChunkTc / 8), j8 = tid % (kChunkTc / 8);
      const bf16* src = w2 + static_cast<long long>(c0) * H + j0 + j8 * 8;
#pragma unroll
      for (int i = 0; i < S::kCopies; ++i)
        cp_async16(stage + S::kW1 + c0 * S::LdW2 + j8 * 8 + i * dc * S::LdW2,
                   src + static_cast<long long>(i) * dc * H);
    }
  }
  cp_async_commit();
}

// W 32-bit words (2W bf16) from 4-, 8- or 16-byte aligned memory and back
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const bf16* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    static_assert(W == 1, "1, 2 or a multiple of 4 words");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
template <int W>
__device__ __forceinline__ void store_words(bf16* p, const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}
// N floats (N a multiple of 2) from 8- or 16-byte aligned memory
template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else {
    static_assert(N == 2, "2 or a multiple of 4 floats");
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  }
}

// fc1 over K = C for MW 16-row m-tiles and NT n8 tiles of hidden columns:
// acc += A[rows, :] B^T; a is this lane's ldmatrix row address in the first
// m-tile (lda apart), b in B's rows (the hidden columns, k contiguous)
template <int C, int MW, int NT>
__device__ __forceinline__ void fc1_tile(float (&acc)[MW][NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb) {
  using namespace kasf_mma;
#pragma unroll
  for (int k = 0; k < C / 16; ++k) {
    uint32_t af[MW][4];
#pragma unroll
    for (int m = 0; m < MW; ++m) ldsm_x4(af[m], a + m * 16 * lda + k * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + np * 16 * ldb + k * 16);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        mma_k16(acc[m][2 * np], af[m], bf[0], bf[1]);
        mma_k16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
      }
    }
  }
}

// fc1's accumulators start at b1: bb holds this lane's column pairs
template <int MW, int NT>
__device__ __forceinline__ void init_bias(float (&acc)[MW][NT][4], const uint32_t* bb) {
  using namespace kasf_mma;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      acc[m][n][0] = acc[m][n][2] = bf16_lo(bb[n]);
      acc[m][n][1] = acc[m][n][3] = bf16_hi(bb[n]);
    }
}

// exact GELU in f32 of fc1's accumulators (b1 included), rounded to bf16
// pairs: hp[m][n][0] row g, hp[m][n][1] row g + 8 of m-tile m, columns 2t,
// 2t + 1 of n8 tile n. 0.5 z (1 + erf) as one FMA around erff
template <int MW, int NT>
__device__ __forceinline__ void gelu_pack(uint32_t (&hp)[MW][NT][2],
                                          const float (&acc)[MW][NT][4]) {
  using namespace kasf_mma;
  const auto gelu = [](float z) {
    const float h = 0.5f * z;
    return fmaf(h, erff(z * 0.70710678118654752f), h);
  };
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      hp[m][n][0] = pack_bf16(gelu(acc[m][n][0]), gelu(acc[m][n][1]));
      hp[m][n][1] = pack_bf16(gelu(acc[m][n][2]), gelu(acc[m][n][3]));
    }
}

// fc2 over the NH n8 tiles of hidden columns whose bf16 pairs are in hp:
// the accumulators of n8 tiles 2kk, 2kk+1 are the A fragment of k16 kk.
// acc += h B^T for NO n8 tiles of output channels, B's rows at b
template <int MW, int NO, int NH>
__device__ __forceinline__ void fc2_from_registers(float (&acc)[MW][NO][4],
                                                   const uint32_t (&hp)[MW][NH][2],
                                                   const bf16* b, int ldb) {
  using namespace kasf_mma;
#pragma unroll
  for (int kk = 0; kk < NH / 2; ++kk) {
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + np * 16 * ldb + kk * 16);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const uint32_t a[4] = {hp[m][2 * kk][0], hp[m][2 * kk][1], hp[m][2 * kk + 1][0],
                               hp[m][2 * kk + 1][1]};
        mma_k16(acc[m][2 * np], a, bf[0], bf[1]);
        mma_k16(acc[m][2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }
}

template <int C, bool LN>
__global__ void __launch_bounds__(TcShape<C>::kThreads, TcShape<C>::kMinBlocks)
mlp_bf16_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ b2, const float* __restrict__ ls2,
                   bf16* __restrict__ out, long long M, int H, float eps) {
  using S = TcShape<C>;
  using namespace kasf_mma;
  extern __shared__ float4 smem4[];
  bf16* aS = reinterpret_cast<bf16*>(smem4);
  bf16* ring = aS + S::kRingOff;
  bf16* hS = aS + S::kHsOff;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' row and column pair
  const long long row0 = static_cast<long long>(blockIdx.x) * S::R;
  const int chunks = H / kChunkTc;
  // fc1: rows r1.., hidden columns c1.. of the chunk; fc2: rows r2..,
  // channels c2.. (without the split r1 = r2, c1 = c2 = 0)
  const int r1 = S::kSplit ? warp % (S::R / 16) * 16 : warp * 16 * S::MW;
  const int c1 = S::kSplit ? warp / (S::R / 16) * S::HW : 0;
  const int r2 = S::kSplit ? warp % (S::R / (16 * S::MW)) * (16 * S::MW) : r1;
  const int c2 = S::kSplit ? warp / (S::R / (16 * S::MW)) * S::OW : 0;

  // ---- the rows' inputs (LN on: normalised with f32 statistics), in bf16.
  // Warp w takes rows w*kRowsW.., P of them a pass: L = C/32 neighbouring
  // lanes a row, 32 neighbouring channels a lane, so a row's sums take
  // log2(L) shuffles and a pass reads 2 KB in one piece.
  {
    constexpr int L = C / 32, P = 32 / L, kPasses = S::kRowsW / P;
    const int rw = warp * S::kRowsW + lane / L;  // the lane's row in pass 0
    const int ch = lane % L * 32;                // its first channel
    uint32_t xw[kPasses][16];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const long long row = row0 + rw + p * P;
      if (row < M) {
        load_words(xw[p], x + row * C + ch);
      } else {
#pragma unroll
        for (int u = 0; u < 16; ++u) xw[p][u] = 0u;
      }
    }
    // the ring's first pieces queue behind the rows' loads
    for (int q = 0; q < S::kAhead; ++q) issue_piece<C>(ring, w1, w2, q, H);
    if constexpr (LN) {
      float4 gv[8], bv[8];  // this lane's 32 channels of gamma and beta
#pragma unroll
      for (int u4 = 0; u4 < 8; ++u4) {
        gv[u4] = reinterpret_cast<const float4*>(gamma + ch)[u4];
        bv[u4] = reinterpret_cast<const float4*>(beta + ch)[u4];
      }
      float mean[kPasses], rstd[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        mean[p] = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) mean[p] += bf16_lo(xw[p][u]) + bf16_hi(xw[p][u]);
      }
      group_sums<L>(mean);
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        mean[p] *= 1.0f / C;
        rstd[p] = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float d0 = bf16_lo(xw[p][u]) - mean[p], d1 = bf16_hi(xw[p][u]) - mean[p];
          rstd[p] = fmaf(d0, d0, fmaf(d1, d1, rstd[p]));
        }
      }
      group_sums<L>(rstd);
#pragma unroll
      for (int p = 0; p < kPasses; ++p) rstd[p] = rsqrtf(rstd[p] * (1.0f / C) + eps);
#pragma unroll
      for (int u4 = 0; u4 < 8; ++u4)  // four channels a step
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          uint32_t& w0 = xw[p][2 * u4];
          uint32_t& w1_ = xw[p][2 * u4 + 1];
          w0 = pack_bf16((bf16_lo(w0) - mean[p]) * rstd[p] * gv[u4].x + bv[u4].x,
                         (bf16_hi(w0) - mean[p]) * rstd[p] * gv[u4].y + bv[u4].y);
          w1_ = pack_bf16((bf16_lo(w1_) - mean[p]) * rstd[p] * gv[u4].z + bv[u4].z,
                          (bf16_hi(w1_) - mean[p]) * rstd[p] * gv[u4].w + bv[u4].w);
        }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) store_words(aS + (rw + p * P) * S::LdA + ch, xw[p]);
  }

  float oacc[S::MW][S::OW / 8][4];
#pragma unroll
  for (int m = 0; m < S::MW; ++m)
#pragma unroll
    for (int n = 0; n < S::OW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[m][n][e] = 0.f;

  // ldmatrix.x4 row addresses: A (rows 0-15 at k 0 and 8); B stored by n
  // rows (n 0-7 at k 0 and 8, then n 8-15): b[0..1] one n8 tile, b[2..3] the next
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 8;
  const bf16* a_ptr = aS + (r1 + a_row) * S::LdA + a_col;

  for (int j = 0; j < chunks; ++j) {
    // this lane's b1 column pairs: n8 tile n of the warp's HW columns
    uint32_t bb[S::HW / 8];
#pragma unroll
    for (int n = 0; n < S::HW / 8; ++n)
      bb[n] = *reinterpret_cast<const uint32_t*>(b1 + j * kChunkTc + c1 + n * 8 + 2 * t);
    cp_async_wait<S::kAhead - 1>();  // this chunk's W1 (and W2) has landed
    __syncthreads();  // ... for every thread; the stage read last is free
    issue_piece<C>(ring, w1, w2, j * S::kPieces + S::kAhead, H);
    const bf16* w1s = ring + (j % S::kStages) * S::kStage;
    const bf16* w2s = w1s + S::kW1;
    const bf16* b1_ptr = w1s + (c1 + b_row) * S::LdA + b_col;
    const bf16* b2_ptr = w2s + (c2 + b_row) * S::LdW2 + b_col;

    if constexpr (!S::kSplit) {
      // the chunk in slices of kSliceTc hidden columns: fc1 (from b1), GELU
      // and straight on into fc2 from the registers
      constexpr int NS = kSliceTc / 8;
#pragma unroll
      for (int s = 0; s < kChunkTc / kSliceTc; ++s) {
        float h[S::MW][NS][4];
        init_bias(h, bb + NS * s);
        fc1_tile<C>(h, a_ptr, S::LdA, b1_ptr + s * kSliceTc * S::LdA, S::LdA);
        uint32_t hp[S::MW][NS][2];
        gelu_pack(hp, h);
        fc2_from_registers(oacc, hp, b2_ptr + s * kSliceTc, S::LdW2);
      }
    } else {
      float h[1][S::HW / 8][4];
      init_bias(h, bb);
      fc1_tile<C>(h, a_ptr, S::LdA, b1_ptr, S::LdA);
      uint32_t hp[1][S::HW / 8][2];
      gelu_pack(hp, h);
      // a row's hidden is read by several warps: through hS, once
#pragma unroll
      for (int n = 0; n < S::HW / 8; ++n) {
        bf16* hrow = hS + (r1 + g) * S::LdW2 + c1 + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(hrow) = hp[0][n][0];
        *reinterpret_cast<uint32_t*>(hrow + 8 * S::LdW2) = hp[0][n][1];
      }
      cp_async_wait<S::kAhead - 1>();  // this chunk's W2 has landed
      __syncthreads();  // ... and hS is complete; W1's buffer is free
      issue_piece<C>(ring, w1, w2, j * S::kPieces + 1 + S::kAhead, H);
      const bf16* h_ptr = hS + (r2 + a_row) * S::LdW2 + a_col;
#pragma unroll
      for (int kk = 0; kk < kChunkTc / 16; ++kk) {
        uint32_t a[S::MW][4];
#pragma unroll
        for (int m = 0; m < S::MW; ++m) ldsm_x4(a[m], h_ptr + m * 16 * S::LdW2 + kk * 16);
#pragma unroll
        for (int np = 0; np < S::OW / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b2_ptr + np * 16 * S::LdW2 + kk * 16);
#pragma unroll
          for (int m = 0; m < S::MW; ++m) {
            mma_k16(oacc[m][2 * np], a[m], b[0], b[1]);
            mma_k16(oacc[m][2 * np + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }

  // ---- epilogue: the f32 outputs staged row-major in shared memory, then
  // a warp a row with V = C/32 neighbouring channels a lane: out + b2 (LN on:
  // x + ls2 * (out + b2)), rounded once; tail rows masked
  constexpr int V = C / 32;
  __syncthreads();  // every warp is done with aS, the ring and hS
  float* oS = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int m = 0; m < S::MW; ++m)
#pragma unroll
    for (int n = 0; n < S::OW / 8; ++n) {
      float* o = oS + (r2 + m * 16 + g) * S::LdO + c2 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(oacc[m][n][0], oacc[m][n][1]);
      *reinterpret_cast<float2*>(o + 8 * S::LdO) = make_float2(oacc[m][n][2], oacc[m][n][3]);
    }
  __syncthreads();
  uint32_t xw[S::kRowsW][V / 2];
  if constexpr (LN) {
#pragma unroll
    for (int i = 0; i < S::kRowsW; ++i) {
      const long long row = row0 + warp * S::kRowsW + i;
      if (row < M) load_words(xw[i], x + row * C + lane * V);
    }
  }
  uint32_t bw[V / 2];
  float lv[V];
  load_words(bw, b2 + lane * V);
  if constexpr (LN) load_floats(lv, ls2 + lane * V);
#pragma unroll
  for (int i = 0; i < S::kRowsW; ++i) {
    const int r = warp * S::kRowsW + i;
    if (row0 + r >= M) break;
    float y[V];
    load_floats(y, oS + r * S::LdO + lane * V);
    uint32_t ow[V / 2];
#pragma unroll
    for (int u = 0; u < V / 2; ++u) {
      float y0 = y[2 * u] + bf16_lo(bw[u]), y1 = y[2 * u + 1] + bf16_hi(bw[u]);
      if constexpr (LN) {
        y0 = bf16_lo(xw[i][u]) + lv[2 * u] * y0;
        y1 = bf16_hi(xw[i][u]) + lv[2 * u + 1] * y1;
      }
      ow[u] = pack_bf16(y0, y1);
    }
    store_words(out + (row0 + r) * C + lane * V, ow);
  }
}

// ---- launchers

constexpr int kMaxDevices = 64;

// threads, rows and dynamic shared memory of a block of each instantiation,
// and its blocks a tile: f32 runs persistent blocks (C <= 128) or clusters
// of two blocks (C >= 256), a grid of at most one wave, each walking its
// tiles; bf16 a block a tile
template <int C, bool kBf16>
constexpr int rows_of() {
  if constexpr (kBf16) return TcShape<C>::R;
  else if constexpr (C <= 128) return F32Rows<C>::R;
  else return F32Cluster<C>::R;
}
template <int C, bool kBf16>
constexpr size_t smem_of() {
  if constexpr (kBf16) return TcShape<C>::kSmem;
  else if constexpr (C <= 128) return F32Rows<C>::kSmem;
  else return F32Cluster<C>::kSmem;
}
template <int C, bool kBf16>
struct Cfg {
  static constexpr bool kPersistent = !kBf16;
  static constexpr int kCluster = !kBf16 && C >= 256 ? 2 : 1;
  static constexpr int kSlice = kCluster > 1 ? C / 2 : C;  // channels a block (f32)
  static constexpr int kThreads = kBf16 ? TcShape<C>::kThreads : 256;
  static constexpr int kRows = rows_of<C, kBf16>();
  static constexpr size_t kSmem = smem_of<C, kBf16>();
};

template <int C, bool LN, bool kBf16>
auto kernel_of() {
  if constexpr (kBf16) {
    return &mlp_bf16_tc_kernel<C, LN>;
  } else if constexpr (C <= 128) {
    return &mlp_f32_persistent_kernel<C, LN>;
  } else {
    return &mlp_f32_cluster_kernel<C, LN>;
  }
}

// a launch of the instantiation: grid blocks (a multiple of its cluster)
template <int C, bool kBf16>
struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Launch(unsigned blocks, cudaStream_t stream) : attr{}, cfg{} {
    using K = Cfg<C, kBf16>;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(K::kThreads);
    cfg.dynamicSmemBytes = K::kSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = K::kCluster > 1 ? 1 : 0;
  }
};

// raise the instantiation's dynamic shared-memory limit and count the
// blocks the device holds at once, once per device: SMs x blocks a SM, or
// for clusters the clusters the device holds at once x blocks a cluster
// (the clusters must each fit on one GPC, so some SMs may stay idle)
template <int C, bool LN, bool kBf16>
cudaError_t configure(int* resident) {
  using K = Cfg<C, kBf16>;
  static int blocks[kMaxDevices];  // one array per instantiation; 0: not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    const auto kernel = kernel_of<C, LN, kBf16>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(K::kSmem));
    int n = 0;
    if constexpr (K::kCluster > 1) {
      Launch<C, kBf16> one(K::kCluster, nullptr);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &one.cfg);
      n *= K::kCluster;
    } else {
      int sms = 0, per_sm = 0;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::kThreads, K::kSmem);
      n = sms * per_sm;
    }
    if (err != cudaSuccess) return err;
    if (n < K::kCluster) return cudaErrorInvalidConfiguration;
    blocks[dev] = n;
  }
  *resident = blocks[dev];
  return cudaSuccess;
}

// blocks of a launch over M rows: a tile each, or for persistent blocks and
// clusters at most one wave of them, each walking its tiles
template <int C, bool kBf16>
long long grid_of(long long M, int resident) {
  using K = Cfg<C, kBf16>;
  const long long tiles = (M + K::kRows - 1) / K::kRows;
  const long long at_once = resident / K::kCluster;  // tiles the device takes at once
  return K::kPersistent && tiles > at_once ? at_once * K::kCluster : tiles * K::kCluster;
}

template <int C, bool LN, bool kBf16>
cudaError_t launch_tile(const void* x, const float* gamma, const float* beta,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const float* ls2, void* out, float* work, long long M, int H,
                        float eps, cudaStream_t stream) {
  using K = Cfg<C, kBf16>;
  using T = typename std::conditional<kBf16, bf16, float>::type;
  int resident = 0;
  cudaError_t err = configure<C, LN, kBf16>(&resident);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(grid_of<C, kBf16>(M, resident));
  if constexpr (K::kPersistent) {  // the chunks come from the transposed copies
    if (work == nullptr) return cudaErrorInvalidValue;
    mlp_f32_stage_weights_kernel<<<H / 32 * (C / 32) * 2, 256, 0, stream>>>(
        static_cast<const float*>(w1), static_cast<const float*>(w2), work, work + C * H, C, H,
        K::kSlice);
    w1 = work;
    w2 = work + C * H;
  }
  Launch<C, kBf16> l(blocks, stream);
  cudaLaunchKernelEx(&l.cfg, kernel_of<C, LN, kBf16>(), static_cast<const T*>(x), gamma, beta,
                     static_cast<const T*>(w1), static_cast<const T*>(b1),
                     static_cast<const T*>(w2), static_cast<const T*>(b2), ls2,
                     static_cast<T*>(out), M, H, eps);
  return cudaGetLastError();
}

// floats of workspace a launch needs: the transposed weights of the f32
// tiles, else none
inline long long workspace(int dtype, int C, int H) {
  return dtype == 0 && (C == 64 || C == 128 || C == 256 || C == 512) ? 2LL * C * H : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w1, b1, w2, b2, out); gamma, beta and
// ls2 are float32 (read only with LN on). All tensors contiguous and 16-byte
// aligned; x and out are (M, C), w1 is (H, C), w2 is (C, H), with C in
// {64, 128, 256, 512} and H a multiple of 64 up to 2048; work holds
// workspace(dtype, C, H) floats (null where that is 0).
template <bool LN>
cudaError_t launch(int dtype, const void* x, const void* gamma, const void* beta,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* ls2, void* out, void* work, long long M, int C, int H,
                   float eps, void* stream) {
  if (M < 1 || H < kChunkTc || H > 2048 || H % kChunkTc != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* ls = static_cast<const float*>(ls2);
  float* wk = static_cast<float*>(work);
#define KASF_TILE_CASE(CC)                                                                 \
  case CC:                                                                                 \
    return dtype == 0                                                                      \
               ? launch_tile<CC, LN, false>(x, g, be, w1, b1, w2, b2, ls, out, wk, M, H, eps, s) \
               : launch_tile<CC, LN, true>(x, g, be, w1, b1, w2, b2, ls, out, wk, M, H, eps, s);
  switch (C) {
    KASF_TILE_CASE(64)
    KASF_TILE_CASE(128)
    KASF_TILE_CASE(256)
    KASF_TILE_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef KASF_TILE_CASE
}

template <int C, bool LN, bool kBf16>
void describe(long long M, int* info) {
  using K = Cfg<C, kBf16>;
  cudaFuncAttributes attr{};
  int resident = 0, per_sm = 0;
  const auto kernel = kernel_of<C, LN, kBf16>();
  if (configure<C, LN, kBf16>(&resident) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::kThreads, K::kSmem) !=
          cudaSuccess)
    return;
  info[0] = K::kThreads;
  info[1] = K::kRows;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(K::kSmem);
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = per_sm;
  info[6] = static_cast<int>(grid_of<C, kBf16>(M, resident));
  info[7] = K::kCluster;
  info[8] = resident;
}

// The instantiation for (dtype, C) on the current device, for reports:
// info = {threads a block, rows a tile, registers a thread, dynamic shared
// memory a block in bytes, local memory (spills) a thread in bytes, blocks
// a SM holds, blocks of a launch over M rows, blocks a cluster (a tile),
// blocks the device holds at once}. Left untouched for a width or dtype
// there is none of.
template <bool LN>
void describe_width(int dtype, int C, long long M, int* info) {
  switch (dtype * 1000 + C) {
    case 64: describe<64, LN, false>(M, info); break;
    case 128: describe<128, LN, false>(M, info); break;
    case 256: describe<256, LN, false>(M, info); break;
    case 512: describe<512, LN, false>(M, info); break;
    case 1064: describe<64, LN, true>(M, info); break;
    case 1128: describe<128, LN, true>(M, info); break;
    case 1256: describe<256, LN, true>(M, info); break;
    case 1512: describe<512, LN, true>(M, info); break;
    default: break;
  }
}

}  // namespace kasf_tile
