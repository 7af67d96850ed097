// K4: LayerNorm-folded MLP tail backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/mlp.py:_mlp_ln_bwd_kernel
// (wrapper fused_mlp_ln_bwd_pallas, VJP _fused_mlp_ln_bwd). The forward (K3)
// is, over M token rows of width C (64, 128, 256 or 512) and a hidden width H:
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
// bitwise equal. In f32, and in bf16 at C = 64, 256 and 512, inputs are
// staged in f32 and every product accumulates in f32: on the CUDA cores, or
// at C = 64 in the weight pass on the tensor cores in 3xTF32 (2c.): one
// TF32 product keeps ~3 digits and would break the 1e-4 the gradients are
// held to, but each operand split as hi + lo = tf32(x) + tf32(x - hi) and
// the three products hi hi + hi lo + lo hi summed in f32 are good to ~2^-20
// relative, near f32 FMAs' 2^-24, two orders under that limit; only dx is
// rounded to the input dtype there. In bf16 at C = 128 (the flagship's
// width, and the JAX package's bench trains in bf16) both passes run on the
// tensor cores (4.): mma.sync m16n8k16 on bf16 operands into f32
// accumulators, with a = LN(x) * gamma + beta, h = GELU(z), do = g * ls2
// and dz rounded to bf16 where the TPU kernel's bf16 path rounds them, as
// the plain version in bf16 does (it is held to that, 1e-2; dW2 = ls2 G
// with G = g^T h from g as it is, where the TPU kernel takes h^T do from
// the rounded do: a difference of do's rounding, <= 2^-8 of dW2's largest
// entry, and so db2 = ls2 sum g). So bf16 at C = 128 rounds four operands
// that bf16 at the other widths keeps in f32. Tail rows of a ragged M are
// loaded as zeros; their g is zero, so dh, dz and every contribution of
// theirs vanish.
//
// Widths. Each launch is a template on C, instantiated at 64
// (MotionAGFormer-XS and hierarchical), 128 (the flagship), 256 (DSTFormer)
// and 512 (MixSTE); the numbers below are C = 128's, whose instantiations
// compute bit for bit what they did before the template.
//  * dx pass: at C = 128 one block a 112-row tile (1.); at 256 and 512 a
//    thread-block cluster of two blocks a tile, each over half the channels,
//    after a stage launch that lays the weights out for it (1b.). At C = 64
//    one block a 112-row tile too, as two warp groups over hidden halves
//    (1c.): C = 128's block there ran half the work per thread (da 7 x 4,
//    fc1 and dh over 64 channels) between the same three block barriers a
//    chunk, 42 % of its bound.
//  * weight pass: at C = 128 one block per (hidden chunk of 64, row split),
//    40-row tiles (2.); at 256 and 512 a thread-block cluster of two blocks
//    per (chunk, split), each over half the channels, chunks of 64 and 32
//    columns and tiles of 48 and 32 rows (2b.). Either way dW1c and G_c are
//    8,192 floats a block, 64 registers a thread, and 128 blocks at the
//    models' H. At C = 64 one block per (chunk of 128 columns, so H a
//    multiple of 128, row split), 56-row tiles, 2 x 66 blocks at H = 256,
//    its four products on the tensor cores in 3xTF32 (2c.): the C = 128
//    block's layouts there issued FFMAs at about two thirds of the pipe's
//    rate.
//  * reduce: channel blocks as before; a hidden block's 8 dW1 rows are
//    C / 128 float4s a thread (at C = 64 half a float4: threads 128-255 of
//    warps 0-7 idle, the block's 128 float4s one a thread); the dx chains
//    read partials of C channels.
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
//       (2 x 17,920 B); mean and rstd a row (896 B); then the weights: a
//       ring of two stages, each W1 rows j0..j0+31 (stride C + 4),
//       W2[:, j0..j0+31] and b1[j0..j0+31] (33,408 B): 221,824 B. (The bf16
//       chunk layouts below, dxp::Cfg's, are the C = 64 pass's, 1c.; bf16
//       at C = 128 is the tensor-core pass, 4a.: in bf16 a bf16 stage and
//       two widened W1 chunks with their b1 and one widened W2 chunk.)
//     - The ring: each chunk is copied raw with 16-byte cp.async.cg, so no
//       synchronous global load stays in the hidden loop; ls2 is folded into
//       g when the tile is staged (do = g * ls2), so W2 is copied raw:
//       chunk j+1 is issued at the barrier that opens chunk j and lands
//       while chunk j is multiplied. (In bf16 at C = 64 chunk j+1 lands in
//       the bf16 stage during chunk j's products and is widened to f32
//       during chunk j's dz step, so the products read f32 and wait for
//       nothing.)
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
//  1b. at C = 256 and 512: the stage launch (mlp_ln_bwd_stage_kernel) writes
//     W1 and W2^T in f32 into the workspace as channel halves, [2][H][C/2 +
//     4] each (rows padded as the chunk buffers are; W2 transposed through
//     shared memory, bf16 widened; in bf16 also b1), so that a block's slice
//     of a hidden chunk of either is one contiguous run: one bulk copy (the
//     weight pass reads them too, 2b.). Then the dx pass
//     (mlp_ln_bwd_dx_cluster_kernel): a cluster of two blocks
//     takes a tile, block b the channels CS b .. CS b + CS - 1 (CS = C / 2):
//     112 rows of 128 channels a block at C = 256 (the C = 128 block's rows x
//     channels), 56 of 256 at 512, so da's 7 x 8 register tile a thread
//     (56 accumulators over the whole hidden width) carries over. Clusters
//     are persistent, as many as the card holds (cudaOccupancyMax-
//     ActiveClusters: 66 of two, every SM), each walking the tiles clusterid,
//     + nclusterid, ...: at M = 14,688, 132 tiles (2.00 waves) at 256 and
//     263 (3.98) at 512. (Not four blocks of 128 channels: the card holds
//     only 30 clusters of four, and K3's such layout ran 22-35 % slower.)
//     - Rows: each block stages its slice of the tile, aS = LN(x) * gamma +
//       beta and dS = g * ls2; LN's row sums, then their squared deviations,
//       are summed across the cluster in rank order through DSMEM
//       (kasf_mma::cluster_row_sums, K3's exchange), so both blocks get the
//       same bits; the rows' mean and rstd stay for the epilogue. The next
//       tile's rows are prefetched into L2 (half a block).
//     - Hidden chunks of 32 columns, block b finishing columns 16b..16b+15.
//       fc1 and dh run one register layout, 7 rows x 4 columns (p + 8u) a
//       thread over a kKS-th of the block's channels (kKS = 2, 4 lanes,
//       whose float4s fall on distinct banks); a fixed tree of shuffles
//       reduce-scatters the kKS lanes' partial sums, leaving each lane one
//       column of its rows at C = 512 and two (one a block) at 256. A lane
//       sends the other block's column (partial z, dh over this block's
//       channels) by st.async into that block's recv, completing bytes on
//       its mbarrier, and keeps its own; dh of the next chunk runs while
//       they travel. The owner adds the two partials in rank order, b1, and
//       forms dz = dh GELU'(z) once per hidden value in the cluster (at 512
//       it hands half its rows to the lane s ^ 4 beside it, so no lane takes
//       more than 4). After a block barrier each block sends its 16 dz
//       columns into the other's zS by st.async (float4s) and runs da += dz
//       W1 over its own columns while the other's arrive, then over those.
//       No cluster barrier or release fence sits in the chunk loop (K3 found
//       them ~1k cycles an arrive); two block barriers a chunk.
//     - Weights: W1 in two chunk buffers, W2^T in one, each chunk by one
//       bulk copy on the buffer's mbarrier (threads 0 and 32 issue them):
//       W2^T(n + 2) after the barrier that follows dh(n + 1), W1(n + 2) after
//       the one that closes chunk n, the chunk index running on across
//       tiles. (32 row copies from one warp's lanes stalled it ~2.9k cycles
//       a chunk; 16-byte cp.async from every thread cost ~1.6k.)
//     - Shared memory a block (floats): aS, dS R x (CS + 4), the W1 chunks
//       2 x 32 x (CS + 4), W2^T 32 x (CS + 4), zS R x 32, recv R x 16 float2
//       (also dx's row sums in the epilogue), mean and rstd, LN's exchange
//       slots, five mbarriers: 203,944 B at C = 256, 232,040 at 512 (of
//       232,448). 236 and 254 registers a thread, no spill.
//     - Epilogue: dx needs the row means of da * gamma and da * gamma * xhat
//       over all C channels: each block's share goes to both blocks (DSMEM,
//       one cluster barrier a tile), added in rank order; each block writes
//       dx and its channels of the tile's partial sums (da * xhat, da, g; its
//       row groups in a fixed order) into the (tile, 3, C) partials the
//       reduce reads, one a tile whichever cluster ran it: reruns are
//       bitwise equal, no atomics. Tail rows (>= M) are zeros in both blocks.
//     - A chunk at M = 14,688, C/H 512/1024 (scripts/k4_dx_stamps.py on an
//       H100 80GB HBM3 at 700 W): ~21k cycles a block, of which fc1 ~6.7k
//       and dh ~6.4k (3,584 of FMA issue each at the pipe's full rate), da
//       ~5.2k, dz ~0.6k, the two exchange waits ~0.35k; 51 % of the pass's
//       6*M*C*H bound (55-56 % at 256/1024).
//  1c. at C = 64 (mlp_ln_bwd_dx_wg_kernel): one block of 256 threads a 112-row
//     tile, one block a SM (198 KB of shared memory), ceil(M / 112) blocks
//     (132 at M = 14,688, one wave). All 256 threads stage the tile's rows
//     (aS = LN(x) * gamma + beta, dS = g * ls2; a half warp a row); then
//     warp group g (threads 128 g ..) takes hidden columns g H / 2 ..
//     (g + 1) H / 2 - 1 in chunks of 32 and does all of a chunk's work itself:
//     fc1 and dh in the one-block pass's 7 x 4 layouts (in one loop over the
//     channels, dxg::fc1_dh), dz = dh GELU'(z), and da += dz W1c as 7
//     rows x 8 channels a thread (8 W1 + 7 dz float4s per 224 FMAs, as at C =
//     128, where the one-block layout gave 7 x 4 here). Each group has its
//     own zS, hS and cp.async ring (the one-block pass's chunk layouts, two
//     f32 stages, or in bf16 two widened W1 chunks, a widened W2 chunk and a
//     bf16 stage) and synchronises on its own named barrier (bar.sync 1 + g,
//     128), three a chunk instead of three block barriers. The two halves of
//     da meet once: after a block barrier group 0 writes its da into aS and
//     group 1 into dS, and after another every thread adds aS + dS (one
//     order, so reruns are bitwise equal) for the one-block pass's epilogue
//     layout at C = 64 (16 lanes a row, 4 channels each) and runs that
//     epilogue (dxp::dx_epilogue), its sums through group 0's zS. The
//     partials keep the (tile, 3, C) layout. 0.0496 ms at M = 14,688 in
//     f32, 43.5 % of its 6*M*C*H bound of 0.0216 ms (bf16 0.0484;
//     chip_smoke.py phase 7 on an H100 80GB HBM3 at 700 W).
//     - dz takes GELU' with erf by Abramowitz and Stegun 7.1.26 (|error| <=
//       1.5e-7, dxg::gelu_grad): with erff and expf the dz step was ~13 % of
//       a tile (scripts/k4_dx_stamps.py --c 64).
//     - What bounds it: the two groups run their chunks in step, each
//       scheduler one warp of each; group 0 alone over all of H (one warp a
//       scheduler) is only ~20 % slower than both groups over half each, so
//       the schedulers' issue, not a wait, sets the pace
//       (scripts/k4_dx_variants.py). Taking the groups out of step, dz in
//       registers (fc1 and dh on one layout, W2 permuted), the next chunk's
//       copies issued later and unrolling by 1 or 4 measured no faster.
//  2. weight pass at C = 128 (mlp_ln_bwd_w_kernel): one block per (hidden
//     chunk of 64, row split); the split's 40-row tiles in order; per tile a = LN(x) *
//     gamma + beta, z = a W1c^T + b1c, dh = g (ls2 * W2c), dz = dh * GELU'(z)
//     and h = GELU(z) recomputed, and dW1c += dz^T a, G_c += g^T h and db1c
//     += dz accumulated in registers over all of the split's tiles, then
//     written to the workspace as the split's partial. 8*M*C*H FLOP: 7.70
//     GFLOP at M = 14,688, H = 512, bound 0.1149 ms at 67 TFLOP/s.
//     - Grid: H / 64 chunks x splits, splits = min(tiles, 132 / chunks): 8 x
//       16 = 128 blocks at H = 512 on the 132 SMs, one block a SM (4 SMs
//       idle, 3 %: 132 blocks need a chunk count that divides 132, and a
//       chunk of 128 needs 128 accumulators a thread). A split takes
//       ceil(tiles / splits) consecutive tiles (trailing splits may be empty
//       and write zeros). 40-row tiles: 368 at M = 14,688, exactly 23 a
//       split, 920 rows a block against the ideal 918 (48-row tiles give 20
//       of 960; 64-row ones do not fit beside the stage).
//     - Shared memory (floats): aS = LN(x) * gamma + beta and gS = g,
//       row-major at a stride of C + 4 (2 x 21,120 B); zS, hS and the second
//       channel half's zS2, hS2, 40 x (64 + 8) (4 x 11,520 B); the chunk's
//       W1^T and ls2 * W2, both channel-major [c][j] (2 x 32,768 B), and b1,
//       staged and widened once a block; a raw stage of the next tile's x
//       and g rows in the input dtype (40,960 B in f32, 20,480 in bf16) and
//       its mbarrier: 195,080 B in f32, 174,600 in bf16.
//     - Row staging off the critical path: one thread copies tile t+1's x
//       and g rows (two contiguous runs) into the stage with two bulk copies
//       (cp.async.bulk on the TMA engine, completing on an mbarrier) while
//       tile t is multiplied. 16-byte cp.async (2,560 a tile in f32) cost
//       ~600 cycles a tile in whichever phase issued them, and 20-36 more
//       registers a thread. At the top of a tile each warp normalises five
//       rows from the stage (lane l holds channels 4l..4l+3, gamma and beta
//       in registers; the five rows' shuffle sums interleaved, rsqrtf) into
//       aS and widens g into gS; rows >= M are zeros (a = beta, g = 0), so
//       their dz and g vanish. Each of a split's 8 chunk blocks reads its
//       rows once, from L2.
//     - fc1 and dh each split their 128 channels over two warp pairs
//       (warps 0-1 | 2-3 fc1, 4-5 | 6-7 dh), so a thread holds 5 rows x 8
//       hidden columns: 8 weight and 5 a (or g) float4s per 160 FMAs (12.3
//       FMAs a load; 5 x 4 over all channels gave 8.9 and took ~9.4k cycles
//       a tile where this takes ~8.1k). W1 is staged transposed, like ls2 *
//       W2, so one function serves both (fc1 reading W1 row-major paired
//       a.k with w.k, both from float4s in one register bank, and ran ~15 %
//       behind dh). A four-way split with 8 x 8 tiles at 32 rows (16 FMAs a
//       load) gave the same cycles a row: the products issue FMAs at 63-75 %
//       of the pipe's rate, not bound by shared loads.
//       z = zS + zS2 + b1 and dh = hS + hS2; then every thread takes 10
//       elements, h and dz from one erff and one expf each (gelu_and_grad),
//       and sums its dz into db1; then warps 0-3 accumulate dW1c (8 hidden x
//       8 channels a thread) and warps 4-7 G_c (8 channels x 8 hidden), each
//       reading 4 float4s per row for 64 FMAs (16) into 64 registers kept
//       over the whole split. Four barriers a tile; float4 loads touch 4 or
//       8 distinct rows, or neighbouring float4s of one row, so no shared
//       bank conflicts and no transposed store.
//     - Epilogue: float4 stores of dW1c and G_c; db1c summed over the 8 row
//       groups in order.
//  2b. at C = 256 and 512 (mlp_ln_bwd_w_cluster_kernel): a cluster of two
//     blocks per (hidden chunk, row split), launched with cudaLaunchKernelEx
//     and a cluster dimension; block b takes the channels CS b .. CS b + CS
//     - 1 (CS = C / 2) of the split's tiles. Its dW1c (kJ x CS) and G_c (CS x
//     kJ) stay 8,192 floats, so its chunk is kJ = 8192 / CS: 64 columns at
//     C = 256 (the C = 128 block's tile, 128 channels x 64 columns), 32 at
//     512, twice the one-block chunks at those widths before, so each block
//     stages and normalises half the rows per FLOP. Grid: H / kJ chunks x
//     splits clusters, splits = min(tiles, 132 / (2 H / kJ)): 16 x 4 at C/H
//     256/1024 and 32 x 2 at 512/1024, 128 blocks, one wave (the card holds
//     66 clusters of two). 8*M*C*H FLOP: 0.4597 ms at 256/1024, 0.9195 at
//     512/1024 (M = 14,688, 67 TFLOP/s).
//     - Rows: the block's half of a tile's x and g rows by two tensor copies
//       (cp.async.bulk.tensor, one strided box each, from tensor maps the
//       launcher encodes: rows past M land as zeros), the next tile's in
//       flight. Tiles of 48 rows at 256, 32 at 512, from the shared-memory
//       budget (about 217 KB a block in f32, of 232,448 B). In f32 at 512,
//       dh and G_c read g where its tensor copy lands (two buffers, the
//       tiles in turn, in gS's room), so staging copies half the bytes
//       (3.5 % faster there). LN's statistics
//       span all C channels: each block sums its half of a row, then the
//       squared deviations from the half's mean (kLR = 16 or 8 lanes a row,
//       so 4 or 3 shuffles a sum), and sends the pair to the other block by
//       st.async, and widens g while the pairs travel; both combine the
//       halves in rank order (the variance of two equal groups), so both
//       hold the same bits. (kasf_mma::cluster_row_sums, K3's and the dx
//       pass's exchange, takes two cluster barriers a tile: ~1k cycles an
//       arrive against a ~17k-cycle tile here. Taking the next tile's sums
//       a tile ahead, off the tile's critical path, measured no faster.)
//     - Weights: the chunk's W1 and W2^T rows over the block's channels, by
//       two bulk copies from the stage launch's slices (1b.), once a block;
//       ls2 folded into W2^T in place.
//     - fc1 (warps 0-3) and dh (warps 4-7) over the block's channels for
//       all kJ columns, one register layout: lane (s, p, q) takes rows q + 8
//       i, columns p + kPG u (u < 8) and a kKS-th of the channels (kKS = 2,
//       4 lanes), 6 x 8 and 4 x 8 outputs, a step 8 W and kRT X float4s for
//       32 kRT FMAs; a fixed tree of shuffles reduce-scatters the kKS lanes'
//       partial sums, leaving each lane kE columns of each block's half. A
//       lane keeps its own block's (`own`) and sends the other block's by
//       st.async into that block's recv, on its mbarrier.
//     - The owner of a column adds the two blocks' partial z (b1 after) and
//       dh in rank order and forms h = GELU(z) and dz = dh GELU'(z) once per
//       hidden value in the cluster (db1 summed there); it writes both into
//       its hS, dzS and sends them into the other block's.
//     - Outer products as at C = 128 (outer_tile, here unrolled by 8):
//       warps 0-3 dW1c += dz^T a, warps 4-7 G_c += g^T h, over the block's
//       channels and the whole chunk, in registers over the split.
//     - No cluster barrier sits in the tile loop: every exchange completes
//       bytes on the receiver's mbarrier. Four block barriers a tile.
//     - Epilogue: each block writes its channels of the split's partial
//       (dW1 rows, G columns) and db1 of its columns, in the C = 128 layout,
//       so the reduce reads one partial a split as before; no atomics.
//     - A tile's cycles by phase: scripts/k4_w_stamps.py.
//     Registers, spills and blocks a SM of both passes: kasf_mlp_ln_bwd_info
//     and chip_smoke.py phase 7's report (a spill in either fails it); each
//     launch's device time and share of its own bound: phase 7's profile.
//  2c. at C = 64 (mlp_ln_bwd_w_tc_kernel): wp::Cfg<64>'s grid, tiles and
//     partials (2 x 66 blocks at H = 256 and M = 14,688, 4 tiles of 56 rows
//     a split, so the reduce is C = 128's), its four products on mma.sync
//     m16n8k8 with TF32 operands in 3xTF32: each f32 operand x split once
//     into hi = tf32(x) and lo = x - hi cut to TF32, then lo hi + hi lo + hi
//     hi into f32 accumulators (kasf_mma::mma_tf32x3), 3 x 8*M*C*H FLOP of
//     TF32 against 8*M*C*H of f32 FFMA: a bound of 0.0117 ms at 495 TFLOP/s
//     against 0.0287 at 67. (The C = 128 block's layouts, here 0.0588 ms,
//     issued FFMAs at about two thirds of the pipe's rate, as the C = 64 dx
//     pass's did: two warps a scheduler; its tile's products took 20k of
//     25.4k cycles, scripts/k4_w_stamps.py.)
//     - Orientation: the chunk's 128 hidden columns are the mma's M side,
//       16 a warp (warp w columns 16 w ..). z^T = W1c a^T and dh^T = (ls2
//       W2c)^T g^T take K = the 64 channels (8 k8 steps, k-slots t and t + 4
//       on channels 8k + 2t and 8k + 2t + 1) and N = the tile's 56 rows (7
//       n8 steps); dW1c += dz^T a and G_c^T += h^T g take K = the rows and
//       N = the channels. An n-tile of z^T's accumulators is the A fragment
//       of a k8 step over its 8 rows (k-slot t row 2t, slot t + 4 row 2t +
//       1), so h = GELU(z + b1), dz = dh GELU'(z + b1) and db1 are taken in
//       the registers that hold z^T and dh^T, split there and never stored.
//     - Operands laid out as the mma reads them, so no register has to be
//       moved into a fragment: the tile's a = LN(x) gamma + beta and g as
//       planes of 16-byte units (hi, hi, lo, lo) of two neighbouring
//       channels, one unit a products 1-2 B fragment's hi and lo pairs (in
//       3-4 the two rows of a B fragment come from two units); the chunk's
//       W1c and (ls2 W2c)^T as the A fragments themselves, a warp's 32
//       fragments of a k8 step 512 contiguous bytes of hi and of lo. (With
//       (hi, lo) float2 elements the fragments took ~2.5k register moves a
//       warp a tile against 672 mma, and the pass 0.0553 ms.) The planes'
//       units are swizzled so every fragment load of a quarter warp falls
//       on 8 distinct bank groups.
//     - Weights: warp 1 copies W1c (one run) and W2c (a run a channel) raw
//       into the ends of their fragments' room by bulk copies on an
//       mbarrier, issued with tile 0's rows, so they land under tile 0's
//       LayerNorm; every thread then reads its share of a matrix, a block
//       barrier, and the split fragments overwrite the raw rows (splitting
//       W1c while W2c still lands, on an mbarrier of its own, measured no
//       faster).
//     - A tile: the rows' wait, LN and the split planes, a block barrier
//       (thread 0 issues the next tile's rows into the stage), z^T and dh^T
//       (2 x 168 mma a warp), GELU (erf by Abramowitz and Stegun, as the dx
//       pass's dz), dW1c and G_c^T (2 x 168), a block barrier. dW1c and G_c^T
//       stay in 64 accumulator registers a thread over the split.
//     - Shared memory: planes 2 x 56 rows of 128 floats, fragments 4 x 8,192
//       floats, the raw stage of 2 x 56 rows, two mbarriers: 217,104 B in
//       f32, 202,768 in bf16 (both dtypes widen to f32 before the split, so
//       one path).
//     - Epilogue: float4 stores of dW1c rows, G_c columns; db1 over the four
//       lanes of a column in a fixed order: reruns are bitwise equal.
//  3. reduce (mlp_ln_bwd_reduce_kernel): sum the partials in a fixed order
//     (the dx pass's per tile, the weight pass's per split) and finish
//     dgamma, dbeta, dW1, db1, dW2, db2 and dls2. Bound by bytes: 9.4 MB at
//     M = 14,688, H = 512 (132 dx partials of 1.5 KB, 16 weight partials of
//     526 KB, W2, the gradients), 0.0028 ms at 3.35 TB/s. Every output is one
//     sum in index order from +0 (splits s = 0.., tiles n = 0..), so dW1,
//     db1, dW2, dgamma, dbeta and db2 are bitwise those of a plain loop
//     `acc = acc + part[s]`; only dls2's sum over j is grouped otherwise.
//     - Grid: one wave of 288-thread blocks. In each, warps 0-7 take a
//       float4 of a split's partial a thread: channel blocks 1024 / H rows
//       of G (two at H = 512, at most 8, one row at H >= 1024), hidden
//       blocks 8 rows of dW1; 64 + 64 = 128 blocks at H = 512. A thread's
//       loads of 16 splits come before their adds with no branch between
//       (past the last split a load repeats it, its add skipped); the
//       compiler keeps 6-8 of them in flight ahead of the adds in 56
//       registers, and a budget that holds all 16 (124 registers) measured
//       slower. float4 stores. (The first design, one thread a channel
//       walking the 132 x 3 dx partials alone, took 0.0125 ms.)
//     - Warp 8 of a channel block sums its 3 x rows dx chains (dgamma,
//       dbeta and g's sum for db2 and dls2), a lane each over the tiles in
//       order, while warps 0-7 sum G: all 288 threads copy the chains'
//       partials into a stage by 4-byte cp.async, chain-major so a lane
//       reads float4s, and arrive on an mbarrier as their copies land;
//       warp 8 alone refills the stage (16 KB: 680 tiles at H = 512).
//       Warp 8 of a hidden block sums its 8 rows' db1 as two float4s.
//     - dls2 = sum_j W2 * G + b2 * sum g: each G float4's share of the
//       row's dot product goes to shared memory; after a barrier one warp a
//       row sums the shares in a fixed order and adds b2 times warp 8's sum
//       of g. Reruns are bitwise equal.
//     - At C = 64 (mlp_ln_bwd_reduce_seg_kernel, namespace rds) the grid
//       above made 48 blocks at H = 256 (16 channel blocks, 32 hidden blocks
//       with half their item threads idle) for 8,192 float4 chains 66
//       splits deep: 16 loads in flight a thread, five rounds of a load's
//       latency, 0.0077 ms (35 % of its bound on an H100 80GB HBM3 at
//       700 W). There each of 132 blocks owns one segment of a split's
//       partial (a G row of H floats, H / 64 rows of dW1, or a quarter of
//       db1), so the SMs bring equal bytes, and brings that segment of
//       every split into shared memory at once by bulk copies, eight splits
//       an mbarrier (n_w H <= 132 x 128 floats, at most 66 KB, by the
//       weight pass's split rule), so the launch's bytes are all in flight
//       from its start; warps 0-3 sum two floats a thread in index order
//       from +0 as the groups land, warp 4 of a G block the channel's dx
//       chains as warp 8 does above: 0.0047-0.0051 ms on the same card,
//       the copies alone 0.0041. (Segments of 128 floats of dW1 and db1,
//       194 blocks, 1.5 a SM, some SMs twice the bytes of others, took
//       0.0061 ms.)
//     - At C = 512 (mlp_ln_bwd_reduce_wide_kernel, namespace rdw) the grid
//       above made 640 blocks at H = 1024 (512 one-row channel blocks with
//       two splits to sum a thread, their dx chains staged 4 bytes at a
//       time; 128 hidden blocks): 0.0107 ms (45 % of its 0.0049 bound on
//       an H100 80GB HBM3 at 700 W). There 128 blocks each own an equal
//       share: four G rows (and their channels' dx chains), 4 H floats of
//       dW1 and H / 128 of db1, brought with the block's W2 rows by bulk
//       copies, an mbarrier a split and part; warps 0-3 sum G, 4-7 dW1 and
//       db1, warp 8 copies its channels' dx partials 16 bytes a (tile,
//       quantity) and lanes 0-11 add the chains: 0.0077 ms in the K4 call
//       (0.0064-0.0065 alone; its copies alone 0.0062). Every output, dls2
//       included, is the C = 128 grid's bit for bit.
//     Registers, spills and blocks a SM: kasf_mlp_ln_bwd_info; the reduce
//     alone on a caller's workspace: kasf_mlp_ln_bwd_reduce.
//  4. bf16 at C = 128 on the tensor cores (namespaces mm, dxm, wpm). Bound:
//     10*M*C*H FLOP at 989 TFLOP/s dense bf16, 0.0097 ms a call at M =
//     14,688 and H = 512 (dx pass 6*M*C*H, 0.0058; weight pass 8*M*C*H,
//     0.0078); the products are no longer the pace-setters, so the design
//     keeps C = 128's tiles, grids and partials (the reduce is unchanged)
//     and moves every product onto mma.sync; what is left is shared-memory
//     traffic (ldmatrix), GELU' on M*H values a pass (erf by Abramowitz and
//     Stegun, as at C = 64; without it the dx pass takes 28 % less time and
//     the weight pass 12 %, scripts/k4_bf16_variants.py), and the barriers:
//     0.0428 and 0.0653 ms at M = 14,688 (14 % and 12 % of their bounds;
//     the CUDA-core passes before them 0.1672 and 0.2108), chip_smoke.py
//     phase 7 on an H100 80GB HBM3 at 700 W. Both passes stage a = bf16(LN(x) gamma + beta) and
//     do = bf16(g ls2) by one formula (mm::stage_rows), so they round alike;
//     bf16 rows are padded by 16 bytes so an ldmatrix's eight rows fall on
//     distinct banks.
//  4a. dx pass (mlp_ln_bwd_dx_mma_kernel): one block of 7 warps a 112-row
//     tile (dx_tiles and the partials as at 1.), a warp 16 rows; ~170 KB of
//     shared memory, one block a SM, 132 blocks at M = 14,688. Each warp
//     loads its rows' A fragments of a and do once (64 registers); hidden
//     chunks of 64 columns arrive through a three-stage cp.async ring (W1
//     rows, W2 columns, b1, raw bf16), one block barrier a chunk. For each
//     16 columns: z (16 mma) and dh (16 mma) into two accumulator sets, dz =
//     dh GELU'(z + b1) packed to bf16 is the A fragment of da += dz W1c (16
//     mma, W1c by ldmatrix.trans), so the hidden never leaves registers; da
//     (16 rows x 128 channels, 64 registers) is held over the whole hidden
//     width. Epilogue: a row's 128 channels lie on the four lanes of a quad,
//     so its two means take two shuffles; x and g re-read (L2); the tile's
//     sums over its rows by shuffles, then over the warps in order.
//  4b. weight pass (mlp_ln_bwd_w_mma_kernel): 2.'s grid of (hidden chunk of
//     64, row split) and its splits of 40-row tiles; a block walks its
//     split's rows in steps of 64 (a multiple of 16 for the k16 contraction
//     over rows; the last step ragged, its tail rows zeros), the next step's
//     x and g rows by two bulk copies into a raw stage while the step is
//     multiplied. A step: a, do and g staged in bf16; warp w takes z and dh
//     for rows 16 (w % 4) and columns 32 (w / 4) (W1c plain, W2c by
//     ldmatrix.trans), h = GELU(z + b1) and dz to shared memory in bf16, db1
//     from dz in f32; then warps 0-3 accumulate dW1c += dz^T a and warps 4-7
//     G_c^T += h^T g, 32 hidden x 64 channels a warp (64 registers over the
//     split), both transposed operands by ldmatrix.trans. Three barriers a
//     step; ~140 KB of shared memory, 128 blocks at H = 512.
#include <cuda.h>  // CUtensorMap and its encoder's signature (called through the runtime)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f)) +
         z * expf(-0.5f * z * z) * 0.39894228040143268f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v summed over the n neighbouring lanes of an aligned group (butterfly:
// every lane of the group holds the same sum, bitwise)
template <int n>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = n / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// each entry summed over the n neighbouring lanes of an aligned group
// (lanes xor 1, 2, ...; n = 1 leaves them)
template <int n, int R, int U>
__device__ __forceinline__ void lanes_sum(float (&v)[R][U]) {
#pragma unroll
  for (int off = 1; off < n; off <<= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) v[i][u] += __shfl_xor_sync(0xffffffffu, v[i][u], off);
}

// (a.x + a.y) + (a.z + a.w), and the same of the squares
__device__ __forceinline__ float quad_sum(float4 a) { return (a.x + a.y) + (a.z + a.w); }
__device__ __forceinline__ float quad_sq(float4 a) {
  return (a.x * a.x + a.y * a.y) + (a.z * a.z + a.w * a.w);
}

// ---- 1. dx pass: its own tile (the helpers above belong to every launch)
namespace dxp {

using bf16 = __nv_bfloat16;
using kasf_mma::cp_async16;

constexpr int kT = 256;  // threads a block: 8 warps

// The dx pass's one-block tile, at C = 64 and 128 (C = 256 and 512 take the
// cluster tile, dxc::Cfg): 112 rows and hidden chunks of 32 columns. At C =
// 64 the warp-group pass (dxg) takes its rows, chunk layouts, fc1 and dh
// layouts and epilogue from here.
template <int C>
struct Cfg {
  static_assert(C == 64 || C == 128, "the one-block widths");
  static constexpr int kR = 112;  // rows a tile
  static constexpr int kKC = 32;  // hidden columns a chunk
  // fc1 and dh (128 threads each): kKS neighbouring lanes split the
  // channels (float4 s, s + kKS, ...; one here) and sum by shuffles; a
  // thread holds kRT1 rows x 4 columns of the chunk
  static constexpr int kKS = 1;
  static constexpr int kCG1 = kKC / 4;                // column groups
  static constexpr int kRG1 = 128 / (kKS * kCG1);     // row groups: rows q + kRG1 i
  static constexpr int kRT1 = kR / kRG1;              // 7
  // da (256 threads): kCG lanes of a warp hold a row's C channels, kK
  // float4s each (channels 4p + 4 kCG k); kRG row groups of kRT rows
  static constexpr int kCG = 16;
  static constexpr int kK = C / (4 * kCG);             // 2
  static constexpr int kRG = kT / kCG;                 // 16
  static constexpr int kRT = kR / kRG;                 // 7
  // staging: a warp's rows w, w + 8, ..., kBatch lane groups' rows at a
  // time; kLanes lanes hold a row (all 32 at C = 128, a half warp at 64),
  // lane l the float4s 4 (l % kLanes) + 128 q of its row
  static constexpr int kLanes = C / 4 < 32 ? C / 4 : 32;
  static constexpr int kSub = 32 / kLanes;             // rows a warp stages at once
  static constexpr int kQ = C < 128 ? 1 : C / 128;
  static constexpr int kWarpRows = kR / (kT / 32);     // 14
  static constexpr int kBatch = 7;
  static constexpr int kLdA = C + 4;     // aS, dS rows: LN(x) * gamma + beta, g * ls2
  static constexpr int kLdZ = kKC + 8;   // zS, hS rows: z + b1 (then dz), dh
  static constexpr int kLdW1 = C + 4;    // W1 chunk rows in f32, as in memory
  static constexpr int kLdW1h = C + 8;   // W1 chunk rows in bf16
  // a chunk in f32 (floats): W1 rows | W2 columns (C rows of kKC) | b1
  static constexpr int kW1F = kKC * kLdW1, kW2F = C * kKC, kStageF = kW1F + kW2F + kKC;
  // a chunk in bf16 (elements), the same order
  static constexpr int kW1H = kKC * kLdW1h, kW2H = C * kKC, kStageH = kW1H + kW2H + kKC;
  // shared memory in floats: aS, dS | zS, hS | mean, rstd | ring. In f32 the
  // ring is two stages; in bf16 two widened W1 chunks (each with its b1), one
  // widened W2 chunk and one bf16 stage
  static constexpr int kOffZ = 2 * kR * kLdA;
  static constexpr int kOffStat = kOffZ + 2 * kR * kLdZ;
  static constexpr int kOffRing = kOffStat + 2 * kR;
  static constexpr int kW1B = kW1F + kKC;         // a widened W1 chunk and its b1
  static constexpr int kOffW2f = 2 * kW1B;        // from kOffRing
  static constexpr int kOffStageH = kOffW2f + kW2F;
  static_assert(kR % kRG == 0 && kRG1 * kRT1 == kR && kWarpRows % (kSub * kBatch) == 0 &&
                    kR % (kT / 32) == 0 && kKC * C % (8 * kT) == 0 && kKC % 8 == 0,
                "the threads divide the tile and the chunk evenly");
  static_assert(kOffStat % 4 == 0 && kOffRing % 4 == 0 && kStageF % 4 == 0 && kW1B % 4 == 0 &&
                    kOffStageH % 4 == 0 && kW1H % 8 == 0 && kW2H % 8 == 0,
                "16-byte alignment of the shared buffers");
  static_assert(kRG * 3 * C <= 2 * kR * kLdA, "the epilogue's sums fit in aS and dS");
};

// the f32 one-block pass's shared memory (C = 128)
template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (Cfg<C>::kOffRing + 2 * Cfg<C>::kStageF);
}

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
// ring stage, raw, in 16-byte pieces, by NT threads (tid < NT); one group
// (empty past the last chunk)
template <int C, int NT = kT>
__device__ __forceinline__ void fetch_chunk(float* st, const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b1, int j0, int H,
                                            int tid) {
  using K = Cfg<C>;
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < K::kKC * C / 4 / NT; ++i) {
      const int e = tid + i * NT, j = e / (C / 4), c4 = e % (C / 4);
      cp_async16(st + j * K::kLdW1 + c4 * 4, w1 + (j0 + j) * C + c4 * 4);
    }
#pragma unroll
    for (int i = 0; i < C * K::kKC / 4 / NT; ++i) {
      const int e = tid + i * NT, c = e / (K::kKC / 4), j4 = e % (K::kKC / 4);
      cp_async16(st + K::kW1F + c * K::kKC + j4 * 4, w2 + c * H + j0 + j4 * 4);
    }
    if (tid < K::kKC / 4) cp_async16(st + K::kW1F + K::kW2F + tid * 4, b1 + j0 + tid * 4);
  }
  kasf_mma::cp_async_commit();
}
template <int C, int NT = kT>
__device__ __forceinline__ void fetch_chunk(bf16* st, const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2,
                                            const bf16* __restrict__ b1, int j0, int H,
                                            int tid) {
  using K = Cfg<C>;
  if (j0 < H) {
#pragma unroll
    for (int i = 0; i < K::kKC * C / 8 / NT; ++i) {
      const int e = tid + i * NT, j = e / (C / 8), c8 = e % (C / 8);
      cp_async16(st + j * K::kLdW1h + c8 * 8, w1 + (j0 + j) * C + c8 * 8);
    }
#pragma unroll
    for (int i = 0; i < C * K::kKC / 8 / NT; ++i) {
      const int e = tid + i * NT, c = e / (K::kKC / 8), j8 = e % (K::kKC / 8);
      cp_async16(st + K::kW1H + c * K::kKC + j8 * 8, w2 + c * H + j0 + j8 * 8);
    }
    if (tid < K::kKC / 8) cp_async16(st + K::kW1H + K::kW2H + tid * 8, b1 + j0 + tid * 8);
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

// A landed bf16 chunk widened by NT threads (tid < NT): W1 rows to w1f (b1
// after them, at kW1F), W2 columns to w2f, in the f32 chunk's layouts
template <int C, int NT = kT>
__device__ __forceinline__ void widen_chunk(float* w1f, float* w2f, const bf16* st, int tid) {
  using K = Cfg<C>;
#pragma unroll
  for (int i = 0; i < K::kKC * C / 8 / NT; ++i) {
    const int e = tid + i * NT, j = e / (C / 8), c8 = e % (C / 8);
    widen8(w1f + j * K::kLdW1 + c8 * 8, st + j * K::kLdW1h + c8 * 8);
  }
#pragma unroll
  for (int i = 0; i < C * K::kKC / 8 / NT; ++i) {
    const int e = tid + i * NT;
    widen8(w2f + e * 8, st + K::kW1H + e * 8);
  }
  if (tid < K::kKC / 8) widen8(w1f + K::kW1F + tid * 8, st + K::kW1H + K::kW2H + tid * 8);
}

// Stage the tile: aS = LN(x) * gamma + beta, dS = g * ls2 (row-major), and
// each row's mean and rstd. Warp w takes rows w, w + 8, ...; lane l holds
// channels 4l..4l+3 (+ 128 q) at C >= 128; at C = 64 the half warp l / 16
// takes every other of those rows, lane l channels 4 (l % 16)... Tail rows
// (>= M) are zeros: a = beta, do = 0.
template <int C, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, const T* __restrict__ g,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ ls2, float* aS,
                                           float* dS, float* sMean, float* sRstd,
                                           long long row0, long long M, float eps, int warp,
                                           int lane) {
  using K = Cfg<C>;
  constexpr int kB = K::kBatch, kQ = K::kQ;  // rows of a lane's in flight together
  constexpr int kL = K::kLanes, kS = K::kSub;
  const int cl = lane % kL, sub = lane / kL;  // at C = 128: lane, 0
  float4 gm[kQ], bt[kQ], ls[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    gm[q] = ld4(gamma + 4 * cl + 128 * q);
    bt[q] = ld4(beta + 4 * cl + 128 * q);
    ls[q] = ld4(ls2 + 4 * cl + 128 * q);
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int h = 0; h < K::kWarpRows / (kS * kB); ++h) {
    float4 xv[kB][kQ], gv[kB][kQ];
#pragma unroll
    for (int i = 0; i < kB; ++i) {  // the loads of the batch's rows in flight together
      const long long row = row0 + warp + (kT / 32) * ((h * kB + i) * kS + sub);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        xv[i][q] = row < M ? load4(x + row * C + 4 * cl + 128 * q) : zero;
        gv[i][q] = row < M ? load4(g + row * C + 4 * cl + 128 * q) : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int r = warp + (kT / 32) * ((h * kB + i) * kS + sub);
      float s = quad_sum(xv[i][0]);
#pragma unroll
      for (int q = 1; q < kQ; ++q) s += quad_sum(xv[i][q]);
      const float mean = group_sum<kL>(s) * (1.0f / C);
      float4 xc[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = xv[i][q];
        xc[q] = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
      }
      float sq = quad_sq(xc[0]);
#pragma unroll
      for (int q = 1; q < kQ; ++q) sq += quad_sq(xc[q]);
      const float rstd = 1.0f / sqrtf(group_sum<kL>(sq) * (1.0f / C) + eps);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 c = xc[q], gmq = gm[q], btq = bt[q], lsq = ls[q], gq = gv[i][q];
        st4(aS + r * K::kLdA + 4 * cl + 128 * q,
            make_float4(fmaf(c.x * rstd, gmq.x, btq.x), fmaf(c.y * rstd, gmq.y, btq.y),
                        fmaf(c.z * rstd, gmq.z, btq.z), fmaf(c.w * rstd, gmq.w, btq.w)));
        st4(dS + r * K::kLdA + 4 * cl + 128 * q,
            make_float4(gq.x * lsq.x, gq.y * lsq.y, gq.z * lsq.z, gq.w * lsq.w));
      }
      if (cl == 0) {
        sMean[r] = mean;
        sRstd[r] = rstd;
      }
    }
  }
}

// fc1 of the chunk, z = a W1c^T + b1c, into zS. Thread (row group q,
// column group p, channel split s): rows q + kRG1 i, hidden columns
// p + kCG1 u (u < 4), channel float4s s, s + kKS, ...; each step reads 4 W1
// and kRT1 a float4s for 16 kRT1 FMAs. The kKS splits' sums meet by
// shuffles; the split lanes share the stores.
template <int C>
__device__ __forceinline__ void fc1_chunk(const float* aS, const float* w1c, const float* b1c,
                                          float* zS, int q, int p, int s) {
  using K = Cfg<C>;
  float acc[K::kRT1][4];
#pragma unroll
  for (int i = 0; i < K::kRT1; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll 2
  for (int t = 0; t < C / 4 / K::kKS; ++t) {
    const int c = 4 * (s + K::kKS * t);
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld4(w1c + (p + K::kCG1 * u) * K::kLdW1 + c);
#pragma unroll
    for (int i = 0; i < K::kRT1; ++i) {
      const float4 a = ld4(aS + (q + K::kRG1 * i) * K::kLdA + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][u] = fmaf(a.x, w[u].x, acc[i][u]);
        acc[i][u] = fmaf(a.y, w[u].y, acc[i][u]);
        acc[i][u] = fmaf(a.z, w[u].z, acc[i][u]);
        acc[i][u] = fmaf(a.w, w[u].w, acc[i][u]);
      }
    }
  }
  lanes_sum<K::kKS>(acc);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float bias = b1c[p + K::kCG1 * u];
#pragma unroll
    for (int i = 0; i < K::kRT1; ++i)
      if ((i * 4 + u) % K::kKS == s)
        zS[(q + K::kRG1 * i) * K::kLdZ + p + K::kCG1 * u] = acc[i][u] + bias;
  }
}

// dh of the chunk, dh = do W2c, into hS. Thread (q, p, s): rows q + kRG1 i,
// hidden columns 4p..4p+3, channel float4s s, s + kKS, ...; each step reads
// 4 W2 and kRT1 do float4s for 16 kRT1 FMAs.
template <int C>
__device__ __forceinline__ void dh_chunk(const float* dS, const float* w2c, float* hS, int q,
                                         int p, int s) {
  using K = Cfg<C>;
  float acc[K::kRT1][4];
#pragma unroll
  for (int i = 0; i < K::kRT1; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
#pragma unroll 2
  for (int t = 0; t < C / 4 / K::kKS; ++t) {
    const int c = 4 * (s + K::kKS * t);
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld4(w2c + (c + u) * K::kKC + 4 * p);
#pragma unroll
    for (int i = 0; i < K::kRT1; ++i) {
      const float4 d = ld4(dS + (q + K::kRG1 * i) * K::kLdA + c);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[i][v] = fmaf(d.x, lane4(w[0], v), acc[i][v]);
        acc[i][v] = fmaf(d.y, lane4(w[1], v), acc[i][v]);
        acc[i][v] = fmaf(d.z, lane4(w[2], v), acc[i][v]);
        acc[i][v] = fmaf(d.w, lane4(w[3], v), acc[i][v]);
      }
    }
  }
  lanes_sum<K::kKS>(acc);
#pragma unroll
  for (int i = 0; i < K::kRT1; ++i)
    if (i % K::kKS == s)
      st4(hS + (q + K::kRG1 * i) * K::kLdZ + 4 * p,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// da += dz W1c over the kKC hidden columns of a chunk (K: a tile's Cfg).
// Thread (row group q, channel group p of kCG): rows q + kRG i, channels
// 4p + 4 kCG k .. +3 (k < kK); each step of four hidden columns reads 4 kK
// W1 and kRT dz float4s for 16 kK kRT FMAs.
template <typename K>
__device__ __forceinline__ void da_chunk(const float* zS, const float* w1c,
                                         float (&da)[K::kRT][4 * K::kK], int q, int p) {
#pragma unroll 2
  for (int j = 0; j < K::kKC; j += 4) {
    float4 w[K::kK][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < K::kK; ++k)
        w[k][u] = ld4(w1c + (j + u) * K::kLdW1 + 4 * K::kCG * k + 4 * p);
#pragma unroll
    for (int i = 0; i < K::kRT; ++i) {
      const float4 d = ld4(zS + (q + K::kRG * i) * K::kLdZ + j);
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int k = 0; k < K::kK; ++k) {
          float& o = da[i][4 * k + v];
          o = fmaf(d.x, lane4(w[k][0], v), o);
          o = fmaf(d.y, lane4(w[k][1], v), o);
          o = fmaf(d.z, lane4(w[k][2], v), o);
          o = fmaf(d.w, lane4(w[k][3], v), o);
        }
    }
  }
}

// The tile's epilogue: dx per row, and the tile's partial sums of da *
// xhat, da and g per channel into part (block blockIdx.x's). Thread (row
// group q4, channel group p4) of K's layout holds da for rows q4 + kRG i and
// channels 4 p4 + 4 kCG k .. + 3; redS is kRG * 3 * C floats of shared
// memory that no thread reads any more.
template <typename K, int C, typename T>
__device__ __forceinline__ void dx_epilogue(const float (&da)[K::kRT][4 * K::kK],
                                            const T* __restrict__ x, const T* __restrict__ g,
                                            const float* __restrict__ gamma,
                                            const float* sMean, const float* sRstd, float* redS,
                                            T* __restrict__ dx, float* __restrict__ part,
                                            long long row0, long long M, int q4, int p4,
                                            int tid) {
  // ---- dx per row (the kCG lanes of a row group hold the row's C channels)
  // and the thread's sums of da * xhat, da and g over its valid rows
  constexpr int kE = 4 * K::kK;  // channels a thread: 4p + 4 kCG k + v
  float gam[kE];
#pragma unroll
  for (int k = 0; k < K::kK; ++k) {
    const float4 gk = ld4(gamma + 4 * K::kCG * k + 4 * p4);
    gam[4 * k] = gk.x;
    gam[4 * k + 1] = gk.y;
    gam[4 * k + 2] = gk.z;
    gam[4 * k + 3] = gk.w;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float sx[kE], sd[kE], sg[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) sx[k] = sd[k] = sg[k] = 0.f;
#pragma unroll
  for (int i = 0; i < K::kRT; ++i) {
    const int r = q4 + K::kRG * i;
    const long long row = row0 + r;
    const bool valid = row < M;
    const float mean = sMean[r], rstd = sRstd[r];
    const T* xr = x + row * C + 4 * p4;
    const T* gr = g + row * C + 4 * p4;
    float4 xa[K::kK], ga[K::kK];  // x's float4s, then g's
#pragma unroll
    for (int k = 0; k < K::kK; ++k) xa[k] = valid ? load4(xr + 4 * K::kCG * k) : zero;
#pragma unroll
    for (int k = 0; k < K::kK; ++k) ga[k] = valid ? load4(gr + 4 * K::kCG * k) : zero;
    float xv[kE], gv[kE];
#pragma unroll
    for (int k = 0; k < K::kK; ++k) {
      xv[4 * k] = xa[k].x;
      xv[4 * k + 1] = xa[k].y;
      xv[4 * k + 2] = xa[k].z;
      xv[4 * k + 3] = xa[k].w;
      gv[4 * k] = ga[k].x;
      gv[4 * k + 1] = ga[k].y;
      gv[4 * k + 2] = ga[k].z;
      gv[4 * k + 3] = ga[k].w;
    }
    float xh[kE], dxh[kE], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      xh[k] = (xv[k] - mean) * rstd;
      dxh[k] = da[i][k] * gam[k];
      m1 += dxh[k];
      m2 = fmaf(dxh[k], xh[k], m2);
    }
    m1 = group_sum<K::kCG>(m1) * (1.0f / C);
    m2 = group_sum<K::kCG>(m2) * (1.0f / C);
    float o[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) o[k] = gv[k] + rstd * (dxh[k] - m1 - xh[k] * m2);
    if (valid) {
#pragma unroll
      for (int k = 0; k < K::kK; ++k)
        store4(dx + row * C + 4 * K::kCG * k + 4 * p4,
               make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]));
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        sx[k] = fmaf(da[i][k], xh[k], sx[k]);
        sd[k] += da[i][k];
        sg[k] += gv[k];
      }
    }
  }
  // the tile's sums over the kRG row groups, in order, through redS
  float* red = redS + q4 * 3 * C + 4 * p4;  // [row group][3][C]
#pragma unroll
  for (int k = 0; k < K::kK; ++k)
    st4(red + 4 * K::kCG * k, make_float4(sx[4 * k], sx[4 * k + 1], sx[4 * k + 2], sx[4 * k + 3]));
#pragma unroll
  for (int k = 0; k < K::kK; ++k)
    st4(red + C + 4 * K::kCG * k,
        make_float4(sd[4 * k], sd[4 * k + 1], sd[4 * k + 2], sd[4 * k + 3]));
#pragma unroll
  for (int k = 0; k < K::kK; ++k)
    st4(red + 2 * C + 4 * K::kCG * k,
        make_float4(sg[4 * k], sg[4 * k + 1], sg[4 * k + 2], sg[4 * k + 3]));
  __syncthreads();
  for (int c = tid; c < C; c += kT) {
    float t[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < K::kRG; ++q)
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) t[k3] += redS[(q * 3 + k3) * C + c];
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
      part[(static_cast<long long>(blockIdx.x) * 3 + k3) * C + c] = t[k3];
  }
}

}  // namespace dxp

// One block per tile of dxp::Cfg<C>::kR rows, in f32 (bf16 at C = 128 runs
// mlp_ln_bwd_dx_mma_kernel, 4a.); the hidden width in chunks of kKC through
// a cp.async ring; warps 0-3 run fc1 and warps 4-7 dh, then all take dz and
// da; dx and the tile's partial sums at the end.
template <typename T, int C>
__global__ void __launch_bounds__(dxp::kT, 1)
mlp_ln_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ ls2,
                     T* __restrict__ dx, float* __restrict__ part, long long M, int H,
                     float eps) {
  using namespace dxp;
  using K = Cfg<C>;
  static_assert(std::is_same<T, float>::value, "bf16 at C = 128 is mlp_ln_bwd_dx_mma_kernel");
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* dS = aS + K::kR * K::kLdA;
  float* zS = aS + K::kOffZ;
  float* hS = zS + K::kR * K::kLdZ;
  float* sMean = aS + K::kOffStat;
  float* sRstd = sMean + K::kR;
  float* st0 = aS + K::kOffRing;  // the ring's two stages
  float* st1 = st0 + K::kStageF;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * K::kR;
  fetch_chunk<C>(st0, w1, w2, b1, 0, H, tid);
  stage_rows<C>(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, row0, M, eps, warp, lane);

  // fc1 / dh layout (thread tid % 128 of warps 0-3 or 4-7): channel split
  // fastest, then column group, then row group (at C = 128: row group
  // 4 (warp % 4) + lane / 8, column group lane % 8); da layout: row group
  // tid / kCG, channel group tid % kCG
  const int i1 = tid & 127;
  const int s1 = i1 % K::kKS, p1 = i1 / K::kKS % K::kCG1, q1 = i1 / (K::kKS * K::kCG1);
  const int q4 = tid / K::kCG, p4 = tid % K::kCG;
  float da[K::kRT][4 * K::kK];
#pragma unroll
  for (int i = 0; i < K::kRT; ++i)
#pragma unroll
    for (int k = 0; k < 4 * K::kK; ++k) da[i][k] = 0.f;

  for (int j0 = 0, s = 0; j0 < H; j0 += K::kKC, s ^= 1) {
    const float* w1c = s ? st1 : st0;  // this chunk's W1, W2 and b1
    const float* w2c = w1c + K::kW1F;
    const float* b1c = w2c + K::kW2F;
    kasf_mma::cp_async_wait<0>();
    __syncthreads();  // this chunk is in; the last chunk's zS and stage are consumed
    fetch_chunk<C>(s ? st0 : st1, w1, w2, b1, j0 + K::kKC, H, tid);
    if (warp < 4)
      fc1_chunk<C>(aS, w1c, b1c, zS, q1, p1, s1);
    else
      dh_chunk<C>(dS, w2c, hS, q1, p1, s1);
    __syncthreads();  // z and dh in
    // dz = dh * GELU'(z + b1) in place of z, a pair of columns at a time
    constexpr int kPairs = K::kR * K::kKC / 2;
#pragma unroll
    for (int i = 0; i < (kPairs + kT - 1) / kT; ++i) {
      const int e = tid + i * kT, r = e / (K::kKC / 2), j2 = e % (K::kKC / 2) * 2;
      if (kPairs % kT == 0 || e < kPairs) {
        const float2 z = *reinterpret_cast<const float2*>(zS + r * K::kLdZ + j2);
        const float2 h = *reinterpret_cast<const float2*>(hS + r * K::kLdZ + j2);
        *reinterpret_cast<float2*>(zS + r * K::kLdZ + j2) =
            make_float2(h.x * gelu_erf_grad(z.x), h.y * gelu_erf_grad(z.y));
      }
    }
    __syncthreads();  // dz in
    da_chunk<K>(zS, w1c, da, q4, p4);
  }

  dx_epilogue<K, C>(da, x, g, gamma, sMean, sRstd, aS, dx, part, row0, M, q4, p4, tid);
}

// ---- 1c. dx pass at C = 64: one block a 112-row tile, two warp groups over
// hidden halves
namespace dxg {

constexpr int kT = 256;   // threads a block: two warp groups
constexpr int kGT = 128;  // threads a warp group

// The tile, the row staging, the chunk ring and fc1's and dh's layouts are
// dxp::Cfg<64>'s (P); a warp group keeps da for the whole tile, kRT rows x
// 4 kK channels a thread (kCG lanes hold a row's 64 channels), and has its
// own zS, hS and ring after aS, dS, mean and rstd.
struct Cfg {
  using P = dxp::Cfg<64>;
  static constexpr int C = 64;
  static constexpr int kR = P::kR, kKC = P::kKC, kLdA = P::kLdA, kLdW1 = P::kLdW1,
                       kLdZ = P::kLdZ;
  static constexpr int kCG = 8;            // lanes a row
  static constexpr int kK = C / (4 * kCG);  // 2 float4s a lane: channels 4p + 32k
  static constexpr int kRG = kGT / kCG;     // 16 row groups
  static constexpr int kRT = kR / kRG;      // 7 rows a thread
  // floats: aS, dS | mean, rstd | each group's zS, hS and ring; a ring is
  // two f32 stages, or two widened W1 chunks (with b1), one widened W2
  // chunk and one bf16 stage (the larger, so both dtypes share offsets)
  static constexpr int kZF = kR * kLdZ;  // a zS or hS
  static constexpr int kOffStat = 2 * kR * kLdA;
  static constexpr int kOffGroup = kOffStat + 2 * kR;
  static constexpr int kRingF = 2 * P::kStageF;
  static constexpr int kRingH = P::kOffStageH + P::kStageH / 2;
  static constexpr int kRing = kRingF > kRingH ? kRingF : kRingH;
  static constexpr int kGroupF = 2 * kZF + kRing;
  static constexpr size_t kSmem = sizeof(float) * (kOffGroup + 2 * kGroupF);
  static_assert(kR % kRG == 0 && kK * 4 * kCG == C && P::kKS == 1 &&
                    P::kRG1 * P::kCG1 == kGT && P::kStageH % 8 == 0,
                "a warp group's threads divide the tile and the chunk evenly");
  static_assert(kOffGroup % 4 == 0 && kZF % 4 == 0 && kRing % 4 == 0,
                "16-byte alignment of the shared buffers");
  static_assert(kRG * 3 * C <= 2 * kZF, "the epilogue's sums fit in group 0's zS and hS");
  static_assert(kSmem <= 232448, "one block a SM");
};

// bar.sync on warp group grp's own barrier (1 + grp; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "n"(kGT) : "memory");
}

// GELU'(z) = Phi(z) + z phi(z), with erf by Abramowitz and Stegun 7.1.26,
// erf(x) = 1 - t (a1 + t (a2 + ... + t a5)) exp(-x^2), t = 1 / (1 + p x),
// x = |z| / sqrt 2 (|error| <= 1.5e-7, as close as erff's few ulps), so
// that exp(-z^2 / 2) serves both terms: ~20 instructions and no branch
// against ~40 for erff and expf (the dz step was ~13 % of a tile's cycles)
__device__ __forceinline__ float gelu_grad(float z) {
  const float e = expf(-0.5f * z * z);
  const float t = __fdividef(1.0f, fmaf(0.3275911f * 0.70710678118654752f, fabsf(z), 1.0f));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float half_erf = fmaf(-0.5f * p, e, 0.5f);  // erf(x) / 2
  return 0.5f + copysignf(half_erf, z) + z * e * 0.39894228040143268f;
}

// fc1 and dh of a chunk in one loop, in dxp::fc1_chunk's and dh_chunk's
// layouts and each sum's order (so their bits): thread (row group q,
// column group p) keeps z for rows q + 16 i, columns p + 8 u and dh for the
// same rows, columns 4p..4p+3, 56 accumulators over one pass of the 64
// channels (2 % faster than the two loops one after the other,
// scripts/k4_dx_variants.py); z + b1 into zS, dh into hS
__device__ __forceinline__ void fc1_dh(const float* aS, const float* dS, const float* w1c,
                                       const float* w2c, const float* b1c, float* zS, float* hS,
                                       int q, int p) {
  using P = dxp::Cfg<64>;
  float z[P::kRT1][4], h[P::kRT1][4];
#pragma unroll
  for (int i = 0; i < P::kRT1; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) z[i][u] = h[i][u] = 0.f;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float4 w[4], v[4];  // W1 rows p + 8u, W2 rows c + u
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = dxp::ld4(w1c + (p + P::kCG1 * u) * P::kLdW1 + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = dxp::ld4(w2c + (c + u) * P::kKC + 4 * p);
#pragma unroll
    for (int i = 0; i < P::kRT1; ++i) {
      const float4 a = dxp::ld4(aS + (q + P::kRG1 * i) * P::kLdA + c);
      const float4 d = dxp::ld4(dS + (q + P::kRG1 * i) * P::kLdA + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        z[i][u] = fmaf(a.x, w[u].x, z[i][u]);
        h[i][u] = fmaf(d.x, dxp::lane4(v[0], u), h[i][u]);
        z[i][u] = fmaf(a.y, w[u].y, z[i][u]);
        h[i][u] = fmaf(d.y, dxp::lane4(v[1], u), h[i][u]);
        z[i][u] = fmaf(a.z, w[u].z, z[i][u]);
        h[i][u] = fmaf(d.z, dxp::lane4(v[2], u), h[i][u]);
        z[i][u] = fmaf(a.w, w[u].w, z[i][u]);
        h[i][u] = fmaf(d.w, dxp::lane4(v[3], u), h[i][u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float bias = b1c[p + P::kCG1 * u];
#pragma unroll
    for (int i = 0; i < P::kRT1; ++i)
      zS[(q + P::kRG1 * i) * P::kLdZ + p + P::kCG1 * u] = z[i][u] + bias;
  }
#pragma unroll
  for (int i = 0; i < P::kRT1; ++i)
    dxp::st4(hS + (q + P::kRG1 * i) * P::kLdZ + 4 * p,
             make_float4(h[i][0], h[i][1], h[i][2], h[i][3]));
}

}  // namespace dxg

// One block per 112-row tile at C = 64. All 256 threads stage the tile's rows
// (aS = LN(x) * gamma + beta, dS = g * ls2); then warp group grp (threads
// 128 grp ..) walks hidden columns grp H / 2 .. (grp + 1) H / 2 - 1 in
// chunks of 32 through its own cp.async ring, taking fc1, dh, dz and da +=
// dz W1c itself on its own named barrier. The two groups' da meet once,
// through aS and dS, added in one fixed order; the epilogue is the
// one-block pass's at C = 64.
template <typename T>
__global__ void __launch_bounds__(dxg::kT, 1)
mlp_ln_bwd_dx_wg_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const T* __restrict__ w1, const T* __restrict__ b1,
                        const T* __restrict__ w2, const float* __restrict__ ls2,
                        T* __restrict__ dx, float* __restrict__ part, long long M, int H,
                        float eps) {
  using K = dxg::Cfg;
  using P = K::P;
  constexpr int C = K::C, kGT = dxg::kGT;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* dS = aS + K::kR * K::kLdA;
  float* sMean = aS + K::kOffStat;
  float* sRstd = sMean + K::kR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / kGT, gt = tid % kGT;  // warp group, thread in it
  float* zS = aS + K::kOffGroup + grp * K::kGroupF;
  float* hS = zS + K::kZF;
  float* ring = hS + K::kZF;
  // f32: chunk k lands in stage k & 1, at ring + (k & 1) kStageF. bf16: the
  // widened W1 chunks (with b1) at ring and ring + kW1B, the W2 chunk at ring
  // + kOffW2f, the bf16 stage after it
  auto stage = [&](int k) {
    return reinterpret_cast<T*>(kF32 ? ring + (k & 1) * P::kStageF : ring + P::kOffStageH);
  };
  const int jb = grp * (H / 2), je = jb + H / 2;  // the group's hidden columns

  const long long row0 = static_cast<long long>(blockIdx.x) * K::kR;
  dxp::fetch_chunk<C, kGT>(stage(0), w1, w2, b1, jb, H, gt);
  dxp::stage_rows<C>(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, row0, M, eps, warp, lane);
  if constexpr (!kF32) kasf_mma::cp_async_wait<0>();
  __syncthreads();  // the rows are staged; bf16: each group's first chunk landed
  if constexpr (!kF32) {
    dxp::widen_chunk<C, kGT>(ring, ring + P::kOffW2f, stage(0), gt);
    dxg::group_sync(grp);  // the bf16 stage is free
    dxp::fetch_chunk<C, kGT>(stage(1), w1, w2, b1, jb + K::kKC, H, gt);
  }

  // fc1 / dh layout: row group gt / 8, column group gt % 8 (dxp's at C = 64);
  // da layout: row group gt / kCG, channel group gt % kCG
  const int p1 = gt % P::kCG1, q1 = gt / P::kCG1;
  const int q4 = gt / K::kCG, p4 = gt % K::kCG;
  float da[K::kRT][4 * K::kK];
#pragma unroll
  for (int i = 0; i < K::kRT; ++i)
#pragma unroll
    for (int k = 0; k < 4 * K::kK; ++k) da[i][k] = 0.f;

  for (int j0 = jb, k = 0; j0 < je; j0 += K::kKC, ++k) {
    // chunk k's W1, W2 and b1 in f32
    const float* w1c = kF32 ? reinterpret_cast<const float*>(stage(k)) : ring + (k & 1) * P::kW1B;
    const float* w2c = kF32 ? w1c + P::kW1F : ring + P::kOffW2f;
    const float* b1c = w1c + (kF32 ? P::kW1F + P::kW2F : P::kW1F);
    if constexpr (kF32) kasf_mma::cp_async_wait<0>();
    dxg::group_sync(grp);  // this chunk is in; the last chunk's zS and stage are consumed
    if constexpr (kF32)
      if (j0 + K::kKC < je) dxp::fetch_chunk<C, kGT>(stage(k + 1), w1, w2, b1, j0 + K::kKC, H, gt);
    dxg::fc1_dh(aS, dS, w1c, w2c, b1c, zS, hS, q1, p1);
    if constexpr (!kF32) kasf_mma::cp_async_wait<0>();
    dxg::group_sync(grp);  // z and dh in; bf16: the next chunk landed, W2's buffer free
    // dz = dh * GELU'(z + b1) in place of z, a pair of columns at a time
    constexpr int kPairs = K::kR * K::kKC / 2;
    static_assert(kPairs % kGT == 0, "the group's threads divide the chunk's pairs");
#pragma unroll
    for (int i = 0; i < kPairs / kGT; ++i) {
      const int e = gt + i * kGT, r = e / (K::kKC / 2), j2 = e % (K::kKC / 2) * 2;
      const float2 z = *reinterpret_cast<const float2*>(zS + r * K::kLdZ + j2);
      const float2 h = *reinterpret_cast<const float2*>(hS + r * K::kLdZ + j2);
      *reinterpret_cast<float2*>(zS + r * K::kLdZ + j2) =
          make_float2(h.x * dxg::gelu_grad(z.x), h.y * dxg::gelu_grad(z.y));
    }
    if constexpr (!kF32)  // the next chunk
      if (j0 + K::kKC < je)
        dxp::widen_chunk<C, kGT>(ring + ((k + 1) & 1) * P::kW1B, ring + P::kOffW2f, stage(k + 1),
                                 gt);
    dxg::group_sync(grp);  // dz in; bf16: the next chunk widened, the bf16 stage free
    if constexpr (!kF32)
      if (j0 + 2 * K::kKC < je)
        dxp::fetch_chunk<C, kGT>(stage(k + 2), w1, w2, b1, j0 + 2 * K::kKC, H, gt);
    dxp::da_chunk<K>(zS, w1c, da, q4, p4);
  }

  // ---- the two groups' da, added once: group 0's through aS, group 1's
  // through dS (free once both groups are past their last chunk), then
  // da = aS + dS in the epilogue's layout (16 lanes a row, 4 channels each)
  __syncthreads();
  float* mine = grp ? dS : aS;
#pragma unroll
  for (int i = 0; i < K::kRT; ++i)
#pragma unroll
    for (int k = 0; k < K::kK; ++k)
      dxp::st4(mine + (q4 + K::kRG * i) * K::kLdA + 4 * K::kCG * k + 4 * p4,
               make_float4(da[i][4 * k], da[i][4 * k + 1], da[i][4 * k + 2], da[i][4 * k + 3]));
  __syncthreads();
  const int qe = tid / P::kCG, pe = tid % P::kCG;
  float dae[P::kRT][4 * P::kK];
  static_assert(P::kK == 1 && P::kRG * P::kCG == dxp::kT, "the epilogue's layout");
#pragma unroll
  for (int i = 0; i < P::kRT; ++i) {
    const int o = (qe + P::kRG * i) * K::kLdA + 4 * pe;
    const float4 a = dxp::ld4(aS + o), b = dxp::ld4(dS + o);
    dae[i][0] = a.x + b.x;
    dae[i][1] = a.y + b.y;
    dae[i][2] = a.z + b.z;
    dae[i][3] = a.w + b.w;
  }
  // the sums go through group 0's zS and hS, which no thread reads any more
  dxp::dx_epilogue<P, C>(dae, x, g, gamma, sMean, sRstd, aS + K::kOffGroup, dx, part, row0, M,
                         qe, pe, tid);
}

// ---- 1b. dx pass at C = 256 and 512: a thread-block cluster of two blocks a
// tile, each over half the channels
namespace dxc {

using dxp::ld4;
using dxp::load4;
using dxp::st4;
using dxp::store4;

constexpr int kT = 256;  // threads a block: 8 warps
constexpr int kNB = 2;   // blocks a cluster

// Block b of a cluster holds channels CS b .. CS b + CS - 1 of the tile's
// kR rows: 112 rows of 128 channels at C = 256 (the C = 128 block's rows x
// channels), 56 of 256 at 512. The hidden width comes in chunks of kJ
// columns; block b finishes columns kW b .. kW b + kW - 1 of each.
template <int C>
struct Cfg {
  static_assert(C == 256 || C == 512, "the cluster widths");
  static constexpr int CS = C / kNB;          // channels a block
  static constexpr int kR = 14336 / CS;       // rows a tile: 112, 56
  static constexpr int kJ = 32;               // hidden columns a chunk
  static constexpr int kW = kJ / kNB;         // ... a block finishes
  // fc1 and dh, one layout for both: lane (s, p, q) of kKS x 8 x kRG takes
  // rows q + kRG i (i < kRT), columns p + 8u (u < 4) and a kKS-th of the
  // block's channels: the float4s 8 b + kG s + e (e < kG) of each run of 8.
  // A warp holds kKS splits x kPW column groups x 32 / (kKS kPW) row groups,
  // so its W loads touch 16 float4s (two wavefronts) at both widths
  static constexpr int kKS = CS / 64;         // 2, 4
  static constexpr int kG = 8 / kKS;          // 4, 2
  static constexpr int kPW = 16 / kKS;        // 8, 4
  static constexpr int kRG = kT / (8 * kKS);  // 16, 8
  static constexpr int kRT = kR / kRG;        // 7
  // after the reduce-scatter over the kKS lanes a lane holds kNE columns of
  // its rows, one of them (at C = 512: of half the lanes) the other block's
  static constexpr int kNE = 4 / kKS;         // 2, 1
  static constexpr int kSlots = kT * kNE / 2; // lanes a chunk's partials go between
  // da (da_chunk's view): kCG lanes hold a row's CS channels, kK float4s each
  // (channels 4p + 4 kCG k), row groups q of rows q + kRG i (kRG and kRT as
  // fc1's); a da_chunk call takes kKC = kW columns
  static constexpr int kCG = CS / 8;          // 16, 32
  static constexpr int kK = 2;
  static constexpr int kKC = kW;
  // row strides, in floats, that put a warp's distinct float4s of fc1 and
  // dh on distinct banks: W1, W2^T chunk rows (p + 8u, s) CS + 4; aS, dS
  // rows (q + kRG i, s) CS + 8 at C = 256, CS + 4 at 512
  static constexpr int kLdW1 = CS + 4;
  static constexpr int kLdA = CS + (kKS == 2 ? 8 : 4);
  static constexpr int kLdZ = kJ;             // zS rows: dz of the chunk
  // staging: warp w rows kRowsW w.., lane l the float4s 4l + 128u of a row
  static constexpr int kRowsW = kR / (kT / 32);  // 14, 7
  static constexpr int kNV = CS / 128;           // 1, 2
  // shared memory (floats): aS, dS [kR][kLdA] (LN(x) * gamma + beta,
  // g * ls2) | W1 chunks [2][kJ][kLdW1] | W2^T chunk [kJ][kLdW1] | zS
  // [kR][kJ] | recv [kRT][kSlots] float2 (the other block's partial z, dh of
  // this block's columns; in the epilogue dx's two row sums, [2][kNB][kR]) |
  // mean, rstd [kR] | slots [2][kNB][kR] (LN's row sums, then its squared
  // deviations; slot b from block b) | mbarriers (recv's, zS's, the two W1
  // buffers', W2^T's)
  static constexpr int kOffD = kR * kLdA;
  static constexpr int kOffW1 = 2 * kR * kLdA;
  static constexpr int kOffW2 = kOffW1 + 2 * kJ * kLdW1;
  static constexpr int kOffZ = kOffW2 + kJ * kLdW1;
  static constexpr int kOffRecv = kOffZ + kR * kJ;
  static constexpr int kOffStat = kOffRecv + 2 * kRT * kSlots;
  static constexpr int kOffSlots = kOffStat + 2 * kR;
  static constexpr int kOffBar = kOffSlots + 2 * kNB * kR;
  static constexpr int kBars = 5;
  static constexpr size_t kSmem = sizeof(float) * kOffBar + kBars * sizeof(unsigned long long);
  // bytes the other block sends a chunk: partials into recv, dz into zS
  static constexpr unsigned kRecvBytes = sizeof(float2) * kRT * kSlots;
  static constexpr unsigned kZBytes = sizeof(float) * kR * kW;
  static_assert(kRG * kRT == kR && kT / kCG == kRG && 4 * kCG * kK == CS && kKS * kG == 8 &&
                    kRowsW * (kT / 32) == kR && kSlots * kRT == kR * kW && kJ == 32 &&
                    2 * kNB * kR <= 2 * kRT * kSlots,
                "the thread layouts cover the tile; dx's row sums fit in recv");
  static_assert(kOffD % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 && kOffZ % 4 == 0 &&
                    kOffRecv % 4 == 0 && kOffBar % 2 == 0 && kLdW1 % 4 == 0 && kLdA % 4 == 0,
                "16-byte alignment of the copies' targets and float4s, 8 of the mbarriers");
  static_assert(kRG * 3 * CS <= kR * kLdA, "the epilogue's sums fit in aS");
  static_assert(kSmem <= 232448, "shared memory");
};

// One thread: the block's slice of hidden rows j0 .. j0 + kJ - 1 of a
// matrix the stage launch wrote, [kNB][H][kLdW1] (W1, or W2^T: slice b holds
// channels CS b.., each row padded as the chunk buffers are), into a chunk
// buffer by one bulk copy (the TMA engine) completing on bar. The caller
// issues it after a block barrier past the buffer's last reads (each
// thread's reads have returned, so the copy needs no proxy fence).
template <int C>
__device__ __forceinline__ void fetch_slice(float* buf, const float* __restrict__ w, int j0,
                                            int H, unsigned rank, unsigned long long* bar) {
  using K = Cfg<C>;
  constexpr unsigned kBytes = sizeof(float) * K::kJ * K::kLdW1;
  kasf_mma::mbar_arm(bar, kBytes);
  kasf_mma::bulk_load(buf, w + (static_cast<long long>(rank) * H + j0) * K::kLdW1, kBytes, bar);
}

// Stage the block's slice of the tile: aS = LN(x) * gamma + beta and dS =
// g * ls2 (row-major, stride kLdA), each row's mean and rstd. LN's statistics
// span all C channels: the rows' sums, then their squared deviations from
// the mean (as the plain version forms the variance), each summed across
// the cluster in rank order (kasf_mma::cluster_row_sums). Warp w takes rows
// kRowsW w..; lane l holds channels 4l + 128u of the slice. Rows >= M are
// zeros: a = beta, do = 0, and rstd stays finite.
template <int C, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, const T* __restrict__ g,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ ls2, float* aS, float* dS,
                                           float* sMean, float* sRstd, const float* slots,
                                           long long row0, long long M, float eps,
                                           unsigned rank, int warp, int lane) {
  using K = Cfg<C>;
  constexpr int N = K::kRowsW, NV = K::kNV;
  const int r0 = warp * N, c0 = rank * K::CS + 4 * lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[N][NV];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const long long row = row0 + r0 + i;
      xv[i][u] = row < M ? load4(x + row * C + c0 + 128 * u) : zero;
    }
  // dS first: its loads in flight with x's (the last tile's dh is past)
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = c0 + 128 * u;
    const float4 ls = ld4(ls2 + c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const long long row = row0 + r0 + i;
      const float4 gv = row < M ? load4(g + row * C + c) : zero;
      st4(dS + (r0 + i) * K::kLdA + c - rank * K::CS,
          make_float4(gv.x * ls.x, gv.y * ls.y, gv.z * ls.z, gv.w * ls.w));
    }
  }
  float s[N], mean[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = quad_sum(xv[i][0]);
#pragma unroll
    for (int u = 1; u < NV; ++u) s[i] += quad_sum(xv[i][u]);
  }
  kasf_mma::cluster_row_sums<kNB>(s, slots, K::kR, r0, rank, lane);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mean[i] = s[i] * (1.0f / C);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const float4 v = xv[i][u];
      xv[i][u] = make_float4(v.x - mean[i], v.y - mean[i], v.z - mean[i], v.w - mean[i]);
    }
    s[i] = quad_sq(xv[i][0]);
#pragma unroll
    for (int u = 1; u < NV; ++u) s[i] += quad_sq(xv[i][u]);
  }
  kasf_mma::cluster_row_sums<kNB>(s, slots + kNB * K::kR, K::kR, r0, rank, lane);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 1.0f / sqrtf(s[i] * (1.0f / C) + eps);  // rstd
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = c0 + 128 * u;
    const float4 gm = ld4(gamma + c), bt = ld4(beta + c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 v = xv[i][u];
      st4(aS + (r0 + i) * K::kLdA + c - rank * K::CS,
          make_float4(fmaf(v.x * s[i], gm.x, bt.x), fmaf(v.y * s[i], gm.y, bt.y),
                      fmaf(v.z * s[i], gm.z, bt.z), fmaf(v.w * s[i], gm.w, bt.w)));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sMean[r0 + i] = mean[i];
      sRstd[r0 + i] = s[i];
    }
  }
}

// acc[i][u] = the block's channels' share of X[q + kRG i] . W[p + 8u]: X
// row-major (aS, or dS), W a chunk's rows (W1, or W2^T), both over the
// block's CS channels. Lane s takes the float4s 8 b + kG s + e (e < kG) of
// each run of 8; a warp's W loads touch 16 distinct float4s and its X loads
// 4 or 8 (broadcast to the column groups), all on distinct banks, the
// fewest wavefronts a load can take. A step reads 4 W and kRT X float4s for
// 16 kRT FMAs; every sum runs over the lane's channels in order.
template <int C>
__device__ __forceinline__ void rows_dot(const float* X, const float* W,
                                         float (&acc)[Cfg<C>::kRT][4], int q, int p, int s) {
  using K = Cfg<C>;
#pragma unroll
  for (int i = 0; i < K::kRT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  const float* xq = X + q * K::kLdA + 4 * K::kG * s;
  const float* wp = W + p * K::kLdW1 + 4 * K::kG * s;
#pragma unroll 2
  for (int tb = 0; tb < K::CS / 4 / K::kKS; tb += 4) {  // four steps an iteration
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int f = 4 * (8 * (tb / K::kG + d / K::kG) + d % K::kG);  // float offset
      float4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = ld4(wp + 8 * u * K::kLdW1 + f);
#pragma unroll
      for (int i = 0; i < K::kRT; ++i) {
        const float4 a = ld4(xq + i * K::kRG * K::kLdA + f);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][u] = fmaf(a.x, w[u].x, acc[i][u]);
          acc[i][u] = fmaf(a.y, w[u].y, acc[i][u]);
          acc[i][u] = fmaf(a.z, w[u].z, acc[i][u]);
          acc[i][u] = fmaf(a.w, w[u].w, acc[i][u]);
        }
      }
    }
  }
}

// The kKS lanes of a (row group, column group) hold partial sums of the same
// 7 x 4 outputs over their channels: a fixed tree of shuffles leaves each
// with the sums over all the block's channels of kNE of the columns, u = s
// and s + 2 (kKS = 2: one of each block's), or u = s (kKS = 4; columns
// u < 2 are block 0's).
template <int KS, int RT>
__device__ __forceinline__ void scatter_lanes(const float (&a)[RT][4], float (&o)[RT][4 / KS],
                                              int s) {
  if constexpr (KS == 2) {
    const bool odd = s & 1;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float give = __shfl_xor_sync(0xffffffffu, odd ? a[i][2 * e] : a[i][2 * e + 1], 1);
        o[i][e] = (odd ? a[i][2 * e + 1] : a[i][2 * e]) + give;
      }
  } else {
    static_assert(KS == 4, "two or four channel splits");
    const bool hi = s & 2, odd = s & 1;
    float h[RT][2];  // columns 2 (s >> 1) + v over this lane's pair of splits
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float give = __shfl_xor_sync(0xffffffffu, hi ? a[i][v] : a[i][2 + v], 2);
        h[i][v] = (hi ? a[i][2 + v] : a[i][v]) + give;
      }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float give = __shfl_xor_sync(0xffffffffu, odd ? h[i][0] : h[i][1], 1);
      o[i][0] = (odd ? h[i][1] : h[i][0]) + give;
    }
  }
}

}  // namespace dxc

// Clusters of two blocks walk the tiles clusterid, + nclusterid, ... (at most
// as many clusters as the card holds at once); block b of a cluster takes
// the tile's channels CS b .. CS b + CS - 1. Per tile: the rows (LN's
// statistics summed across the cluster), dh of chunk 0, then per hidden
// chunk n:
//  1. fc1(n) over the block's channels; a reduce-scatter of z and dh over
//     the lanes that split the channels; each lane sends the other block's
//     columns (partial z, dh over this block's channels) into its recv by
//     st.async, and keeps its own.
//  2. dh(n + 1), while the partials travel.
//  3. the other block's partials of this block's kW columns: z = the two in
//     rank order + b1, dh likewise, dz = dh * GELU'(z) into zS.
//  4. a block barrier; then this block's dz columns into the other block's
//     zS by st.async, while
//  5. da += dz W1 over this block's columns, then, once the other block's
//     dz is in, over its columns.
// Each exchange completes bytes on the receiver's mbarrier (recv's, zS's),
// so a block waits for its data on its own mbarrier and no cluster barrier
// or release fence sits in the chunk loop. Thread 0 arms each phase once the
// last has completed; bytes may land before it. The n-th chunk's exchange
// completes its mbarriers' phase n: parity n & 1. The write-after-read
// hazards follow from the data flow: a block sends partials of chunk n + 1
// only after its zS of chunk n is complete (after the barrier that closes
// chunk n), which needs the other block's dz of chunk n, which that block
// computed from its recv (so it has read it) and sent after its own block
// barrier; so neither recv nor zS is written while it is read.
// Weights: W1 chunks in two buffers, W2^T in one, each chunk by one bulk
// copy from the stage launch's slices, completing on the buffer's mbarrier:
// W2^T(n + 2) starts at the barrier of step 4 (after dh(n + 1)) and W1(n + 2)
// at the barrier that closes chunk n (after da(n)); the chunk index runs on
// across tiles, so the weights stream without a break (the last chunk of a
// tile leaves W2^T of the next tile's first in the buffer).
// Epilogue: dx needs the row means of da * gamma and da * gamma * xhat over
// all C channels: each block's share goes to both blocks (DSMEM, a cluster
// barrier) and each adds the two in rank order. Each block writes dx for
// its channels and its channels of the tile's partial sums (da * xhat, da,
// g; a fixed order over its row groups): one partial a tile, whichever
// cluster ran it, so reruns are bitwise equal.
template <typename T, int C>
__global__ void __launch_bounds__(dxc::kT, 1)
mlp_ln_bwd_dx_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ w1s_g, const float* __restrict__ b1,
                             const float* __restrict__ w2s_g, const float* __restrict__ ls2,
                             T* __restrict__ dx, float* __restrict__ part, long long M, int H,
                             float eps) {
  using namespace dxc;
  using K = Cfg<C>;
  using kasf_mma::map_rank;
  using kasf_mma::mbar_arm;
  using kasf_mma::mbar_wait;
  using kasf_mma::mbar_wait_cluster;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* dS = aS + K::kOffD;
  float* w1s = aS + K::kOffW1;  // chunk n in w1s + (n & 1) kJ kLdW1
  float* w2s = aS + K::kOffW2;
  float* zS = aS + K::kOffZ;
  float2* recv = reinterpret_cast<float2*>(aS + K::kOffRecv);
  float* sMean = aS + K::kOffStat;
  float* sRstd = sMean + K::kR;
  float* slots = aS + K::kOffSlots;
  // recv's, zS's; W1 buffer b's at w1_bar + b, W2^T's
  auto* bar = reinterpret_cast<unsigned long long*>(aS + K::kOffBar);
  unsigned long long* const w1_bar = bar + 2;
  unsigned long long* const w2_bar = bar + 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // fc1 / dh: lane (s, p, q); da: row group q4, channel group p4
  constexpr int kWP = 8 / K::kPW, kQW = 32 / (K::kKS * K::kPW);  // warps a row group, rows a warp
  const int s = lane % K::kKS, p = lane / K::kKS % K::kPW + K::kPW * (warp % kWP);
  const int q = lane / (K::kKS * K::kPW) + kQW * (warp / kWP);
  const int q4 = tid / K::kCG, p4 = tid % K::kCG;
  const unsigned rank = kasf_mma::cluster_rank(), other = rank ^ 1u;
  const long long cid = kasf_mma::cluster_index(), ncl = kasf_mma::cluster_count();
  const long long tiles = (M + K::kR - 1) / K::kR;
  const int chunks = H / K::kJ;
  const long long my_tiles = cid < tiles ? (tiles - 1 - cid) / ncl + 1 : 0;
  const long long total = my_tiles * chunks;  // chunks the block multiplies
  // the lane's columns after the reduce-scatter: at C = 256 column
  // p + 8 (s + 2e) of each row, e = rank its own and e = other the other
  // block's; at C = 512 the one column p + 8s, its own where s / 2 = rank
  const bool owns = K::kNE == 2 || (s >> 1) == static_cast<int>(rank);
  const bool sends = K::kNE == 2 || !owns;
  const int col = K::kNE == 2 ? p + 8 * s + K::kW * rank : p + 8 * s;  // its own column
  const int slot = K::kNE == 2 ? tid : (tid >> 2) * 2 + (s & 1);

  if (tid == 0) {
    for (int b = 0; b < K::kBars; ++b) kasf_mma::mbar_init(bar + b);
    mbar_arm(bar, K::kRecvBytes);  // chunk 0's exchanges
    mbar_arm(bar + 1, K::kZBytes);
  }
  kasf_mma::cluster_sync();  // both blocks of the cluster run, their mbarriers initialised
  const unsigned recv_far = map_rank(recv + slot, other), recv_bar = map_rank(bar, other);
  const unsigned z_far = map_rank(zS, other), z_bar = map_rank(bar + 1, other);
  // the weights, from the stage launch's slices: thread 0 copies W1, thread
  // 32 W2^T; the m-th copy into a buffer completes its mbarrier's phase m
  // (W1(n): buffer n & 1, copy n >> 1)
  const bool w1_copier = tid == 0, w2_copier = tid == 32;
  if (total > 0 && w1_copier) {
    fetch_slice<C>(w1s, w1s_g, 0, H, rank, w1_bar);
    fetch_slice<C>(w1s + K::kJ * K::kLdW1, w1s_g, K::kJ, H, rank, w1_bar + 1);
  }
  if (total > 0 && w2_copier) fetch_slice<C>(w2s, w2s_g, 0, H, rank, w2_bar);

  long long n = 0;  // the block's chunks so far, over its tiles
  for (long long k = 0; k < my_tiles; ++k) {
    const long long tile = cid + k * ncl, row0 = tile * K::kR;
    if (tid == 0 && k + 1 < my_tiles) {  // the next tile's rows into L2, half a block
      const long long next0 = row0 + ncl * K::kR;
      const long long rows = M - next0 < K::kR ? M - next0 : K::kR;
      const long long per = (rows + 1) / 2, first = rank * per;
      const long long mine = rows - first < per ? rows - first : per;
      if (mine > 0) {
        const unsigned bytes = static_cast<unsigned>(mine * C * sizeof(T));
        kasf_mma::bulk_prefetch_l2(x + (next0 + first) * C, bytes);
        kasf_mma::bulk_prefetch_l2(g + (next0 + first) * C, bytes);
      }
    }
    stage_rows<C>(x, g, gamma, beta, ls2, aS, dS, sMean, sRstd, slots, row0, M, eps, rank, warp,
                  lane);
    __syncthreads();  // the tile's rows staged
    float ht[K::kRT][K::kNE];  // dh of the next chunk, over the block's channels
    {
      float acc[K::kRT][4];
      mbar_wait(w2_bar, static_cast<unsigned>(n) & 1u);  // W2^T(n) has landed
      rows_dot<C>(dS, w2s, acc, q, p, s);
      scatter_lanes<K::kKS>(acc, ht, s);
    }
    __syncthreads();  // W2^T(n) read
    if (n + 1 < total && w2_copier) fetch_slice<C>(w2s, w2s_g, K::kJ, H, rank, w2_bar);
    float da[K::kRT][4 * K::kK];
#pragma unroll
    for (int i = 0; i < K::kRT; ++i)
#pragma unroll
      for (int c = 0; c < 4 * K::kK; ++c) da[i][c] = 0.f;

    for (int j = 0; j < chunks; ++j, ++n) {
      float* w1c = w1s + (n & 1) * K::kJ * K::kLdW1;
      const unsigned par = static_cast<unsigned>(n) & 1u;
      const bool ahead = j + 1 < chunks;  // dh of the tile's next chunk comes now
      const float bias = owns ? b1[j * K::kJ + col] : 0.f;
      // 1. fc1; the other block's columns go to it, this block's stay
      float zo[K::kRT], ho[K::kRT];
      {
        float acc[K::kRT][4], zt[K::kRT][K::kNE];
        mbar_wait(w1_bar + (n & 1), static_cast<unsigned>(n >> 1) & 1u);  // W1(n) has landed
        rows_dot<C>(aS, w1c, acc, q, p, s);
        scatter_lanes<K::kKS>(acc, zt, s);
        const bool hi = K::kNE == 2 && rank == 1;  // at C = 256: own entry 1, sent 0
#pragma unroll
        for (int i = 0; i < K::kRT; ++i) {
          zo[i] = hi ? zt[i][K::kNE - 1] : zt[i][0];
          ho[i] = hi ? ht[i][K::kNE - 1] : ht[i][0];
          const float zs = hi ? zt[i][0] : zt[i][K::kNE - 1];
          const float hs = hi ? ht[i][0] : ht[i][K::kNE - 1];
          if (sends)
            kasf_mma::st_async2(recv_far + sizeof(float2) * i * K::kSlots, make_float2(zs, hs),
                                recv_bar);
        }
      }
      // 2. dh of the next chunk while the partials travel
      if (ahead) {
        mbar_wait(w2_bar, static_cast<unsigned>(n + 1) & 1u);  // W2^T(n + 1) has landed
        float acc[K::kRT][4];
        rows_dot<C>(dS, w2s, acc, q, p, s);
        scatter_lanes<K::kKS>(acc, ht, s);
      }
      // 3. dz of this block's columns: the two blocks' partials in rank order
      mbar_wait_cluster(bar, par);  // the other block's partials are in
      if (tid == 0) mbar_arm(bar, K::kRecvBytes);  // the next chunk's
      float z[K::kRT], h[K::kRT];
#pragma unroll
      for (int i = 0; i < K::kRT; ++i) {
        z[i] = h[i] = 0.f;
        if (owns) {
          const float2 r = recv[i * K::kSlots + slot];
          z[i] = (rank == 0 ? zo[i] + r.x : r.x + zo[i]) + bias;
          h[i] = rank == 0 ? ho[i] + r.y : r.y + ho[i];
        }
      }
      if constexpr (K::kNE == 2) {
#pragma unroll
        for (int i = 0; i < K::kRT; ++i)
          zS[(q + K::kRG * i) * K::kJ + col] = h[i] * gelu_erf_grad(z[i]);
      } else {
        // at C = 512 half the lanes own a column: each hands rows kHalf..
        // to its partner (s ^ 2, which sends), so every lane takes at most
        // kHalf GELU's, all lanes on one instruction stream
        constexpr int kHalf = (K::kRT + 1) / 2;
        const int owner_col = owns ? col : col ^ 16;  // the owner's: p + 8 (s ^ 2)
#pragma unroll
        for (int t = 0; t < kHalf; ++t) {
          const bool mine = owns || t + kHalf < K::kRT;
          const int i = owns ? t : t + kHalf < K::kRT ? t + kHalf : 0;
          float zt = z[t], hv = h[t];
          if (t + kHalf < K::kRT) {
            const float zp = __shfl_xor_sync(0xffffffffu, z[t + kHalf], 2);
            const float hp = __shfl_xor_sync(0xffffffffu, h[t + kHalf], 2);
            zt = owns ? zt : zp;
            hv = owns ? hv : hp;
          }
          const float dz = hv * gelu_erf_grad(zt);
          if (mine) zS[(q + K::kRG * i) * K::kJ + owner_col] = dz;
        }
      }
      __syncthreads();  // this block's dz columns in; W2^T(n + 1) read
      if (ahead && n + 2 < total && w2_copier)
        fetch_slice<C>(w2s, w2s_g, (j + 2) % chunks * K::kJ, H, rank, w2_bar);
      // 4. this block's dz columns into the other block's zS
      for (int e = tid; e < K::kR * K::kW / 4; e += kT) {
        const int off = e / (K::kW / 4) * K::kJ + K::kW * rank + 4 * (e % (K::kW / 4));
        kasf_mma::st_async4(z_far + sizeof(float) * off, ld4(zS + off), z_bar);
      }
      // 5. da += dz W1: this block's columns, then the other block's
      dxp::da_chunk<K>(zS + K::kW * rank, w1c + K::kW * rank * K::kLdW1, da, q4, p4);
      mbar_wait_cluster(bar + 1, par);  // the other block's dz columns are in
      if (tid == 0) mbar_arm(bar + 1, K::kZBytes);  // the next chunk's
      dxp::da_chunk<K>(zS + K::kW * other, w1c + K::kW * other * K::kLdW1, da, q4, p4);
      __syncthreads();  // W1(n) and zS read
      if (n + 2 < total && w1_copier)
        fetch_slice<C>(w1c, w1s_g, (j + 2) % chunks * K::kJ, H, rank, w1_bar + (n & 1));
    }

    // ---- dx and the tile's partial sums over this block's channels 4 p4 +
    // 4 kCG k + v; the kCG lanes of a row group hold a row's CS channels
    constexpr int kE = 4 * K::kK;
    const int cb = rank * K::CS + 4 * p4;  // the thread's first channel
    float gam[kE];
#pragma unroll
    for (int k2 = 0; k2 < K::kK; ++k2) {
      const float4 gk = ld4(gamma + cb + 4 * K::kCG * k2);
      gam[4 * k2] = gk.x;
      gam[4 * k2 + 1] = gk.y;
      gam[4 * k2 + 2] = gk.z;
      gam[4 * k2 + 3] = gk.w;
    }
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    // the block's shares of each row's sums of da * gamma and da * gamma * xhat
    float m1[K::kRT], m2[K::kRT];
#pragma unroll
    for (int i = 0; i < K::kRT; ++i) {
      const int r = q4 + K::kRG * i;
      const long long row = row0 + r;
      const float mean = sMean[r], rstd = sRstd[r];
      m1[i] = m2[i] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < K::kK; ++k2) {
        const float4 xa = row < M ? load4(x + row * C + cb + 4 * K::kCG * k2) : zero;
        const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float dxh = da[i][4 * k2 + v] * gam[4 * k2 + v];
          m1[i] += dxh;
          m2[i] = fmaf(dxh, (xv[v] - mean) * rstd, m2[i]);
        }
      }
    }
    // [2][kNB][kR]: da * gamma, da * gamma * xhat (recv is idle until the
    // other block sends partials of the next tile's first chunk, after the
    // next tile's cluster barriers, and this block reads these before them)
    float* const sums = reinterpret_cast<float*>(recv);
#pragma unroll
    for (int i = 0; i < K::kRT; ++i) {
      m1[i] = group_sum<K::kCG>(m1[i]);
      m2[i] = group_sum<K::kCG>(m2[i]);
    }
    if (p4 < kNB) {  // lane b of the row group to block b
      const unsigned a = map_rank(sums + rank * K::kR + q4, p4);
#pragma unroll
      for (int i = 0; i < K::kRT; ++i) {
        kasf_mma::st_cluster(a + sizeof(float) * K::kRG * i, m1[i]);
        kasf_mma::st_cluster(a + sizeof(float) * (kNB * K::kR + K::kRG * i), m2[i]);
      }
    }
    kasf_mma::cluster_sync();  // both blocks' shares are in
    float sx[kE], sd[kE], sg[kE];
#pragma unroll
    for (int c = 0; c < kE; ++c) sx[c] = sd[c] = sg[c] = 0.f;
#pragma unroll
    for (int i = 0; i < K::kRT; ++i) {
      const int r = q4 + K::kRG * i;
      const long long row = row0 + r;
      const bool valid = row < M;
      const float mean = sMean[r], rstd = sRstd[r];
      const float t1 = (sums[r] + sums[K::kR + r]) * (1.0f / C);
      const float t2 = (sums[kNB * K::kR + r] + sums[(kNB + 1) * K::kR + r]) * (1.0f / C);
      float4 xa[K::kK], ga[K::kK];
#pragma unroll
      for (int k2 = 0; k2 < K::kK; ++k2) xa[k2] = valid ? load4(x + row * C + cb + 4 * K::kCG * k2) : zero;
#pragma unroll
      for (int k2 = 0; k2 < K::kK; ++k2) ga[k2] = valid ? load4(g + row * C + cb + 4 * K::kCG * k2) : zero;
      float o[kE];
#pragma unroll
      for (int k2 = 0; k2 < K::kK; ++k2) {
        const float xv[4] = {xa[k2].x, xa[k2].y, xa[k2].z, xa[k2].w};
        const float gv[4] = {ga[k2].x, ga[k2].y, ga[k2].z, ga[k2].w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = 4 * k2 + v;
          const float xh = (xv[v] - mean) * rstd, dxh = da[i][c] * gam[c];
          o[c] = gv[v] + rstd * (dxh - t1 - xh * t2);
          if (valid) {
            sx[c] = fmaf(da[i][c], xh, sx[c]);
            sd[c] += da[i][c];
            sg[c] += gv[v];
          }
        }
      }
      if (valid) {
#pragma unroll
        for (int k2 = 0; k2 < K::kK; ++k2)
          store4(dx + row * C + cb + 4 * K::kCG * k2,
                 make_float4(o[4 * k2], o[4 * k2 + 1], o[4 * k2 + 2], o[4 * k2 + 3]));
      }
    }
    // the tile's sums over the kRG row groups, in order, through aS (free:
    // last read by fc1 of the tile's last chunk)
    float* red = aS + q4 * 3 * K::CS + 4 * p4;  // [row group][3][CS]
#pragma unroll
    for (int k2 = 0; k2 < K::kK; ++k2) {
      const int o = 4 * K::kCG * k2;
      st4(red + o, make_float4(sx[4 * k2], sx[4 * k2 + 1], sx[4 * k2 + 2], sx[4 * k2 + 3]));
      st4(red + K::CS + o,
          make_float4(sd[4 * k2], sd[4 * k2 + 1], sd[4 * k2 + 2], sd[4 * k2 + 3]));
      st4(red + 2 * K::CS + o,
          make_float4(sg[4 * k2], sg[4 * k2 + 1], sg[4 * k2 + 2], sg[4 * k2 + 3]));
    }
    __syncthreads();
    for (int c = tid; c < K::CS; c += kT) {
      float t[3] = {0.f, 0.f, 0.f};
      for (int r = 0; r < K::kRG; ++r)
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) t[k3] += aS[(r * 3 + k3) * K::CS + c];
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
        part[(tile * 3 + k3) * C + rank * K::CS + c] = t[k3];
    }
  }
}

// The weights the cluster passes read (dx and weight pass), in f32 into the
// workspace, as [kNB][H][CS + 4] slices: w1s[b][j][c] = W1[j][CS b + c] and
// w2s[b][j][c] = W2[CS b + c][j], so that a chunk's slice of either, padded
// as the chunk buffers are, is one contiguous run (one bulk copy); in bf16
// also b1 widened (in f32 the passes read b1 where it is). A block a 32 x 32 tile
// of W2 (transposed through shared memory) and the same tile of W1; block 0
// also b1. Bound by bytes: W1 and W2 read and written once (4 MB each way
// in f32 at C/H 512/1024).
template <typename T, int C>
__global__ void __launch_bounds__(256)
mlp_ln_bwd_stage_kernel(const T* __restrict__ w1, const T* __restrict__ b1,
                        const T* __restrict__ w2, float* __restrict__ w1s,
                        float* __restrict__ w2s, float* __restrict__ b1f, int H) {
  using K = dxc::Cfg<C>;
  __shared__ float tile[32][33];
  const int ct = blockIdx.x / (H / 32), jt = blockIdx.x % (H / 32);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = ct * 32 + tx;  // the channel of a thread's writes
  const long long slice = (static_cast<long long>(c / K::CS) * H + jt * 32) * K::kLdW1 + c % K::CS;
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    tile[r][tx] = to_f(w2[static_cast<long long>(ct * 32 + r) * H + jt * 32 + tx]);
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    w2s[slice + r * K::kLdW1] = tile[tx][r];
    w1s[slice + r * K::kLdW1] = to_f(w1[static_cast<long long>(jt * 32 + r) * C + c]);
  }
  if (!std::is_same<T, float>::value && blockIdx.x == 0)
    for (int j = threadIdx.x; j < H; j += 256) b1f[j] = to_f(b1[j]);
}

// ---- 2. weight pass: its own tile and helpers
namespace wp {

using bf16 = __nv_bfloat16;
using dxp::ld4;
using dxp::load4;
using dxp::st4;

constexpr int kT = 256;          // threads a block: 8 warps
constexpr int kRG = kT / 32;     // row groups: group q owns rows q + 8 i
constexpr int kSMs = 132;        // the H100's: splits = min(tiles, 132 / chunks)

// The weight pass's one-block tile, at C = 64 and 128 (C = 256 and 512 take
// the cluster tile, wpc::Cfg): 40 rows and a hidden chunk of 64 columns at
// C = 128, so that dW1c and G_c (kJ x C each) are 8,192 floats a block, 64
// registers a thread, and the grid of H / kJ chunks x splits is 128 blocks at
// H = 512; at C = 64 the same 8,192 floats are a chunk of 128 columns (H a
// multiple of 128), and tiles of 56 rows: 2 x 66 blocks at H = 256, 4 tiles
// (224 rows) a split at M = 14,688 against the ideal 222.5. (At C = 64 the
// kernel is mlp_ln_bwd_w_tc_kernel, which takes this tile, chunk and its
// splits; the C = 64 branches below are no longer instantiated.)
template <int C>
struct Cfg {
  static_assert(C == 64 || C == 128, "the one-block widths");
  static constexpr int kR = C == 64 ? 56 : 40;  // rows a tile
  static constexpr int kJ = 8192 / C;   // hidden columns a block (its chunk)
  static constexpr int kRT = kR / kRG;  // 5 rows a thread (7 at C = 64)
  // staging: kLanes lanes a row (a half warp at C = 64), kQ float4s a lane
  static constexpr int kLanes = C / 4 < 32 ? C / 4 : 32;
  static constexpr int kQ = C < 128 ? 1 : C / 128;
  // fc1 and dh: kNS channel splits of kKH channels, each on kJ threads of 8
  // row groups x kJ / 8 column groups, each into its own buffer
  static constexpr int kNS = 128 / kJ;  // 2
  static constexpr int kKH = C / kNS;   // 64
  // GELU and dz: kV neighbouring columns a thread, kCols threads a row,
  // kRGz row groups of kRTz rows
  static constexpr int kV = 2;
  static constexpr int kCols = kJ / kV;
  static constexpr int kRGz = kT / kCols;
  static constexpr int kRTz = kR / kRGz;
  static constexpr int kLdA = C + 4;    // aS, gS rows: LN(x) * gamma + beta, g
  static constexpr int kLdZ = kJ + 8;   // z and dh buffers: z (then h), dh (then dz)
  static constexpr int kLdW = kJ;       // W1 chunk transposed and ls2 * W2 chunk,
                                        // channel-major: [c][j]
  // shared memory in floats: aS, gS | z, dh of split 0, z, dh of split 1,
  // ... | W1^T, ls2 * W2, b1 of the chunk | the raw stage of the next tile's
  // x and g rows, in the input dtype
  static constexpr int kOffZ = 2 * kR * kLdA;
  static constexpr int kOffW1 = kOffZ + 2 * kNS * kR * kLdZ;
  static constexpr int kOffW2 = kOffW1 + C * kLdW;
  static constexpr int kOffB1 = kOffW2 + C * kLdW;
  static constexpr int kOffRaw = kOffB1 + kJ;
  static_assert(kR % kRG == 0 && kJ % 16 == 0 && kNS * kJ == 128 && kCols * kRGz == kT &&
                    kR % kRGz == 0 && kJ * C / 4 % kT == 0,
                "the thread layouts divide the tile");
  static_assert(kOffZ % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 && kOffRaw % 4 == 0 &&
                    kLdA % 4 == 0 && kLdZ % 4 == 0,
                "16-byte alignment of the shared buffers");
  static_assert(kRGz * kJ <= kR * kLdA, "the epilogue's db1 sums fit in aS");
};

template <typename T, int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * Cfg<C>::kOffRaw + sizeof(T) * 2 * Cfg<C>::kR * C +
         sizeof(unsigned long long);
}

template <int C>
__host__ __device__ inline long long tiles(long long M) {
  return (M + Cfg<C>::kR - 1) / Cfg<C>::kR;
}
template <int C>
inline int splits(long long M, int H) {
  const long long s = kSMs / (H / Cfg<C>::kJ), t = tiles<C>(M);
  return static_cast<int>(s < 1 ? 1 : s < t ? s : t);
}

// GELU(z) and GELU'(z) = Phi(z) + z phi(z) from one erff and one expf
__device__ __forceinline__ float2 gelu_and_grad(float z) {
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752f));
  return make_float2(z * cdf, cdf + z * expf(-0.5f * z * z) * 0.39894228040143268f);
}

using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;

// One thread: copy the tile's rows row0.. (those < M) of x and of g, each a
// contiguous run in device memory, raw into the stage by two bulk copies
// (the TMA engine; no per-thread copy instructions) that complete on bar.
template <int C, typename T>
__device__ __forceinline__ void fetch_rows(T* raw, const T* __restrict__ x,
                                           const T* __restrict__ g, long long row0,
                                           long long M, unsigned long long* bar) {
  constexpr int kR = Cfg<C>::kR;
  const long long n = M - row0 < kR ? M - row0 : kR;
  const unsigned bytes = static_cast<unsigned>(n * C * sizeof(T));
  kasf_mma::mbar_expect(bar, 2 * bytes);
  kasf_mma::bulk_load(raw, x + row0 * C, bytes, bar);
  kasf_mma::bulk_load(raw + kR * C, g + row0 * C, bytes, bar);
}

// Stage the chunk's weights once, widened and channel-major: w1t[c][j] =
// W1[j0 + j][c], w2s[c][j] = ls2[c] * W2[c][j0 + j], and b1[j0..]
template <int C, typename T>
__device__ __forceinline__ void stage_weights(float* w1t, float* w2s, float* b1s,
                                              const T* __restrict__ w1,
                                              const T* __restrict__ w2,
                                              const T* __restrict__ b1,
                                              const float* __restrict__ ls2, int j0, int H,
                                              int tid) {
  constexpr int kJ = Cfg<C>::kJ, kLdW = Cfg<C>::kLdW;
  constexpr int kN = kJ * C / 4 / kT;  // float4s a thread, of each matrix
  float4 v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {  // a warp's lanes on neighbouring j
    const int e = tid + i * kT, j = e % kJ, c4 = e / kJ;
    v[i] = load4(w1 + static_cast<long long>(j0 + j) * C + 4 * c4);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, j = e % kJ, c4 = e / kJ;
    float* col = w1t + 4 * c4 * kLdW + j;
    col[0] = v[i].x;
    col[kLdW] = v[i].y;
    col[2 * kLdW] = v[i].z;
    col[3 * kLdW] = v[i].w;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, c = e / (kJ / 4), j4 = e % (kJ / 4);
    v[i] = load4(w2 + static_cast<long long>(c) * H + j0 + 4 * j4);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int e = tid + i * kT, c = e / (kJ / 4), j4 = e % (kJ / 4);
    const float s = ls2[c];
    st4(w2s + c * kLdW + 4 * j4, make_float4(v[i].x * s, v[i].y * s, v[i].z * s, v[i].w * s));
  }
  if (tid < kJ) b1s[tid] = to_f(b1[j0 + tid]);
}

// four neighbouring elements of a staged row, as f32
__device__ __forceinline__ float4 raw4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 raw4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(kasf_mma::bf16_lo(v.x), kasf_mma::bf16_hi(v.x), kasf_mma::bf16_lo(v.y),
                     kasf_mma::bf16_hi(v.y));
}

// each of the lane group's row sums over its L neighbouring lanes (at L = 32
// warp_sum's order)
template <int L, int R>
__device__ __forceinline__ void rows_sum(float (&s)[R]) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
}

// aS = LN(x) * gamma + beta and gS = g from the raw stage. Warp w takes rows
// w + 8i; lane l holds channels 4l..4l+3 (+ 128 q) at C = 128; at C = 64 the
// half warp l / 16 takes every other of those rows (the second half none of
// the last at an odd kRT), lane l channels 4 (l % 16)... Rows >= M are zeros.
template <int C, typename T>
__device__ __forceinline__ void stage_rows(const T* raw, float* aS, float* gS,
                                           const float4 (&gm)[Cfg<C>::kQ],
                                           const float4 (&bt)[Cfg<C>::kQ], long long row0,
                                           long long M, float eps, int warp, int lane) {
  using K = Cfg<C>;
  constexpr int kQ = K::kQ, kL = K::kLanes, kS = 32 / kL;
  constexpr int kRT = (K::kRT + kS - 1) / kS;  // rows a lane holds
  const int cl = lane % kL, sub = lane / kL;    // at C = 128: lane, 0
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[kRT][kQ], gv[kRT][kQ];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = warp + kRG * (kS * i + sub);
    const bool valid = kS * i + sub < K::kRT && row0 + r < M;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      xv[i][q] = valid ? raw4(raw + r * C + 4 * cl + 128 * q) : zero;
      gv[i][q] = valid ? raw4(raw + (K::kR + r) * C + 4 * cl + 128 * q) : zero;
    }
  }
  // the rows' statistics reduce together, one shuffle of each row a step,
  // so their latencies overlap; rsqrtf has no branch to serialise them
  float s[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    s[i] = quad_sum(xv[i][0]);
#pragma unroll
    for (int q = 1; q < kQ; ++q) s[i] += quad_sum(xv[i][q]);
  }
  rows_sum<kL>(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const float mean = s[i] * (1.0f / C);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 v = xv[i][q];
      xv[i][q] = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
    }
    s[i] = quad_sq(xv[i][0]);
#pragma unroll
    for (int q = 1; q < kQ; ++q) s[i] += quad_sq(xv[i][q]);
  }
  rows_sum<kL>(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (kS * i + sub >= K::kRT) continue;  // past the warp's rows (C = 64 only)
    const int r = warp + kRG * (kS * i + sub);
    const float rstd = rsqrtf(s[i] * (1.0f / C) + eps);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 xc = xv[i][q], gmq = gm[q], btq = bt[q];
      st4(aS + r * K::kLdA + 4 * cl + 128 * q,
          make_float4(fmaf(xc.x * rstd, gmq.x, btq.x), fmaf(xc.y * rstd, gmq.y, btq.y),
                      fmaf(xc.z * rstd, gmq.z, btq.z), fmaf(xc.w * rstd, gmq.w, btq.w)));
      st4(gS + r * K::kLdA + 4 * cl + 128 * q, gv[i][q]);
    }
  }
}

// out = X Wc over the channel split kh (channels kh kKH .. +kKH), for fc1
// (X = a, Wc = W1c^T: z without b1) and dh (X = g, Wc = ls2 * W2c). Thread
// (row group q, column group p of kJ / 8): rows q + 8i, hidden columns
// 4p..4p+3 and kJ / 2 + 4p..; each step of four channels reads 8 Wc and kRT
// X float4s for 32 kRT FMAs.
template <int C>
__device__ __forceinline__ void split_product(const float* X, const float* Wc, float* out,
                                              int kh, int q, int p) {
  using K = Cfg<C>;
  constexpr int kRT = K::kRT, kJ = K::kJ;
  float acc[kRT][8];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[i][v] = 0.f;
#pragma unroll 2
  for (int c = kh * K::kKH; c < kh * K::kKH + K::kKH; c += 4) {
    float4 w[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = ld4(Wc + (c + u) * K::kLdW + 4 * p);
      w[4 + u] = ld4(Wc + (c + u) * K::kLdW + kJ / 2 + 4 * p);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float4 d = ld4(X + (q + kRG * i) * K::kLdA + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float& o = acc[i][4 * h + v];
          o = fmaf(d.x, dxp::lane4(w[4 * h], v), o);
          o = fmaf(d.y, dxp::lane4(w[4 * h + 1], v), o);
          o = fmaf(d.z, dxp::lane4(w[4 * h + 2], v), o);
          o = fmaf(d.w, dxp::lane4(w[4 * h + 3], v), o);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    float* row = out + (q + kRG * i) * K::kLdZ + 4 * p;
    st4(row, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    st4(row + kJ / 2, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// two neighbouring floats of shared memory: loaded, added to v, stored (one
// float2 access)
template <int kV>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[kV]) {
  static_assert(kV == 2, "a float2");
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x;
  v[1] = f.y;
}
template <int kV>
__device__ __forceinline__ void add_cols(const float* p, float (&v)[kV]) {
  float w[kV];
  load_cols<kV>(p, w);
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] += w[i];
}
template <int kV>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[kV]) {
  static_assert(kV == 2, "a float2");
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// acc[a][b] += P[r][a] Q[r][b] over the tile's R rows, where the thread's a
// are 4 neighbours at P and 4 at P + kHalfP, its b likewise at Q: dW1c
// (P = dz, Q = a) or G_c (P = g, Q = h). 4 float4s a row for 64 FMAs.
template <int R, int kLdP, int kHalfP, int kLdQ, int kHalfQ>
__device__ __forceinline__ void outer_tile(const float* P, const float* Q,
                                           float (&acc)[8][8]) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float4 p0 = ld4(P + r * kLdP), p1 = ld4(P + r * kLdP + kHalfP);
    const float4 q0 = ld4(Q + r * kLdQ), q1 = ld4(Q + r * kLdQ + kHalfQ);
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(pv[a], qv[b], acc[a][b]);
  }
}

}  // namespace wp

// At C = 128: one block per (hidden chunk of wp::Cfg<C>::kJ, row split); the
// split's tiles through a raw stage that one thread fills by bulk copies; warps 0-3
// run fc1 and warps 4-7 dh, each over kNS channel splits, all take GELU and
// dz, then warps 0-3 accumulate dW1c and warps 4-7 G_c in registers; the
// split's partial at the end.
template <typename T, int C>
__global__ void __launch_bounds__(wp::kT, 1)
mlp_ln_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const float* __restrict__ ls2,
                    float* __restrict__ part, long long M, int H, float eps) {
  using namespace wp;
  using K = Cfg<C>;
  constexpr int kJ = K::kJ, kR = K::kR, kLdZ = K::kLdZ, kLdA = K::kLdA, kV = K::kV;
  extern __shared__ float4 smem4[];
  float* aS = reinterpret_cast<float*>(smem4);
  float* gS = aS + kR * kLdA;
  float* zb = aS + K::kOffZ;  // split s: z at zb + 2 s kR kLdZ, dh after it
  float* zS = zb;             // h = GELU(z) after the sum
  float* hS = zb + kR * kLdZ; // dz after the sum
  float* w1t = aS + K::kOffW1;
  float* w2s = aS + K::kOffW2;
  float* b1s = aS + K::kOffB1;
  T* raw = reinterpret_cast<T*>(aS + K::kOffRaw);
  auto* bar = reinterpret_cast<unsigned long long*>(raw + 2 * kR * C);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJ;
  const long long n_tiles = tiles<C>(M);
  const long long per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const long long t_begin = blockIdx.y * per;
  const long long t_end = t_begin + per < n_tiles ? t_begin + per : n_tiles;
  if (tid == 0) mbar_init(bar);
  __syncthreads();  // the barrier is initialised
  if (tid == 0 && t_begin < t_end) fetch_rows<C>(raw, x, g, t_begin * kR, M, bar);
  stage_weights<C>(w1t, w2s, b1s, w1, w2, b1, ls2, j0, H, tid);
  __syncthreads();  // the weights are staged
  float4 gm[K::kQ], bt[K::kQ];
#pragma unroll
  for (int q = 0; q < K::kQ; ++q) {
    gm[q] = ld4(gamma + 4 * (lane % K::kLanes) + 128 * q);
    bt[q] = ld4(beta + 4 * (lane % K::kLanes) + 128 * q);
  }
  // GELU's columns kV jc.. of rows qz + kRGz i (at C = 128 a lane's pair of a
  // warp's rows)
  const int jc = tid % K::kCols, qz = tid / K::kCols;
  float b1p[kV];
  load_cols<kV>(b1s + 2 * jc, b1p);

  // fc1 / dh (thread idx of warps 0-3 or 4-7): channel split kh = idx / kJ,
  // row group q8 = (idx % kJ) / (kJ / 8), column group idx % (kJ / 8).
  // Outer products: g8 = (idx / 8) % (kJ / 8), g16 = 8 (idx / kJ) + idx % 8
  // (at C = 128 g8 is q8); warps 0-3 hold dW1c[4 g8 + v (+kJ/2)][4 g16 + v
  // (+C/2)], warps 4-7 G_c[4 g16 + v (+C/2)][4 g8 + v (+kJ/2)]
  const int idx = tid & 127, kh = idx / kJ;
  const int q8 = idx % kJ / (kJ / 8), p8 = idx % (kJ / 8);
  const int g8 = idx / 8 % (kJ / 8), g16 = 8 * (idx / kJ) + (idx & 7);
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float db1a[kV];  // columns kV jc.. over rows qz + kRGz i
#pragma unroll
  for (int v = 0; v < kV; ++v) db1a[v] = 0.f;
  for (long long t = t_begin; t < t_end; ++t) {
    mbar_wait(bar, static_cast<unsigned>((t - t_begin) & 1));
    __syncthreads();  // tile t's rows landed; the last tile's products are done
    stage_rows<C>(raw, aS, gS, gm, bt, t * kR, M, eps, warp, lane);
    __syncthreads();  // a and g in; the stage is free
    if (tid == 0 && t + 1 < t_end) fetch_rows<C>(raw, x, g, (t + 1) * kR, M, bar);
    float* out = zb + (2 * kh + (warp < 4 ? 0 : 1)) * kR * kLdZ;
    if (warp < 4)
      split_product<C>(aS, w1t, out, kh, q8, p8);
    else
      split_product<C>(gS, w2s, out, kh, q8, p8);
    __syncthreads();  // every split's z and dh in
    // z + b1 and dh from their splits in order; h = GELU(z) in place of z,
    // dz = dh * GELU'(z) in place of dh
#pragma unroll
    for (int i = 0; i < K::kRTz; ++i) {
      const int o = (qz + K::kRGz * i) * kLdZ + kV * jc;
      float z[kV], d[kV];
      load_cols<kV>(zb + o, z);  // the splits' z in order, then their dh
#pragma unroll
      for (int s = 1; s < K::kNS; ++s) add_cols<kV>(zb + 2 * s * kR * kLdZ + o, z);
      load_cols<kV>(zb + kR * kLdZ + o, d);
#pragma unroll
      for (int s = 1; s < K::kNS; ++s) add_cols<kV>(zb + (2 * s + 1) * kR * kLdZ + o, d);
      float h[kV], dz[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float2 e = gelu_and_grad(z[v] + b1p[v]);
        h[v] = e.x;
        dz[v] = d[v] * e.y;
        db1a[v] += dz[v];
      }
      store_cols<kV>(zS + o, h);
      store_cols<kV>(hS + o, dz);
    }
    __syncthreads();  // h and dz in
    if (warp < 4)
      outer_tile<kR, kLdZ, kJ / 2, kLdA, C / 2>(hS + 4 * g8, aS + 4 * g16, acc);
    else
      outer_tile<kR, kLdA, C / 2, kLdZ, kJ / 2>(gS + 4 * g16, zS + 4 * g8, acc);
  }

  // the split's partial: dW1c rows, G_c columns, db1c
  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * C + H);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float4 lo = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    const float4 hi = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    if (warp < 4) {
      const int j = 4 * g8 + (a & 3) + (a < 4 ? 0 : kJ / 2);
      float* row = base + static_cast<long long>(j0 + j) * C + 4 * g16;
      st4(row, lo);
      st4(row + C / 2, hi);
    } else {
      const int c = 4 * g16 + (a & 3) + (a < 4 ? 0 : C / 2);
      float* row = base + static_cast<long long>(H) * C + static_cast<long long>(c) * H +
                   j0 + 4 * g8;
      st4(row, lo);
      st4(row + kJ / 2, hi);
    }
  }
  __syncthreads();  // aS is free
  float* red = aS;  // [row group][kJ]
#pragma unroll
  for (int v = 0; v < kV; ++v) red[qz * kJ + kV * jc + v] = db1a[v];
  __syncthreads();
  if (tid < kJ) {
    float s = 0.f;
    for (int q = 0; q < K::kRGz; ++q) s += red[q * kJ + tid];
    base[2LL * H * C + j0 + tid] = s;
  }
}

// ---- 2c. weight pass at C = 64 on the tensor cores in 3xTF32: its own
// layouts and helpers; the tile, chunk and splits are wp::Cfg<64>'s
namespace tc {

using bf16 = __nv_bfloat16;
using dxp::ld4;
using dxp::st4;
using kasf_mma::mma_tf32x3;
using kasf_mma::split_tf32;
using P = wp::Cfg<64>;

constexpr int kT = 256;      // 8 warps: warp w holds chunk columns 16 w .. 16 w + 15
constexpr int C = 64;
constexpr int kR = P::kR;    // 56 rows a tile: 7 n8 (products 1-2) or k8 (3-4) steps
constexpr int kJ = P::kJ;    // 128 hidden columns a chunk: 8 m16 tiles, one a warp
constexpr int kRS = kR / 8;  // 7 row steps
constexpr int kCS = C / 8;   // 8 channel steps
// A plane holds a tile's (rows, 64) operand split for 3xTF32: channels 2p
// and 2p + 1 of row r as one 16-byte unit (hi, hi, lo, lo) at r kLd + 4 (p ^
// sw(r)), so a unit is a B fragment's hi and lo register pairs when its two
// k-slots are those channels (products 1-2). The swizzle puts the 8 units a
// quarter warp loads in one instruction on distinct bank groups: rows g =
// 2q, 2q + 1 at units 4k + t (t < 4) in products 1-2, rows 2t and 2t + 1 at
// units 8q + g (g = 2q', 2q' + 1) in products 3-4.
constexpr int kLd = 2 * C;
// The weights' planes hold the A fragments themselves: for warp w, k8 step k
// and lane (g, t) the float4 {X(j, c), X(j + 8, c), X(j, c + 1), X(j + 8, c +
// 1)}, j = 16 w + g, c = 8k + 2t, of the hi parts at ((8 w + k) 32 + lane) 4,
// of the lo parts kFrag floats further: a fragment is one 16-byte load, a
// warp's 32 of them 512 contiguous bytes.
constexpr int kFrag = kJ * C;  // floats of a matrix's hi (or lo) fragments
constexpr int kOffG = kR * kLd;              // the tile's planes: a = LN(x) gamma + beta, g
constexpr int kOffW1 = 2 * kR * kLd;         // the chunk's W1c (j, c)
constexpr int kOffW2 = kOffW1 + 2 * kFrag;   // and (ls2 W2c)^T (j, c)
constexpr int kOffRaw = kOffW2 + 2 * kFrag;  // the next tile's x and g rows, raw
// the weights' raw rows land at the end of their fragments (W1c [128][64],
// W2c [64][128] in the input dtype) and are split into them in place
template <typename T>
__host__ __device__ constexpr int raw_w() {
  return 2 * kFrag - kJ * C * static_cast<int>(sizeof(T)) / 4;
}
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * kOffRaw + sizeof(T) * 2 * kR * C + 2 * sizeof(unsigned long long);
}
static_assert(kR % 8 == 0 && kJ == 16 * (kT / 32) && C == 8 * (kT / 32),
              "one m16 tile a warp; a warp a k8 step of the weights' split");
static_assert(kOffW1 % 4 == 0 && kOffRaw % 4 == 0 && raw_w<float>() % 4 == 0 &&
                  raw_w<bf16>() % 4 == 0,
              "16-byte alignment of the shared buffers");
static_assert(smem_bytes<float>() <= 232448, "one block a SM");

// the float offset of unit p (channels 2p, 2p + 1) of row r in a plane
__device__ __forceinline__ int unit(int r, int p) {
  return r * kLd + 4 * (p ^ ((((r >> 1) & 3) << 1) ^ ((r & 1) << 2)));
}

// four neighbouring channels' values (units 2p', 2p' + 1, which the swizzle
// keeps side by side) split and stored as two units
__device__ __forceinline__ void store_split4(float* p, float4 v) {
  const float2 a = split_tf32(v.x), b = split_tf32(v.y), c = split_tf32(v.z),
               d = split_tf32(v.w);
  st4(p, make_float4(a.x, b.x, a.y, b.y));
  st4(p + 4, make_float4(c.x, d.x, c.y, d.y));
}

// a float4's bits as a fragment's four registers
__device__ __forceinline__ void bits4(float4 v, uint32_t (&r)[4]) {
  r[0] = __float_as_uint(v.x);
  r[1] = __float_as_uint(v.y);
  r[2] = __float_as_uint(v.z);
  r[3] = __float_as_uint(v.w);
}

// One warp: the chunk's W1c and W2c (rows j0.. of W1, one contiguous run;
// columns j0.. of W2, a run of 128 a channel) raw into the ends of their
// fragments' room by bulk copies on bar
template <typename T>
__device__ __forceinline__ void fetch_weights(float* w1F, float* w2F, const T* __restrict__ w1,
                                              const T* __restrict__ w2, int j0, int H, int lane,
                                              unsigned long long* bar) {
  T* r1 = reinterpret_cast<T*>(w1F + raw_w<T>());
  T* r2 = reinterpret_cast<T*>(w2F + raw_w<T>());
  if (lane == 0) kasf_mma::mbar_expect(bar, 2 * kJ * C * sizeof(T));
  __syncwarp();
  if (lane < 16)  // 8 rows of W1c a lane
    kasf_mma::bulk_load(r1 + 8 * C * lane, w1 + static_cast<long long>(j0 + 8 * lane) * C,
                        8 * C * sizeof(T), bar);
  for (int c = lane; c < C; c += 32)
    kasf_mma::bulk_load(r2 + kJ * c, w2 + static_cast<long long>(c) * H + j0, kJ * sizeof(T),
                        bar);
}

// two neighbouring raw elements as f32
__device__ __forceinline__ float2 raw2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 raw2(const bf16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(kasf_mma::bf16_lo(v), kasf_mma::bf16_hi(v));
}

// a fragment's four values split, its hi and lo float4s stored
__device__ __forceinline__ void store_frag(float* f, float4 v) {
  const float2 a = split_tf32(v.x), b = split_tf32(v.y), c = split_tf32(v.z),
               d = split_tf32(v.w);
  st4(f, make_float4(a.x, b.x, c.x, d.x));
  st4(f + kFrag, make_float4(a.y, b.y, c.y, d.y));
}

// The weights' fragments from their raw rows: X = W1c, X(j, c) = W1c[j][c],
// and X = (ls2 W2c)^T, X(j, c) = ls2[c] W2c[c][j], the A operands of z^T =
// W1c a^T and dh^T = (ls2 W2c)^T g^T. A matrix's fragments overwrite its raw
// rows, so every thread reads its share first, a block barrier, then the
// split stores: W1c, then W2c. Thread (warp W, lane L) takes of W1c the
// fragments (w = i, lane (g = W, t = L % 4), k = L / 4): rows 16 i + W and +
// 8, channels 2L, 2L + 1, a warp reading 256 contiguous bytes a row; of W2c
// the quads q = tid + 256 i, each four fragments (g = g0 .. g0 + 3) of one
// (w, k, t): four 16-byte reads (channels c, c + 1 at columns j = 16 w + g0
// and j + 8).
template <typename T>
__device__ __forceinline__ void split_weights(float* w1F, float* w2F,
                                              const float* __restrict__ ls2, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const T* r1 = reinterpret_cast<const T*>(w1F + raw_w<T>());
  float4 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 u = raw2(r1 + (16 * i + warp) * C + 2 * lane);
    const float2 w = raw2(r1 + (16 * i + warp + 8) * C + 2 * lane);
    v[i] = make_float4(u.x, w.x, u.y, w.y);
  }
  __syncthreads();  // W1c's raw rows are read: its fragments may overwrite them
#pragma unroll
  for (int i = 0; i < 8; ++i)
    store_frag(w1F + ((8 * i + lane / 4) * 32 + 4 * warp + lane % 4) * 4, v[i]);
  const T* r2 = reinterpret_cast<const T*>(w2F + raw_w<T>());
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // quad q: g0 = 4 (q & 1), w = 2 (q >> 7) + (q >> 1 & 1)
    const int q = tid + kT * i, t = q >> 2 & 3, k = q >> 4 & 7;
    const int c = 8 * k + 2 * t, j = 16 * (2 * (q >> 7) + (q >> 1 & 1)) + 4 * (q & 1);
    v[4 * i] = wp::raw4(r2 + c * kJ + j);
    v[4 * i + 1] = wp::raw4(r2 + c * kJ + j + 8);
    v[4 * i + 2] = wp::raw4(r2 + (c + 1) * kJ + j);
    v[4 * i + 3] = wp::raw4(r2 + (c + 1) * kJ + j + 8);
  }
  __syncthreads();  // W2c's raw rows are read
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = tid + kT * i, t = q >> 2 & 3, k = q >> 4 & 7;
    const int w = 2 * (q >> 7) + (q >> 1 & 1), g0 = 4 * (q & 1);
    const float s0 = ls2[8 * k + 2 * t], s1 = ls2[8 * k + 2 * t + 1];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      store_frag(w2F + ((8 * w + k) * 32 + 4 * (g0 + u) + t) * 4,
                 make_float4(s0 * dxp::lane4(v[4 * i], u), s0 * dxp::lane4(v[4 * i + 1], u),
                             s1 * dxp::lane4(v[4 * i + 2], u), s1 * dxp::lane4(v[4 * i + 3], u)));
  }
}

// aP = LN(x) * gamma + beta and gP = g from the raw stage, split: warp w
// takes rows w + 8 i, its half warps every other one (the second none of the
// last); lane l channels 4 (l % 16)... Rows >= M are zeros (a = beta, g = 0).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* raw, float* aP, float* gP, float4 gm,
                                           float4 bt, long long row0, long long M, float eps,
                                           int warp, int lane) {
  constexpr int kRT = (kR / 8 + 1) / 2;  // rows a lane holds: 4 (the second half warp 3)
  const int cl = lane % 16, sub = lane / 16;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[kRT], gv[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = warp + 8 * (2 * i + sub);
    const bool valid = 2 * i + sub < kR / 8 && row0 + r < M;
    xv[i] = valid ? wp::raw4(raw + r * C + 4 * cl) : zero;
    gv[i] = valid ? wp::raw4(raw + (kR + r) * C + 4 * cl) : zero;
  }
  float s[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) s[i] = quad_sum(xv[i]);
  wp::rows_sum<16>(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const float mean = s[i] * (1.0f / C);
    const float4 v = xv[i];
    xv[i] = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
    s[i] = quad_sq(xv[i]);
  }
  wp::rows_sum<16>(s);
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (2 * i + sub >= kR / 8) continue;  // past the warp's rows
    const int r = warp + 8 * (2 * i + sub);
    const float rstd = rsqrtf(s[i] * (1.0f / C) + eps);
    const float4 xc = xv[i];
    const int o = unit(r, 2 * cl);
    store_split4(aP + o, make_float4(fmaf(xc.x * rstd, gm.x, bt.x), fmaf(xc.y * rstd, gm.y, bt.y),
                                     fmaf(xc.z * rstd, gm.z, bt.z), fmaf(xc.w * rstd, gm.w, bt.w)));
    store_split4(gP + o, gv[i]);
  }
}

// GELU(z) and GELU'(z) = Phi(z) + z phi(z), with erf by Abramowitz and
// Stegun 7.1.26 as dxg::gelu_grad takes it (|error| <= 1.5e-7), so that one
// exp(-z^2 / 2) serves Phi and phi
__device__ __forceinline__ float2 gelu_and_grad(float z) {
  const float e = expf(-0.5f * z * z);
  const float t = __fdividef(1.0f, fmaf(0.3275911f * 0.70710678118654752f, fabsf(z), 1.0f));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float cdf = 0.5f + copysignf(fmaf(-0.5f * p, e, 0.5f), z);  // Phi(z)
  return make_float2(z * cdf, cdf + z * e * 0.39894228040143268f);
}

}  // namespace tc

// At C = 64 (see 2c. above): one block of 8 warps per (hidden chunk of 128,
// row split of 56-row tiles), warp w over chunk columns jr = 16 w + g and
// jr + 8 (g = lane / 4, t = lane % 4). A tile: the rows' LN, a and g split
// into planes; z^T and dh^T (16 x 56 a warp) on mma.sync m16n8k8 in
// 3xTF32 from the weights' fragments and the tile's planes, k-slots t and t
// + 4 of k8 step k on channels 8k + 2t and 8k + 2t + 1 (one unit); h, dz and db1 in
// the accumulators' registers; dW1c += dz^T a and G_c^T += h^T g on the same
// mma, their A fragments from those registers, n8 steps 2q and 2q + 1 on
// channels 16q + 2g and 16q + 2g + 1 (one unit); dW1c and G_c (32 registers
// each a thread) over the whole split; the split's partial at the end.
template <typename T>
__global__ void __launch_bounds__(tc::kT, 1)
mlp_ln_bwd_w_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const T* __restrict__ w1, const T* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ ls2,
                       float* __restrict__ part, long long M, int H, float eps) {
  using namespace tc;
  extern __shared__ float4 smem4[];
  float* aP = reinterpret_cast<float*>(smem4);
  float* gP = aP + kOffG;
  float* w1F = aP + kOffW1;
  float* w2F = aP + kOffW2;
  T* raw = reinterpret_cast<T*>(aP + kOffRaw);
  auto* bars = reinterpret_cast<unsigned long long*>(raw + 2 * kR * C);  // rows, weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, jr = 16 * warp + gq;
  const int j0 = blockIdx.x * kJ;
  const long long n_tiles = wp::tiles<C>(M);
  const long long per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const long long t_begin = blockIdx.y * per;
  const long long t_end = t_begin + per < n_tiles ? t_begin + per : n_tiles;
  if (tid == 0) {
    kasf_mma::mbar_init(bars);
    kasf_mma::mbar_init(bars + 1);
  }
  __syncthreads();  // both mbarriers are initialised
  if (tid == 0 && t_begin < t_end) wp::fetch_rows<C>(raw, x, g, t_begin * kR, M, bars);
  if (warp == 1 && t_begin < t_end) fetch_weights<T>(w1F, w2F, w1, w2, j0, H, lane, bars + 1);
  const float4 gm = ld4(gamma + 4 * (lane % 16)), bt = ld4(beta + 4 * (lane % 16));
  const float b1j[2] = {to_f(b1[j0 + jr]), to_f(b1[j0 + jr + 8])};

  float dw[kCS][4], gg[kCS][4];  // dW1c, G_c^T: rows jr, jr + 8; n8 step n channels 16 (n / 2) + 2g + n % 2
#pragma unroll
  for (int n = 0; n < kCS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[n][i] = gg[n][i] = 0.f;
  float db1[2] = {0.f, 0.f};  // columns jr, jr + 8 over the thread's rows
  for (long long t = t_begin; t < t_end; ++t) {
    kasf_mma::mbar_wait(bars, static_cast<unsigned>((t - t_begin) & 1));
    stage_rows<T>(raw, aP, gP, gm, bt, t * kR, M, eps, warp, lane);
    if (t == t_begin) {  // the weights landed under the first tile's LayerNorm
      kasf_mma::mbar_wait(bars + 1, 0);
      split_weights<T>(w1F, w2F, ls2, tid);
    }
    __syncthreads();  // the tile's planes (and the weights') in; the stage is free
    if (tid == 0 && t + 1 < t_end) wp::fetch_rows<C>(raw, x, g, (t + 1) * kR, M, bars);

    // 1-2. z^T = W1c a^T and dh^T = (ls2 W2c)^T g^T: m16 = the warp's
    // columns, k8 steps over the channels, n8 steps over the rows
    float z[kRS][4], d[kRS][4];
#pragma unroll
    for (int n = 0; n < kRS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) z[n][i] = d[n][i] = 0.f;
#pragma unroll
    for (int k = 0; k < kCS; ++k) {
      const int p = 4 * k + tq;  // channels 8k + 2t (slot t), 8k + 2t + 1 (slot t + 4)
      uint32_t w1h[4], w1l[4], w2h[4], w2l[4];  // a = {(jr, t), (jr + 8, t), (jr, t + 4), (jr + 8, t + 4)}
      const int f = ((8 * warp + k) * 32 + lane) * 4;
      bits4(ld4(w1F + f), w1h);
      bits4(ld4(w1F + kFrag + f), w1l);
      bits4(ld4(w2F + f), w2h);
      bits4(ld4(w2F + kFrag + f), w2l);
#pragma unroll
      for (int n = 0; n < kRS; ++n) {
        const int r = 8 * n + gq;
        const float4 ua = ld4(aP + unit(r, p)), ug = ld4(gP + unit(r, p));
        const uint32_t ah[2] = {__float_as_uint(ua.x), __float_as_uint(ua.y)};
        const uint32_t al[2] = {__float_as_uint(ua.z), __float_as_uint(ua.w)};
        const uint32_t gh[2] = {__float_as_uint(ug.x), __float_as_uint(ug.y)};
        const uint32_t gl[2] = {__float_as_uint(ug.z), __float_as_uint(ug.w)};
        mma_tf32x3(z[n], w1h, w1l, ah, al);
        mma_tf32x3(d[n], w2h, w2l, gh, gl);
      }
    }
    // h = GELU(z + b1) in place of z, dz = dh GELU'(z + b1) in place of dh;
    // db1 over the thread's rows in order
#pragma unroll
    for (int n = 0; n < kRS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = gelu_and_grad(z[n][i] + b1j[i >> 1]);
        z[n][i] = e.x;
        d[n][i] *= e.y;
        db1[i >> 1] += d[n][i];
      }
    // 3-4. dW1c += dz^T a and G_c^T += h^T g: k8 step n over rows 8 n..,
    // slot t row 8 n + 2 t and slot t + 4 row 8 n + 2 t + 1, so the A
    // fragments are the n-tiles of h and dz; n8 steps over the channels
#pragma unroll
    for (int n = 0; n < kRS; ++n) {
      uint32_t hh[4], hl[4], zh[4], zl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int src = (i & 1) * 2 + (i >> 1);  // a = {c0, c2, c1, c3}
        const float2 hs = split_tf32(z[n][src]), ds = split_tf32(d[n][src]);
        hh[i] = __float_as_uint(hs.x);
        hl[i] = __float_as_uint(hs.y);
        zh[i] = __float_as_uint(ds.x);
        zl[i] = __float_as_uint(ds.y);
      }
      const int r = 8 * n + 2 * tq;
#pragma unroll
      for (int q = 0; q < kCS / 2; ++q) {  // n8 steps 2q, 2q + 1: unit 8q + g of rows r, r + 1
        const int p = 8 * q + gq;
        const float4 a0 = ld4(aP + unit(r, p)), a1 = ld4(aP + unit(r + 1, p));
        const float4 g0 = ld4(gP + unit(r, p)), g1 = ld4(gP + unit(r + 1, p));
        // n8 step 2q: channel 16q + 2g, the units' first; 2q + 1 the second
        uint32_t bh[2] = {__float_as_uint(a0.x), __float_as_uint(a1.x)};
        uint32_t bl[2] = {__float_as_uint(a0.z), __float_as_uint(a1.z)};
        mma_tf32x3(dw[2 * q], zh, zl, bh, bl);
        bh[0] = __float_as_uint(a0.y); bh[1] = __float_as_uint(a1.y);
        bl[0] = __float_as_uint(a0.w); bl[1] = __float_as_uint(a1.w);
        mma_tf32x3(dw[2 * q + 1], zh, zl, bh, bl);
        bh[0] = __float_as_uint(g0.x); bh[1] = __float_as_uint(g1.x);
        bl[0] = __float_as_uint(g0.z); bl[1] = __float_as_uint(g1.z);
        mma_tf32x3(gg[2 * q], hh, hl, bh, bl);
        bh[0] = __float_as_uint(g0.y); bh[1] = __float_as_uint(g1.y);
        bl[0] = __float_as_uint(g0.w); bl[1] = __float_as_uint(g1.w);
        mma_tf32x3(gg[2 * q + 1], hh, hl, bh, bl);
      }
    }
    __syncthreads();  // the planes are read: the next tile's may replace them
  }

  // the split's partial: dW1c rows, G_c columns (channels 16q + 4t .. + 3 of
  // n8 steps 2q, 2q + 1), db1c (the four lanes of a column in a fixed order)
  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * C + H);
  float* gc = base + static_cast<long long>(H) * C;
#pragma unroll
  for (int q = 0; q < kCS / 2; ++q) {
    const int c = 16 * q + 4 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = j0 + jr + 8 * h;
      st4(base + j * C + c, make_float4(dw[2 * q][2 * h], dw[2 * q + 1][2 * h],
                                        dw[2 * q][2 * h + 1], dw[2 * q + 1][2 * h + 1]));
      gc[c * H + j] = gg[2 * q][2 * h];
      gc[(c + 1) * H + j] = gg[2 * q + 1][2 * h];
      gc[(c + 2) * H + j] = gg[2 * q][2 * h + 1];
      gc[(c + 3) * H + j] = gg[2 * q + 1][2 * h + 1];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = db1[h];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tq == 0) base[2LL * H * C + j0 + jr + 8 * h] = s;
  }
}

// ---- 2b. weight pass at C = 256 and 512: a thread-block cluster of two
// blocks a (hidden chunk, row split), each over half the channels
namespace wpc {

using dxp::ld4;
using dxp::st4;
using wp::raw4;
using wp::rows_sum;

constexpr int kT = 256;  // threads a block: 8 warps
constexpr int kNB = 2;   // blocks a cluster

// Block b of a cluster holds channels CS b .. CS b + CS - 1 of its split's
// rows and accumulates dW1c (kJ x CS) and G_c (CS x kJ) over them: 8,192
// floats each, 64 registers a thread, as the C = 128 block does. So its
// chunk is kJ = 8192 / CS hidden columns (64 at C = 256, 32 at 512), twice
// the one-block tile's at the same registers; block b finishes z, h and dz
// of columns kHalf b .. kHalf b + kHalf - 1 of it. Rows a tile from the
// shared-memory budget: 48 at C = 256, 32 at 512.
template <int C>
struct Cfg {
  static_assert(C == 256 || C == 512, "the cluster widths");
  static constexpr int CS = C / kNB;             // channels a block: 128, 256
  static constexpr int kJ = 8192 / CS;           // hidden columns a chunk: 64, 32
  static constexpr int kHalf = kJ / kNB;         // ... a block finishes: 32, 16
  static constexpr int kR = C == 256 ? 48 : 32;  // rows a tile
  static constexpr int kRG = 8;                  // row groups: group q rows q + 8 i
  static constexpr int kRT = kR / kRG;           // 6, 4
  // fc1 (warps 0-3) and dh (warps 4-7): lane (s, p, q) of kKS x kPG x 8
  // takes rows q + 8 i, columns p + kPG u (u < 8) and a kKS-th of the
  // block's channels, the float4s 8 b + kG s + e (e < kG) of each run of 8:
  // a warp's X loads touch 4 (C = 256) or 8 float4s on distinct banks, its W
  // loads 16 (two wavefronts, the fewest)
  static constexpr int kKS = CS / 64;            // 2, 4
  static constexpr int kG = 8 / kKS;             // 4, 2
  static constexpr int kPG = kJ / 8;             // 8, 4
  static constexpr int kE = 4 / kKS;             // columns of each block a lane keeps of
                                                 // a reduce-scatter: 2, 1
  static constexpr int kLR = C == 256 ? 16 : 8;  // lanes that stage a row (kRT kLR / 32 rows)
  static constexpr int kLdA = CS + 4;            // aS, gS rows
  static constexpr int kLdW = dxc::Cfg<C>::kLdW1;  // W1, W2^T slice rows (the stage launch's)
  // shared memory (floats): aS, gS [kR][kLdA] (LN(x) * gamma + beta, g) |
  // W1, ls2 * W2^T [kJ][kLdW] (the chunk's rows over the block's channels) |
  // own [2][kR][kHalf] (z, dh of this block's columns over its channels) |
  // recv [2][kR][kHalf] (the same over the other block's channels) | hS,
  // dzS [kR][kJ] | ln [kR] float2 (the other block's LN sums) | mbarriers
  // (raw, weights, ln, recv, hz) | the raw stage [2][kR][CS] (x, g) in the
  // input dtype, 128-byte aligned for the tensor copies. Where kDirectG
  // (below), gS's room goes to a second g buffer after the stage, and the
  // offsets after aS move down by kR kLdA.
  static constexpr int kOffG = kR * kLdA;
  static constexpr int kOffW1 = 2 * kR * kLdA;
  static constexpr int kOffW2 = kOffW1 + kJ * kLdW;
  static constexpr int kOffOwn = kOffW2 + kJ * kLdW;
  static constexpr int kOffRecv = kOffOwn + 2 * kR * kHalf;
  static constexpr int kOffH = kOffRecv + 2 * kR * kHalf;
  static constexpr int kOffDz = kOffH + kR * kJ;
  static constexpr int kOffLn = kOffDz + kR * kJ;
  static constexpr int kOffBar = kOffLn + 2 * kR;
  static constexpr int kBars = 5;
  static constexpr int kOffRaw = (kOffBar + 2 * kBars + 31) / 32 * 32;
  // bytes that complete a phase of the weights', ln's, recv's and hz's mbarriers
  static constexpr unsigned kWBytes = sizeof(float) * 2 * kJ * kLdW;
  static constexpr unsigned kLnBytes = sizeof(float2) * kR;
  static constexpr unsigned kXBytes = sizeof(float) * 2 * kR * kHalf;
  static_assert(kRT * kRG == kR && kKS * kPG * kRG == 128 && 32 % (kKS * kPG) == 0 &&
                    kR * kHalf % kT == 0 && kT % kHalf == 0 && kRT * kLR % 32 == 0 &&
                    CS / 4 % kLR == 0,
                "the thread layouts cover the tile");
  static_assert(kOffG % 4 == 0 && kOffW1 % 4 == 0 && kOffW2 % 4 == 0 && kLdA % 4 == 0 &&
                    kLdW % 4 == 0 && kOffLn % 2 == 0 && kOffBar % 2 == 0,
                "16-byte alignment of the float4s and bulk copies, 8 of the mbarriers");
  static_assert(kT <= kR * kLdA, "the epilogue's db1 sums fit in aS");
};

template <typename T, int C>
__host__ __device__ constexpr unsigned raw_bytes() {
  return sizeof(T) * 2 * Cfg<C>::kR * Cfg<C>::CS;
}
// In f32 at C = 512 dh and G_c read g where its tensor copy lands: two
// buffers of kR x CS floats, the tiles' in turn, in place of gS and g's raw
// stage (the same room), so a tile's staging copies half the bytes; dh's g
// loads then take two wavefronts a step where gS's take one (its rows are not
// padded). Elsewhere g is widened into gS as the tile is staged.
template <typename T, int C>
constexpr bool kDirectG = std::is_same<T, float>::value && C == 512;
template <typename T, int C>
__host__ __device__ constexpr int ldg() {  // g rows: dh's X, G_c's P
  return kDirectG<T, C> ? Cfg<C>::CS : Cfg<C>::kLdA;
}
template <typename T, int C>
__host__ __device__ constexpr int off_shift() {  // floats from gS's room to the second g buffer
  return kDirectG<T, C> ? Cfg<C>::kR * Cfg<C>::kLdA : 0;
}
template <typename T, int C>
constexpr size_t smem_bytes() {
  constexpr size_t kB = sizeof(float) * (Cfg<C>::kOffRaw - off_shift<T, C>()) +
                        raw_bytes<T, C>() +
                        (kDirectG<T, C> ? sizeof(float) * Cfg<C>::kR * Cfg<C>::CS : 0);
  static_assert(kB <= 232448, "shared memory");
  static_assert((Cfg<C>::kOffRaw - off_shift<T, C>()) % 32 == 0, "the stage 128-byte aligned");
  return kB;
}

// 4 bytes into the shared memory of a block of the cluster (addr from
// map_rank), completing on that block's mbarrier at bar (from map_rank too)
__device__ __forceinline__ void st_async1(unsigned addr, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// One thread: a box of rows row0.. and channels c0.. of the matrix `map`
// describes into shared memory by the TMA engine, completing on bar; rows
// past the matrix land as zeros
__device__ __forceinline__ void tensor_rows(void* dst, const CUtensorMap* map, int c0, int row0,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(kasf_mma::smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(row0),
      "r"(kasf_mma::smem_addr(bar))
      : "memory");
}

// One thread: the block's channels of the tile's rows row0.. of x and of g
// into the raw stage by two tensor copies (one strided box each) that
// complete on bar. The fence in mbar_expect orders the stage's last reads.
template <int C, typename T>
__device__ __forceinline__ void fetch_rows(T* raw, const CUtensorMap* xm, const CUtensorMap* gm,
                                           long long row0, unsigned rank,
                                           unsigned long long* bar, unsigned buf) {
  using K = Cfg<C>;
  kasf_mma::mbar_expect(bar, raw_bytes<T, C>());
  tensor_rows(raw, xm, rank * K::CS, static_cast<int>(row0), bar);
  tensor_rows(raw + (1 + (kDirectG<T, C> ? buf : 0)) * K::kR * K::CS, gm, rank * K::CS,
              static_cast<int>(row0), bar);
}

// aS = LN(x) * gamma + beta and gS = g over the block's channels, from the
// raw stage. kLR neighbouring lanes take a row (warp w rows w + 8 (lane /
// kLR + 32 / kLR i)), lane l the float4s l % kLR + kLR k of it, so a row's
// sums take log2 kLR shuffles. LN's statistics span all C channels: each
// block sums its half of a row, then the squared deviations from the half's
// mean, and sends the pair to the other block (st.async on its ln
// mbarrier); both combine the two halves in rank order (the variance of two
// equal groups), so both get the same bits. g is widened into gS while the
// pairs travel (unless kDirectG). Rows past M are zeros (the tensor copy
// fills them): a = beta and g = 0, so they add nothing.
template <int C, typename T>
__device__ __forceinline__ void stage_rows(const T* raw, float* aS, float* gS,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, const float2* lnS,
                                           unsigned ln_far, unsigned ln_bar,
                                           unsigned long long* bar, unsigned par, unsigned rank,
                                           float eps, int warp, int lane) {
  using K = Cfg<C>;
  constexpr int CS = K::CS, kLR = K::kLR, kN = CS / 4 / kLR, kRL = K::kRT * kLR / 32;
  const int l = lane % kLR, r0 = warp + K::kRG * (lane / kLR);
  float4 xv[kRL][kN];
#pragma unroll
  for (int i = 0; i < kRL; ++i)
#pragma unroll
    for (int k = 0; k < kN; ++k)
      xv[i][k] = raw4(raw + (r0 + K::kRG * 32 / kLR * i) * CS + 4 * (l + kLR * k));
  float s[kRL], m2[kRL];
#pragma unroll
  for (int i = 0; i < kRL; ++i) {
    s[i] = quad_sum(xv[i][0]);
#pragma unroll
    for (int k = 1; k < kN; ++k) s[i] += quad_sum(xv[i][k]);
    s[i] = group_sum<kLR>(s[i]);
    const float mb = s[i] * (1.0f / CS);
    m2[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float4 d = xv[i][k];
      m2[i] += quad_sq(make_float4(d.x - mb, d.y - mb, d.z - mb, d.w - mb));
    }
    m2[i] = group_sum<kLR>(m2[i]);
  }
  if (l == 0)
#pragma unroll
    for (int i = 0; i < kRL; ++i)
      kasf_mma::st_async2(ln_far + sizeof(float2) * (r0 + K::kRG * 32 / kLR * i),
                          make_float2(s[i], m2[i]), ln_bar);
  if constexpr (!kDirectG<T, C>) {
#pragma unroll
    for (int i = 0; i < kRL; ++i)
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int r = r0 + K::kRG * 32 / kLR * i, c = 4 * (l + kLR * k);
        st4(gS + r * K::kLdA + c, raw4(raw + (K::kR + r) * CS + c));
      }
  }
  float4 gm[kN], bt[kN];  // the lane's channels of gamma and beta, in flight with the sums
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    gm[k] = ld4(gamma + 4 * (l + kLR * k));
    bt[k] = ld4(beta + 4 * (l + kLR * k));
  }
  kasf_mma::mbar_wait_cluster(bar, par);  // the other block's sums are in
  const bool first = rank == 0;
#pragma unroll
  for (int i = 0; i < kRL; ++i) {
    const int r = r0 + K::kRG * 32 / kLR * i;
    const float2 o = lnS[r];
    const float s0 = first ? s[i] : o.x, s1 = first ? o.x : s[i];
    const float q0 = first ? m2[i] : o.y, q1 = first ? o.y : m2[i];
    const float mean = (s0 + s1) * (1.0f / C);
    const float d = s1 * (1.0f / CS) - s0 * (1.0f / CS);
    const float rstd = rsqrtf(((q0 + q1) + d * d * (0.5f * CS)) * (1.0f / C) + eps);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float4 x = xv[i][k], g = gm[k], b = bt[k];
      st4(aS + r * K::kLdA + 4 * (l + kLR * k),
          make_float4(fmaf((x.x - mean) * rstd, g.x, b.x), fmaf((x.y - mean) * rstd, g.y, b.y),
                      fmaf((x.z - mean) * rstd, g.z, b.z), fmaf((x.w - mean) * rstd, g.w, b.w)));
    }
  }
}

// acc[i][u] = the block's channels' share of X[q + 8 i] . W[p + kPG u]: X
// row-major (aS, or gS), W a chunk's rows (W1, or ls2 * W2^T), both over the
// block's CS channels; the lane takes the float4s 8 b + kG s + e (e < kG) of
// each run of 8, in order. A step reads 8 W and kRT X float4s for 32 kRT
// FMAs.
template <int C, int kLdX>
__device__ __forceinline__ void rows_dot8(const float* X, const float* W,
                                          float (&acc)[Cfg<C>::kRT][8], int q, int p, int s) {
  using K = Cfg<C>;
#pragma unroll
  for (int i = 0; i < K::kRT; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  const float* xq = X + q * kLdX + 4 * K::kG * s;
  const float* wq = W + p * K::kLdW + 4 * K::kG * s;
#pragma unroll 2
  for (int b = 0; b < K::CS / 32; ++b)
#pragma unroll
    for (int e = 0; e < K::kG; ++e) {
      const int f = 32 * b + 4 * e;  // float offset of the step's float4
      float4 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = ld4(wq + K::kPG * u * K::kLdW + f);
#pragma unroll
      for (int i = 0; i < K::kRT; ++i) {
        const float4 a = ld4(xq + K::kRG * i * kLdX + f);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[i][u] = fmaf(a.x, w[u].x, acc[i][u]);
          acc[i][u] = fmaf(a.y, w[u].y, acc[i][u]);
          acc[i][u] = fmaf(a.z, w[u].z, acc[i][u]);
          acc[i][u] = fmaf(a.w, w[u].w, acc[i][u]);
        }
      }
    }
}

// The kKS lanes of a (row group, column group) hold partial sums of the same
// RT x 8 outputs over their channels: a fixed tree of shuffles leaves lane s
// with the sums over the block's channels of columns u = kE s + e (lo,
// block 0's columns) and u + 4 (hi, block 1's), e < kE = 4 / KS.
template <int KS, int RT>
__device__ __forceinline__ void scatter8(const float (&a)[RT][8], float (&lo)[RT][4 / KS],
                                         float (&hi)[RT][4 / KS], int s) {
  if constexpr (KS == 2) {
    const bool t1 = s & 1;  // keeps u & 2 == 2
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 4 * h + e;
          const float give = __shfl_xor_sync(0xffffffffu, t1 ? a[i][u] : a[i][u + 2], 1);
          const float v = (t1 ? a[i][u + 2] : a[i][u]) + give;
          if (h) hi[i][e] = v;
          else lo[i][e] = v;
        }
  } else {
    static_assert(KS == 4, "two or four channel splits");
    const bool t2 = s & 2, t1 = s & 1;
    float m[RT][4];  // columns 4 h + e + 2 t2 over this lane's pair of splits
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 4 * h + e;
          const float give = __shfl_xor_sync(0xffffffffu, t2 ? a[i][u] : a[i][u + 2], 2);
          m[i][2 * h + e] = (t2 ? a[i][u + 2] : a[i][u]) + give;
        }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float give = __shfl_xor_sync(0xffffffffu, t1 ? m[i][2 * h] : m[i][2 * h + 1], 1);
        const float v = (t1 ? m[i][2 * h + 1] : m[i][2 * h]) + give;
        if (h) hi[i][0] = v;
        else lo[i][0] = v;
      }
  }
}

// acc[a][b] += P[r][a] Q[r][b] over the tile's R rows, as wp::outer_tile
// (the C = 128 pass's), with eight rows' loads in flight: 1 % faster here
template <int R, int kLdP, int kHalfP, int kLdQ, int kHalfQ>
__device__ __forceinline__ void outer_rows(const float* P, const float* Q, float (&acc)[8][8]) {
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const float4 p0 = ld4(P + r * kLdP), p1 = ld4(P + r * kLdP + kHalfP);
    const float4 q0 = ld4(Q + r * kLdQ), q1 = ld4(Q + r * kLdQ + kHalfQ);
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(pv[a], qv[b], acc[a][b]);
  }
}

}  // namespace wpc

// At C = 256 and 512: a cluster of two blocks per (hidden chunk of
// wpc::Cfg<C>::kJ, row split), block b over the channels CS b .. CS b + CS -
// 1 of the split's tiles. The chunk's W1 and W2^T rows over the block's
// channels come once, by two bulk copies from the stage launch's slices (ls2
// folded into W2^T in place); the next tile's rows over the block's
// channels land by two tensor copies (strided boxes) while a tile is
// multiplied. Per tile:
//  1. the rows: LN's statistics combined across the cluster (stage_rows).
//  2. fc1 (warps 0-3) and dh (warps 4-7) over the block's channels for all
//     kJ columns; a reduce-scatter over the lanes that split the channels;
//     each lane sends the other block's columns (partial z, dh) into its
//     recv by st.async and keeps its own in `own`.
//  3. z = the two blocks' partials in rank order + b1, dh likewise, then h =
//     GELU(z) and dz = dh GELU'(z) once for each of the block's columns (db1
//     summed there), into hS and dzS and by st.async into the other block's.
//  4. warps 0-3 dW1c += dz^T a, warps 4-7 G_c += g^T h over the block's
//     channels for the whole chunk, in registers over the split.
// Each exchange completes bytes on the receiver's mbarrier (ln's, recv's,
// hz's), so no cluster barrier sits in the tile loop; thread 0 arms each
// phase once the last has completed (bytes may land before it), and the
// k-th tile completes phase k. Write-after-read hazards follow the data
// flow: a block sends what fills a buffer of the other's for tile k + 1
// only after it received what that block sent once it had read the buffer
// for tile k. Each block writes its channels of the split's partial (dW1,
// G) and db1 of its columns; reruns are bitwise equal, no atomics.
template <typename T, int C>
__global__ void __launch_bounds__(wpc::kT, 1)
mlp_ln_bwd_w_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap gmap,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ w1s_g, const float* __restrict__ w2s_g,
                            const float* __restrict__ b1, const float* __restrict__ ls2,
                            float* __restrict__ part, long long M, int H, float eps) {
  using namespace wpc;
  using K = Cfg<C>;
  using kasf_mma::map_rank;
  using kasf_mma::mbar_arm;
  using kasf_mma::mbar_wait_cluster;
  constexpr int kR = K::kR, CS = K::CS, kJ = K::kJ, kHalf = K::kHalf, kRT = K::kRT;
  constexpr int kLdA = K::kLdA, kE = K::kE;
  extern __shared__ __align__(128) float4 wsmem4[];
  float* aS = reinterpret_cast<float*>(wsmem4);
  constexpr int kSh = off_shift<T, C>(), kLdG = ldg<T, C>();
  float* const gS0 = aS + K::kOffG;  // g widened, unless kDirectG
  float* w1c = aS + K::kOffW1 - kSh;
  float* w2c = aS + K::kOffW2 - kSh;
  float* own = aS + K::kOffOwn - kSh;
  float* recv = aS + K::kOffRecv - kSh;
  float* hS = aS + K::kOffH - kSh;
  float* dzS = aS + K::kOffDz - kSh;
  const float2* lnS = reinterpret_cast<const float2*>(aS + K::kOffLn - kSh);
  auto* bar = reinterpret_cast<unsigned long long*>(aS + K::kOffBar - kSh);
  T* raw = reinterpret_cast<T*>(aS + K::kOffRaw - kSh);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned rank = kasf_mma::cluster_rank(), other = rank ^ 1u;
  const int j0 = blockIdx.x / kNB * kJ;
  const long long n_tiles = (M + kR - 1) / kR;
  const long long per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const long long t_begin = blockIdx.y * per;
  const long long t_end = t_begin + per < n_tiles ? t_begin + per : n_tiles;
  if (tid == 0) {
    for (int b = 0; b < K::kBars; ++b) kasf_mma::mbar_init(bar + b);
    mbar_arm(bar + 2, K::kLnBytes);  // tile 0's exchanges
    mbar_arm(bar + 3, K::kXBytes);
    mbar_arm(bar + 4, K::kXBytes);
  }
  kasf_mma::cluster_sync();  // both blocks of the cluster run, their mbarriers initialised
  const unsigned ln_far = map_rank(lnS, other), ln_bar = map_rank(bar + 2, other);
  const unsigned recv_far = map_rank(recv, other), recv_bar = map_rank(bar + 3, other);
  const unsigned h_far = map_rank(hS, other), dz_far = map_rank(dzS, other);
  const unsigned hz_bar = map_rank(bar + 4, other);
  if (tid == 0 && t_begin < t_end) {
    constexpr unsigned kSlice = sizeof(float) * kJ * K::kLdW;
    const long long off = (static_cast<long long>(rank) * H + j0) * K::kLdW;
    mbar_arm(bar + 1, K::kWBytes);
    kasf_mma::bulk_load(w1c, w1s_g + off, kSlice, bar + 1);
    kasf_mma::bulk_load(w2c, w2s_g + off, kSlice, bar + 1);
    fetch_rows<C>(raw, &xmap, &gmap, t_begin * kR, rank, bar, 0u);
  }
  // GELU and db1: the thread's column lc of the block's half, rows tid / kHalf + kT / kHalf k
  const int lc = tid % kHalf;
  const float bias = b1[j0 + rank * kHalf + lc];
  // fc1 / dh: lane (s, p, q)
  constexpr int kLanesQ = K::kKS * K::kPG;  // lanes a row group
  const int s = lane % K::kKS, p = lane / K::kKS % K::kPG;
  const int q = lane / kLanesQ + 32 / kLanesQ * (warp & 3);
  const bool fc1 = warp < 4;
  // outer products, as at C = 128: warps 0-3 hold dW1c[4 g8 + v (+ kJ / 2)]
  // [4 g16 + v (+ CS / 2)], warps 4-7 G_c[4 g16 + v (+ CS / 2)][4 g8 + v (+ kJ / 2)]
  const int idx = tid & 127;
  const int g8 = idx / 8 % (kJ / 8), g16 = 8 * (idx / kJ) + (idx & 7);
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float db1a = 0.f;
  if (t_begin < t_end) {
    kasf_mma::mbar_wait(bar + 1, 0);  // the weights landed: ls2 into W2^T
    for (int e = tid; e < kJ * CS / 4; e += kT) {
      const int j = e / (CS / 4), c = 4 * (e % (CS / 4));
      const float4 w = ld4(w2c + j * K::kLdW + c), l = ld4(ls2 + rank * CS + c);
      st4(w2c + j * K::kLdW + c, make_float4(w.x * l.x, w.y * l.y, w.z * l.z, w.w * l.w));
    }
  }
  for (long long t = t_begin; t < t_end; ++t) {
    const unsigned par = static_cast<unsigned>((t - t_begin) & 1);
    // tile t's g: its tensor copy's buffer, or its widened copy
    float* const gS = kDirectG<T, C> ? reinterpret_cast<float*>(raw) + (1 + par) * kR * CS : gS0;
    kasf_mma::mbar_wait(bar, par);
    __syncthreads();  // tile t's rows landed; the last tile's products done
    stage_rows<C>(raw, aS, gS, gamma + rank * CS, beta + rank * CS, lnS, ln_far, ln_bar, bar + 2,
                  par, rank, eps, warp, lane);
    if (tid == 0) mbar_arm(bar + 2, K::kLnBytes);  // the next tile's
    __syncthreads();  // a and g in; the stage is free
    if (tid == 0 && t + 1 < t_end)
      fetch_rows<C>(raw, &xmap, &gmap, (t + 1) * kR, rank, bar, par ^ 1u);
    {
      float pa[kRT][8], lo[kRT][kE], hi[kRT][kE];
      if constexpr (kLdG == kLdA) {  // one copy of the loop: two were 11 % slower at 256
        rows_dot8<C, kLdA>(fc1 ? aS : gS, fc1 ? w1c : w2c, pa, q, p, s);
      } else {
        if (fc1)
          rows_dot8<C, kLdA>(aS, w1c, pa, q, p, s);
        else
          rows_dot8<C, kLdG>(gS, w2c, pa, q, p, s);
      }
      scatter8<K::kKS>(pa, lo, hi, s);
      const int buf = fc1 ? 0 : kR * kHalf;
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int o = buf + (q + K::kRG * i) * kHalf + p + K::kPG * (kE * s + e);
          own[o] = rank == 0 ? lo[i][e] : hi[i][e];
          st_async1(recv_far + sizeof(float) * o, rank == 0 ? hi[i][e] : lo[i][e], recv_bar);
        }
    }
    mbar_wait_cluster(bar + 3, par);  // the other block's partials are in
    __syncthreads();                  // and this block's
    if (tid == 0) mbar_arm(bar + 3, K::kXBytes);
#pragma unroll
    for (int k = 0; k < kR * kHalf / kT; ++k) {
      const int e = tid + k * kT, f = kR * kHalf + e;
      const float z = (rank == 0 ? own[e] + recv[e] : recv[e] + own[e]) + bias;
      const float d = rank == 0 ? own[f] + recv[f] : recv[f] + own[f];
      const float2 hg = wp::gelu_and_grad(z);
      const float dz = d * hg.y;
      db1a += dz;
      const int o = e / kHalf * kJ + rank * kHalf + lc;
      hS[o] = hg.x;
      dzS[o] = dz;
      st_async1(h_far + sizeof(float) * o, hg.x, hz_bar);
      st_async1(dz_far + sizeof(float) * o, dz, hz_bar);
    }
    mbar_wait_cluster(bar + 4, par);  // the other block's h and dz are in
    __syncthreads();                  // and this block's
    if (tid == 0) mbar_arm(bar + 4, K::kXBytes);
    if (fc1)
      outer_rows<kR, kJ, kJ / 2, kLdA, CS / 2>(dzS + 4 * g8, aS + 4 * g16, acc);
    else
      outer_rows<kR, kLdG, CS / 2, kJ, kJ / 2>(gS + 4 * g16, hS + 4 * g8, acc);
  }

  // the split's partial over this block's channels: dW1c rows, G_c columns;
  // db1 of this block's columns
  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * C + H);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float4 lo = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    const float4 hi = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    if (fc1) {
      const int j = 4 * g8 + (a & 3) + (a < 4 ? 0 : kJ / 2);
      float* row = base + static_cast<long long>(j0 + j) * C + rank * CS + 4 * g16;
      st4(row, lo);
      st4(row + CS / 2, hi);
    } else {
      const int c = rank * CS + 4 * g16 + (a & 3) + (a < 4 ? 0 : CS / 2);
      float* row = base + static_cast<long long>(H) * C + static_cast<long long>(c) * H + j0 +
                   4 * g8;
      st4(row, lo);
      st4(row + kJ / 2, hi);
    }
  }
  __syncthreads();  // aS is free
  aS[tid] = db1a;   // [tid / kHalf][lc]
  __syncthreads();
  if (tid < kHalf) {
    float sum = 0.f;
    for (int r = 0; r < kT / kHalf; ++r) sum += aS[r * kHalf + tid];
    base[2LL * H * C + j0 + rank * kHalf + tid] = sum;
  }
}

// ---- 3. reduce: its own helpers
namespace rd {

using dxp::ld4;
using dxp::load4;
using dxp::st4;
using kasf_mma::cp_async_arrive;
using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;

constexpr int kT = 256;                // item threads: one float4 of a split's partial each
constexpr int kTB = kT + 32;           // and warp 8: the dx chains, or db1
constexpr int kU = 16;                 // splits whose loads a thread issues before its adds
constexpr int kHidRows = 8;            // dW1 rows a hidden block: C / 128 float4s a thread
constexpr int kRowsMax = 8;            // G rows a channel block at most: 24 chains, a lane each
constexpr int kItemsMax = 2048 / 4;    // G float4s a channel block at most (a row at H = 2048)
constexpr int kDxBuf = 4096;           // floats of dx partials staged at a time
static_assert(kHidRows % 4 == 0 && kHidRows / 4 <= 32, "db1 in whole float4s, by warp 8");
static_assert(3 * kRowsMax <= 32, "a lane of warp 8 a chain");

// G rows a channel block: those of 256 float4s, at least one, at most 8
__host__ __device__ inline int rows_c(int H) {
  return H >= 4 * kT ? 1 : 4 * kT / H < kRowsMax ? 4 * kT / H : kRowsMax;
}
template <int C>
__host__ __device__ inline int channel_blocks(int H) {
  return (C + rows_c(H) - 1) / rows_c(H);
}
template <int C>
inline int blocks(int H) {
  return channel_blocks<C>(H) + H / kHidRows;
}

// 4 bytes from global to shared memory (cp.async.ca: .cg takes 16 only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(kasf_mma::smem_addr(dst)),
               "l"(src));
}

// sum over s = 0..n-1 of the float4 at p + s * stride, in that order from +0
// (a plain loop acc = acc + p[s] bit for bit); the loads of kU splits are
// issued before their adds, on the read-only path (the partials are the
// previous launches'). Past the last split a load repeats it and its add is
// skipped, so no load waits on a branch
__device__ __forceinline__ float4 split_sum(const float* p, long long stride, int n) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n; s0 += kU) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      v[u] = __ldg(reinterpret_cast<const float4*>(p + (s0 + u < n ? s0 + u : n - 1) * stride));
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (s0 + u < n) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
  }
  return acc;
}

// the dx partials of tiles n0..n0+nt-1 of the block's chains into the stage,
// chain k's run at dxs + k * per: the calling threads (`first` of `count`)
// take every count-th element, neighbouring lanes on neighbouring addresses
template <int C>
__device__ __forceinline__ void stage_dx(float* dxs, const float* part_dx, int n0, int nt,
                                         int c0, int nr, int per, int first, int count) {
  const int nch = 3 * nr;
  for (int e = first; e < nt * nch; e += count) {
    const int n = e / nch, k = e - n * nch, q = k / nr;
    cp_async4(dxs + k * per + n, part_dx + (3LL * (n0 + n) + q) * C + c0 + k - q * nr);
  }
}

// chain + p[0] + p[1] + ... + p[n-1], added in that order; p 16-byte aligned
__device__ __forceinline__ float add_run(float chain, const float* p, int n) {
  int i = 0;
#pragma unroll 4
  for (; i + 4 <= n; i += 4) {
    const float4 v = ld4(p + i);
    chain += v.x;
    chain += v.y;
    chain += v.z;
    chain += v.w;
  }
  for (; i < n; ++i) chain += p[i];
  return chain;
}

}  // namespace rd

// Channel blocks first (rd::rows_c(H) rows of G each: dW2, dls2, and the
// dgamma, dbeta, db2 of those channels), then hidden blocks (8 rows of dW1
// and their db1); every sum runs over the partials in index order
template <typename T, int C>
__global__ void __launch_bounds__(rd::kTB)
mlp_ln_bwd_reduce_kernel(const float* __restrict__ part_dx, int n_dx,
                         const float* __restrict__ part_w, int n_w,
                         const T* __restrict__ w2, const T* __restrict__ b2,
                         const float* __restrict__ ls2, float* __restrict__ dgamma,
                         float* __restrict__ dbeta, float* __restrict__ dw1,
                         float* __restrict__ db1, float* __restrict__ dw2,
                         float* __restrict__ db2, float* __restrict__ dls2, int H) {
  using namespace rd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long stride = 2LL * H * C + H;  // floats of a split's partial
  const int n_cb = channel_blocks<C>(H);
  if (static_cast<int>(blockIdx.x) >= n_cb) {  // dW1 rows j0..j0+7, float4s f = tid + kT i
    const int j0 = (blockIdx.x - n_cb) * kHidRows;
    if (tid < kT) {
#pragma unroll
      for (int f = tid; f < kHidRows * C / 4; f += kT) {
        const long long o = static_cast<long long>(j0) * C + 4 * f;
        st4(dw1 + o, split_sum(part_w + o, stride, n_w));
      }
    } else if (lane < kHidRows / 4) {
      st4(db1 + j0 + 4 * lane, split_sum(part_w + 2LL * H * C + j0 + 4 * lane, stride, n_w));
    }
    return;
  }
  __shared__ __align__(16) float dxs[kDxBuf];  // [chain][tile] of the stage
  __shared__ float dots[kItemsMax];            // each G float4's share of dls2
  __shared__ float sg[kRowsMax];               // sum g of each row's channel
  __shared__ unsigned long long bar;           // the first stage landed
  const int R = rows_c(H), c0 = blockIdx.x * R;
  const int nr = R < C - c0 ? R : C - c0;
  const int nch = 3 * nr;                // chain q * nr + r: quantity q of channel c0 + r
  const int per = (kDxBuf / nch) & ~3;   // tiles a stage, a whole number of float4s
  if (tid == 0) mbar_init(&bar, kTB);
  __syncthreads();  // the barrier is initialised
  // the first stage: every thread copies a share and arrives once it landed
  stage_dx<C>(dxs, part_dx, 0, per < n_dx ? per : n_dx, c0, nr, per, tid, kTB);
  cp_async_arrive(&bar);
  if (warp == kT / 32) {
    // warp 8: a lane's chain over the tiles in order, while warps 0-7 sum G
    mbar_wait(&bar, 0);
    float chain = 0.f;
    for (int n0 = 0;;) {
      const int nt = per < n_dx - n0 ? per : n_dx - n0;
      if (lane < nch) chain = add_run(chain, dxs + lane * per, nt);
      n0 += nt;
      if (n0 >= n_dx) break;
      __syncwarp();  // the stage is read: the warp refills it alone
      stage_dx<C>(dxs, part_dx, n0, per < n_dx - n0 ? per : n_dx - n0, c0, nr, per, lane, 32);
      kasf_mma::cp_async_commit();
      kasf_mma::cp_async_wait<0>();
      __syncwarp();
    }
    if (lane < nch) {
      const int q = lane / nr, r = lane - q * nr, c = c0 + r;
      if (q == 0) {
        dgamma[c] = chain;
      } else if (q == 1) {
        dbeta[c] = chain;
      } else {
        db2[c] = ls2[c] * chain;
        sg[r] = chain;
      }
    }
  } else {
    // G[c][4 j4..] over the splits: dW2 = ls2 * G, and the float4's share
    // of sum_j W2 * G
    const int row4 = H / 4;
    for (int f = tid; f < nr * row4; f += kT) {
      const int r = f / row4, c = c0 + r;
      const long long o = static_cast<long long>(c) * H + 4 * (f - r * row4);
      const float4 w = load4(w2 + o);
      const float4 gs = split_sum(part_w + static_cast<long long>(H) * C + o, stride, n_w);
      const float s = ls2[c];
      st4(dw2 + o, make_float4(s * gs.x, s * gs.y, s * gs.z, s * gs.w));
      dots[f] = fmaf(w.w, gs.w, fmaf(w.z, gs.z, fmaf(w.y, gs.y, w.x * gs.x)));
    }
  }
  __syncthreads();  // dots and sg in
  // dls2: one warp a row, lane l summing its float4s' shares l, l + 32, ...
  const int row4 = H / 4;
  for (int r = warp; r < nr; r += kTB / 32) {
    float t = 0.f;
    for (int f = lane; f < row4; f += 32) t += dots[r * row4 + f];
    t = warp_sum(t);
    if (lane == 0) dls2[c0 + r] = fmaf(to_f(b2[c0 + r]), sg[r], t);
  }
}

// ---- 3, at C = 64: the reduce over segments (its own grid and helpers)
namespace rds {

using kasf_mma::bulk_load;
using kasf_mma::mbar_arm;
using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;

constexpr int kC = 64;
constexpr int kW = 2;                  // floats an item thread sums over the splits
constexpr int kT = 128;                // item threads: warps 0-3
constexpr int kTB = kT + 32;           // and warp 4: a G block's dx chains
constexpr int kDb1Blocks = 4;          // db1 in quarters
constexpr int kBlocks = 2 * kC + kDb1Blocks;  // 132: G rows, dW1 segments, db1 quarters
constexpr int kGroup = 8;              // splits an mbarrier
constexpr int kMaxSplits = wp::kSMs;   // splits <= 132 / (H / 128): n_w H <= 132 x 128
constexpr int kMaxBars = (kMaxSplits + kGroup - 1) / kGroup;
constexpr int kDxBuf = 3 * 512;        // floats of dx partials staged at a time: 512 tiles
static_assert(kMaxBars <= 32, "a lane of warp 0 an mbarrier");

// dynamic shared memory: every split's segment of H floats
inline int smem_bytes(int H, int n_w) { return n_w * H * static_cast<int>(sizeof(float)); }

// kW neighbouring floats of shared or device memory, as f32
__device__ __forceinline__ void ldv(float (&v)[kW], const float* p) {
  if constexpr (kW == 4) {
    const float4 x = dxp::ld4(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
}
__device__ __forceinline__ void ldv(float (&v)[kW], const __nv_bfloat16* p) {
  if constexpr (kW == 4) {
    const float4 x = dxp::load4(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    v[0] = kasf_mma::bf16_lo(x);
    v[1] = kasf_mma::bf16_hi(x);
  }
}
__device__ __forceinline__ void stv(float* p, const float (&v)[kW]) {
  if constexpr (kW == 4)
    dxp::st4(p, make_float4(v[0], v[1], v[2], v[3]));
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

}  // namespace rds

// K4's reduce at C = 64. The block-wide sums of the C = 128 grid (48 blocks
// at H = 256, 66 splits deep, half their item threads idle on a hidden
// block) kept 16 splits of loads in flight a thread and went 5 rounds of a
// load's latency deep. Here each of 132 blocks owns one contiguous segment
// of a split's partial, H floats (a G row, H / 64 rows of dW1) or a quarter
// of db1, so each brings the same bytes, and the lanes of warp 0 issue that
// segment of every split at once as bulk copies (TMA) into shared memory,
// eight splits an mbarrier: all of the launch's 8.7 MB is in flight from
// the start, with no register held for it. Warps 0-3 then sum kW floats a
// thread over the splits in index order from +0 as the groups land
// (bitwise the plain loop); in a G block warp 4 sums the dx chains of its
// channel (dgamma, dbeta, g) over the tiles in order, as the C = 128
// grid's warp 8 does, and warps 0-3 finish dW2 = ls2 G and dls2 (the
// row's dot with W2 summed over a thread's floats in order, a butterfly a
// warp, the warps' sums in order; b2 times g's sum added last).
template <typename T>
__global__ void __launch_bounds__(rds::kTB)
mlp_ln_bwd_reduce_seg_kernel(const float* __restrict__ part_dx, int n_dx,
                             const float* __restrict__ part_w, int n_w,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             const float* __restrict__ ls2, float* __restrict__ dgamma,
                             float* __restrict__ dbeta, float* __restrict__ dw1,
                             float* __restrict__ db1, float* __restrict__ dw2,
                             float* __restrict__ db2, float* __restrict__ dls2, int H) {
  using namespace rds;
  constexpr int C = kC;
  extern __shared__ uint4 seg_raw[];  // [split][len] floats
  float* seg = reinterpret_cast<float*>(seg_raw);
  __shared__ __align__(16) float dxs[kDxBuf];  // [chain][tile] of the dx stage
  __shared__ unsigned long long bars[kMaxBars];
  __shared__ float parts[kT / 32 + 1];  // a G block: each item warp's dot, sum g
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long stride = 2LL * H * C + H;  // floats of a split's partial
  const int b = blockIdx.x;
  const bool g_row = b < C;
  // the block's segment of each split's partial: its offset and floats
  long long off;
  int len = H;
  if (g_row) {
    off = static_cast<long long>(H) * C + static_cast<long long>(b) * H;
  } else if (b < 2 * C) {
    off = static_cast<long long>(b - C) * H;
  } else {
    len = H / kDb1Blocks;
    off = 2LL * H * C + static_cast<long long>(b - 2 * C) * len;
  }
  const int nbars = (n_w + kGroup - 1) / kGroup;
  if (tid < nbars) mbar_init(&bars[tid], 1);
  __syncthreads();  // the barriers are initialised
  if (warp == 0 && lane < nbars) {  // lane l: splits 8 l .. 8 l + 7 on barrier l
    const int s0 = lane * kGroup, ns = min(kGroup, n_w - s0);
    mbar_arm(&bars[lane], static_cast<unsigned>(ns * len * sizeof(float)));
    for (int s = s0; s < s0 + ns; ++s)
      bulk_load(seg + s * len, part_w + s * stride + off,
                static_cast<unsigned>(len * sizeof(float)), &bars[lane]);
  }
  float bias = 0.f;  // a G row's b2, for thread 0
  if (warp == kT / 32) {
    if (!g_row) return;
    // a lane's chain over the tiles in order: dgamma, dbeta, g of channel b
    const int per = (kDxBuf / 3) & ~3;
    float chain = 0.f;
    for (int n0 = 0; n0 < n_dx; n0 += per) {
      const int nt = per < n_dx - n0 ? per : n_dx - n0;
      rd::stage_dx<C>(dxs, part_dx, n0, nt, b, 1, per, lane, 32);
      kasf_mma::cp_async_commit();
      kasf_mma::cp_async_wait<0>();
      __syncwarp();
      if (lane < 3) chain = rd::add_run(chain, dxs + lane * per, nt);
      __syncwarp();  // the stage is read before the warp refills it
    }
    if (lane == 0) dgamma[b] = chain;
    if (lane == 1) dbeta[b] = chain;
    if (lane == 2) {
      db2[b] = ls2[b] * chain;
      parts[kT / 32] = chain;
    }
  } else {
    // floats kW f .. of the segment over the splits, eight an mbarrier: the
    // loads of a group before its adds (past the last split a load repeats
    // it and its add is skipped). A G row's ls2, b2 and the W2 of a thread's
    // first floats are read while the copies land
    float t = 0.f;  // a G row: this thread's share of sum_j W2 * G
    const float s = g_row ? ls2[b] : 0.f;
    if (g_row && tid == 0) bias = to_f(b2[b]);
    float w[kW] = {};
    if (g_row && tid < len / kW) ldv(w, w2 + static_cast<long long>(b) * H + kW * tid);
    for (int f = tid; f < len / kW; f += kT) {
      float acc[kW] = {};
      for (int g0 = 0; g0 < n_w; g0 += kGroup) {
        mbar_wait(&bars[g0 / kGroup], 0);
        float v[kGroup][kW];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          ldv(v[u], seg + (g0 + u < n_w ? g0 + u : n_w - 1) * len + kW * f);
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (g0 + u < n_w) {
#pragma unroll
            for (int c = 0; c < kW; ++c) acc[c] += v[u][c];
          }
      }
      if (g_row) {
        const long long o = static_cast<long long>(b) * H + kW * f;
        if (f != tid) ldv(w, w2 + o);
        float d[kW];
        float dot = w[0] * acc[0];
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          d[c] = s * acc[c];
          if (c > 0) dot = fmaf(w[c], acc[c], dot);
        }
        stv(dw2 + o, d);
        t += dot;
      } else if (b < 2 * C) {
        stv(dw1 + off + kW * f, acc);
      } else {
        stv(db1 + (off - 2LL * H * C) + kW * f, acc);
      }
    }
    if (!g_row) return;
    t = warp_sum(t);
    if (lane == 0) parts[warp] = t;
  }
  __syncthreads();  // a G block: the warps' dots and sum g in
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kT / 32; ++i) t += parts[i];
    dls2[b] = fmaf(bias, parts[kT / 32], t);
  }
}

// ---- 3, at C = 512: the reduce over equal blocks (its own grid and helpers)
namespace rdw {

using kasf_mma::bulk_load;
using kasf_mma::mbar_arm;
using kasf_mma::mbar_init;
using kasf_mma::mbar_wait;

constexpr int kC = 512;
constexpr int kRows = 4;               // G rows a block, whose channels' dx chains it sums
constexpr int kBlocks = kC / kRows;    // 128: a block each G row group and dW1 segment
constexpr int kT = 256;                // item threads: warps 0-3 G, warps 4-7 dW1 and db1
constexpr int kHalf = kT / 2;
constexpr int kTB = kT + 32;           // and warp 8: the dx chains
// splits <= 132 / (2 H / 32) by the weight pass's split rule, H >= 64: 33
constexpr int kMaxSplits = wp::kSMs / (wpc::kNB * (64 / wpc::Cfg<kC>::kJ));
constexpr int kDxTiles = 512;          // tiles of dx partials staged at a time
constexpr int kChains = 3 * kRows;     // dgamma, dbeta and g of the block's channels
constexpr int kMaxRow4 = 2048 / 4;     // float4s of a G row at most
static_assert(kChains <= 32, "a lane of warp 8 a chain");

// floats of db1 a block: H / 128 rounded up to whole float4s (the last
// blocks may own none)
__host__ __device__ inline int db1_len(int H) {
  return 4 * ((H + 4 * kBlocks - 1) / (4 * kBlocks));
}
// floats of a split's segment in shared memory: dW1's 4 H, G's 4 H, db1's
__host__ __device__ inline int seg_len(int H) { return 8 * H + db1_len(H); }
// dynamic shared memory: every split's segment, then the block's W2 rows
template <typename T>
inline int smem_bytes(int H, int n_w) {
  return n_w * seg_len(H) * static_cast<int>(sizeof(float)) +
         kRows * H * static_cast<int>(sizeof(T));
}

}  // namespace rdw

// K4's reduce at C = 512. The C = 128 grid made 640 blocks at H = 1024 (512
// one-row channel blocks, 128 hidden blocks), each with two splits to sum a
// thread, and a channel block's warp 8 staged its 3 x 263 dx values by
// 4-byte copies 2 KB or 6 KB apart before three lanes added them alone, so
// the fixed cost a block, not the bytes, set the pace (0.0107 ms, 45 % of
// its bound on an H100 80GB HBM3 at 700 W). Here each of 128 blocks owns an
// equal share: G rows 4 b .. 4 b + 3, the 4 H floats of dW1 from 4 H b, and
// H / 128 floats of db1, and lanes of warp 0 bring that segment of every
// split, and the block's rows of W2, into shared memory at once by bulk
// copies, an mbarrier a split for its G (and, with split 0, W2) and one for
// its dW1 and db1, so all of the launch's bytes are in flight from its
// start and a split's sums start as it lands (eight splits an mbarrier
// measured 4 % slower at H = 1,024). Warps 0-3 sum G a float4 a thread over
// the splits in index order from +0 (dW2 = ls2 G, and each float4's share
// of sum_j W2 G as the C = 128 grid forms it), warps 4-7 dW1 and db1
// likewise, and warp 8 copies the dx partials of the block's four channels
// by 16-byte cp.async, 16 bytes a (tile, quantity), and lanes 0-11 each add
// one chain over the tiles in order. Every output is the C = 128 grid's,
// bit for bit: dls2's row sums too, a warp a row in the same order.
template <typename T>
__global__ void __launch_bounds__(rdw::kTB)
mlp_ln_bwd_reduce_wide_kernel(const float* __restrict__ part_dx, int n_dx,
                              const float* __restrict__ part_w, int n_w,
                              const T* __restrict__ w2, const T* __restrict__ b2,
                              const float* __restrict__ ls2, float* __restrict__ dgamma,
                              float* __restrict__ dbeta, float* __restrict__ dw1,
                              float* __restrict__ db1, float* __restrict__ dw2,
                              float* __restrict__ db2, float* __restrict__ dls2, int H) {
  using namespace rdw;
  constexpr int C = kC;
  extern __shared__ uint4 wide_raw[];  // [split][dW1 4 H | G 4 H | db1], then W2's rows
  float* seg = reinterpret_cast<float*>(wide_raw);
  __shared__ __align__(16) float dxs[kChains * kDxTiles];  // [tile][quantity][channel]
  __shared__ float dots[kRows * kMaxRow4];                // each G float4's share of dls2
  __shared__ float sg[kRows];                             // sum g of each row's channel
  __shared__ unsigned long long bars[2 * kMaxSplits];     // [split][G and W2, dW1 and db1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long stride = 2LL * H * C + H;  // floats of a split's partial
  const int b = blockIdx.x, c0 = b * kRows;
  const int len = seg_len(H), ld = db1_len(H);
  const int nd = max(0, min(ld, H - b * ld));  // the block's floats of db1
  const long long o1 = 4LL * H * b;            // its dW1 segment in a partial, and G's
  const long long og = static_cast<long long>(H) * C + o1;  // G rows c0.. at H C + c0 H
  T* w2s = reinterpret_cast<T*>(seg + n_w * len);
  for (int i = tid; i < 2 * n_w; i += kTB) mbar_init(&bars[i], 1);
  __syncthreads();  // the barriers are initialised
  if (warp == 0) {
    for (int i = lane; i < 2 * n_w; i += 32) {  // barrier 2 s + p: split s, part p
      const int s = i >> 1;
      const bool g_part = (i & 1) == 0;
      const unsigned w2_bytes = kRows * H * sizeof(T);
      float* dst = seg + s * len;
      const float* src = part_w + s * stride;
      if (g_part) {
        mbar_arm(&bars[i], 16u * H + (s == 0 ? w2_bytes : 0u));
        if (s == 0) bulk_load(w2s, w2 + static_cast<long long>(c0) * H, w2_bytes, &bars[i]);
        bulk_load(dst + 4 * H, src + og, 16u * H, &bars[i]);
      } else {
        mbar_arm(&bars[i], 4u * (4 * H + nd));
        bulk_load(dst, src + o1, 16u * H, &bars[i]);
        if (nd > 0) bulk_load(dst + 8 * H, src + 2LL * H * C + b * ld, 4u * nd, &bars[i]);
      }
    }
  }
  if (warp < 8) {
    // a float4 of the segment over the splits, each as it lands
    const bool g_part = warp < 4;
    const int t = g_part ? tid : tid - kHalf;
    const int n4 = g_part ? H : H + nd / 4;  // float4s: G's 4 H floats, or dW1's and db1's
    const int row4 = H / 4;
    for (int f = t; f < n4; f += kHalf) {
      // its offset in a split's segment: G at 4 H, dW1 at 0, db1 at 8 H
      const int at = 4 * f + (g_part || f >= H ? 4 * H : 0);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < n_w; ++s) {
        mbar_wait(&bars[2 * s + (g_part ? 0 : 1)], 0);
        const float4 v = dxp::ld4(seg + s * len + at);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if (g_part) {  // G[c0 + r][4 j4..]: dW2 = ls2 G, and its share of sum_j W2 G
        const int r = f / row4;
        const float4 w = dxp::load4(w2s + 4 * f);
        const float s = ls2[c0 + r];
        dxp::st4(dw2 + static_cast<long long>(c0) * H + 4 * f,
                 make_float4(s * acc.x, s * acc.y, s * acc.z, s * acc.w));
        dots[f] = fmaf(w.w, acc.w, fmaf(w.z, acc.z, fmaf(w.y, acc.y, w.x * acc.x)));
      } else if (f < H) {
        dxp::st4(dw1 + o1 + 4 * f, acc);
      } else {
        dxp::st4(db1 + b * ld + 4 * (f - H), acc);
      }
    }
  } else {
    // warp 8: the dx partials of channels c0 .. c0 + 3, 16 bytes a (tile,
    // quantity), then lane q kRows + r adds quantity q of channel c0 + r
    // over the tiles in order
    float chain = 0.f;
    for (int n0 = 0; n0 < n_dx; n0 += kDxTiles) {
      const int nt = min(kDxTiles, n_dx - n0);
      for (int e = lane; e < 3 * nt; e += 32)
        kasf_mma::cp_async16(dxs + kRows * e, part_dx + (3LL * n0 + e) * C + c0);
      kasf_mma::cp_async_commit();
      kasf_mma::cp_async_wait<0>();
      __syncwarp();
      if (lane < kChains) {
        const float* p = dxs + lane;
        int n = 0;
        for (; n + 8 <= nt; n += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = p[(n + u) * kChains];
#pragma unroll
          for (int u = 0; u < 8; ++u) chain += v[u];
        }
        for (; n < nt; ++n) chain += p[n * kChains];
      }
      __syncwarp();  // the stage is read before the warp refills it
    }
    if (lane < kChains) {
      const int q = lane / kRows, r = lane - q * kRows, c = c0 + r;
      if (q == 0) {
        dgamma[c] = chain;
      } else if (q == 1) {
        dbeta[c] = chain;
      } else {
        db2[c] = ls2[c] * chain;
        sg[r] = chain;
      }
    }
  }
  __syncthreads();  // dots and sg in
  // dls2: warp r sums row r's shares, lane l its float4s l, l + 32, ..., as
  // the C = 128 grid does
  if (warp < kRows) {
    const int row4 = H / 4;
    float t = 0.f;
    for (int f = lane; f < row4; f += 32) t += dots[warp * row4 + f];
    t = warp_sum(t);
    if (lane == 0) dls2[c0 + warp] = fmaf(to_f(b2[c0 + warp]), sg[warp], t);
  }
}

// ---- 4. bf16 at C = 128 on the tensor cores (4a. dx pass, 4b. weight
// pass): what the two passes share
namespace mm {

using bf16 = __nv_bfloat16;
using kasf_mma::ldsm_x4;
using kasf_mma::ldsm_x4_trans;
using kasf_mma::mma_k16;
using kasf_mma::pack_bf16;

constexpr int C = 128;
constexpr int kKC = 64;        // hidden columns a chunk (dx pass) or a block (weight pass)
constexpr int kLdA = C + 8;    // bf16 rows of the C channels: a, do, g, W1 rows
constexpr int kLdJ = kKC + 8;  // bf16 rows of a chunk's columns: W2 rows, h, dz
static_assert(kKC == wp::Cfg<128>::kJ, "the weight pass keeps C = 128's chunks and splits");

// Lane l's element offset in a 16 x 16 block of a row-major bf16 array at
// stride ld, for ldmatrix.x4: rows (l & 7) + 8 ((l >> 3) & 1), columns
// 8 (l >> 4) (off_a) gives an A operand stored by rows of m (plain) and a B
// operand stored by rows of k (.trans); rows (l & 7) + 8 (l >> 4), columns
// 8 ((l >> 3) & 1) (off_b) gives a B operand stored by rows of n (plain)
// and an A operand stored by rows of k (.trans). Either way registers
// 0, 1 are the first n-tile's (b0, b1) and 2, 3 the second's for a B
// operand.
__device__ __forceinline__ int off_a(int lane, int ld) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
}
__device__ __forceinline__ int off_b(int lane, int ld) {
  return ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
}

// Both passes take GELU(z) and GELU'(z) from tc::gelu_and_grad, one formula
// so both round dz alike: erf by Abramowitz and Stegun 7.1.26 (|error| <=
// 1.5e-7, as the C = 64 passes take it; bf16 rounds dz at 2^-9), one expf
// for Phi and phi. With erff the dx pass took 7 % longer and the weight
// pass 5 % (scripts/k4_bf16_variants.py)

// two neighbouring bf16 of memory as floats, and two floats stored as bf16
__device__ __forceinline__ float2 load2(const bf16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(kasf_mma::bf16_lo(w), kasf_mma::bf16_hi(w));
}
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// The tile's operands in bf16, rounded where the TPU kernel rounds them:
// aB = bf16(LN(x) * gamma + beta), doB = bf16(g * ls2) and, where gB is
// given, gB = g, rows of kLdA. xs and gs hold the tile's rows at a stride of
// C (device memory in the dx pass, the raw stage in the weight pass); rows
// r >= n are zeros. Warp w takes rows w + kWarps i, eight at a time, lane l
// channels 4l..4l+3; one formula in both passes, so both round a alike.
// Each row's mean and rstd go to sMean, sRstd where given.
template <int kWarps, int kRows>
__device__ __forceinline__ void stage_rows(const bf16* xs, const bf16* gs, int n,
                                           float4 gm, float4 bt, float4 ls, bf16* aB, bf16* doB,
                                           bf16* gB, float* sMean, float* sRstd, float eps,
                                           int warp, int lane) {
  constexpr int kB = 8, kPer = kRows / kWarps;
  static_assert(kRows % kWarps == 0 && kPer % kB == 0, "whole batches of a warp's rows");
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int h = 0; h < kPer / kB; ++h) {
    float4 xv[kB], gv[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int r = warp + kWarps * (h * kB + i);
      xv[i] = r < n ? dxp::load4(xs + r * C + 4 * lane) : zero;
      gv[i] = r < n ? dxp::load4(gs + r * C + 4 * lane) : zero;
    }
    float s[kB], mean[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) s[i] = quad_sum(xv[i]);
    wp::rows_sum<32>(s);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      mean[i] = s[i] * (1.0f / C);
      const float4 v = xv[i];
      xv[i] = make_float4(v.x - mean[i], v.y - mean[i], v.z - mean[i], v.w - mean[i]);
      s[i] = quad_sq(xv[i]);
    }
    wp::rows_sum<32>(s);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int r = warp + kWarps * (h * kB + i);
      const float rstd = 1.0f / sqrtf(s[i] * (1.0f / C) + eps);
      const float4 c = xv[i], gq = gv[i];
      const float4 a = r < n ? make_float4(fmaf(c.x * rstd, gm.x, bt.x), fmaf(c.y * rstd, gm.y, bt.y),
                                           fmaf(c.z * rstd, gm.z, bt.z), fmaf(c.w * rstd, gm.w, bt.w))
                             : zero;
      store4(aB + r * kLdA + 4 * lane, a);
      store4(doB + r * kLdA + 4 * lane,
             make_float4(gq.x * ls.x, gq.y * ls.y, gq.z * ls.z, gq.w * ls.w));
      if (gB != nullptr) store4(gB + r * kLdA + 4 * lane, gq);
      if (sMean != nullptr && lane == 0) {
        sMean[r] = mean[i];
        sRstd[r] = rstd;
      }
    }
  }
}

}  // namespace mm

// ---- 4a. the dx pass's tile: one block of 7 warps a 112-row tile (the
// one-block pass's, so the dx partials and the reduce are C = 128's), a warp
// 16 rows; the weights in chunks of 64 hidden columns through a cp.async
// ring of three stages
namespace dxm {

using namespace mm;

constexpr int kWarps = 7, kT = 32 * kWarps;
constexpr int kR = 16 * kWarps;  // 112
constexpr int kStages = 3;
// a stage (bf16): the chunk's W1 rows [j][c], W2 columns [c][j], b1
constexpr int kW1 = kKC * kLdA, kW2 = C * kLdJ, kStage = kW1 + kW2 + kKC;
// shared memory (bf16): aB, doB | the ring | mean, rstd (floats)
constexpr int kOffRing = 2 * kR * kLdA;
constexpr int kOffStat = kOffRing + kStages * kStage;
constexpr size_t kSmem = sizeof(bf16) * kOffStat + sizeof(float) * 2 * kR;
static_assert(kR == dxp::Cfg<128>::kR, "C = 128's dx tiles: the reduce reads one partial a tile");
static_assert(kW1 % 8 == 0 && kW2 % 8 == 0 && kStage % 8 == 0 && kOffRing % 8 == 0 &&
                  kOffStat % 8 == 0,
              "16-byte alignment of the shared buffers");
static_assert(sizeof(float) * kWarps * 3 * C <= sizeof(bf16) * kOffRing,
              "the epilogue's sums fit in aB and doB");
static_assert(kSmem <= 232448, "one block a SM");

// Start copying chunk j (W1 rows j0.., W2 columns j0.., b1) raw into stage
// j % kStages by 16-byte cp.async; one group (empty past the last chunk)
__device__ __forceinline__ void fetch_chunk(bf16* ring, const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2,
                                            const bf16* __restrict__ b1, int j, int H, int tid) {
  const int j0 = j * kKC;
  if (j0 < H) {
    bf16* st = ring + (j % kStages) * kStage;
    for (int e = tid; e < kKC * C / 8; e += kT) {
      const int r = e / (C / 8), c8 = e % (C / 8);
      kasf_mma::cp_async16(st + r * kLdA + 8 * c8, w1 + (j0 + r) * C + 8 * c8);
    }
    for (int e = tid; e < C * kKC / 8; e += kT) {
      const int c = e / (kKC / 8), q = e % (kKC / 8);
      kasf_mma::cp_async16(st + kW1 + c * kLdJ + 8 * q, w2 + c * H + j0 + 8 * q);
    }
    if (tid < kKC / 8) kasf_mma::cp_async16(st + kW1 + kW2 + 8 * tid, b1 + j0 + 8 * tid);
  }
  kasf_mma::cp_async_commit();
}

}  // namespace dxm

// bf16 at C = 128: one block a 112-row tile. The tile's a and do are
// staged in bf16 and each warp keeps its 16 rows' A fragments of both in
// registers; for each 16 hidden columns of a chunk a warp takes z = a W1c^T
// and dh = do W2c (two accumulator sets), dz = dh GELU'(z + b1) packed to
// bf16 as the A fragment of da += dz W1c, so the hidden stays in registers;
// da (16 rows x 128 channels a warp) meets LayerNorm's backward at the end.
__global__ void __launch_bounds__(dxm::kT, 1)
mlp_ln_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2, const float* __restrict__ ls2,
                         __nv_bfloat16* __restrict__ dx, float* __restrict__ part, long long M,
                         int H, float eps) {
  using namespace dxm;
  extern __shared__ float4 smem4[];
  bf16* aB = reinterpret_cast<bf16*>(smem4);
  bf16* doB = aB + kR * kLdA;
  bf16* ring = aB + kOffRing;
  float* sMean = reinterpret_cast<float*>(aB + kOffStat);
  float* sRstd = sMean + kR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kR;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) fetch_chunk(ring, w1, w2, b1, j, H, tid);
  {
    const long long left = M - row0;
    stage_rows<kWarps, kR>(x + row0 * C, g + row0 * C, left < kR ? static_cast<int>(left) : kR,
                           dxp::ld4(gamma + 4 * lane), dxp::ld4(beta + 4 * lane),
                           dxp::ld4(ls2 + 4 * lane), aB, doB, nullptr, sMean, sRstd, eps, warp,
                           lane);
  }
  __syncthreads();  // a and do staged
  const int rw = 16 * warp;
  uint32_t af[C / 16][4], df[C / 16][4];
#pragma unroll
  for (int k = 0; k < C / 16; ++k) {
    ldsm_x4(af[k], aB + rw * kLdA + off_a(lane, kLdA) + 16 * k);
    ldsm_x4(df[k], doB + rw * kLdA + off_a(lane, kLdA) + 16 * k);
  }
  float da[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[n][e] = 0.f;
  const int ob = off_b(lane, kLdA), ot1 = off_a(lane, kLdA), ot2 = off_a(lane, kLdJ);

  for (int ch = 0; ch < H / kKC; ++ch) {
    kasf_mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed; every warp is done with the stage refilled next
    fetch_chunk(ring, w1, w2, b1, ch + kStages - 1, H, tid);
    const bf16* w1c = ring + (ch % kStages) * kStage;
    const bf16* w2c = w1c + kW1;
    const bf16* b1c = w2c + kW2;
#pragma unroll 1
    for (int q = 0; q < kKC / 16; ++q) {
      float z[2][4], dh[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][e] = dh[u][e] = 0.f;
#pragma unroll
      for (int k = 0; k < C / 16; ++k) {
        uint32_t b[4];
        ldsm_x4(b, w1c + 16 * q * kLdA + ob + 16 * k);
        mma_k16(z[0], af[k], b[0], b[1]);
        mma_k16(z[1], af[k], b[2], b[3]);
        ldsm_x4_trans(b, w2c + 16 * k * kLdJ + ot2 + 16 * q);
        mma_k16(dh[0], df[k], b[0], b[1]);
        mma_k16(dh[1], df[k], b[2], b[3]);
      }
      // dz = dh GELU'(z + b1), rows g and g + 8, columns 16 q + 8 u + 2 t..;
      // packed, the A fragment of the 16 columns
      uint32_t az[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 bias = load2(b1c + 16 * q + 8 * u + 2 * tq);
        az[2 * u] = pack_bf16(dh[u][0] * tc::gelu_and_grad(z[u][0] + bias.x).y,
                              dh[u][1] * tc::gelu_and_grad(z[u][1] + bias.y).y);
        az[2 * u + 1] = pack_bf16(dh[u][2] * tc::gelu_and_grad(z[u][2] + bias.x).y,
                                  dh[u][3] * tc::gelu_and_grad(z[u][3] + bias.y).y);
      }
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, w1c + 16 * q * kLdA + ot1 + 16 * n2);
        mma_k16(da[2 * n2], az, b[0], b[1]);
        mma_k16(da[2 * n2 + 1], az, b[2], b[3]);
      }
    }
  }

  // ---- epilogue: the thread holds da of rows rw + gq (+ 8) and channels
  // 8n + 2tq, + 1; a row's 128 channels lie on the 4 lanes of its quad
  float mean[2], rstd[2], m1[2], m2[2];
  long long row[2];
  bool valid[2];
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
    const int r = rw + gq + 8 * hs;
    row[hs] = row0 + r;
    valid[hs] = row[hs] < M;
    mean[hs] = sMean[r];
    rstd[hs] = sRstd[r];
    m1[hs] = m2[hs] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    const int c = 8 * n + 2 * tq;
    const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const float2 xv = valid[hs] ? load2(x + row[hs] * C + c) : make_float2(0.f, 0.f);
      const float d0 = da[n][2 * hs] * gm.x, d1 = da[n][2 * hs + 1] * gm.y;
      m1[hs] += d0;
      m1[hs] += d1;
      m2[hs] = fmaf(d0, (xv.x - mean[hs]) * rstd[hs], m2[hs]);
      m2[hs] = fmaf(d1, (xv.y - mean[hs]) * rstd[hs], m2[hs]);
    }
  }
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
    m1[hs] = group_sum<4>(m1[hs]) * (1.0f / C);
    m2[hs] = group_sum<4>(m2[hs]) * (1.0f / C);
  }
  // dx, and the sums of da * xhat, da and g over the warp's valid rows per
  // channel (rows g, g + 8, then the 8 row groups by shuffles); aB and doB
  // are free: every warp loaded its fragments before the first chunk
  float* red = reinterpret_cast<float*>(aB);  // [warp][3][C]
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    const int c = 8 * n + 2 * tq;
    const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
    float s[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      if (!valid[hs]) continue;
      const float2 xv = load2(x + row[hs] * C + c), gv = load2(g + row[hs] * C + c);
      const float a0 = da[n][2 * hs], a1 = da[n][2 * hs + 1];
      const float h0 = (xv.x - mean[hs]) * rstd[hs], h1 = (xv.y - mean[hs]) * rstd[hs];
      store2(dx + row[hs] * C + c, gv.x + rstd[hs] * (a0 * gm.x - m1[hs] - h0 * m2[hs]),
             gv.y + rstd[hs] * (a1 * gm.y - m1[hs] - h1 * m2[hs]));
      s[0][0] = fmaf(a0, h0, s[0][0]);
      s[0][1] = fmaf(a1, h1, s[0][1]);
      s[1][0] += a0;
      s[1][1] += a1;
      s[2][0] += gv.x;
      s[2][1] += gv.y;
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
        for (int v = 0; v < 2; ++v) s[k3][v] += __shfl_xor_sync(0xffffffffu, s[k3][v], off);
    if (gq == 0)
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
        *reinterpret_cast<float2*>(red + (warp * 3 + k3) * C + c) = make_float2(s[k3][0], s[k3][1]);
  }
  __syncthreads();
  for (int e = tid; e < 3 * C; e += kT) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * 3 * C + e];
    part[static_cast<long long>(blockIdx.x) * 3 * C + e] = t;
  }
}

// ---- 4b. the weight pass's block: wp::Cfg<128>'s grid of (chunk of 64
// hidden columns, row split) and its splits of 40-row tiles, so the partials
// and the reduce are C = 128's; a block walks its split's rows in steps of
// 64 (a multiple of 16 for the k16 contraction over rows), the last step
// ragged
namespace wpm {

using namespace mm;

constexpr int kWarps = 8, kT = 32 * kWarps;
constexpr int kR = 64;                   // rows a step
constexpr int kUnit = wp::Cfg<128>::kR;  // the partition's tile: 40 rows
// shared memory (bf16): aB, doB, gB | W1 rows [j][c] | W2 columns [c][j] |
// hB, dzB | b1 (floats) | the raw stage of a step's x and g rows | mbarrier
constexpr int kOffW1 = 3 * kR * kLdA;
constexpr int kOffW2 = kOffW1 + kKC * kLdA;
constexpr int kOffH = kOffW2 + C * kLdJ;
constexpr int kOffDz = kOffH + kR * kLdJ;
constexpr int kOffB1 = kOffDz + kR * kLdJ;
constexpr int kOffRaw = kOffB1 + 2 * kKC;
constexpr int kOffBar = kOffRaw + 2 * kR * C;
constexpr size_t kSmem = sizeof(bf16) * kOffBar + sizeof(unsigned long long);
static_assert(kR % 16 == 0 && kR / 16 == kWarps / 2 && kKC == 2 * 32,
              "the products' warp tiles cover the step");
static_assert(kOffW1 % 8 == 0 && kOffW2 % 8 == 0 && kOffH % 8 == 0 && kOffDz % 8 == 0 &&
                  kOffB1 % 8 == 0 && kOffRaw % 8 == 0 && kOffBar % 8 == 0,
              "16-byte alignment of the shared buffers");
static_assert(4 * kKC * sizeof(float) <= 2 * kR * kLdJ * sizeof(bf16), "db1's sums fit in hB");
static_assert(kSmem <= 232448, "one block a SM");

// One thread: copy rows row0..row0+n-1 of x and of g raw into the stage by
// two bulk copies that complete on bar
__device__ __forceinline__ void fetch_rows(bf16* raw, const bf16* __restrict__ x,
                                           const bf16* __restrict__ g, long long row0, int n,
                                           unsigned long long* bar) {
  const unsigned bytes = static_cast<unsigned>(n) * C * sizeof(bf16);
  kasf_mma::mbar_expect(bar, 2 * bytes);
  kasf_mma::bulk_load(raw, x + row0 * C, bytes, bar);
  kasf_mma::bulk_load(raw + kR * C, g + row0 * C, bytes, bar);
}

}  // namespace wpm

// bf16 at C = 128: one block per (hidden chunk of 64, row split). A step:
// a, do and g staged in bf16 from the raw stage (the next step's rows then
// in flight); warp w takes z = a W1c^T and dh = do W2c for rows 16 (w % 4)
// and columns 32 (w / 4) (8 n-tiles), h = GELU(z + b1) and dz = dh GELU'(z +
// b1) go to shared memory in bf16 (db1 summed from dz in f32); then warps
// 0-3 accumulate dW1c += dz^T a and warps 4-7 G_c^T += h^T g (32 hidden x
// 64 channels a warp, ldmatrix.trans giving the transposed operands) in
// registers over the split; the split's partial at the end.
__global__ void __launch_bounds__(wpm::kT, 1)
mlp_ln_bwd_w_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2, const float* __restrict__ ls2,
                        float* __restrict__ part, long long M, int H, float eps) {
  using namespace wpm;
  extern __shared__ float4 smem4[];
  bf16* aB = reinterpret_cast<bf16*>(smem4);
  bf16* doB = aB + kR * kLdA;
  bf16* gB = doB + kR * kLdA;
  bf16* w1B = aB + kOffW1;
  bf16* w2B = aB + kOffW2;
  bf16* hB = aB + kOffH;
  bf16* dzB = aB + kOffDz;
  float* b1s = reinterpret_cast<float*>(aB + kOffB1);
  bf16* raw = aB + kOffRaw;
  auto* bar = reinterpret_cast<unsigned long long*>(aB + kOffBar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * kKC;
  // the split's rows: per consecutive 40-row tiles of the partition
  const long long units = (M + kUnit - 1) / kUnit;
  const long long per = (units + gridDim.y - 1) / gridDim.y;
  const long long r_begin = blockIdx.y * per * kUnit;
  const long long r_end = r_begin + per * kUnit < M ? r_begin + per * kUnit : M;
  if (tid == 0) kasf_mma::mbar_init(bar);
  __syncthreads();  // the barrier is initialised
  if (tid == 0 && r_begin < r_end)
    fetch_rows(raw, x, g, r_begin, r_end - r_begin < kR ? static_cast<int>(r_end - r_begin) : kR,
               bar);
  // the chunk's weights once, raw: W1 rows j0.. and W2 columns j0..
  for (int e = tid; e < kKC * C / 8; e += kT) {
    const int r = e / (C / 8), c8 = e % (C / 8);
    *reinterpret_cast<uint4*>(w1B + r * kLdA + 8 * c8) =
        *reinterpret_cast<const uint4*>(w1 + (j0 + r) * C + 8 * c8);
  }
  for (int e = tid; e < C * kKC / 8; e += kT) {
    const int c = e / (kKC / 8), q = e % (kKC / 8);
    *reinterpret_cast<uint4*>(w2B + c * kLdJ + 8 * q) =
        *reinterpret_cast<const uint4*>(w2 + c * H + j0 + 8 * q);
  }
  if (tid < kKC) b1s[tid] = to_f(b1[j0 + tid]);
  const float4 gm = dxp::ld4(gamma + 4 * lane), bt = dxp::ld4(beta + 4 * lane),
               ls = dxp::ld4(ls2 + 4 * lane);
  __syncthreads();  // W1c, W2c and b1 are in

  // z and dh: rows rw.., columns jw..; outer products: hidden rows jo..,
  // channels co.. of dW1c (warps 0-3, from dz and a) or G_c^T (4-7, h and g)
  const int rw = 16 * (warp & 3), jw = 32 * (warp >> 2);
  const int jo = 32 * (warp & 1), co = 64 * ((warp >> 1) & 1);
  const bf16* X = warp < 4 ? dzB : hB;
  const bf16* Y = warp < 4 ? aB : gB;
  float bias[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    bias[u][0] = b1s[jw + 8 * u + 2 * tq];
    bias[u][1] = b1s[jw + 8 * u + 2 * tq + 1];
  }
  float acc[2][8][4], db1a[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) db1a[u][0] = db1a[u][1] = 0.f;
  const int oa = rw * kLdA + off_a(lane, kLdA), ob = jw * kLdA + off_b(lane, kLdA);
  const int ot2 = off_a(lane, kLdJ) + jw;
  const int ox = off_b(lane, kLdJ) + jo, oy = off_a(lane, kLdA) + co;

  unsigned parity = 0;
  for (long long row0 = r_begin; row0 < r_end; row0 += kR, parity ^= 1) {
    const int n = r_end - row0 < kR ? static_cast<int>(r_end - row0) : kR;
    kasf_mma::mbar_wait(bar, parity);
    __syncthreads();  // the step's rows landed; the last step's products are done
    stage_rows<kWarps, kR>(raw, raw + kR * C, n, gm, bt, ls, aB, doB, gB, nullptr, nullptr, eps,
                           warp, lane);
    __syncthreads();  // a, do and g in; the raw stage is free
    if (tid == 0 && row0 + kR < r_end)
      fetch_rows(raw, x, g, row0 + kR,
                 r_end - row0 - kR < kR ? static_cast<int>(r_end - row0 - kR) : kR, bar);
    float z[4][4], dh[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[u][e] = dh[u][e] = 0.f;
#pragma unroll
    for (int k = 0; k < C / 16; ++k) {
      uint32_t fa[4], fd[4];
      ldsm_x4(fa, aB + oa + 16 * k);
      ldsm_x4(fd, doB + oa + 16 * k);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, w1B + ob + 16 * p * kLdA + 16 * k);
        mma_k16(z[2 * p], fa, b[0], b[1]);
        mma_k16(z[2 * p + 1], fa, b[2], b[3]);
        ldsm_x4_trans(b, w2B + ot2 + 16 * k * kLdJ + 16 * p);
        mma_k16(dh[2 * p], fd, b[0], b[1]);
        mma_k16(dh[2 * p + 1], fd, b[2], b[3]);
      }
    }
    // h and dz of rows rw + gq (+ 8), columns jw + 8u + 2tq, + 1, in bf16
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        const float2 e0 = tc::gelu_and_grad(z[u][2 * hs] + bias[u][0]);
        const float2 e1 = tc::gelu_and_grad(z[u][2 * hs + 1] + bias[u][1]);
        const float d0 = dh[u][2 * hs] * e0.y, d1 = dh[u][2 * hs + 1] * e1.y;
        db1a[u][0] += d0;
        db1a[u][1] += d1;
        const int o = (rw + gq + 8 * hs) * kLdJ + jw + 8 * u + 2 * tq;
        store2(hB + o, e0.x, e1.x);
        store2(dzB + o, d0, d1);
      }
    __syncthreads();  // hB and dzB are in
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      uint32_t fx[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldsm_x4_trans(fx[mi], X + ox + 16 * kk * kLdJ + 16 * mi);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(b, Y + oy + 16 * kk * kLdA + 16 * p);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_k16(acc[mi][2 * p], fx[mi], b[0], b[1]);
          mma_k16(acc[mi][2 * p + 1], fx[mi], b[2], b[3]);
        }
      }
    }
  }

  // the split's partial: dW1c rows (float2s), G_c columns, db1c
  float* base = part + static_cast<long long>(blockIdx.y) * (2LL * H * C + H);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        const int j = j0 + jo + 16 * mi + gq + 8 * hs, c = co + 8 * n + 2 * tq;
        const float v0 = acc[mi][n][2 * hs], v1 = acc[mi][n][2 * hs + 1];
        if (warp < 4) {
          *reinterpret_cast<float2*>(base + static_cast<long long>(j) * C + c) =
              make_float2(v0, v1);
        } else {
          float* col = base + static_cast<long long>(H) * C + j;
          col[static_cast<long long>(c) * H] = v0;
          col[static_cast<long long>(c + 1) * H] = v1;
        }
      }
  // db1: over the warp's 8 row groups, then its 4 row warps in order
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) db1a[u][v] += __shfl_xor_sync(0xffffffffu, db1a[u][v], off);
  __syncthreads();  // hB is free
  float* red = reinterpret_cast<float*>(hB);  // [row warp][kKC]
  if (gq == 0)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float2*>(red + (warp & 3) * kKC + jw + 8 * u + 2 * tq) =
          make_float2(db1a[u][0], db1a[u][1]);
  __syncthreads();
  if (tid < kKC)
    base[2LL * H * C + j0 + tid] =
        ((red[tid] + red[kKC + tid]) + red[2 * kKC + tid]) + red[3 * kKC + tid];
}

struct Args {
  const void *x, *g, *w1, *b1, *w2, *b2;
  const float *gamma, *beta, *ls2;
  void* dx;
  float *dgamma, *dbeta, *dw1, *db1, *dw2, *db2, *dls2, *work;
};

// the dx pass's rows a tile: one block's at C = 64 and 128, a cluster's beyond
template <int C>
constexpr int dx_rows() {
  if constexpr (C <= 128) return dxp::Cfg<C>::kR;
  else return dxc::Cfg<C>::kR;
}
template <int C>
long long dx_tiles(long long M) {
  return (M + dx_rows<C>() - 1) / dx_rows<C>();
}

// floats of the stage launch's output at C >= 256: W1 and W2^T in f32 as
// padded slices (dxc::Cfg::kLdW1 floats a row), b1
template <int C>
long long stage_floats(int H) {
  if constexpr (C <= 128) return 0;
  else return 2LL * dxc::kNB * H * dxc::Cfg<C>::kLdW1 + H;
}

// the weight pass's rows a tile and row splits for M rows and hidden H:
// splits = min(tiles, 132 / blocks a split), at least one (one wave)
template <int C>
constexpr int w_rows() {
  if constexpr (C <= 128) return wp::Cfg<C>::kR;
  else return wpc::Cfg<C>::kR;
}
template <int C>
int w_splits(long long M, int H) {
  if constexpr (C <= 128) {
    return wp::splits<C>(M, H);
  } else {
    const long long s = wp::kSMs / (wpc::kNB * (H / wpc::Cfg<C>::kJ));
    const long long t = (M + w_rows<C>() - 1) / w_rows<C>();
    return static_cast<int>(s < 1 ? 1 : s < t ? s : t);
  }
}

constexpr int kMaxDevices = 64;
static_assert(dxc::kNB == 2 && wpc::kNB == 2 && dxc::kT == 256 && wpc::kT == 256,
              "both cluster kernels: clusters of two blocks of 256 threads");

// A launch of `grid` blocks of 256 threads in clusters of two (grid.x a
// multiple of two) with `smem` bytes of dynamic shared memory on `stream`,
// for cudaLaunchKernelEx
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(dim3 grid, size_t smem, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The clusters of two blocks of `kernel` (at `smem` bytes) the device holds
// at once (cudaOccupancyMaxActiveClusters; a cluster lives within one GPC),
// its dynamic shared-memory limit raised first; once per device, into held
template <typename K>
cudaError_t clusters_held(K kernel, size_t smem, int (&held)[kMaxDevices], int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (held[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int n = 0;
    ClusterLaunch one(dim3(2), smem, nullptr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &one.cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    held[dev] = n;
  }
  *clusters = held[dev];
  return cudaSuccess;
}
template <typename T, int C>
cudaError_t dx_clusters(int* clusters) {
  static int held[kMaxDevices];  // one array per instantiation; 0: not yet
  return clusters_held(mlp_ln_bwd_dx_cluster_kernel<T, C>, dxc::Cfg<C>::kSmem, held, clusters);
}
template <typename T, int C>
cudaError_t w_clusters(int* clusters) {
  static int held[kMaxDevices];
  return clusters_held(mlp_ln_bwd_w_cluster_kernel<T, C>, wpc::smem_bytes<T, C>(), held,
                       clusters);
}

// The TMA engine's description of the (M, C) row-major matrix at `base`
// for boxes of `rows` rows x `cols` channels, for cp.async.bulk.tensor;
// the driver's encoder is reached through the runtime's entry point, so the
// library links no driver library
template <typename T>
cudaError_t row_map(CUtensorMap* map, const void* base, long long M, int C, int cols, int rows) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The reduce over a.work as the two passes leave it for M rows and hidden H
template <typename T, int C>
cudaError_t launch_reduce(const Args& a, long long M, int H, cudaStream_t stream) {
  const long long tiles = dx_tiles<C>(M);  // the dx pass's tiles
  const int splits = w_splits<C>(M, H);
  if constexpr (C == 64) {
    const int smem = rds::smem_bytes(H, splits);
    if (splits > rds::kMaxSplits) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_ln_bwd_reduce_seg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_reduce_seg_kernel<T><<<rds::kBlocks, rds::kTB, smem, stream>>>(
        a.work, static_cast<int>(tiles), a.work + tiles * 3 * C, splits,
        static_cast<const T*>(a.w2), static_cast<const T*>(a.b2), a.ls2, a.dgamma, a.dbeta,
        a.dw1, a.db1, a.dw2, a.db2, a.dls2, H);
  } else if constexpr (C == 512) {
    const int smem = rdw::smem_bytes<T>(H, splits);
    if (splits > rdw::kMaxSplits) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_ln_bwd_reduce_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_reduce_wide_kernel<T><<<rdw::kBlocks, rdw::kTB, smem, stream>>>(
        a.work, static_cast<int>(tiles), a.work + tiles * 3 * C, splits,
        static_cast<const T*>(a.w2), static_cast<const T*>(a.b2), a.ls2, a.dgamma, a.dbeta,
        a.dw1, a.db1, a.dw2, a.db2, a.dls2, H);
  } else {
    mlp_ln_bwd_reduce_kernel<T, C><<<rd::blocks<C>(H), rd::kTB, 0, stream>>>(
        a.work, static_cast<int>(tiles), a.work + tiles * 3 * C, splits,
        static_cast<const T*>(a.w2), static_cast<const T*>(a.b2), a.ls2, a.dgamma, a.dbeta,
        a.dw1, a.db1, a.dw2, a.db2, a.dls2, H);
  }
  return cudaGetLastError();
}

// The dx pass: at C = 64 one block of two warp groups a tile, at 128 one
// block a tile; at 256 and 512 the stage launch, then clusters of two, at
// most one wave of them, walking the tiles
template <typename T, int C>
cudaError_t launch_dx(const Args& a, float* stage, long long M, int H, float eps,
                      cudaStream_t stream) {
  const long long tiles = dx_tiles<C>(M);
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  if constexpr (C == 64) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_dx_wg_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(dxg::Cfg::kSmem));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_dx_wg_kernel<T><<<static_cast<unsigned>(tiles), dxg::kT, dxg::Cfg::kSmem,
                                 stream>>>(x, g, a.gamma, a.beta, w1, b1, w2, a.ls2,
                                           static_cast<T*>(a.dx), a.work, M, H, eps);
  } else if constexpr (C == 128 && !std::is_same<T, float>::value) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_dx_mma_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(dxm::kSmem));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_dx_mma_kernel<<<static_cast<unsigned>(tiles), dxm::kT, dxm::kSmem, stream>>>(
        x, g, a.gamma, a.beta, w1, b1, w2, a.ls2, static_cast<T*>(a.dx), a.work, M, H, eps);
  } else if constexpr (C == 128) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_dx_kernel<T, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(dxp::smem_bytes<C>()));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_dx_kernel<T, C><<<static_cast<unsigned>(tiles), dxp::kT,
                                 dxp::smem_bytes<C>(), stream>>>(
        x, g, a.gamma, a.beta, w1, b1, w2, a.ls2, static_cast<T*>(a.dx), a.work, M, H, eps);
  } else {
    int resident = 0;
    const cudaError_t err = dx_clusters<T, C>(&resident);
    if (err != cudaSuccess) return err;
    constexpr bool kF32 = std::is_same<T, float>::value;
    const long long slices = 1LL * dxc::kNB * H * dxc::Cfg<C>::kLdW1;  // floats a matrix
    float* w1s = stage;
    float* w2s = stage + slices;
    float* b1f = stage + 2 * slices;
    mlp_ln_bwd_stage_kernel<T, C><<<(C / 32) * (H / 32), 256, 0, stream>>>(w1, b1, w2, w1s, w2s,
                                                                            b1f, H);
    const cudaError_t staged = cudaGetLastError();
    if (staged != cudaSuccess) return staged;
    const long long clusters = tiles < resident ? tiles : resident;
    ClusterLaunch l(dim3(static_cast<unsigned>(clusters * dxc::kNB)), dxc::Cfg<C>::kSmem, stream);
    cudaLaunchKernelEx(&l.cfg, mlp_ln_bwd_dx_cluster_kernel<T, C>, x, g, a.gamma, a.beta, w1s,
                       kF32 ? reinterpret_cast<const float*>(b1) : b1f, w2s, a.ls2,
                       static_cast<T*>(a.dx), a.work, M, H, eps);
  }
  return cudaGetLastError();
}

// The weight pass into its row splits' partials at part_w: at C = 64 one
// block a (hidden chunk, split) on the tensor cores, at 128 one block a
// (chunk, split) on the CUDA cores; at 256 and 512 a cluster of two a (chunk,
// split), reading the stage launch's weights, x and g through tensor maps
template <typename T, int C>
cudaError_t launch_w(const Args& a, float* part_w, const float* stage, long long M, int H,
                     float eps, cudaStream_t stream) {
  const int splits = w_splits<C>(M, H);
  if constexpr (C == 64) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_w_tc_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(tc::smem_bytes<T>()));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_w_tc_kernel<T><<<dim3(H / tc::kJ, splits), tc::kT, tc::smem_bytes<T>(), stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.beta,
        static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
        a.ls2, part_w, M, H, eps);
  } else if constexpr (C == 128 && !std::is_same<T, float>::value) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_w_mma_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(wpm::kSmem));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_w_mma_kernel<<<dim3(H / mm::kKC, splits), wpm::kT, wpm::kSmem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.beta,
        static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
        a.ls2, part_w, M, H, eps);
  } else if constexpr (C == 128) {
    const cudaError_t err = cudaFuncSetAttribute(mlp_ln_bwd_w_kernel<T, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(wp::smem_bytes<T, C>()));
    if (err != cudaSuccess) return err;
    mlp_ln_bwd_w_kernel<T, C><<<dim3(H / wp::Cfg<C>::kJ, splits), wp::kT,
                                wp::smem_bytes<T, C>(), stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.beta,
        static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
        a.ls2, part_w, M, H, eps);
  } else {
    using K = wpc::Cfg<C>;
    int held = 0;
    CUtensorMap xm, gm;
    cudaError_t err = w_clusters<T, C>(&held);  // raises its shared-memory limit
    if (err == cudaSuccess) err = row_map<T>(&xm, a.x, M, C, K::CS, K::kR);
    if (err == cudaSuccess) err = row_map<T>(&gm, a.g, M, C, K::CS, K::kR);
    if (err != cudaSuccess) return err;
    const long long slices = 1LL * wpc::kNB * H * K::kLdW;  // floats a matrix of the stage
    const float* b1 = std::is_same<T, float>::value ? static_cast<const float*>(a.b1)
                                                    : stage + 2 * slices;
    ClusterLaunch l(dim3(wpc::kNB * (H / K::kJ), splits), wpc::smem_bytes<T, C>(), stream);
    err = cudaLaunchKernelEx(&l.cfg, mlp_ln_bwd_w_cluster_kernel<T, C>, xm, gm, a.gamma, a.beta,
                             stage, stage + slices, b1, a.ls2, part_w, M, H, eps);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch(const Args& a, long long M, int H, float eps, cudaStream_t stream) {
  const long long tiles = dx_tiles<C>(M);  // the dx pass's tiles
  float* part_w = a.work + tiles * 3 * C;
  float* stage = part_w + static_cast<long long>(w_splits<C>(M, H)) * (2LL * H * C + H);
  cudaError_t err = launch_dx<T, C>(a, stage, M, H, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_w<T, C>(a, part_w, stage, M, H, eps, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce<T, C>(a, M, H, stream);
}

// A kernel's threads a block, registers and local memory (spills) a thread,
// blocks resident a SM at `smem` bytes of dynamic shared memory and its
// static shared memory, into info[0..4]; false where the runtime refuses
template <typename K>
bool describe(K kernel, int threads, int smem, int* info) {
  cudaFuncAttributes attr{};
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return false;
  info[0] = threads;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = per_sm;
  info[4] = static_cast<int>(attr.sharedSizeBytes);
  return true;
}

// the device's SMs, 0 where the runtime refuses
inline int device_sms() {
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// info[0..5]: the dx pass as {threads, rows a tile, registers, shared
// memory bytes, spill bytes, blocks a SM}; info[6..13]: the weight pass as
// {threads, rows a tile, hidden columns a block, row splits for M rows and
// hidden H, registers, shared memory bytes, spill bytes, blocks a SM};
// info[14..19]: the reduce as {threads, blocks for hidden H, registers,
// shared memory bytes (static and, at C = 64 and 512, dynamic), spill bytes,
// blocks a SM}; info[20..22]: the dx pass
// again, {blocks a cluster (a tile), clusters the device holds at once (one
// block each at C = 128), blocks of its launch over M rows}; info[23..25]:
// the weight pass again, {blocks a cluster (a hidden chunk and split),
// clusters the device holds at once (one block each at C = 128), blocks of
// its launch}; info[26]: the dx pass's warp groups a block, each over its
// share of the hidden width (two at C = 64, else one)
template <typename T, int C>
void describe_all(long long M, int H, int* info) {
  int d[5];
  const long long tiles = dx_tiles<C>(M);
  const int splits = w_splits<C>(M, H);
  if constexpr (C <= 128) {
    constexpr bool kMma = C == 128 && !std::is_same<T, float>::value;  // bf16: 4a., 4b.
    const int smem_dx = static_cast<int>(C == 64 ? dxg::Cfg::kSmem
                                         : kMma  ? dxm::kSmem
                                                 : dxp::smem_bytes<C>());
    const int sms = device_sms();
    bool dx_known = false;
    if constexpr (C == 64)
      dx_known = describe(mlp_ln_bwd_dx_wg_kernel<T>, dxg::kT, smem_dx, d);
    else if constexpr (kMma)
      dx_known = describe(mlp_ln_bwd_dx_mma_kernel, dxm::kT, smem_dx, d);
    else
      dx_known = describe(mlp_ln_bwd_dx_kernel<T, C>, dxp::kT, smem_dx, d);
    if (dx_known && sms > 0) {
      const int v[6] = {d[0], dx_rows<C>(), d[1], smem_dx, d[2], d[3]};
      for (int i = 0; i < 6; ++i) info[i] = v[i];
      info[20] = 1;
      info[21] = sms * d[3];
      info[22] = static_cast<int>(tiles);
      info[26] = C == 64 ? 2 : 1;
    }
    const int smem_w = static_cast<int>(C == 64 ? tc::smem_bytes<T>()
                                        : kMma  ? wpm::kSmem
                                                : wp::smem_bytes<T, C>());
    bool w_known = false;
    if constexpr (C == 64)
      w_known = describe(mlp_ln_bwd_w_tc_kernel<T>, tc::kT, smem_w, d);
    else if constexpr (kMma)
      w_known = describe(mlp_ln_bwd_w_mma_kernel, wpm::kT, smem_w, d);
    else
      w_known = describe(mlp_ln_bwd_w_kernel<T, C>, wp::kT, smem_w, d);
    if (w_known && sms > 0) {
      const int v[8] = {d[0], w_rows<C>(), wp::Cfg<C>::kJ, splits, d[1], smem_w, d[2], d[3]};
      for (int i = 0; i < 8; ++i) info[6 + i] = v[i];
      info[23] = 1;
      info[24] = sms * d[3];
      info[25] = H / wp::Cfg<C>::kJ * splits;
    }
  } else {
    const int smem_dx = static_cast<int>(dxc::Cfg<C>::kSmem);
    int clusters = 0;
    if (dx_clusters<T, C>(&clusters) == cudaSuccess &&
        describe(mlp_ln_bwd_dx_cluster_kernel<T, C>, dxc::kT, smem_dx, d)) {
      const int v[6] = {d[0], dx_rows<C>(), d[1], smem_dx, d[2], d[3]};
      for (int i = 0; i < 6; ++i) info[i] = v[i];
      info[20] = dxc::kNB;
      info[21] = clusters;
      info[22] = static_cast<int>((tiles < clusters ? tiles : clusters) * dxc::kNB);
      info[26] = 1;
    }
    const int smem_w = static_cast<int>(wpc::smem_bytes<T, C>());
    if (w_clusters<T, C>(&clusters) == cudaSuccess &&
        describe(mlp_ln_bwd_w_cluster_kernel<T, C>, wpc::kT, smem_w, d)) {
      const int v[8] = {d[0], w_rows<C>(), wpc::Cfg<C>::kJ, splits, d[1], smem_w, d[2], d[3]};
      for (int i = 0; i < 8; ++i) info[6 + i] = v[i];
      info[23] = wpc::kNB;
      info[24] = clusters;
      info[25] = wpc::kNB * (H / wpc::Cfg<C>::kJ) * splits;
    }
  }
  if constexpr (C == 64) {
    const int smem_r = rds::smem_bytes(H, splits);
    if (describe(mlp_ln_bwd_reduce_seg_kernel<T>, rds::kTB, smem_r, d)) {
      const int v[6] = {d[0], rds::kBlocks, d[1], d[4] + smem_r, d[2], d[3]};
      for (int i = 0; i < 6; ++i) info[14 + i] = v[i];
    }
  } else if constexpr (C == 512) {
    const int smem_r = rdw::smem_bytes<T>(H, splits);
    if (describe(mlp_ln_bwd_reduce_wide_kernel<T>, rdw::kTB, smem_r, d)) {
      const int v[6] = {d[0], rdw::kBlocks, d[1], d[4] + smem_r, d[2], d[3]};
      for (int i = 0; i < 6; ++i) info[14 + i] = v[i];
    }
  } else if (describe(mlp_ln_bwd_reduce_kernel<T, C>, rd::kTB, 0, d)) {
    const int v[6] = {d[0], rd::blocks<C>(H), d[1], d[4], d[2], d[3]};
    for (int i = 0; i < 6; ++i) info[14 + i] = v[i];
  }
}

// the shapes K4 takes: C in {64, 128, 256, 512}, H a multiple of 64 up to
// 2048 (of 128 at C = 64: the weight pass's chunk)
bool takes(long long M, int C, int H) {
  return M >= 1 && (C == 64 || C == 128 || C == 256 || C == 512) && H >= 64 &&
         H % (C == 64 ? 128 : 64) == 0 && H <= 4 * rd::kItemsMax;
}

// f<C>() at the width C takes, for the four widths
template <typename F>
auto by_width(int C, F&& f) {
  return C == 64    ? f(std::integral_constant<int, 64>{})
         : C == 128 ? f(std::integral_constant<int, 128>{})
         : C == 256 ? f(std::integral_constant<int, 256>{})
                    : f(std::integral_constant<int, 512>{});
}

}  // namespace

extern "C" {

// Floats of workspace kasf_mlp_ln_bwd needs for M rows, width C and hidden
// H: the dx pass's partials, one a tile, then the weight pass's, one a row
// split (the reduce reads these two), then at C = 256 and 512 the stage
// launch's f32 weights, W1 and W2^T as [2][H][C / 2 + 4] slices each, and b1
// (H). 0 for a shape K4 does not take.
long long kasf_mlp_ln_bwd_workspace(long long M, int C, int H) {
  if (!takes(M, C, H)) return 0;
  return by_width(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    return dx_tiles<kC>(M) * 3 * kC +
           static_cast<long long>(w_splits<kC>(M, H)) * (2LL * H * kC + H) +
           stage_floats<kC>(H);
  });
}

// dtype: 0 = float32, 1 = bfloat16 (x, g, w1, b1, w2, b2, dx); gamma, beta,
// ls2, the parameter gradients and the workspace are float32. All tensors
// contiguous and 16-byte aligned: x, g, dx (M, C) with C in {64, 128, 256,
// 512}; w1 and dw1 (H, C); w2 and dw2 (C, H) with H a multiple of 64 up to
// 2048 (of 128 at C = 64). Returns cudaGetLastError() after the last of the three launches (0
// on success).
int kasf_mlp_ln_bwd(int dtype, const void* x, const void* g, const void* gamma,
                    const void* beta, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* ls2, void* dx, void* dgamma, void* dbeta,
                    void* dw1, void* db1, void* dw2, void* db2, void* dls2, void* work,
                    long long M, int C, int H, float eps, void* stream) {
  if (!takes(M, C, H) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  Args a{x, g, w1, b1, w2, b2,
         static_cast<const float*>(gamma), static_cast<const float*>(beta),
         static_cast<const float*>(ls2), dx,
         static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(dw1),
         static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
         static_cast<float*>(dls2), static_cast<float*>(work)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    return dtype == 0 ? launch<float, kC>(a, M, H, eps, s)
                      : launch<__nv_bfloat16, kC>(a, M, H, eps, s);
  });
}

// The reduce alone (the third of kasf_mlp_ln_bwd's launches) on a workspace
// laid out as the two passes leave it for M rows, width C and hidden H, of
// kasf_mlp_ln_bwd_workspace(M, C, H) floats: dgamma, dbeta, dw1, db1, dw2,
// db2 and dls2 as kasf_mlp_ln_bwd writes them. dtype as there (w2, b2); ls2,
// the workspace and the gradients float32; all 16-byte aligned.
int kasf_mlp_ln_bwd_reduce(int dtype, const void* work, const void* w2, const void* b2,
                           const void* ls2, void* dgamma, void* dbeta, void* dw1,
                           void* db1, void* dw2, void* db2, void* dls2, long long M, int C,
                           int H, void* stream) {
  if (!takes(M, C, H) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, nullptr, w2, b2,
         nullptr, nullptr, static_cast<const float*>(ls2), nullptr,
         static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(dw1),
         static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
         static_cast<float*>(dls2), static_cast<float*>(const_cast<void*>(work))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    return dtype == 0 ? launch_reduce<float, kC>(a, M, H, s)
                      : launch_reduce<__nv_bfloat16, kC>(a, M, H, s);
  });
}

// The three launches' instantiations for (dtype, C) on the current device at
// M rows and hidden H, for reports, into info[27] as describe_all lays it
// out. Left untouched for a shape or dtype there is none of, or where the
// runtime refuses the query.
void kasf_mlp_ln_bwd_info(int dtype, int C, long long M, int H, int* info) {
  if (!takes(M, C, H) || (dtype != 0 && dtype != 1)) return;
  by_width(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    if (dtype == 0)
      describe_all<float, kC>(M, H, info);
    else
      describe_all<__nv_bfloat16, kC>(M, H, info);
    return 0;
  });
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
