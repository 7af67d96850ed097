// K3: LayerNorm-folded MLP tail forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/mlp.py:_mlp_ln_kernel
// (wrapper fused_mlp_ln_pallas). Over M token rows of width C:
//     out = x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)
// with LayerNorm statistics in f32 (eps passed through: 1e-5 for the flagship
// and MotionAGFormer, 1e-6 for the MixSTE family), exact-erf GELU, and W1
// (H, C), W2 (C, H) in the torch nn.Linear layout. C in {64, 128, 256, 512},
// H a multiple of 64 up to 2048.
//
// Bound on the H100: 4*M*C*H FLOP against ~2*M*C elements moved: bound by
// operations (15.4 GFLOP at M = 58,752, C/H = 128/512: ~230 us on the CUDA
// cores in f32, ~16 us on the tensor cores in bf16).
//
// The kernels are the hidden-chunk tile of csrc/mlp_tile.cuh with LayerNorm
// and the residual switched on; its header says how the tile is laid out
// (bf16: mma.sync with the hidden kept in registers at C <= 128, weight
// chunks through a cp.async ring, 128 rows a block, 64 at C = 512; f32 at
// C <= 128: persistent blocks over 112-row tiles, rows and weight chunks by
// bulk copies from a transposed copy of the weights written first, LN once
// a tile, 7 x 8 register tiles; f32 at C = 256 and 512: a thread-block
// cluster of two blocks a tile, each over half the channels, LN's
// statistics and fc1's partial sums exchanged through distributed shared
// memory). An f32 launch is two kernels and needs kasf_mlp_ln_workspace
// floats of scratch.
#include "mlp_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1, b1, w2, b2, out); gamma, beta and
// ls2 are float32. All tensors contiguous and 16-byte aligned; x and out are
// (M, C), w1 is (H, C), w2 is (C, H); work holds kasf_mlp_ln_workspace
// floats (null where that is 0). Returns cudaGetLastError() after the launch
// (0 on success).
int kasf_mlp_ln(int dtype, const void* x, const void* gamma, const void* beta,
                const void* w1, const void* b1, const void* w2, const void* b2,
                const void* ls2, void* out, void* work, long long M, int C, int H, float eps,
                void* stream) {
  return kasf_tile::launch<true>(dtype, x, gamma, beta, w1, b1, w2, b2, ls2, out, work, M, C,
                                H, eps, stream);
}

// floats of workspace kasf_mlp_ln needs for (dtype, C, H)
long long kasf_mlp_ln_workspace(int dtype, int C, int H) {
  return kasf_tile::workspace(dtype, C, H);
}

// The instantiation for (dtype, C) on the current device, for reports:
// info = {threads a block, rows a tile, registers a thread, dynamic shared
// memory a block in bytes, local memory (spills) a thread in bytes, blocks
// a SM holds, blocks of a launch over M rows, blocks a cluster (a tile),
// blocks the device holds at once}. Left untouched for a width or dtype
// there is none of.
void kasf_mlp_ln_info(int dtype, int C, long long M, int* info) {
  kasf_tile::describe_width<true>(dtype, C, M, info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
