// K5: fused MLP forward (fc1 -> GELU -> fc2) for Hopper (sm_90a).
//
// Replaces the Pallas kernel kasportsformer_tpu/ops/mlp.py:_mlp_kernel
// (wrapper fused_mlp_pallas). Over M token rows of width C:
//     out = GELU(x W1^T + b1) W2^T + b2
// with W1 (H, C), W2 (C, H) in the torch nn.Linear layout, C in
// {64, 128, 256, 512} and H a multiple of 64 up to 2048. GELU is the exact
// erf form, applied to the f32 accumulator and rounded once to the compute
// dtype (the TPU kernel's bf16 path used the tanh form with a pre-halved W2,
// up to 4.8e-4 away).
//
// Bound on the H100: 4*M*C*H FLOP against ~2*M*C elements moved: bound by
// operations (15.4 GFLOP at M = 58,752, C/H = 128/512: ~230 us on the CUDA
// cores in f32, ~16 us on the tensor cores in bf16; 123 GFLOP at C/H =
// 512/1024: ~1.84 ms and ~0.125 ms).
//
// The kernels are the hidden-chunk tile of csrc/mlp_tile.cuh that K3 runs,
// with LayerNorm and the residual switched off: the rows enter the tile as
// they are, the hidden never reaches device memory, and the epilogue adds b2.
// In f32 a launch is two kernels (the weights transposed into
// kasf_mlp_workspace floats of scratch, then the persistent tile: blocks at
// C <= 128, clusters of two blocks at C = 256 and 512).
#include "mlp_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor). All tensors contiguous and
// 16-byte aligned; x and out are (M, C), w1 is (H, C), w2 is (C, H); work
// holds kasf_mlp_workspace floats (null where that is 0). Returns
// cudaGetLastError() after the launch (0 on success).
int kasf_mlp(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* out, void* work, long long M, int C, int H, void* stream) {
  return kasf_tile::launch<false>(dtype, x, nullptr, nullptr, w1, b1, w2, b2, nullptr, out,
                                 work, M, C, H, 0.f, stream);
}

// floats of workspace kasf_mlp needs for (dtype, C, H)
long long kasf_mlp_workspace(int dtype, int C, int H) {
  return kasf_tile::workspace(dtype, C, H);
}

// The instantiation for (dtype, C) on the current device, for reports:
// info = {threads a block, rows a tile, registers a thread, dynamic shared
// memory a block in bytes, local memory (spills) a thread in bytes, blocks
// a SM holds, blocks of a launch over M rows, blocks a cluster (a tile),
// blocks the device holds at once}. Left untouched for a width or dtype
// there is none of.
void kasf_mlp_info(int dtype, int C, long long M, int* info) {
  kasf_tile::describe_width<false>(dtype, C, M, info);
}

const char* kasf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
