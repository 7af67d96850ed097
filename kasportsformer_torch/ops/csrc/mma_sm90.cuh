// Warp-level tensor-core and copy primitives for Hopper (sm_90a) kernels:
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads and
// the m16n8k16 bf16 mma.sync with f32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//  * A (16 x 16, row): a[0] = (row g, k 2t..2t+1), a[1] = (row g+8, same k),
//    a[2] = (row g, k 8+2t..), a[3] = (row g+8, k 8+2t..); the lower k in the
//    low half of each register.
//  * B (16 x 8, col): b0 = (k 2t..2t+1, col g), b1 = (k 8+2t.., col g). A
//    matrix stored by rows of n (k contiguous) is loaded by a plain ldmatrix.
//  * C (16 x 8, f32): c[0..1] = (row g, cols 2t, 2t+1), c[2..3] = (row g+8,
//    same cols). Two neighbouring n-tiles of C, packed pairwise to bf16, are
//    exactly the A fragment of a product over those 16 columns.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace kasf_mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: m16n8k16, bf16 in, f32 accumulate. Registers only (not
// volatile), so the compiler may schedule other work around it
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// the two bf16 of a 32-bit word, exactly, as floats (lo from the low half)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

}  // namespace kasf_mma
