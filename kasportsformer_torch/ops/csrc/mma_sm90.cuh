// Warp-level tensor-core and copy primitives for Hopper (sm_90a) kernels:
// 16-byte cp.async copies into shared memory, bulk copies on the TMA
// engine completing on an mbarrier (and L2 prefetches), thread-block
// cluster barriers, stores into a cluster peer's shared memory and row sums
// across a cluster, ldmatrix fragment loads (plain and transposed), the
// m16n8k16 and m16n8k8 bf16 mma.sync with f32 accumulators, and the m16n8k8
// TF32 mma.sync with the hi / lo split of an f32 operand for products in
// 3xTF32.
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
// and of mma.sync.m16n8k8 with TF32 operands (one element a register):
//  * A (16 x 8, row): a[0] = (row g, k t), a[1] = (row g+8, k t), a[2] =
//    (row g, k t+4), a[3] = (row g+8, k t+4).
//  * B (8 x 8, col): b0 = (k t, col g), b1 = (k t+4, col g).
//  * C as above. An n-tile of C is so the A fragment of a product over its
//    8 columns with k-slot t taking column 2t and slot t+4 column 2t+1:
//    a = {c[0], c[2], c[1], c[3]}, its B rows in the same order.
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
// one arrival on bar once every cp.async this thread issued before has
// landed (the barrier counts this thread among its `count` arrivals)
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An mbarrier in shared memory whose phase completes on `count` arrivals
// (by default one: the copying thread's) and the bytes they announced
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// wait until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One thread: arrive on bar, announcing the bytes that complete its phase
// (bulk copies, st.async stores); they may land before or after it
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One thread: arrive on bar, announcing the bytes of the bulk copies that
// complete its phase. The fence first orders the block's earlier accesses
// to shared memory (made visible to this thread by a barrier) before them.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arm(bar, bytes);
}
// bytes (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the TMA engine, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// L2 prefetch of bytes (a multiple of 16) of global memory by the TMA
// engine; nothing lands in shared memory and nothing is waited for
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// ---- thread-block clusters: the block's rank, the cluster's index and
// count (one-dimensional grids), the cluster barrier (every thread of every
// block of the cluster; arrive releases this thread's earlier memory
// accesses, wait acquires the others'), and stores into the shared memory
// of a block of the cluster (DSMEM) at an address map_rank gives
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of p (this block's shared memory) in block rank
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
// 16 (8) bytes into the shared memory of a block of the cluster (addr from
// map_rank), completing bytes on that block's mbarrier at bar (from
// map_rank too): the receiver learns by its mbarrier that the data is in,
// with no barrier or fence on the sending side
__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(unsigned addr, float2 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}
// wait until the phase of this parity has completed, acquiring at cluster
// scope what other blocks' stores released into it
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Each of a warp's N row sums, first over its 32 lanes (every lane ends with
// the sum) and then over the NB blocks of the cluster: lane b < NB stores the
// warp's sums into block b's slot `rank` (slots of `stride` floats at
// `slots`, the warp's rows from `row0`); after a cluster barrier each block
// adds the NB slots in rank order, so every block gets the same bits. Every
// thread of every block of the cluster calls it (the barrier is aligned).
template <int NB, int N>
__device__ __forceinline__ void cluster_row_sums(float (&s)[N], const float* slots, int stride,
                                                 int row0, unsigned rank, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  if (lane < NB) {
    const unsigned a = map_rank(slots + rank * stride + row0, lane);
#pragma unroll
    for (int i = 0; i < N; ++i) st_cluster(a + 4 * i, s[i]);
  }
  cluster_sync();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float sum = slots[row0 + i];
#pragma unroll
    for (int b = 1; b < NB; ++b) sum += slots[b * stride + row0 + i];
    s[i] = sum;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// the transposed forms: a matrix stored by rows of k (n contiguous) as the
// "col" B operand
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// c += a b: m16n8k8, bf16 in, f32 accumulate (a head of 8 channels: A
// (16 x 8, row) a[0] = (row g, k 2t..2t+1), a[1] = (row g+8, same k); B
// b0 = (k 2t..2t+1, col g)). Registers only
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// x split for 3xTF32, as the bits of two floats: hi = tf32(x) rounded to
// nearest, ties away from zero (what cvt.rna.tf32.f32 gives for finite x,
// and how sm_90 computes it: an integer add of half the dropped unit and a
// mask, here without its inf / NaN guard), and lo = x - hi (exact) with its
// 13 low bits cut, which the mma would ignore: x = hi + lo to within 2^-21
// |x|. A NaN x gives a NaN lo, so it still reaches the product.
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  return make_float2(hi, __uint_as_float(__float_as_uint(x - hi) & 0xffffe000u));
}

// c += a b: m16n8k8, TF32 in, f32 accumulate. Registers only
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, a = ahi + alo and b = bhi + blo split by split_tf32:
// the two cross terms first, then hi hi, each product exact (11-bit
// significands) and summed in f32; alo blo (<= 2^-22 |a b|) is dropped, so
// the product keeps ~f32's precision: ~2^-20 relative against TF32's 2^-11
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
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
