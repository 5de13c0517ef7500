// Building blocks shared by the port's Hopper (sm_90a) GEMM-shaped kernels
// (csrc/int8_matmul.cu, csrc/conv2d_same_bwdw.cu, and the recurrent
// backward kernels): asynchronous 16-byte copies into shared memory with
// zero-fill, ldmatrix fragment loads, and the bfloat16 tensor-core product
// mma.sync.m16n8k16 with float32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 * group + t:
//   A (16 x 16, row major): a[0] = A[group][2t..2t+1], a[1] = A[group+8][..],
//                           a[2] = A[group][2t+8..2t+9], a[3] = A[group+8][..]
//   B (16 x 8, k major):    b[0] = B[2t..2t+1][group], b[1] = B[2t+8..2t+9][group]
//   D (16 x 8, float32):    d[0..1] = D[group][2t..2t+1], d[2..3] = D[group+8][..]
// ldmatrix.x4 fills these from shared memory: four 8 x 8 tiles of 16-bit
// values, tile i addressed by lanes 8i .. 8i+7 (one 16-byte row each);
// with .trans each lane receives a column pair instead of a row pair, which
// is how a tile stored k-major (the reduction index over rows) becomes an
// A or B fragment.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory, asynchronously. Only the
// first ``bytes`` (0..16) are read; the rest of the 16 are zero-filled, so
// bytes = 0 writes zeros and reads nothing (``src`` must still be a valid
// address). Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a . b for one 16 x 8 x 16 tile: bfloat16 products (exact in
// float32), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values that hold bfloat16 numbers, as one packed bfloat16
// pair (exact)
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows 0-7 of four accumulator tiles d[nt] (16 x 8 each, mma_bf16's D),
// those below ``rows`` only, to out[row * pitch + nt * 8 + column]
__device__ __forceinline__ void store_d_rows(const float (&d)[4][4],
                                             float* out, int pitch, int rows,
                                             int lane) {
  const int g = lane / 4;
  if (g < rows) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = out + g * pitch + nt * 8 + 2 * (lane % 4);
      p[0] = d[nt][0];
      p[1] = d[nt][1];
    }
  }
}

}  // namespace sm90
