// Tensor-core and async-copy helpers shared by the bf16 kernels
// (flash_attention.cu, ssd_scan.cu): 16-byte cp.async with zero-fill,
// ldmatrix fragments and mma.sync m16n8k16 bf16 -> f32.
//
// Fragment layouts are those of the PTX ISA for mma.m16n8k16 with .bf16
// operands: A is 16 x 16 row-major (four 8 x 8 matrices: rows 0-7 / 8-15 by
// k 0-7 / 8-15), B is 16 x 8 column-major (k 0-7 and 8-15), C/D is 16 x 8
// f32 with thread t holding rows t / 4 and t / 4 + 8, columns 2 (t % 4) and
// 2 (t % 4) + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the
// 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Per-lane element offsets (in bf16, for a tile with rows `stride` apart)
// of the ldmatrix row addresses of one 16 x 16 operand block:
// A of a row-major [m][k] tile, non-trans (rows = m)
__device__ __forceinline__ int a_lane(int lane, int stride) {
  return (lane % 16) * stride + (lane / 16) * 8;
}
// B of a tile stored [n][k] (k contiguous), non-trans: matrices (n 0-7, k
// 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), so registers
// 0/1 feed n-tile 0 and 2/3 n-tile 1
__device__ __forceinline__ int b_lane_nk(int lane, int stride) {
  return (lane % 8 + (lane / 16) * 8) * stride + ((lane / 8) % 2) * 8;
}
// B of a tile stored [k][n] (n contiguous), .trans: the same register order
__device__ __forceinline__ int b_lane_kn(int lane, int stride) {
  return (lane % 8 + ((lane / 8) % 2) * 8) * stride + (lane / 16) * 8;
}
// A of a tile stored [k][m] (m contiguous), .trans: matrices (m 0-7, k 0-7),
// (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
__device__ __forceinline__ int a_lane_km(int lane, int stride) {
  return (lane % 8 + (lane / 16) * 8) * stride + ((lane / 8) % 2) * 8;
}

}  // namespace sm90
