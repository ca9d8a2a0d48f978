// Tensor-core building blocks of the hand-written kernels
// (flash_attention.cu, rmsnorm_swiglu.cu): warp-level mma.sync products,
// ldmatrix, cp.async, and the 3xTF32 split that keeps float32 products
// within float32's tolerance on the TF32 tensor cores.
//
// Fragments, lane = 4 g + t (g = lane / 4, t = lane % 4), as PTX defines
// them for mma.sync (row-major A, column-major B, float32 C):
//
// * C (16 x 8): c[0], c[1] at row g, columns 2t and 2t + 1; c[2], c[3] at
//   row g + 8, the same columns.
// * bfloat16 m16n8k16: A (16 x 16) a[0] = row g, columns 2t, 2t + 1 (one
//   32-bit pair); a[1] = row g + 8; a[2] = row g, columns 2t + 8, 2t + 9;
//   a[3] = row g + 8, columns 2t + 8, 2t + 9.  B (16 x 8) b[0] = rows 2t,
//   2t + 1 of column g; b[1] = rows 2t + 8, 2t + 9.
// * TF32 m16n8k8: A (16 x 8) a[0] = (g, t), a[1] = (g + 8, t), a[2] =
//   (g, t + 4), a[3] = (g + 8, t + 4).  B (8 x 8) b[0] = (t, g), b[1] =
//   (t + 4, g).
//
// 3xTF32: a float32 x is hi + lo with hi = tf32(x), rounded to nearest
// (ties away) on a 10-bit mantissa through the integer view, and lo = x -
// hi (exact in float32), which the tensor cores cut to TF32; a * b = ah bh
// + ah bl + al bh, dropping al bl (2^-22 relative), accumulated in float32.  One pass of TF32 keeps about three
// decimal digits, which misses the kernels' 2e-4 tolerance at their
// contraction lengths.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory; zeros where !in (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero),
// as the bits of a float32
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// lo goes to the tensor cores as it is: they take a TF32 operand's top 19
// bits, so lo is cut to TF32 there (2^-21 of x at most) at no cost here
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32 (the small products first)
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// float32 A fragment (a[0..3] in the TF32 layout) split into hi and lo
__device__ __forceinline__ void split4(const float* a, uint32_t* hi,
                                       uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// Four 8 x 8 matrices of 16-bit elements; lane l gives the address of row
// l % 8 of matrix l / 8.  Without .trans lane 4g + t receives (g, 2t..2t+1)
// of each matrix; with .trans (2t..2t+1, g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace mma
