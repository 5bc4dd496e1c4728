// PTX helpers shared by K3's tensor-core kernels (attention_tc.cu,
// attention_bwd_tc.cu, attention_tf32.cu, attention_bwd_tf32.cu), for
// sm_90a: cp.async copies into shared memory that zero-fill what lies past
// a ragged end, ldmatrix, the bf16 mma.sync.m16n8k16 and the tf32
// mma.sync.m16n8k8 with f32 accumulation, and the split of an f32 operand
// into tf32 hi and lo for 3xTF32.
//
// Head dimensions off the mma's k-step (D % 16 != 0, D % 4 == 0): the
// kernels give each row D16 = D rounded up to 16 columns in shared memory,
// and the copies zero-fill the columns past D, so a k-step that reaches past
// D adds exact zeros. At D % 8 != 0 a bf16 row's pitch is not 16-byte
// aligned, so those copies go 8 bytes at a time (kNarrow).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace tc {

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// D rounded up to the mma's k-step
__host__ __device__ __forceinline__ int round16(int64_t d) { return int((d + 15) / 16 * 16); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
// 8 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The eight bf16 columns [col, col + 8) of one row (src points at column
// col) into shared memory at dst: what lies past D, or the whole group when
// !row_ok, is zero-filled. `base` is any valid address of the tensor, read
// by no copy (src-size 0). col is a multiple of 8 and D of 4, so each half
// of the group lies wholly before D or wholly past it.
template <bool kNarrow>
__device__ __forceinline__ void cp_cols8(uint32_t dst, const __nv_bfloat16* src,
                                         const __nv_bfloat16* base, int col, int D,
                                         bool row_ok) {
  if constexpr (kNarrow) {
    const bool a = row_ok && col < D, b = row_ok && col + 4 < D;
    cp_async8(dst, a ? src : base, a);
    cp_async8(dst + 8, b ? src + 4 : base, b);
  } else {
    const bool a = row_ok && col < D;
    cp_async16(dst, a ? src : base, a);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b, one m16n8k16 tile: bf16 operands, f32 accumulator. Fragment
// coordinates (PTX ISA, mma.m16n8k16): lane = 4 gq + tq; an f32 accumulator
// holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive f32 values in shared memory, one 8-byte load
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo (+ what lo drops), hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
// hi), in two integer operations for each: rounding to nearest with ties
// away from zero is half a tf32 ulp added to the magnitude, then the 13 low
// bits dropped. hi's are cleared, for x - hi; lo's are left, as the tensor
// cores read only a tf32 operand's 19 high bits. (cvt.rna.tf32.f32 itself
// compiles to a compare and a select besides, for NaN and inf; here as
// there an inf or NaN x gives an inf or NaN hi and a NaN lo.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a . b, one m16n8k8 tile: tf32 operands, f32 accumulator. Fragment
// coordinates (PTX ISA, mma.m16n8k8 .tf32): lane = 4 gq + tq; a0 (row gq,
// k tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4); b0 (k tq,
// n gq), b1 (tq + 4, gq); c holds rows gq and gq + 8, columns 2 tq, 2 tq + 1.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
