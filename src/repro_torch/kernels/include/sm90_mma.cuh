// Warp-level bf16 tensor-core helpers shared by the flash-attention and SSD
// kernels: ldmatrix, mma.sync m16n8k16 (bf16 in, f32 accumulate), cp.async
// with zero fill, a fast 2^x, and the hi/lo split of an f32 value into two
// bf16 values.
//
// Fragment layout of mma.sync.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A (16 x 16, row-major)  a0 (gid, 2tig..+1)   a1 (gid+8, 2tig..+1)
//                           a2 (gid, 8+2tig..+1) a3 (gid+8, 8+2tig..+1)
//   B (16 x 8, k x n)       b0 (k 2tig..+1, n gid) b1 (k 8+2tig..+1, n gid)
//   C (16 x 8, f32)         c0 c1 (gid, 2tig..+1)  c2 c3 (gid+8, 2tig..+1)
// A pair of bf16 values in a 32-bit register holds the lower column index
// in its low half.  A matrix stored [m][k] gives A fragments by ldmatrix;
// stored [k][m], by ldmatrix.trans.  A B operand stored [n][k] gives B
// fragments by ldmatrix; stored [k][n], by ldmatrix.trans.
//
// Built into each kernel's library by kernels/_build.py, which passes this
// directory with -I and hashes it with the source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register r receives matrix r.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: bf16 products, exact in f32, summed in f32.
// Registers only (not volatile), so the compiler may schedule it freely.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the special-function unit (ex2.approx: about 2^-22 relative; flush
// to zero below 2^-126, where every use here is negligible against 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// x = hi + lo to about 2^-17 relative: hi = bf16(x), lo = bf16(x - hi).
// A product of an exact bf16 operand with x then costs two tensor-core
// products and keeps nearly f32 precision.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Rows [r0, r0 + ROWS) of a matrix of T (bf16 or f32) with row stride `st`
// (elements) into shared memory with row stride STR, COLS columns (16 bytes'
// worth a multiple of): entries at rows >= `rows` or columns >= `cols` are
// zero.  With `vec` (the base, the stride and `cols` allow 16-byte copies)
// by cp.async, which the caller commits and waits for; otherwise by plain
// loads and stores.
template <int ROWS, int COLS, int STR, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int r0, int rows, int cols,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T), CH = COLS / PER;
    for (int e = tid; e < ROWS * CH; e += NT) {
      const int r = e / CH, d = (e - r * CH) * PER;
      const bool in = r0 + r < rows && d < cols;
      cp_async16(dst + r * STR + d,
                 in ? src + (long long)(r0 + r) * st + d : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, d = e - r * COLS;
      dst[r * STR + d] = (r0 + r < rows && d < cols)
                             ? src[(long long)(r0 + r) * st + d]
                             : zero_value<T>();
    }
  }
}
