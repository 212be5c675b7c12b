// Fused RMSNorm for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no --use_fast_math.  The C entry point launches on the stream it is
// given, allocates nothing and returns the CUDA error of the launch.
//
// rmsnorm   replaces src/repro/kernels/rmsnorm/kernel.py:rmsnorm
//           (_rmsnorm_kernel).
//   y = x * rsqrt(sum(x^2) / d + eps) * scale per row of d values, the sum
//   in f32, y in x's dtype (f32 or bf16), scale f32.
//
//   Bound: device memory.  A row is read and written once (R*d*(2 or 4)
//   bytes each way, plus d*4 of scale); the work is three flops a value.
//   At the zamba2 serving shapes (4096 x 2560 and 4096 x 5120 bf16) that
//   is 42 and 84 MB, 12.5 and 25 us at 3.35 TB/s.
//
//   Design: the TPU kernel normalised blocks of 256 rows in VMEM, with d
//   padded to the 128-lane tile and a masked mean.  Here one warp owns one
//   row and reads exactly its d values, so any d works and nothing is
//   padded: a first pass sums the squares in f32 (a butterfly of shuffles
//   across the warp), a second pass reads the row again -- from L1/L2, the
//   row is at most a few tens of KB -- and writes the result.  Where d, the
//   row stride and the pointers allow it, each lane moves 16 bytes at a
//   time (8 bf16 or 4 f32 values); otherwise one value at a time.  Rows may
//   be strided (the last position of a batch of sequences); the output is
//   contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8                    // rows per block of 256 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// VEC values of type T per lane and step; VEC * sizeof(T) is 16 bytes, or
// VEC is 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * WARPS) rmsnorm_kernel(
    const T* __restrict__ x, long long x_rs, const float* __restrict__ scale,
    T* __restrict__ y, int R, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * x_rs;
  T* yr = y + row * (long long)d;
  const int nv = d / VEC;

  float ss = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    alignas(16) T v[VEC];
    if constexpr (VEC == 1) {
      v[0] = xr[i];
    } else {
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(xr + (long long)i * VEC);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f(v[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < nv; i += 32) {
    alignas(16) T v[VEC];
    if constexpr (VEC == 1) {
      v[0] = xr[i];
    } else {
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(xr + (long long)i * VEC);
    }
    alignas(16) T o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      from_f(&o[j], to_f(v[j]) * r * scale[i * VEC + j]);
    if constexpr (VEC == 1) {
      yr[i] = o[0];
    } else {
      *reinterpret_cast<uint4*>(yr + (long long)i * VEC) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

template <typename T>
static int launch(const void* x, long long x_rs, const void* scale, void* y,
                  int R, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && x_rs % VEC == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int blocks = (R + WARPS - 1) / WARPS;
  if (vec) {
    rmsnorm_kernel<T, VEC><<<blocks, 32 * WARPS, 0, stream>>>(
        (const T*)x, x_rs, (const float*)scale, (T*)y, R, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<blocks, 32 * WARPS, 0, stream>>>(
        (const T*)x, x_rs, (const float*)scale, (T*)y, R, d, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// x (R rows of d, row stride x_rs elements, contiguous within a row),
// scale (d,) f32, y (R, d) contiguous in x's dtype.
int rmsnorm_forward(int is_bf16, const void* x, long long x_rs,
                    const void* scale, void* y, int R, int d, float eps,
                    void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(x, x_rs, scale, y, R, d, eps,
                                 (cudaStream_t)stream);
  return launch<float>(x, x_rs, scale, y, R, d, eps, (cudaStream_t)stream);
}

}  // extern "C"
