// Fused RMSNorm for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no --use_fast_math.  The C entry point launches on the stream it is
// given, allocates nothing and returns the CUDA error of the launch.
//
// Registers a thread (ptxas -v, sm_90a, CUDA 12.8), no spills: the one-slot
// instances 30-32, the NV_MAX instances 45-64 (bf16 16-byte slots 64, the
// cap of their launch bounds), the two-pass instances 32.
//
// rmsnorm   replaces src/repro/kernels/rmsnorm/kernel.py:rmsnorm
//           (_rmsnorm_kernel).
//   y = x * rsqrt(sum(x^2) / d + eps) * scale per row of d values, the sum
//   in f32, y in x's dtype (f32 or bf16), scale f32.
//
//   Bound: device memory.  A row is read and written once (R*d*(2 or 4)
//   bytes each way, plus d*4 of scale); the work is three flops a value.
//   At the zamba2 serving shapes (4096 x 2560 and 4096 x 5120 bf16) that
//   is 42 and 84 MB, 12.5 and 25 us at 3.35 TB/s; at decode (4 rows) a few
//   tens of KB, so a call is as long as one trip to device memory and back.
//
//   Design: the TPU kernel normalised blocks of 256 rows in VMEM, with d
//   padded to the 128-lane tile and a masked mean.  Here a group of tpr
//   threads (a multiple of 32) owns a row and reads exactly its d values,
//   so any d works and nothing is padded.  Each thread loads its slots of
//   the row -- vectors j, j + tpr, ... of 16 bytes (8 bf16 or 4 f32) where
//   d, the row stride and the pointers allow it, else single values -- all
//   at once into registers, sums their squares in f32, and the group
//   reduces with a butterfly of shuffles in each warp and then, in order,
//   across its warps through shared memory, behind a barrier of the row's
//   own warps (a block's rows do not wait for each other).  The row stays
//   in registers for the write, so x is read once; scale is read in
//   16-byte loads, and y goes out in 16-byte streaming stores (evict
//   first), so the output does not push rows of x, or of the residual
//   stream it came from, out of L2.  The host picks the group from (R, d, dtype), nothing
//   at run time.  With few rows (R <= SMALL_ROWS, decode's 4) a block of
//   one vector a thread owns a row, so the rows spread over as many SMs and
//   every load of a row is in flight at once.  With many rows a group of
//   the fewest threads that hold the row in NV_MAX vectors each takes it,
//   a block of 256 threads several rows, four blocks an SM (prefill's
//   2560-wide rows: 64 threads a row, 16 rows an SM in flight).  Rows
//   longer than NV_MAX * 256 vectors (above 10240 bf16 or 5120 f32 values)
//   take a warp a row in two passes, the second reading the row again.
//   Rows may be strided (the last position of a batch of sequences); the
//   output is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_THREADS 1024
#define NV_MAX 5            // vectors a thread holds in the many-row instance
#define SMALL_ROWS 128      // at most this many rows: a block a row
#define GROUP_BLOCK 256     // threads a block of the many-row instance
#define LOOP_WARPS 8        // rows a block of the two-pass instance

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sc = scale[VEC c .. VEC c + VEC), in 16-byte loads where VEC > 1.
template <int VEC>
__device__ __forceinline__ void load_scale(float (&sc)[VEC],
                                           const float* __restrict__ scale,
                                           int c) {
  if constexpr (VEC == 1) {
    sc[0] = __ldg(scale + c);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 s4 =
          __ldg(reinterpret_cast<const float4*>(scale + c * VEC + k));
      sc[k] = s4.x;
      sc[k + 1] = s4.y;
      sc[k + 2] = s4.z;
      sc[k + 3] = s4.w;
    }
  }
}

// Wait for the `threads` threads (a multiple of 32) of named barrier id.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// VEC values of type T a slot (VEC * sizeof(T) is 16 bytes, or VEC is 1),
// up to NV slots a thread, tpr threads a row, blockDim.x / tpr rows a block:
// one slot in blocks of up to 1024 threads, NV_MAX slots in blocks of up to
// GROUP_BLOCK threads, four blocks an SM (64 registers a thread hold them
// all without spilling).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(NV == 1 ? MAX_THREADS : GROUP_BLOCK,
                                  NV == 1 ? 1 : 4)
    rmsnorm_kernel(
    const T* __restrict__ x, long long x_rs, const float* __restrict__ scale,
    T* __restrict__ y, int R, int d, float eps, int tpr) {
  __shared__ float red[MAX_THREADS / 32];
  const int tid = threadIdx.x;
  const int rl = tid / tpr, j = tid - rl * tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + rl;
  const bool live = row < R;
  const int nv = d / VEC;
  const T* xr = x + row * x_rs;

  alignas(16) T v[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = j + i * tpr;
    if (live && c < nv) {
      if constexpr (VEC == 1) {
        v[i][0] = xr[c];
      } else {
        *reinterpret_cast<uint4*>(v[i]) =
            *reinterpret_cast<const uint4*>(xr + (long long)c * VEC);
      }
    }
  }
  // One slot a thread: its scale is fetched while the sum is reduced.
  float sc[VEC];
  if constexpr (NV == 1) {
    if (live && j < nv) load_scale<VEC>(sc, scale, j);
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live && j + i * tpr < nv) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f(v[i][k]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {  // the row's warps, in order, behind the row's own barrier
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    bar_sync(1 + rl, tpr);
    const int w0 = rl * (tpr >> 5);
    ss = 0.0f;
    for (int w = 0; w < (tpr >> 5); ++w) ss += red[w0 + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);

  T* yr = y + row * (long long)d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = j + i * tpr;
    if (c < nv) {
      alignas(16) T o[VEC];
      if constexpr (NV > 1) load_scale<VEC>(sc, scale, c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) from_f(&o[k], to_f(v[i][k]) * r * sc[k]);
      if constexpr (VEC == 1) {
        yr[c] = o[0];
      } else {  // evict-first: y does not push x's rows out of L2
        __stcs(reinterpret_cast<uint4*>(yr + (long long)c * VEC),
               *reinterpret_cast<const uint4*>(o));
      }
    }
  }
}

// Rows too long to hold in registers: a warp a row, LOOP_WARPS rows a
// block; a first pass sums the squares, a second reads the row again (from
// L2) and writes the result.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * LOOP_WARPS) rmsnorm_loop_kernel(
    const T* __restrict__ x, long long x_rs, const float* __restrict__ scale,
    T* __restrict__ y, int R, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LOOP_WARPS + (threadIdx.x >> 5);
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
    for (int k = 0; k < VEC; ++k) {
      const float f = to_f(v[k]);
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
    for (int k = 0; k < VEC; ++k)
      from_f(&o[k], to_f(v[k]) * r * scale[i * VEC + k]);
    if constexpr (VEC == 1) {
      yr[i] = o[0];
    } else {
      *reinterpret_cast<uint4*>(yr + (long long)i * VEC) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

// The launch for R rows of nv slots of VEC values: returns the instance
// (0: a block a row, one slot a thread; 1: groups of up to NV_MAX slots a
// thread; 2: two passes) and sets threads a row, threads a block, blocks.
static int plan(int R, int nv, int* tpr, int* threads, int* blocks) {
  const int up32 = (nv + 31) / 32 * 32;
  if (R <= SMALL_ROWS && nv <= MAX_THREADS) {
    *tpr = *threads = up32;
    *blocks = R;
    return 0;
  }
  if (nv > NV_MAX * GROUP_BLOCK) {
    *tpr = 32;
    *threads = 32 * LOOP_WARPS;
    *blocks = (R + LOOP_WARPS - 1) / LOOP_WARPS;
    return 2;
  }
  int t = 32;  // the fewest threads, a power of two, that hold the row
  while (t * NV_MAX < nv) t *= 2;
  if (R <= SMALL_ROWS) t = GROUP_BLOCK;  // few long rows: a block a row
  *tpr = t;
  // several rows a block where the batch still gives every SM two blocks
  int rpb = t >= GROUP_BLOCK ? 1 : GROUP_BLOCK / t;
  while (rpb > 1 && (R + rpb - 1) / rpb < 264) rpb /= 2;
  *threads = rpb * t;
  *blocks = (R + rpb - 1) / rpb;
  return 1;
}

template <typename T, int VEC>
static int launch_vec(const T* x, long long x_rs, const float* scale, T* y,
                      int R, int d, float eps, cudaStream_t stream) {
  int tpr, threads, blocks;
  switch (plan(R, d / VEC, &tpr, &threads, &blocks)) {
    case 0:
      rmsnorm_kernel<T, VEC, 1><<<blocks, threads, 0, stream>>>(
          x, x_rs, scale, y, R, d, eps, tpr);
      break;
    case 1:
      rmsnorm_kernel<T, VEC, NV_MAX><<<blocks, threads, 0, stream>>>(
          x, x_rs, scale, y, R, d, eps, tpr);
      break;
    default:
      rmsnorm_loop_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
          x, x_rs, scale, y, R, d, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, long long x_rs, const void* scale, void* y,
                  int R, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && x_rs % VEC == 0 &&
                   ((uintptr_t)x | (uintptr_t)y | (uintptr_t)scale) % 16 == 0;
  if (vec)
    return launch_vec<T, VEC>((const T*)x, x_rs, (const float*)scale, (T*)y,
                              R, d, eps, stream);
  return launch_vec<T, 1>((const T*)x, x_rs, (const float*)scale, (T*)y, R,
                          d, eps, stream);
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
