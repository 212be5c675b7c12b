// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to PyTorch through
// ctypes.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no --use_fast_math: expf is the accurate function.  The C entry point
// launches on the stream it is given, allocates nothing and returns the
// CUDA error of the launch.
//
// ssd   replaces src/repro/kernels/ssd_scan/kernel.py:ssd (_ssd_kernel).
//   Per batch row, chunk by chunk, with cum the in-chunk cumulative sum of
//   da:
//     y_i   = sum_{j<=i} (C_i.B_j) e^{cum_i-cum_j} xw_j + e^{cum_i} C_i.state
//     state <- state e^{cum_end} + sum_j e^{cum_end-cum_j} B_j (x) xw_j
//   y is written in xw's dtype, the final state in f32.
//
//   Bound: operations.  At the serving shape (B=4, S=1024, 24 heads of
//   64, ds=128, chunk 256) the call moves about 34 MB (10 us at 3.35 TB/s)
//   and the chunked algorithm does some 5-13 GFLOP, depending on what is
//   counted (chip_smoke.py computes both); in f32 on the CUDA cores, where
//   this kernel runs, that is 70-190 us.
//
//   Design: the TPU kernel walked a batch row's chunks in grid order with
//   all heads' state resident in VMEM.  Heads are independent here (da is
//   per head; B and C are shared), so one block owns one (batch row, head)
//   and loops over the chunks itself; nothing is carried between blocks,
//   there are no atomics and the result is deterministic.  The head's
//   (hd, ds) state stays in shared memory for the whole sequence.  A chunk
//   is cut into tiles of 64 rows; for each tile of outputs i only the tiles
//   j <= i are visited (the causal half), and inside the diagonal tile the
//   pairs j > i are skipped before the exponent is formed, which is the TPU
//   kernel's mask-inside-the-exponent: e^{positive} never appears.  Tiles
//   of B, C and xw are converted to f32 in shared memory (bf16 or f32 in
//   device memory), every product accumulates in f32 with fmaf, and rows
//   are padded to ds+1 floats so that the 32 lanes of a warp reading 32
//   rows hit 32 banks.  Ragged edges (a chunk that is not a multiple of 64,
//   e.g. a single 13-token chunk) are masked in the kernel.  Inputs may be
//   strided on every axis but the last (B and C are column slices of the
//   conv output); the wrapper passes the strides.
//
//   Shared memory: 4 * (hd*(ds+1) + 2*64*(ds+1) + 64*hd + 64*64 + chunk)
//   bytes, 132 KB at the serving shape, set with cudaFuncSetAttribute.  The
//   wrapper takes hd <= 128, ds <= 128 (hd*ds <= 16384) and chunk <= 2048,
//   at most 189,440 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define NT 256                          // threads per block
#define TILE 64                         // rows of a chunk tile
#define MAX_HD 128
#define YPT (TILE * MAX_HD / NT)        // y accumulators per thread, at most

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

static size_t smem_bytes(int hd, int ds, int chunk) {
  size_t dsp = (size_t)ds + 1;
  return sizeof(float) * ((size_t)hd * dsp + 2 * (size_t)TILE * dsp +
                          (size_t)TILE * hd + (size_t)TILE * TILE + chunk);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const TX* __restrict__ xw, long long xw_sb, long long xw_ss,
    long long xw_sh, const float* __restrict__ da, long long da_sb,
    long long da_ss, const TB* __restrict__ bm, long long b_sb,
    long long b_ss, const TB* __restrict__ cm, long long c_sb,
    long long c_ss, const float* __restrict__ s0, TX* __restrict__ y,
    float* __restrict__ fin, int S, int nh, int hd, int ds, int chunk) {
  extern __shared__ float smem[];
  const int dsp = ds + 1;
  float* st_s = smem;                   // (hd, dsp)   carried state
  float* c_s = st_s + hd * dsp;         // (TILE, dsp) C rows of the i tile
  float* b_s = c_s + TILE * dsp;        // (TILE, dsp) B rows of the j tile
  float* x_s = b_s + TILE * dsp;        // (TILE, hd)  xw rows of the j tile
  float* w_s = x_s + TILE * hd;         // (TILE, TILE) decayed scores
  float* cum = w_s + TILE * TILE;       // (chunk)     in-chunk cumsum of da

  const int tid = threadIdx.x;
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int nstate = hd * ds;
  const size_t sbase = ((size_t)b * nh + h) * nstate;
  const TX* xw_b = xw + b * xw_sb + h * xw_sh;
  const float* da_b = da + b * da_sb + h;
  const TB* bm_b = bm + b * b_sb;
  const TB* cm_b = cm + b * c_sb;
  TX* y_b = y + ((size_t)b * S * nh + h) * hd;
  const long long y_ss = (long long)nh * hd;

  for (int e = tid; e < nstate; e += NT)
    st_s[(e / ds) * dsp + e % ds] = s0 ? s0[sbase + e] : 0.f;

  const int nyo = TILE * hd;            // outputs of one i tile
  for (int c = 0; c < S / chunk; ++c) {
    const long long t0 = (long long)c * chunk;
    __syncthreads();
    // inclusive cumsum of the chunk's da, 32 steps at a time by warp 0
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + tid;
        float v = i < chunk ? da_b[(t0 + i) * da_ss] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (i < chunk) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < chunk; i0 += TILE) {
      const int ti = min(TILE, chunk - i0);
      for (int e = tid; e < TILE * ds; e += NT) {
        const int i = e / ds, s = e % ds;
        c_s[i * dsp + s] = i < ti ? ld(cm_b + (t0 + i0 + i) * c_ss + s) : 0.f;
      }
      __syncthreads();

      // inter-chunk part: e^{cum_i} C_i . state_p
      float acc[YPT];
#pragma unroll
      for (int k = 0; k < YPT; ++k) {
        acc[k] = 0.f;
        const int e = tid + k * NT;
        if (e < nyo) {
          const int i = e / hd, p = e % hd;
          if (i < ti) {
            float dot = 0.f;
            for (int s = 0; s < ds; ++s)
              dot = fmaf(c_s[i * dsp + s], st_s[p * dsp + s], dot);
            acc[k] = expf(cum[i0 + i]) * dot;
          }
        }
      }

      // intra-chunk part: the j tiles up to and including the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int tj = min(TILE, chunk - j0);
        __syncthreads();
        for (int e = tid; e < TILE * ds; e += NT) {
          const int j = e / ds, s = e % ds;
          b_s[j * dsp + s] = j < tj ? ld(bm_b + (t0 + j0 + j) * b_ss + s) : 0.f;
        }
        for (int e = tid; e < TILE * hd; e += NT) {
          const int j = e / hd, p = e % hd;
          x_s[e] = j < tj ? ld(xw_b + (t0 + j0 + j) * xw_ss + p) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < TILE * TILE; e += NT) {
          const int i = e / TILE, j = e % TILE;
          float w = 0.f;
          if (i < ti && j < tj && j0 + j <= i0 + i) {
            float dot = 0.f;
            for (int s = 0; s < ds; ++s)
              dot = fmaf(c_s[i * dsp + s], b_s[j * dsp + s], dot);
            w = dot * expf(cum[i0 + i] - cum[j0 + j]);
          }
          w_s[e] = w;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < YPT; ++k) {
          const int e = tid + k * NT;
          if (e < nyo) {
            const int i = e / hd, p = e % hd;
            float sum = 0.f;
            for (int j = 0; j < tj; ++j)
              sum = fmaf(w_s[i * TILE + j], x_s[j * hd + p], sum);
            acc[k] += sum;
          }
        }
      }

#pragma unroll
      for (int k = 0; k < YPT; ++k) {
        const int e = tid + k * NT;
        if (e < nyo) {
          const int i = e / hd, p = e % hd;
          if (i < ti) put(y_b + (t0 + i0 + i) * y_ss + p, acc[k]);
        }
      }
      __syncthreads();
    }

    // carried state: decay over the whole chunk, then add the chunk's
    // contribution.  Each thread updates the same state entries throughout.
    const float cend = cum[chunk - 1];
    const float decay = expf(cend);
    for (int e = tid; e < nstate; e += NT) st_s[(e / ds) * dsp + e % ds] *= decay;
    for (int j0 = 0; j0 < chunk; j0 += TILE) {
      const int tj = min(TILE, chunk - j0);
      __syncthreads();
      for (int e = tid; e < TILE * ds; e += NT) {
        const int j = e / ds, s = e % ds;
        b_s[j * dsp + s] = j < tj ? ld(bm_b + (t0 + j0 + j) * b_ss + s) : 0.f;
      }
      for (int e = tid; e < TILE * hd; e += NT) {
        const int j = e / hd, p = e % hd;
        x_s[e] = j < tj ? ld(xw_b + (t0 + j0 + j) * xw_ss + p) *
                              expf(cend - cum[j0 + j])
                        : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < nstate; e += NT) {
        const int p = e / ds, s = e % ds;
        float sum = 0.f;
        for (int j = 0; j < tj; ++j)
          sum = fmaf(x_s[j * hd + p], b_s[j * dsp + s], sum);
        st_s[p * dsp + s] += sum;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nstate; e += NT)
    fin[sbase + e] = st_s[(e / ds) * dsp + e % ds];
}

template <typename TX, typename TB>
static int launch(const void* xw, long long xw_sb, long long xw_ss,
                  long long xw_sh, const void* da, long long da_sb,
                  long long da_ss, const void* bm, long long b_sb,
                  long long b_ss, const void* cm, long long c_sb,
                  long long c_ss, const void* s0, void* y, void* fin, int B,
                  int S, int nh, int hd, int ds, int chunk,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, ds, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<TX, TB><<<B * nh, NT, smem, stream>>>(
      (const TX*)xw, xw_sb, xw_ss, xw_sh, (const float*)da, da_sb, da_ss,
      (const TB*)bm, b_sb, b_ss, (const TB*)cm, c_sb, c_ss,
      (const float*)s0, (TX*)y, (float*)fin, S, nh, hd, ds, chunk);
  return (int)cudaGetLastError();
}

extern "C" {

size_t ssd_smem(int hd, int ds, int chunk) {
  return smem_bytes(hd, ds, chunk);
}

// x_bf16 / bc_bf16: 1 when xw (and y) / B and C are bf16, 0 when f32.
// Strides are in elements; the last axis of xw, da, B and C is contiguous.
int ssd_forward(int x_bf16, int bc_bf16, const void* xw, long long xw_sb,
                long long xw_ss, long long xw_sh, const void* da,
                long long da_sb, long long da_ss, const void* bm,
                long long b_sb, long long b_ss, const void* cm,
                long long c_sb, long long c_ss, const void* s0, void* y,
                void* fin, int B, int S, int nh, int hd, int ds, int chunk,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SSD_ARGS                                                          \
  xw, xw_sb, xw_ss, xw_sh, da, da_sb, da_ss, bm, b_sb, b_ss, cm, c_sb,   \
      c_ss, s0, y, fin, B, S, nh, hd, ds, chunk, st
  if (x_bf16 && bc_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(SSD_ARGS);
  if (x_bf16) return launch<__nv_bfloat16, float>(SSD_ARGS);
  if (bc_bf16) return launch<float, __nv_bfloat16>(SSD_ARGS);
  return launch<float, float>(SSD_ARGS);
#undef SSD_ARGS
}

}  // extern "C"
