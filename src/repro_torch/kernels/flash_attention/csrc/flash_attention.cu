// Flash attention (forward) for Hopper (sm_90a), bound to PyTorch through
// ctypes.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no --use_fast_math: expf is the accurate function.  The C entry point
// launches on the stream it is given, allocates nothing and returns the
// CUDA error of the launch.
//
// flash_attention   replaces src/repro/kernels/flash_attention/kernel.py
//                   :flash_attention (_flash_kernel).
//   o[b,h,i] = softmax_j(q[b,h,i] . k[b,g,j] / sqrt(hd) + mask) v[b,g,j]
//   with g = h / (H/KV) (GQA), queries at absolute positions T-S+i, keys at
//   0..T-1; causal keeps j <= T-S+i, a window w keeps T-S+i - j < w.  The
//   softmax runs online in f32 (running max m, sum l, accumulator acc) with
//   NEG_INF = -2e38 and l floored at 1e-30, as in the TPU kernel; o is
//   written in q's dtype.
//
//   Bound: at the zamba2 serving shape (B 4, H = KV = 32, S = T = 1024, hd
//   80, bf16, causal) the call moves q, k, v and o once, 84 MB (25 us at
//   3.35 TB/s), and does the causal half of QK^T and PV, about 21.5 GFLOP:
//   22 us on bf16 tensor cores, 320 us on the f32 CUDA cores where this
//   kernel runs.  So this first kernel is bound by its f32 arithmetic.
//
//   Design: the Pallas grid (B*H, S/bq, T/bk) ran its kv axis in order on
//   one core and carried m, l and acc in VMEM scratch across it.  Here one
//   block of 256 threads owns one (batch*head, tile of 64 queries) and walks
//   the kv tiles of 64 keys itself, so nothing is carried between blocks.
//   Tiles wholly in the causal future or wholly outside the window are
//   never visited (the Pallas `run` predicate, as a loop range).  q, k and
//   v are converted to f32 in shared memory (rows padded to hd+1 floats,
//   so the lanes of a warp reading different rows hit different banks);
//   every product is an f32 fmaf, no tensor cores, no TF32.  A thread owns
//   a 4 x 4 block of scores (rows ty+16i, keys tx+16j) and a 4 x NC block
//   of the output (columns tx+16c): each shared-memory load feeds two to
//   four FMAs.  Row maxima and sums reduce across the 16 lanes that share a
//   row with shuffles.  Masked scores give p = 0.  Ragged S and T are bounds
//   masks (the TPU wrapper's S % block_q rule is a tiling rule only); any
//   hd up to 256 works, the accumulators sized by NC = ceil(hd/16) rounded
//   up to 2, 4, 5, 8 or 16.  Inputs may be strided on all axes but the
//   last, so the model's (B,S,H,hd) tensors are read without a transpose.
//
//   Shared memory: 4 * (192 * (hd+1) + 64 * 65) bytes: 79 KB at hd 80,
//   214 KB at hd 256 (of the 227 KB a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define BQ 64                 // queries per block
#define BK 64                 // keys per tile
#define NT 256                // threads per block: 16 x 16
#define NEG_INF (-2.0e38f)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

static size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)(BQ + 2 * BK) * (hd + 1) + (size_t)BQ * (BK + 1));
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    T* __restrict__ o, long long o_sb, long long o_sh, long long o_ss,
    int H, int KV, int S, int T_, int hd, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* Qs = smem;                       // BQ x hdp
  float* Ks = Qs + BQ * hdp;              // BK x hdp
  float* Vs = Ks + BK * hdp;              // BK x hdp
  float* Ps = Vs + BK * hdp;              // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int q_rows = min(BQ, S - q0);
  const int pos0 = T_ - S + q0;           // absolute position of row 0

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    Qs[r * hdp + d] = r < q_rows ? to_f(qb[(q0 + r) * q_ss + d]) : 0.0f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // The kv tiles some row of this block may see: the causal future of the
  // last row and keys at or before pos0 - window are skipped.
  const int k_end = causal ? min(T_, pos0 + q_rows) : T_;
  const int k_begin = window > 0 ? max(0, pos0 - window + 1) : 0;

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                      // the last tile's readers are done
    const int k_rows = min(BK, T_ - k0);
    for (int i = tid; i < BK * hd; i += NT) {
      const int r = i / hd, d = i - r * hd;
      const bool in = r < k_rows;
      Ks[r * hdp + d] = in ? to_f(kb[(k0 + r) * k_st + d]) : 0.0f;
      Vs[r * hdp + d] = in ? to_f(vb[(k0 + r) * v_st + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * hdp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * hdp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = pos0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < T_ && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) {
          const float vv = Vs[j * hdp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) put(&ob[(q0 + r) * o_ss + d], acc[i][c] / den);
      }
    }
  }
}

// The arguments of flash_kernel after the pointers' strides.
#define FA_PARAMS                                                          \
  const void *q, long long q_sb, long long q_sh, long long q_ss,           \
      const void *k, long long k_sb, long long k_sh, long long k_st,       \
      const void *v, long long v_sb, long long v_sh, long long v_st,       \
      void *o, long long o_sb, long long o_sh, long long o_ss, int B,      \
      int H, int KV, int S, int T_, int hd, int causal, int window,        \
      float scale, cudaStream_t stream

template <typename T, int NC>
static int launch(FA_PARAMS) {
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, NC><<<grid, NT, smem, stream>>>(
      (const T*)q, q_sb, q_sh, q_ss, (const T*)k, k_sb, k_sh, k_st,
      (const T*)v, v_sb, v_sh, v_st, (T*)o, o_sb, o_sh, o_ss, H, KV, S, T_,
      hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(FA_PARAMS) {
#define FA_CASE(NC)                                                         \
  if (hd <= 16 * NC)                                                        \
    return launch<T, NC>(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_st, v, v_sb, \
                         v_sh, v_st, o, o_sb, o_sh, o_ss, B, H, KV, S, T_,  \
                         hd, causal, window, scale, stream);
  FA_CASE(2)
  FA_CASE(4)
  FA_CASE(5)
  FA_CASE(8)
  FA_CASE(16)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

size_t flash_smem(int hd) { return smem_bytes(hd); }

// q (B,H,S,hd), k/v (B,KV,T,hd), o (B,H,S,hd), each given by its pointer
// and its strides in elements over the first three axes (the last axis is
// contiguous).  window <= 0 means no window.
int flash_forward(int is_bf16, const void* q, long long q_sb, long long q_sh,
                  long long q_ss, const void* k, long long k_sb,
                  long long k_sh, long long k_st, const void* v,
                  long long v_sb, long long v_sh, long long v_st, void* o,
                  long long o_sb, long long o_sh, long long o_ss, int B,
                  int H, int KV, int S, int T_, int hd, int causal,
                  int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_st,
                                   v, v_sb, v_sh, v_st, o, o_sb, o_sh, o_ss,
                                   B, H, KV, S, T_, hd, causal, window,
                                   scale, st);
  return dispatch<float>(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_st, v, v_sb,
                         v_sh, v_st, o, o_sb, o_sh, o_ss, B, H, KV, S, T_,
                         hd, causal, window, scale, st);
}

}  // extern "C"
