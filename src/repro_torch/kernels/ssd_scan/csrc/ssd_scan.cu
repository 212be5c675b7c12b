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
//   Bound: at zamba2's serving shape (B=4, S=1024, 80 heads of 64, ds=64,
//   chunk 256, bf16 xw, B and C) a call must move about 97 MB (29 us at
//   3.35 TB/s: xw in, y out, the f32 initial and final states) and do at
//   least 10.8 GFLOP (the causal half of the chunk x chunk products, C.B
//   once per batch row and chunk): 11 us on bf16 tensor cores.  So it is
//   bound by bytes.  At mamba2's (24 heads of 64, ds 128) about 34 MB, 10
//   us.  chip_smoke.py computes both from the inputs.
//
//   Two instances, chosen by dtype:
//
//   The tensor-core instance (xw, B and C bf16; the serving path).  The TPU
//   kernel walked a batch row's chunks in grid order, all heads' state
//   resident in VMEM.  Here the sequential chunk axis becomes parallel, as
//   in the chunked decomposition of Mamba2 (Dao & Gu, "Transformers are
//   SSMs", 2024, sections 6-7): C.B, chunk states, state passing, chunk
//   outputs.  Two launches, which together are the SSD kernel, compute its
//   four steps:
//     1. ssd_tc_states  chunk states and state passing, per (batch row,
//                       head, 64 x 64 tile of the state): walks the chunks
//                       in order with the carried state in registers.  Per
//                       chunk: the in-chunk cumsum of da (into f32 scratch
//                       (B, nc, nh, L)), the chunk's own state sum_j
//                       e^{cum_end - cum_j} xw_j (x) B_j, an (hd x ds)
//                       product with K = chunk, the state before the chunk
//                       written as hi and lo bf16 halves to scratch (2, B,
//                       nc, nh, hd, ds), then carried e^{cum_end} + own.
//                       A separate passing launch, walking every entry's
//                       chunks with a load and a store a step, was
//                       latency-bound and wrote each chunk's own state only
//                       to read it back.
//     2. ssd_tc_out     C.B and the chunk outputs, per (batch row, chunk,
//                       head, 128-row tile, issued longest first), shaped
//                       like flash attention: the scores C_i . B_j^T of a
//                       64-column tile are a tensor-core product into f32
//                       registers, decayed and multiplied by xw_j in the
//                       A-operand layout they land in, plus e^{cum_i} C_i .
//                       state_before.  C.B is recomputed per head (bf16
//                       operands, exact, a few percent of the products)
//                       rather than read from f32 scratch made once for all
//                       heads: each of the heads would read that scratch
//                       again, four times the bytes of B and C, and here
//                       bytes cost more than products.  A warp's 16 rows
//                       meet a k-step's 16 columns wholly after them (the
//                       decay factors as e^{cum_i - cum_r} e^{cum_r -
//                       cum_j}, r the k-step's last column, both factors
//                       <= 1, from per-tile tables: 576 exponents a tile
//                       instead of 8192), wholly before them (skipped), or
//                       across the diagonal (per pair, masked).
//   Every product is mma.sync m16n8k16 bf16 -> f32, fragments by ldmatrix
//   (.trans where the operand is stored k-major) read before the products
//   that use them, tiles copied by cp.async 16 bytes at a time and double-
//   buffered (element by element when a row is not 16-byte aligned) and
//   zero-filled past ragged edges; y and the scratch state are staged in
//   shared memory and stored 16 bytes at a time.  Products of two bf16
//   inputs (C.B) are exact.  The f32 factors -- the decayed scores CB_ij
//   e^{cum_i-cum_j}, e^{cum_end-cum_j} xw_j and the carried state -- are
//   split into hi + lo bf16 halves, each multiplied by the exact bf16
//   operand: two tensor-core products keep about 2^-17 relative precision,
//   so the f32 state meets its 1e-3 bound (one bf16 rounding, 2^-9, would
//   not: tests/test_torch_ssd.py shows it).  The mask stays inside the
//   exponent: pairs j > i are zeroed before e^{...} is formed.  The scratch
//   (at zamba2's shape 1.3 MB of cumsums and 21 MB of states before each
//   chunk, written once and read by the two row tiles of each chunk: about
//   65 MB of extra traffic, 20 us at 3.35 TB/s) is allocated by the
//   wrapper.  hd and ds are zero-padded to 64 or 128.  Shared memory:
//   ssd_tc_states 36,864 + 8 L bytes; ssd_tc_out 4 (L + 576) + 2 (256
//   (dsp+8) + 2 hdp (dsp+8) + 128 (hdp+8)) bytes, 77 KB at zamba2's shape,
//   185 KB at hd = ds = 128, chunk 2048.
//
//   ssd_kernel (f32 xw, B or C).  JAX's f32 tolerance, 1e-3 on y and the
//   state, asks for f32 products, so any f32 operand keeps the first kernel:
//   one block owns one (batch row, head) and loops over the chunks itself,
//   the head's (hd, ds) state in shared memory for the whole sequence; a
//   chunk is cut into tiles of 64 rows, for each tile of outputs i only
//   the tiles j <= i are visited and pairs j > i are skipped before the
//   exponent is formed; tiles are converted to f32 in shared memory (rows
//   padded to ds+1 floats), every product an f32 fmaf.  Shared memory:
//   4 * (hd*(ds+1) + 2*64*(ds+1) + 64*hd + 64*64 + chunk) bytes, 132 KB at
//   mamba2's shape, at most 189,440 bytes.
//
//   Both: ragged chunks (e.g. a single 13-token chunk) are masked in the
//   kernel; inputs may be strided on every axis but the last (B and C are
//   column slices of the conv output); hd <= 128, ds <= 128, chunk <= 2048
//   dividing S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_mma.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core instance: two launches (see the note above).
// ---------------------------------------------------------------------------

#define TC_NT 128                       // threads: 4 warps of 16 rows
typedef __nv_bfloat16 bf16;

// Strides in elements; the last axis of every input is contiguous.
struct SsdArgs {
  const bf16* xw; long long xw_sb, xw_ss, xw_sh;
  const float* da; long long da_sb, da_ss;
  const bf16* bm; long long b_sb, b_ss;
  const bf16* cm; long long c_sb, c_ss;
  const float* s0;                      // (B, nh, hd, ds) or null
  bf16* y;                              // (B, S, nh, hd)
  float* fin;                           // (B, nh, hd, ds)
  float* cum;                           // scratch (B, nc, nh, L)
  bf16* st_hi;                          // scratch (B, nc, nh, hd, ds): the
  bf16* st_lo;                          // state before each chunk, hi + lo
  int B, S, nh, hd, ds, L, nc, vec;
};

// 1. Chunk states and state passing, fused, for one (batch row, head,
// 64 x 64 tile of the (hd, ds) state): the chunks in order, the carried
// state in registers.  Per chunk: the in-chunk cumsum of da (written out
// for step 4), the chunk's own state sum_j xw_j[p] w_j B_j[s] with
// w_j = e^{cum_end - cum_j} (the A operand (w o xw)^T split hi/lo), the
// state before the chunk written to scratch, and the carried state decayed
// by e^{cum_end} plus the chunk's own.  The (chunk, 64-row) tiles of xw and
// B are double-buffered: the next tile's copy overlaps this one's products.
__global__ void __launch_bounds__(TC_NT) ssd_tc_states(SsdArgs a) {
  constexpr int XS = 64 + 8, BS = 64 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);       // 2 x (64, XS) rows j
  bf16* Bs = Xs + 2 * TILE * XS;                      // 2 x (64, BS) rows j
  float* cum = reinterpret_cast<float*>(Bs + 2 * TILE * BS);   // (L)
  float* w = cum + a.L;                                         // (L)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int bh = blockIdx.x, b = bh / a.nh, h = bh - b * a.nh, L = a.L;
  const int s_base = blockIdx.y * 64, p_base = blockIdx.z * 64;
  const int ntile = (L + TILE - 1) / TILE, nsteps = a.nc * ntile;
  const size_t nstate = (size_t)a.hd * a.ds;
  const bool write_cum = blockIdx.y == 0 && blockIdx.z == 0;

  auto issue = [&](int t) {
    const int c = t / ntile, j0 = (t - c * ntile) * TILE;
    const long long t0 = (long long)c * L;
    load_tile<TILE, 64, XS, TC_NT>(
        Xs + (t & 1) * TILE * XS,
        a.xw + b * a.xw_sb + t0 * a.xw_ss + h * a.xw_sh + p_base, a.xw_ss,
        j0, L, a.hd - p_base, a.vec, tid);
    load_tile<TILE, 64, BS, TC_NT>(
        Bs + (t & 1) * TILE * BS, a.bm + b * a.b_sb + t0 * a.b_ss + s_base,
        a.b_ss, j0, L, a.ds - s_base, a.vec, tid);
  };
  issue(0);
  cp_async_commit();

  // this thread's state entries: rows p_base + warp*16 + gid (+8), columns
  // s_base + n*8 + 2tig (+1); the carried state starts at s0 or 0
  const int pr[2] = {p_base + warp * 16 + gid, p_base + warp * 16 + gid + 8};
  float carry[8][4], own[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pr[e >> 1], sc = s_base + n * 8 + 2 * tig + (e & 1);
      carry[n][e] = (a.s0 && p < a.hd && sc < a.ds)
                        ? a.s0[(size_t)bh * nstate + (size_t)p * a.ds + sc]
                        : 0.0f;
      own[n][e] = 0.0f;
    }

  float cend = 0.0f;
  for (int t = 0; t < nsteps; ++t) {
    const int c = t / ntile, j0 = (t - c * ntile) * TILE;
    const size_t bch = ((size_t)b * a.nc + c) * a.nh + h;
    if (j0 == 0) {                      // a new chunk: cumsum and weights
      const float* da = a.da + b * a.da_sb + (long long)c * L * a.da_ss + h;
      for (int i = tid; i < L; i += TC_NT) cum[i] = da[i * a.da_ss];
      __syncthreads();
      if (tid < 32) {                   // inclusive scan, 32 at a time
        float carry_s = 0.0f;
        for (int base = 0; base < L; base += 32) {
          const int i = base + tid;
          float x = i < L ? cum[i] : 0.0f;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, x, off);
            if (tid >= off) x += u;
          }
          x += carry_s;
          if (i < L) cum[i] = x;
          carry_s = __shfl_sync(0xffffffffu, x, 31);
        }
      }
      __syncthreads();
      cend = cum[L - 1];
      for (int i = tid; i < L; i += TC_NT) {
        w[i] = expf(cend - cum[i]);
        if (write_cum) a.cum[bch * L + i] = cum[i];
      }
    }
    if (t + 1 < nsteps) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Xt = Xs + (t & 1) * TILE * XS;
    const bf16* Bt = Bs + (t & 1) * TILE * BS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = j0 + kk * 16 + 2 * tig;     // this lane's A columns
      const float w0 = j < L ? w[j] : 0.0f, w1 = j + 1 < L ? w[j + 1] : 0.0f;
      const float w8 = j + 8 < L ? w[j + 8] : 0.0f;
      const float w9 = j + 9 < L ? w[j + 9] : 0.0f;
      unsigned xr[4], hi[4], lo[4], bfr[4][4];
      ldsm_x4_t(xr, Xt + (kk * 16 + (mat >> 1) * 8 + mrow) * XS + warp * 16 +
                        (mat & 1) * 8);    // xw stored [j][p]: A by .trans
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2)    // B_j stored [j][s]: .trans
        ldsm_x4_t(bfr[n2], Bt + (kk * 16 + (mat & 1) * 8 + mrow) * BS +
                               n2 * 16 + (mat >> 1) * 8);
      const float2 x0 = unpack_bf16(xr[0]), x1 = unpack_bf16(xr[1]);
      const float2 x2 = unpack_bf16(xr[2]), x3 = unpack_bf16(xr[3]);
      split_bf16(x0.x * w0, x0.y * w1, hi[0], lo[0]);
      split_bf16(x1.x * w0, x1.y * w1, hi[1], lo[1]);
      split_bf16(x2.x * w8, x2.y * w9, hi[2], lo[2]);
      split_bf16(x3.x * w8, x3.y * w9, hi[3], lo[3]);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        mma_bf16(own[2 * n2], hi, bfr[n2][0], bfr[n2][1]);
        mma_bf16(own[2 * n2], lo, bfr[n2][0], bfr[n2][1]);
        mma_bf16(own[2 * n2 + 1], hi, bfr[n2][2], bfr[n2][3]);
        mma_bf16(own[2 * n2 + 1], lo, bfr[n2][2], bfr[n2][3]);
      }
    }
    __syncthreads();                    // the stage is free for reloading
    if (j0 + TILE >= L) {               // the chunk's last tile
      // the state before the chunk, split hi/lo, staged in this (free)
      // stage and stored 16 bytes at a time where rows allow it
      bf16* Hs = const_cast<bf16*>(Xt);
      bf16* Ls = const_cast<bf16*>(Bt);
      const float decay = expf(cend);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned hi, lo;
          split_bf16(carry[n][2 * r], carry[n][2 * r + 1], hi, lo);
          const int o = (warp * 16 + gid + 8 * r) * XS + n * 8 + 2 * tig;
          *reinterpret_cast<unsigned*>(Hs + o) = hi;
          *reinterpret_cast<unsigned*>(Ls + o) = lo;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          carry[n][e] = carry[n][e] * decay + own[n][e];
          own[n][e] = 0.0f;
        }
      }
      __syncthreads();
      const size_t base = bch * nstate + (size_t)p_base * a.ds + s_base;
      const int rows = min(64, a.hd - p_base), cols = min(64, a.ds - s_base);
      if ((a.ds & 7) == 0) {
        for (int e = tid; e < 64 * 8; e += TC_NT) {
          const int r = e >> 3, d = (e & 7) * 8;
          if (r < rows && d < cols) {
            const size_t o = base + (size_t)r * a.ds + d;
            *reinterpret_cast<uint4*>(a.st_hi + o) =
                *reinterpret_cast<const uint4*>(Hs + r * XS + d);
            *reinterpret_cast<uint4*>(a.st_lo + o) =
                *reinterpret_cast<const uint4*>(Ls + r * XS + d);
          }
        }
      } else {
        for (int e = tid; e < 64 * 64; e += TC_NT) {
          const int r = e >> 6, d = e & 63;
          if (r < rows && d < cols) {
            const size_t o = base + (size_t)r * a.ds + d;
            a.st_hi[o] = Hs[r * XS + d];
            a.st_lo[o] = Ls[r * XS + d];
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pr[e >> 1], sc = s_base + n * 8 + 2 * tig + (e & 1);
      if (p < a.hd && sc < a.ds)
        a.fin[(size_t)bh * nstate + (size_t)p * a.ds + sc] = carry[n][e];
    }
}

// 2. Outputs of one (batch row, chunk, head, 64-row tile), shaped like
// flash attention: y_i = e^{cum_i} C_i . state_before
// + sum_{j<=i} (C_i . B_j) e^{cum_i-cum_j} xw_j.  C_i's fragments stay in
// registers; per tile of 64 columns j the scores C_i . B_j^T are a tensor-
// core product into f32 registers whose layout is the A operand's of the
// product with xw_j.  Exponents are base 2 (cum scaled by log2 e once).
// A warp's 16 rows meet a k-step's 16 columns in one of three ways: wholly
// after them (the decay factors as e^{cum_i - cum_r} e^{cum_r - cum_j}
// with r the k-step's last column, both factors <= 1, taken from per-tile
// tables: 320 exponents a tile instead of 4096), wholly before them
// (skipped), or across the diagonal (e^{cum_i - cum_j} per pair, masked).
// The B and xw tiles are double-buffered in shared memory; y is staged
// there and stored 16 bytes at a time.
#define TI 128                          // rows of a block: 8 warps of 16
#define OUT_NT 256
template <int HDP, int DSP>
__global__ void __launch_bounds__(OUT_NT) ssd_tc_out(SsdArgs a) {
  constexpr int CS = DSP + 8, SS = DSP + 8, XS = HDP + 8, NNT = HDP / 8;
  constexpr int NKS = DSP / 16;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);    // (L) x log2 e
  float* rowf = cum + ((a.L + 7) & ~7);               // (TI, 4) row factors
  float* colf = rowf + TI * 4;                        // (64) column factors
  bf16* Cs = reinterpret_cast<bf16*>(colf + TILE);    // (TI, CS) rows i
  bf16* Shi = Cs + TI * CS;                           // (HDP, SS) state hi
  bf16* Slo = Shi + HDP * SS;                         // (HDP, SS) state lo
  bf16* Bs = Slo + HDP * SS;                          // 2 x (64, CS) rows j
  bf16* Xs = Bs + 2 * TILE * CS;                      // 2 x (64, XS) rows j
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int bch = blockIdx.x, h = bch % a.nh, bc = bch / a.nh;
  const int b = bc / a.nc, c = bc - b * a.nc, L = a.L;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * TI;     // longest first
  const long long t0 = (long long)c * L;
  const bool inter = c > 0 || a.s0;
  const bf16* xw = a.xw + b * a.xw_sb + t0 * a.xw_ss + h * a.xw_sh;
  const bf16* bm = a.bm + b * a.b_sb + t0 * a.b_ss;
  const int iw = i0 + warp * 16;                      // the warp's first row
  const int ri[2] = {iw + gid, iw + gid + 8};
  const int li[2] = {warp * 16 + gid, warp * 16 + gid + 8};

  auto issue = [&](int jt) {
    load_tile<TILE, DSP, CS, OUT_NT>(Bs + (jt & 1) * TILE * CS, bm, a.b_ss,
                                     jt * TILE, L, a.ds, a.vec, tid);
    load_tile<TILE, HDP, XS, OUT_NT>(Xs + (jt & 1) * TILE * XS, xw, a.xw_ss,
                                     jt * TILE, L, a.hd, a.vec, tid);
  };
  load_tile<TI, DSP, CS, OUT_NT>(Cs, a.cm + b * a.c_sb + t0 * a.c_ss, a.c_ss,
                                 i0, L, a.ds, a.vec, tid);
  if (inter) {
    const size_t off = (size_t)bch * a.hd * a.ds;
    load_tile<HDP, DSP, SS, OUT_NT>(Shi, a.st_hi + off, a.ds, 0, a.hd, a.ds,
                                    a.vec, tid);
    load_tile<HDP, DSP, SS, OUT_NT>(Slo, a.st_lo + off, a.ds, 0, a.hd, a.ds,
                                    a.vec, tid);
  }
  issue(0);
  cp_async_commit();
  const int n_cum = min(L, i0 + TI);
  for (int i = tid; i < n_cum; i += OUT_NT)
    cum[i] = a.cum[(size_t)bch * L + i] * LOG2E;

  float acc[NNT][4];
#pragma unroll
  for (int n = 0; n < NNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  unsigned cf[NKS][4];                  // C_i's A fragments, K = ds
  float ci[2];

  const int n_jt = (n_cum + TILE - 1) / TILE;     // the tiles j < i0 + TI
  for (int jt = 0; jt < n_jt; ++jt) {
    const int j0 = jt * TILE;
    if (jt + 1 < n_jt) issue(jt + 1);
    cp_async_commit();
    if (jt == 0) __syncthreads();       // cum is in shared memory
    // decay tables of this tile for the k-steps wholly before a row:
    // colf[j] = e^{cum_r - cum_j}, rowf[i][g] = e^{cum_i - cum_r}, r the
    // last column of k-step g
    if (j0 + TILE <= L) {
      for (int e = tid; e < TILE + TI * 4; e += OUT_NT) {
        if (e < TILE) {
          colf[e] = ex2(cum[j0 + (e | 15)] - cum[j0 + e]);
        } else {
          const int il = (e - TILE) >> 2, g = (e - TILE) & 3;
          const int i = i0 + il, r = j0 + g * 16 + 15;
          rowf[il * 4 + g] = (r <= i && i < L) ? ex2(cum[i] - cum[r])
                                               : 0.0f;
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        ldsm_x4(cf[ks], Cs + (warp * 16 + (mat & 1) * 8 + mrow) * CS +
                            ks * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int r = 0; r < 2; ++r) ci[r] = ri[r] < L ? cum[ri[r]] : 0.0f;
      if (inter) {                      // e^{cum_i} C_i . state_before^T
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks) {
          unsigned bh_[HDP / 16][4], bl_[HDP / 16][4];
#pragma unroll
          for (int n2 = 0; n2 < HDP / 16; ++n2) {   // state stored [p][s]
            const int off = (n2 * 16 + (mat >> 1) * 8 + mrow) * SS +
                            ks * 16 + (mat & 1) * 8;
            ldsm_x4(bh_[n2], Shi + off);
            ldsm_x4(bl_[n2], Slo + off);
          }
#pragma unroll
          for (int n2 = 0; n2 < HDP / 16; ++n2) {
            mma_bf16(acc[2 * n2], cf[ks], bh_[n2][0], bh_[n2][1]);
            mma_bf16(acc[2 * n2], cf[ks], bl_[n2][0], bl_[n2][1]);
            mma_bf16(acc[2 * n2 + 1], cf[ks], bh_[n2][2], bh_[n2][3]);
            mma_bf16(acc[2 * n2 + 1], cf[ks], bl_[n2][2], bl_[n2][3]);
          }
        }
        const float ei[2] = {ri[0] < L ? ex2(ci[0]) : 0.0f,
                             ri[1] < L ? ex2(ci[1]) : 0.0f};
#pragma unroll
        for (int n = 0; n < NNT; ++n) {
          acc[n][0] *= ei[0];
          acc[n][1] *= ei[0];
          acc[n][2] *= ei[1];
          acc[n][3] *= ei[1];
        }
      }
    }
    const bf16* Bt = Bs + (jt & 1) * TILE * CS;
    const bf16* Xt = Xs + (jt & 1) * TILE * XS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int jk = j0 + kk * 16;                  // the k-step's columns
      if (jk > iw + 15) continue;                   // wholly before them
      const bool after = jk + 15 < iw && iw + 15 < L && j0 + TILE <= L;
      // every fragment of the k-step is read from shared memory before its
      // products: B_j's (stored [j][s]: n by k) and xw_j's (stored [j][p],
      // k by n: .trans)
      unsigned bq[NKS][4], bx[HDP / 16][4];
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        ldsm_x4(bq[ks], Bt + (kk * 16 + (mat >> 1) * 8 + mrow) * CS +
                            ks * 16 + (mat & 1) * 8);
#pragma unroll
      for (int n2 = 0; n2 < HDP / 16; ++n2)
        ldsm_x4_t(bx[n2], Xt + (kk * 16 + (mat & 1) * 8 + mrow) * XS +
                              n2 * 16 + (mat >> 1) * 8);
      // scores C_i . B_j for the k-step's 16 columns: two n-tiles
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        mma_bf16(sc[0], cf[ks], bq[ks][0], bq[ks][1]);
        mma_bf16(sc[1], cf[ks], bq[ks][2], bq[ks][3]);
      }
      // decayed, split hi/lo, in the A layout: a0/a1 from n-tile 0 (rows
      // gid / gid+8), a2/a3 from n-tile 1
      unsigned hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q & 1, nt = q >> 1;
        const int j = jk + nt * 8 + 2 * tig;
        float w0, w1;
        if (after) {
          const float f = rowf[li[r] * 4 + kk];
          w0 = sc[nt][2 * r] * f * colf[j - j0];
          w1 = sc[nt][2 * r + 1] * f * colf[j - j0 + 1];
        } else {
          const int i = ri[r];
          w0 = (j <= i && i < L) ? sc[nt][2 * r] * ex2(ci[r] - cum[j])
                                 : 0.0f;
          w1 = (j + 1 <= i && i < L)
                   ? sc[nt][2 * r + 1] * ex2(ci[r] - cum[j + 1]) : 0.0f;
        }
        split_bf16(w0, w1, hi[q], lo[q]);
      }
#pragma unroll
      for (int n2 = 0; n2 < HDP / 16; ++n2) {
        mma_bf16(acc[2 * n2], hi, bx[n2][0], bx[n2][1]);
        mma_bf16(acc[2 * n2], lo, bx[n2][0], bx[n2][1]);
        mma_bf16(acc[2 * n2 + 1], hi, bx[n2][2], bx[n2][3]);
        mma_bf16(acc[2 * n2 + 1], lo, bx[n2][2], bx[n2][3]);
      }
    }
    __syncthreads();                    // the stage is free for reloading
  }

  // y: staged in shared memory (the two xw stages, TI rows), stored 16
  // bytes at a time where rows allow it
  bf16* Ys = Xs;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NNT; ++n)
      *reinterpret_cast<unsigned*>(Ys + li[r] * XS + n * 8 + 2 * tig) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncthreads();
  const long long y_ss = (long long)a.nh * a.hd;
  bf16* yb = a.y + ((size_t)b * a.S + t0 + i0) * y_ss + (size_t)h * a.hd;
  const int rows = min(TI, L - i0);
  if ((a.hd & 7) == 0) {                // y contiguous: rows 16-byte aligned
    constexpr int CH = HDP / 8;
    for (int e = tid; e < TI * CH; e += OUT_NT) {
      const int r = e / CH, d = (e - r * CH) * 8;
      if (r < rows && d < a.hd)
        *reinterpret_cast<uint4*>(yb + r * y_ss + d) =
            *reinterpret_cast<const uint4*>(Ys + r * XS + d);
    }
  } else {
    for (int e = tid; e < TI * HDP; e += OUT_NT) {
      const int r = e / HDP, d = e - r * HDP;
      if (r < rows && d < a.hd) yb[r * y_ss + d] = Ys[r * XS + d];
    }
  }
}

static int pad64(int x) { return x <= 64 ? 64 : 128; }

static size_t tc_smem_states(int L) {
  return 2 * 2 * 2 * (size_t)TILE * 72 + 2 * 4 * (size_t)L;
}
static size_t tc_smem_out(int hdp, int dsp, int L) {
  return 4 * ((size_t)((L + 7) & ~7) + TI * 4 + TILE) +
         2 * ((size_t)(TI + 2 * TILE) * (dsp + 8) +
              2 * (size_t)hdp * (dsp + 8) + 2 * (size_t)TILE * (hdp + 8));
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define SSD_TRY(x)                               \
  do {                                           \
    cudaError_t e_ = (x);                        \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

template <int HDP, int DSP>
static int launch_tc(const SsdArgs& a, cudaStream_t stream) {
  const size_t s2 = tc_smem_states(a.L), s4 = tc_smem_out(HDP, DSP, a.L);
  SSD_TRY(allow_smem(ssd_tc_states, s2));
  SSD_TRY(allow_smem(ssd_tc_out<HDP, DSP>, s4));
  ssd_tc_states<<<dim3(a.B * a.nh, DSP / 64, HDP / 64), TC_NT, s2,
                  stream>>>(a);
  SSD_TRY(cudaGetLastError());
  ssd_tc_out<HDP, DSP><<<dim3(a.B * a.nc * a.nh, (a.L + TI - 1) / TI),
                         OUT_NT, s4, stream>>>(a);
  return (int)cudaGetLastError();
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

// The f32 instance.  x_bf16 / bc_bf16: 1 when xw (and y) / B and C are
// bf16, 0 when f32; not both (that is ssd_tc_forward's).  Strides are in
// elements; the last axis of xw, da, B and C is contiguous.
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
  if (x_bf16 && bc_bf16) return (int)cudaErrorInvalidValue;
  if (x_bf16) return launch<__nv_bfloat16, float>(SSD_ARGS);
  if (bc_bf16) return launch<float, __nv_bfloat16>(SSD_ARGS);
  return launch<float, float>(SSD_ARGS);
#undef SSD_ARGS
}

size_t ssd_tc_smem(int hd, int ds, int chunk) {
  return tc_smem_out(pad64(hd), pad64(ds), chunk);
}

// The tensor-core instance: xw, B and C bf16.  cum (B, nc, nh, L) is f32
// scratch, st_hi and st_lo (B, nc, nh, hd, ds) bf16 scratch; y must be
// contiguous; vec = 1 when xw, B
// and C allow 16-byte copies (pointers 16-byte aligned, hd, ds and every
// stride a multiple of 8 elements).  Two launches on `stream`.
int ssd_tc_forward(const void* xw, long long xw_sb, long long xw_ss,
                   long long xw_sh, const void* da, long long da_sb,
                   long long da_ss, const void* bm, long long b_sb,
                   long long b_ss, const void* cm, long long c_sb,
                   long long c_ss, const void* s0, void* y, void* fin,
                   void* cum, void* st_hi, void* st_lo, int B,
                   int S, int nh, int hd, int ds, int chunk, int vec,
                   void* stream) {
  SsdArgs a{(const bf16*)xw, xw_sb, xw_ss, xw_sh, (const float*)da, da_sb,
            da_ss, (const bf16*)bm, b_sb, b_ss, (const bf16*)cm, c_sb, c_ss,
            (const float*)s0, (bf16*)y, (float*)fin,
            (float*)cum, (bf16*)st_hi, (bf16*)st_lo, B, S, nh, hd, ds, chunk,
            S / chunk, vec};
  cudaStream_t st_ = (cudaStream_t)stream;
  const int hp = pad64(hd), dp = pad64(ds);
  if (hd > 128 || ds > 128) return (int)cudaErrorInvalidValue;
  if (hp == 64 && dp == 64) return launch_tc<64, 64>(a, st_);
  if (hp == 64) return launch_tc<64, 128>(a, st_);
  if (dp == 64) return launch_tc<128, 64>(a, st_);
  return launch_tc<128, 128>(a, st_);
}

}  // extern "C"
