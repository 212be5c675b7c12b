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
//   22 us on bf16 tensor cores.  So the bf16 call is bound by bytes and by
//   tensor-core operations about equally; on the f32 CUDA cores the same
//   work would take 320 us.
//
//   Two instances, chosen by dtype:
//
//   flash_tc_kernel (bf16 q, k, v; the serving path).  The Pallas grid
//   (B*H, S/bq, T/bk) ran its kv axis in order on one core and carried m,
//   l and acc in VMEM scratch across it.  Here one block of 4 warps owns
//   one (batch*head, tile of queries) and walks the kv tiles of 64 keys
//   itself, so nothing is carried between blocks; query tiles are issued
//   longest first (the last tile of every head first).  Up to hd 80 a warp
//   owns 32 query rows (two m-tiles of 16, a tile of 128 queries), above
//   it 16 (64 queries): their running max m and sum l and their output
//   accumulators stay in registers, and every K and V fragment read from
//   shared memory feeds both m-tiles.  Q.K^T and P.V are mma.sync
//   m16n8k16 bf16 products with f32 accumulation (the products of bf16
//   values are exact in f32); Q and K fragments come from shared memory
//   by ldmatrix (Q's kept in registers where one m-tile leaves room), V's
//   by ldmatrix.trans, each step's fragments read one step ahead of its
//   products.  The scores never leave registers: the softmax runs on the
//   accumulator fragments in f32 (base-2 exponent by ex2.approx, the scale
//   folded in), and P is rounded to bf16 in registers, where the score
//   fragment's layout is the A operand's, and multiplies V directly.  The
//   JAX oracle rounds its softmax weights to bf16 before P.V too
//   (models/layers.py); the row sum l adds the f32 values.  K and V tiles
//   are double-buffered in shared memory and copied with cp.async, 16
//   bytes a copy, the next tile's copy overlapping this tile's products;
//   rows are padded by 16 bytes so the eight rows an ldmatrix reads hit
//   distinct banks.  o is staged in shared memory over Q's tile and stored
//   16 bytes at a time, not as the fragments' 2-byte pieces.  Tiles wholly
//   in the causal future or wholly outside the window are loop bounds (the
//   Pallas `run` predicate); only tiles on the diagonal, the window's edge
//   or the ragged end of T apply a mask.  hd is zero-padded in shared
//   memory to the instance's width (32, 64, 80, 128 or 256): hd 80,
//   zamba2's, is 5 k-steps of 16 for Q.K^T and 10 n-tiles of 8 for P.V.
//   When a row is not 16-byte aligned (hd or a stride not a multiple of 8
//   elements) the tiles are loaded and stored by plain 2-byte accesses
//   instead.  Shared memory: 2 * (tq + 256)
//   * (hdp + 8) bytes, 68 KB at hd 80, 165 KB at hd 256.
//
//   flash_kernel (f32 q, k, v).  JAX's f32 tolerance, 2e-5, is beyond
//   TF32, so f32 keeps the first kernel: one block of 256 threads owns one
//   (batch*head, tile of 64 queries), q, k and v in f32 in shared memory
//   (rows padded to hd+1 floats), every product an f32 fmaf; a thread owns
//   a 4 x 4 block of scores and a 4 x ceil(hd/16) block of the output, so
//   each shared-memory load feeds two to four FMAs.  Shared memory:
//   4 * (192 * (hd+1) + 64 * 65) bytes, 79 KB at hd 80, 214 KB at hd 256.
//
//   Both: the online softmax keeps NEG_INF = -2e38 and floors l at 1e-30;
//   masked scores give p = 0; ragged S and T are bounds masks (the TPU
//   wrapper's S % block_q rule is a tiling rule only); any hd up to 256;
//   inputs may be strided on all axes but the last, so the model's
//   (B,S,H,hd) tensors are read without a transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_mma.cuh"

#define BQ 64                 // queries per block
#define BK 64                 // keys per tile
#define NT 256                // threads per block: 16 x 16
#define NEG_INF (-2.0e38f)

static size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)(BQ + 2 * BK) * (hd + 1) + (size_t)BQ * (BK + 1));
}

template <int NC>
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh,
    long long q_ss, const float* __restrict__ k, long long k_sb,
    long long k_sh, long long k_st, const float* __restrict__ v,
    long long v_sb, long long v_sh, long long v_st, float* __restrict__ o,
    long long o_sb, long long o_sh, long long o_ss,
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + g * k_sh;
  const float* vb = v + b * v_sb + g * v_sh;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    Qs[r * hdp + d] = r < q_rows ? qb[(q0 + r) * q_ss + d] : 0.0f;
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
      Ks[r * hdp + d] = in ? kb[(k0 + r) * k_st + d] : 0.0f;
      Vs[r * hdp + d] = in ? vb[(k0 + r) * v_st + d] : 0.0f;
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

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) ob[(q0 + r) * o_ss + d] = acc[i][c] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core instance.
// ---------------------------------------------------------------------------

#define TC_BK 64              // keys per tile
#define TC_NT 128             // threads per block: 4 warps

// Rows a warp owns, in m-tiles of 16: two up to hd 80, so that every K and
// V fragment read from shared memory feeds two row tiles' products; one
// above, where two would not fit in registers.
__host__ __device__ constexpr int tc_mr(int hdp) { return hdp <= 80 ? 2 : 1; }
// queries a block: 4 warps of 16 * tc_mr rows
__host__ __device__ constexpr int tc_tq(int hdp) { return 64 * tc_mr(hdp); }

static size_t tc_smem_bytes(int hdp) {
  return sizeof(__nv_bfloat16) * (size_t)(tc_tq(hdp) + 4 * TC_BK) *
         (hdp + 8);
}

template <int HDP>
__global__ void __launch_bounds__(TC_NT) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh,
    long long q_ss, const __nv_bfloat16* __restrict__ k, long long k_sb,
    long long k_sh, long long k_st, const __nv_bfloat16* __restrict__ v,
    long long v_sb, long long v_sh, long long v_st,
    __nv_bfloat16* __restrict__ o, long long o_sb, long long o_sh,
    long long o_ss, int H, int KV, int S, int T_, int hd, int causal,
    int window, float scale, int vec) {
  constexpr int MR = tc_mr(HDP);          // m-tiles of 16 rows a warp
  constexpr int TQ = tc_tq(HDP);          // queries a block
  constexpr int STR = HDP + 8;            // row stride in shared memory
  constexpr int NKS = HDP / 16;           // k-steps of QK^T, PV n-tile pairs
  constexpr int NNT = HDP / 8;            // n-tiles of the output
  constexpr bool QREG = MR == 1 && HDP <= 128;   // Q's fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TQ * STR;      // two stages of TC_BK rows
  __nv_bfloat16* Vs = Ks + 2 * TC_BK * STR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;   // longest first
  const int q_rows = min(TQ, S - q0);
  const int pos0 = T_ - S + q0;           // absolute position of row 0
  const int wr = warp * 16 * MR;          // the warp's first row

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + g * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + g * v_sh;

  const int k_end = causal ? min(T_, pos0 + q_rows) : T_;
  const int k_begin = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int first = (k_begin / TC_BK) * TC_BK;

  load_tile<TQ, HDP, STR, TC_NT>(Qs, qb, q_ss, q0, S, hd, vec, tid);
  load_tile<TC_BK, HDP, STR, TC_NT>(Ks, kb, k_st, first, T_, hd, vec, tid);
  load_tile<TC_BK, HDP, STR, TC_NT>(Vs, vb, v_st, first, T_, hd, vec, tid);
  cp_async_commit();

  float acc[MR][NNT][4];
  float m[MR][2], l[MR][2];
  int qp[MR][2];
#pragma unroll
  for (int mt = 0; mt < MR; ++mt) {
#pragma unroll
    for (int n = 0; n < NNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = NEG_INF;
      l[mt][r] = 0.0f;
      qp[mt][r] = pos0 + wr + mt * 16 + gid + 8 * r;
    }
  }
  const float sl2 = scale * 1.4426950408889634f;   // scores in base 2
  const __nv_bfloat16* Qw = Qs + (wr + (mat & 1) * 8 + mrow) * STR +
                            (mat >> 1) * 8;
  unsigned qf[QREG ? NKS : 1][4];

  int stage = 0;
  for (int k0 = first; k0 < k_end; k0 += TC_BK, stage ^= 1) {
    if (k0 + TC_BK < k_end) {             // the next tile, to the other stage
      load_tile<TC_BK, HDP, STR, TC_NT>(Ks + (stage ^ 1) * TC_BK * STR, kb,
                                        k_st, k0 + TC_BK, T_, hd, vec, tid);
      load_tile<TC_BK, HDP, STR, TC_NT>(Vs + (stage ^ 1) * TC_BK * STR, vb,
                                        v_st, k0 + TC_BK, T_, hd, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // this tile (and Q) has landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * TC_BK * STR;
    const __nv_bfloat16* Vt = Vs + stage * TC_BK * STR;
    if (QREG && k0 == first) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? NKS : 1); ++kk)
        ldsm_x4(qf[kk], Qw + kk * 16);
    }

    // S = Q K^T: 16 MR rows x 64 keys a warp, in 8 n-tiles of 8 keys; each
    // K fragment feeds the MR row tiles
    float s[MR][8][4];
#pragma unroll
    for (int mt = 0; mt < MR; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
    // steps t = (k-step, pair of n-tiles); each step's K fragments are
    // read from shared memory one step ahead of its products
    auto ldk = [&](int t, unsigned (&r)[4]) {
      ldsm_x4(r, Kt + ((t & 3) * 16 + (mat >> 1) * 8 + mrow) * STR +
                     (t >> 2) * 16 + (mat & 1) * 8);
    };
    unsigned bq[2][4], a[MR][4];
    ldk(0, bq[0]);
#pragma unroll
    for (int t = 0; t < 4 * NKS; ++t) {
      const int kk = t >> 2, n2 = t & 3;
      if (t + 1 < 4 * NKS) ldk(t + 1, bq[(t + 1) & 1]);
      if (n2 == 0) {
#pragma unroll
        for (int mt = 0; mt < MR; ++mt) {
          if (QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][e] = qf[QREG ? kk : 0][e];
          } else {
            ldsm_x4(a[mt], Qw + mt * 16 * STR + kk * 16);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MR; ++mt) {
        mma_bf16(s[mt][2 * n2], a[mt], bq[t & 1][0], bq[t & 1][1]);
        mma_bf16(s[mt][2 * n2 + 1], a[mt], bq[t & 1][2], bq[t & 1][3]);
      }
    }

    // mask (only where some pair of the tile may be masked), online softmax
    const bool full = k0 + TC_BK <= T_ &&
                      (!causal || k0 + TC_BK - 1 <= pos0) &&
                      (window <= 0 || pos0 + TQ - 1 - k0 < window);
    // P in bf16, laid out as the A operand of P.V: k-step j covers the
    // n-tiles 2j and 2j+1 of the scores
    unsigned pa[MR][4][4];
#pragma unroll
    for (int mt = 0; mt < MR; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * sl2;
          if (!full) {
            const int kp = k0 + n * 8 + 2 * tig + (e & 1);
            const int p = qp[mt][e >> 1];
            const bool ok = kp < T_ && (!causal || kp <= p) &&
                            (window <= 0 || p - kp < window);
            x = ok ? x : NEG_INF;
          }
          s[mt][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        alpha[r] = ex2(m[mt][r] - m_new);
        m[mt][r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[mt][n][e] == NEG_INF ? 0.0f
                                        : ex2(s[mt][n][e] - m[mt][e >> 1]);
          rs[e >> 1] += p[e];
        }
        pa[mt][n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[mt][n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[mt][r] = l[mt][r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < NNT; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

    // O += P V: V is stored [key][d], the B operand's [k][n]: ldmatrix.trans;
    // each V fragment feeds the MR row tiles
    auto ldv = [&](int t, unsigned (&r)[4]) {   // t = (key step, d pair)
      ldsm_x4_t(r, Vt + ((t / NKS) * 16 + (mat & 1) * 8 + mrow) * STR +
                       (t % NKS) * 16 + (mat >> 1) * 8);
    };
    unsigned bv[2][4];
    ldv(0, bv[0]);
#pragma unroll
    for (int t = 0; t < 4 * NKS; ++t) {
      const int j = t / NKS, d2 = t % NKS;
      if (t + 1 < 4 * NKS) ldv(t + 1, bv[(t + 1) & 1]);
#pragma unroll
      for (int mt = 0; mt < MR; ++mt) {
        mma_bf16(acc[mt][2 * d2], pa[mt][j], bv[t & 1][0], bv[t & 1][1]);
        mma_bf16(acc[mt][2 * d2 + 1], pa[mt][j], bv[t & 1][2],
                 bv[t & 1][3]);
      }
    }
    __syncthreads();                      // the stage is free for reloading
  }
  cp_async_wait<0>();

  // o: staged in shared memory over Q's tile (each warp's own rows, which
  // only it read), then stored 16 bytes at a time where rows allow it
#pragma unroll
  for (int mt = 0; mt < MR; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(l[mt][r], 1e-30f);
      __nv_bfloat16* srow = Qs + (wr + mt * 16 + gid + 8 * r) * STR;
#pragma unroll
      for (int n = 0; n < NNT; ++n)
        *reinterpret_cast<unsigned*>(srow + n * 8 + 2 * tig) =
            pack_bf16(acc[mt][n][2 * r] / den, acc[mt][n][2 * r + 1] / den);
    }
  __syncthreads();
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + (long long)q0 * o_ss;
  if (vec) {                            // o is laid out as q: rows aligned
    constexpr int CH = HDP / 8;
    for (int e = tid; e < TQ * CH; e += TC_NT) {
      const int r = e / CH, d = (e - r * CH) * 8;
      if (r < q_rows && d < hd)
        *reinterpret_cast<uint4*>(ob + r * o_ss + d) =
            *reinterpret_cast<const uint4*>(Qs + r * STR + d);
    }
  } else {
    for (int e = tid; e < TQ * HDP; e += TC_NT) {
      const int r = e / HDP, d = e - r * HDP;
      if (r < q_rows && d < hd) ob[r * o_ss + d] = Qs[r * STR + d];
    }
  }
}

// The arguments of both kernels after the pointers' strides.
#define FA_PARAMS                                                          \
  const void *q, long long q_sb, long long q_sh, long long q_ss,           \
      const void *k, long long k_sb, long long k_sh, long long k_st,       \
      const void *v, long long v_sb, long long v_sh, long long v_st,       \
      void *o, long long o_sb, long long o_sh, long long o_ss, int B,      \
      int H, int KV, int S, int T_, int hd, int causal, int window,        \
      float scale, int vec, cudaStream_t stream

template <int NC>
static int launch_f32(FA_PARAMS) {
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<NC><<<grid, NT, smem, stream>>>(
      (const float*)q, q_sb, q_sh, q_ss, (const float*)k, k_sb, k_sh, k_st,
      (const float*)v, v_sb, v_sh, v_st, (float*)o, o_sb, o_sh, o_ss, H, KV,
      S, T_, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
static int launch_tc(FA_PARAMS) {
  typedef __nv_bfloat16 bf;
  const size_t smem = tc_smem_bytes(HDP);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int bq = tc_tq(HDP);
  dim3 grid(B * H, (S + bq - 1) / bq);
  flash_tc_kernel<HDP><<<grid, TC_NT, smem, stream>>>(
      (const bf*)q, q_sb, q_sh, q_ss, (const bf*)k, k_sb, k_sh, k_st,
      (const bf*)v, v_sb, v_sh, v_st, (bf*)o, o_sb, o_sh, o_ss, H, KV, S, T_,
      hd, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

#define FA_ARGS                                                          \
  q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_st, v, v_sb, v_sh, v_st, o, o_sb, \
      o_sh, o_ss, B, H, KV, S, T_, hd, causal, window, scale, vec, stream

static int dispatch_f32(FA_PARAMS) {
  if (hd <= 32) return launch_f32<2>(FA_ARGS);
  if (hd <= 64) return launch_f32<4>(FA_ARGS);
  if (hd <= 80) return launch_f32<5>(FA_ARGS);
  if (hd <= 128) return launch_f32<8>(FA_ARGS);
  if (hd <= 256) return launch_f32<16>(FA_ARGS);
  return (int)cudaErrorInvalidValue;
}

static int tc_width(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}

static int dispatch_tc(FA_PARAMS) {
  switch (tc_width(hd)) {
    case 32: return launch_tc<32>(FA_ARGS);
    case 64: return launch_tc<64>(FA_ARGS);
    case 80: return launch_tc<80>(FA_ARGS);
    case 128: return launch_tc<128>(FA_ARGS);
  }
  if (hd <= 256) return launch_tc<256>(FA_ARGS);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Dynamic shared memory of one block of the instance for this dtype.
size_t flash_smem(int is_bf16, int hd) {
  return is_bf16 ? tc_smem_bytes(tc_width(hd)) : smem_bytes(hd);
}

// q (B,H,S,hd), k/v (B,KV,T,hd), o (B,H,S,hd), each given by its pointer
// and its strides in elements over the first three axes (the last axis is
// contiguous).  window <= 0 means no window.  bf16 runs the tensor-core
// instance, which copies 16 bytes at a time when `vec` (every pointer
// 16-byte aligned, hd and every stride a multiple of 8), and element by
// element otherwise; f32 runs the f32 instance.
int flash_forward(int is_bf16, const void* q, long long q_sb, long long q_sh,
                  long long q_ss, const void* k, long long k_sb,
                  long long k_sh, long long k_st, const void* v,
                  long long v_sb, long long v_sh, long long v_st, void* o,
                  long long o_sb, long long o_sh, long long o_ss, int B,
                  int H, int KV, int S, int T_, int hd, int causal,
                  int window, float scale, int vec, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  return is_bf16 ? dispatch_tc(FA_ARGS) : dispatch_f32(FA_ARGS);
}

}  // extern "C"
