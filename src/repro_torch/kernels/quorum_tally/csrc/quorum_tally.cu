// Quorum-tally kernels for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Built by kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no --use_fast_math, so logf and float division are the IEEE-rounded
// functions that torch.log and true division use on CUDA.  Every C entry
// point launches on the stream it is given, allocates nothing and returns
// cudaGetLastError().
//
// tally_decide             replaces src/repro/kernels/quorum_tally/kernel.py
//                          :tally_decide (_tally_decide_kernel).
//   Bound: device memory.  It reads S*n*4 bytes of votes and writes
//   S*(K+2)*4 + S bytes; the work is n*K integer compares a trial.
//   Design: one thread per trial, K <= 8 counters held in registers (the
//   value loop is unrolled to 8, so no counter is indexed dynamically); a
//   strict '>' keeps the first maximum, as the TPU kernel's running argmax.
//
// masked_tally             replaces kernel.py:masked_tally
//                          (_masked_tally_kernel).
//   Bound: device memory at the main path's shapes (S*n*4 in, S*G*4 out);
//   the adds, S*G*n of them, are far below the f32 rate.
//   Design: a block owns a tile of 32 trials x 32 quorum rows; the tile's
//   votes, weights and thresholds are staged in shared memory, then one
//   thread handles each (trial, row) pair.  Each value's weight is summed
//   with plain f32 adds in acceptor order (no tensor cores, no TF32), and
//   the lowest value id that reaches the threshold wins, as the TPU kernel's
//   descending value loop does.  Grid.y walks the rows, so any G works.
//
// stream_tally_decide_hist replaces kernel.py:stream_tally_decide_hist
//                          (_stream_kernel, _select_sat).
//   Bound: the per-trial selection work (k steps of an n-lane scan per
//   phase) at the main path's shapes; the chunk's bytes are read once per
//   system from L2.
//   Design: one block per (trial tile of 128, system m), one thread per
//   trial.  System m's three mask sets sit in shared memory.  The selection
//   network keeps _select_sat's semantics without a sorted copy: step j
//   extracts the smallest (value, lane) pair after the previous one, so
//   ties go to the lowest lane, and the selected acceptor's weight is added
//   to up to 8 rows held in registers; the first step at which any row
//   crosses its threshold gives the saturation instant (extraction instants
//   never decrease, so later rows only search the steps before it).  The
//   TPU grid accumulated across its sequential trial blocks; here blocks run
//   in no order, so each block builds its histogram in shared memory and
//   adds it, and the three counts, to the output with int32 atomics (exact
//   in any order), and writes its latency sum and max as per-block partials
//   that the wrapper reduces with a deterministic torch reduction.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_K 8
#define MAX_N 128

// ---------------------------------------------------------------------------
// tally_decide
// ---------------------------------------------------------------------------

__global__ void tally_decide_kernel(const int* __restrict__ votes, int S,
                                    int n, int K, int q,
                                    int* __restrict__ counts,
                                    int* __restrict__ winner,
                                    int* __restrict__ max_count,
                                    unsigned char* __restrict__ reached) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int c[MAX_K];
#pragma unroll
  for (int v = 0; v < MAX_K; ++v) c[v] = 0;
  const int* row = votes + (size_t)s * n;
  for (int a = 0; a < n; ++a) {
    int x = row[a];
#pragma unroll
    for (int v = 0; v < MAX_K; ++v) c[v] += (x == v);
  }
  int best = c[0], w = 0;
#pragma unroll
  for (int v = 1; v < MAX_K; ++v) {
    if (v < K && c[v] > best) {
      best = c[v];
      w = v;
    }
  }
#pragma unroll
  for (int v = 0; v < MAX_K; ++v) {
    if (v < K) counts[(size_t)s * K + v] = c[v];
  }
  winner[s] = w;
  max_count[s] = best;
  reached[s] = best >= q;
}

// ---------------------------------------------------------------------------
// masked_tally
// ---------------------------------------------------------------------------

#define MT_TS 32
#define MT_GT 32

__global__ void masked_tally_kernel(const int* __restrict__ votes,
                                    const float* __restrict__ w,
                                    const float* __restrict__ t, int S,
                                    int n, int G, int K,
                                    int* __restrict__ out) {
  __shared__ int sv[MT_TS * MAX_N];
  __shared__ float sw[MT_GT * MAX_N];
  __shared__ float st[MT_GT];
  int s0 = blockIdx.x * MT_TS;
  int g0 = blockIdx.y * MT_GT;
  int ts = min(MT_TS, S - s0);
  int gt = min(MT_GT, G - g0);
  for (int i = threadIdx.x; i < ts * n; i += blockDim.x)
    sv[i] = votes[(size_t)s0 * n + i];
  for (int i = threadIdx.x; i < gt * n; i += blockDim.x)
    sw[i] = w[(size_t)g0 * n + i];
  for (int i = threadIdx.x; i < gt; i += blockDim.x) st[i] = t[g0 + i];
  __syncthreads();
  for (int p = threadIdx.x; p < ts * gt; p += blockDim.x) {
    int ls = p / gt, lg = p - ls * gt;
    const int* vr = sv + ls * n;
    const float* wr = sw + lg * n;
    float sum[MAX_K];
#pragma unroll
    for (int v = 0; v < MAX_K; ++v) sum[v] = 0.0f;
    for (int a = 0; a < n; ++a) {
      int x = vr[a];
      float wa = wr[a];
#pragma unroll
      for (int v = 0; v < MAX_K; ++v)
        if (x == v) sum[v] = __fadd_rn(sum[v], wa);
    }
    float th = st[lg];
    int res = -1;
#pragma unroll
    for (int v = MAX_K - 1; v >= 0; --v)
      if (v < K && sum[v] >= th) res = v;
    out[(size_t)(s0 + ls) * G + g0 + lg] = res;
  }
}

// ---------------------------------------------------------------------------
// stream_tally_decide_hist
// ---------------------------------------------------------------------------

#define ST_BS 128
#define SEL_ROWS 8

// Earliest instant some row of (w, t) saturates over the k first arrivals
// of x in stable ascending order; `big` when no row does.
__device__ float select_sat(const float* __restrict__ x, int n,
                            const float* w, const float* t, int G, int k,
                            float big) {
  float best = big;
  int limit = k;
  for (int g0 = 0; g0 < G; g0 += SEL_ROWS) {
    float cs[SEL_ROWS];
#pragma unroll
    for (int r = 0; r < SEL_ROWS; ++r) cs[r] = 0.0f;
    float pv = 0.0f;
    int pl = -1;
    for (int j = 0; j < limit; ++j) {
      float cv = 0.0f;
      int cl = -1;
      for (int i = 0; i < n; ++i) {
        float xi = x[i];
        bool after = pl < 0 || xi > pv || (xi == pv && i > pl);
        if (after && (cl < 0 || xi < cv)) {
          cv = xi;
          cl = i;
        }
      }
      pv = cv;
      pl = cl;
      bool crossed = false;
#pragma unroll
      for (int r = 0; r < SEL_ROWS; ++r) {
        int g = g0 + r;
        if (g < G) {
          cs[r] = __fadd_rn(cs[r], w[g * n + cl]);
          crossed = crossed || cs[r] >= t[g];
        }
      }
      if (crossed) {
        best = cv;
        limit = j;
        break;
      }
    }
  }
  return best;
}

__global__ void stream_kernel(
    const int* __restrict__ votes, const float* __restrict__ val_arr,
    const float* __restrict__ arrive, const float* __restrict__ classic,
    const float* __restrict__ w1, const float* __restrict__ t1,
    const float* __restrict__ w2c, const float* __restrict__ t2c,
    const float* __restrict__ w2f, const float* __restrict__ t2f,
    const unsigned char* __restrict__ valid, int S, int n, int K, int G1,
    int G2c, int G2f, int k1, int k2c, int k2f, float log_g, int bins,
    float undecided_ms, int* __restrict__ hist, int* __restrict__ counts,
    float* __restrict__ part_sum, float* __restrict__ part_max) {
  extern __shared__ float smem[];
  const int m = blockIdx.y;
  const int b = blockIdx.x;
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  float* sw1 = smem;
  float* st1 = sw1 + G1 * n;
  float* sw2c = st1 + G1;
  float* st2c = sw2c + G2c * n;
  float* sw2f = st2c + G2c;
  float* st2f = sw2f + G2f * n;
  int* shist = (int*)(st2f + G2f);
  float* rsum = (float*)(shist + bins);
  float* rmax = rsum + blockDim.x;
  int* rcnt = (int*)(rmax + blockDim.x);

  for (int i = tid; i < G1 * n; i += blockDim.x)
    sw1[i] = w1[(size_t)m * G1 * n + i];
  for (int i = tid; i < G1; i += blockDim.x) st1[i] = t1[(size_t)m * G1 + i];
  for (int i = tid; i < G2c * n; i += blockDim.x)
    sw2c[i] = w2c[(size_t)m * G2c * n + i];
  for (int i = tid; i < G2c; i += blockDim.x)
    st2c[i] = t2c[(size_t)m * G2c + i];
  for (int i = tid; i < G2f * n; i += blockDim.x)
    sw2f[i] = w2f[(size_t)m * G2f * n + i];
  for (int i = tid; i < G2f; i += blockDim.x)
    st2f[i] = t2f[(size_t)m * G2f + i];
  for (int i = tid; i < bins; i += blockDim.x) shist[i] = 0;
  if (tid < 3) rcnt[tid] = 0;
  __syncthreads();

  const float big = 2.0f * undecided_ms;
  const int s = b * blockDim.x + tid;
  bool fast = false, recb = false, undb = false;
  float lat = 0.0f;
  if (s < S) {
    // masked tally against the fast rows: lowest value saturating any row.
    const int* vr = votes + (size_t)s * n;
    int best = K;
    for (int g = 0; g < G2f; ++g) {
      float sum[MAX_K];
#pragma unroll
      for (int v = 0; v < MAX_K; ++v) sum[v] = 0.0f;
      for (int a = 0; a < n; ++a) {
        int x = vr[a];
        float wa = sw2f[g * n + a];
#pragma unroll
        for (int v = 0; v < MAX_K; ++v)
          if (x == v) sum[v] = __fadd_rn(sum[v], wa);
      }
      float th = st2f[g];
#pragma unroll
      for (int v = 0; v < MAX_K; ++v)
        if (v < K && v < best && sum[v] >= th) best = v;
    }
    const bool reached = best < K;
    const int widx = reached ? best : K - 1;
    const float* wx = val_arr + ((size_t)s * K + widx) * n;
    float t_fast = select_sat(wx, n, sw2f, st2f, G2f, k2f, big);
    float t_det = select_sat(arrive + (size_t)s * n, n, sw1, st1, G1, k1, big);
    float t_cls =
        select_sat(classic + (size_t)s * n, n, sw2c, st2c, G2c, k2c, big);
    float rec = __fadd_rn(t_det, t_cls);
    bool fast_ok = reached && t_fast < undecided_ms;
    lat = fast_ok ? t_fast : rec;
    bool und = lat >= undecided_ms;
    bool v = valid[s] != 0;
    fast = fast_ok && v;
    recb = !fast_ok && !und && v;
    undb = und && v;
    if (fast || recb) {
      // streaming.bucket_index, the same f32 expression.
      float r = fmaxf(lat, 1e-2f) / 1e-2f;
      float fi = ceilf(logf(r) / log_g);
      fi = fminf(fmaxf(fi, 0.0f), (float)(bins - 1));
      atomicAdd(&shist[(int)fi], 1);
    }
  }
  const bool decided = fast || recb;
  rsum[tid] = decided ? lat : 0.0f;
  rmax[tid] = decided ? lat : -INFINITY;
  unsigned mf = __ballot_sync(0xffffffffu, fast);
  unsigned mr = __ballot_sync(0xffffffffu, recb);
  unsigned mu = __ballot_sync(0xffffffffu, undb);
  if ((tid & 31) == 0) {
    atomicAdd(&rcnt[0], __popc(mf));
    atomicAdd(&rcnt[1], __popc(mr));
    atomicAdd(&rcnt[2], __popc(mu));
  }
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (tid < off) {
      rsum[tid] = __fadd_rn(rsum[tid], rsum[tid + off]);
      rmax[tid] = fmaxf(rmax[tid], rmax[tid + off]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    part_sum[(size_t)m * nblk + b] = rsum[0];
    part_max[(size_t)m * nblk + b] = rmax[0];
    atomicAdd(&counts[m * 3 + 0], rcnt[0]);
    atomicAdd(&counts[m * 3 + 1], rcnt[1]);
    atomicAdd(&counts[m * 3 + 2], rcnt[2]);
  }
  for (int i = tid; i < bins; i += blockDim.x) {
    int c = shist[i];
    if (c) atomicAdd(&hist[(size_t)m * bins + i], c);
  }
}

// ---------------------------------------------------------------------------
// C entry points (ctypes).  Pointers and the stream arrive as void*.
// ---------------------------------------------------------------------------

extern "C" {

int qt_tally_decide(const void* votes, int S, int n, int K, int q,
                    void* counts, void* winner, void* max_count,
                    void* reached, void* stream) {
  const int threads = 256;
  const int blocks = (S + threads - 1) / threads;
  tally_decide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)votes, S, n, K, q, (int*)counts, (int*)winner,
      (int*)max_count, (unsigned char*)reached);
  return (int)cudaGetLastError();
}

int qt_masked_tally(const void* votes, const void* w, const void* t, int S,
                    int n, int G, int K, void* out, void* stream) {
  dim3 grid((S + MT_TS - 1) / MT_TS, (G + MT_GT - 1) / MT_GT);
  masked_tally_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int*)votes, (const float*)w, (const float*)t, S, n, G, K,
      (int*)out);
  return (int)cudaGetLastError();
}

int qt_stream_block() { return ST_BS; }

size_t qt_stream_smem(int n, int G1, int G2c, int G2f, int bins) {
  return sizeof(float) * ((size_t)(G1 + G2c + G2f) * (n + 1) + bins +
                          2 * ST_BS + 3);
}

int qt_stream_tally_decide_hist(
    const void* votes, const void* val_arr, const void* arrive,
    const void* classic, const void* w1, const void* t1, const void* w2c,
    const void* t2c, const void* w2f, const void* t2f, const void* valid,
    int S, int n, int K, int M, int G1, int G2c, int G2f, int k1, int k2c,
    int k2f, float log_g, int bins, float undecided_ms, void* hist,
    void* counts, void* part_sum, void* part_max, void* stream) {
  size_t smem = qt_stream_smem(n, G1, G2c, G2f, bins);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + ST_BS - 1) / ST_BS, M);
  stream_kernel<<<grid, ST_BS, smem, (cudaStream_t)stream>>>(
      (const int*)votes, (const float*)val_arr, (const float*)arrive,
      (const float*)classic, (const float*)w1, (const float*)t1,
      (const float*)w2c, (const float*)t2c, (const float*)w2f,
      (const float*)t2f, (const unsigned char*)valid, S, n, K, G1, G2c, G2f,
      k1, k2c, k2f, log_g, bins, undecided_ms, (int*)hist, (int*)counts,
      (float*)part_sum, (float*)part_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
