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
// Registers a thread (ptxas -v, sm_90a, CUDA 12.8): tally_votes_kernel_k
// 29-34, tally_votes_kernel 24, tally_decide_kernel 28, no spills;
// masked_tally_kernel 32-80 (<false, 2>, the main path's, 40), 12-36 bytes
// stored to the stack in <false, 1, 2, 4, 7>; every stream_kernel instance
// 64 (its launch bounds), none spilling where the masks are resident
// (RES), 126-166 bytes stored to the stack where they are read from device
// memory; race_card_kernel<false> 64, no spills; masked_sat_kernel 32-58
// (<true, true>, the main path's, 58), no spills; sorted_prefix_kernel
// 32-80 (<11, false>, the main path's, 48; <12, true> 40), no spills.
//
// tally_votes              replaces src/repro/kernels/quorum_tally/kernel.py
//                          :tally_votes (_tally_kernel).
//   Bound: device memory.  It reads S*n*4 bytes of votes and writes S*K*4
//   bytes of counts; the work is n*K integer compares a trial.  At
//   quorum_reached's 16384 x 11, K = 2 that is 0.85 MB, 0.25 us: the
//   launch's fixed cost and the dependent chain of a thread are what is
//   left to cut.
//   Design: a thread a trial in blocks of 64 threads (S = 16384 gives 256
//   blocks, two an SM), reading its row straight from device memory (a
//   warp's 32 rows share cache lines, so after the first miss its loads hit
//   L1).  For K <= 8 an instance a K keeps K counters in registers, so a
//   vote costs K compares, and the warp's 32 x K counts pass through shared
//   memory to leave as one contiguous span.  Past 8 values, one pass over
//   the row per 8.  Votes outside [0, K), such as the -1 of "no vote" (the
//   TPU kernel's padding), are counted for no value, here and in
//   tally_decide.
//
// tally_decide             replaces src/repro/kernels/quorum_tally/kernel.py
//                          :tally_decide (_tally_decide_kernel).
//   Bound: device memory.  It reads S*n*4 bytes of votes and writes
//   S*(K+2)*4 + S bytes; the work is n*K integer compares a trial.  At the
//   sweep's 16384 x 11, K = 2 that is 1 MB, 0.30 us: a launch's fixed cost
//   is most of what the card can save.
//   Design: one thread per trial, 8 counters in registers, one pass over
//   the row per 8 values, so any K and any n; the thread reads its row
//   straight from device memory (a warp's 32 rows share cache lines, so
//   after the first miss its loads hit L1).  Blocks of 64 threads, so the
//   sweep's chunk of 16384 trials spreads over the card's 132 SMs in 256
//   blocks (it had 64 of 256).  The winner is carried across passes with a
//   strict '>', so the first maximum wins, as the TPU kernel's running
//   argmax.  Staging the block's rows in shared memory with 16-byte
//   asynchronous copies was slower at the sweep's shape: it adds a barrier
//   and a round trip through shared memory to a kernel bound by latency.
//
// masked_tally             replaces kernel.py:masked_tally
//                          (_masked_tally_kernel).
//   Bound: device memory (S*n*4 bytes in, S*G*4 out; 1.7 MB, 0.50 us at
//   the masked race's 8192 x 12 against 39 rows).  The TPU kernel's
//   S*G*n*K multiply-adds are not needed: a trial votes for at most
//   min(n, K) values, and a row of small integer weights is decided by
//   population counts.  In practice the kernel is bound by the latency of
//   its one round trip to device memory at launch, the per-block staging
//   of the rows, and the instructions of the (trial, row) pairs.
//   Design (masked_tally_kernel below): a block takes tiles of 32 trials,
//   1-D over tiles and chunks of rows, so any S and G.  The rows are
//   staged and classified once a block: each row's support mask, and for
//   a row of integer weights in [0, 256) its bit planes and its threshold
//   as a count (a unit row is one plane); any other row adds its voters'
//   weights in lane order with __fadd_rn.  A warp takes 4 trials, a lane
//   an acceptor: for n <= 32 and K <= 8 (every main-path shape) one ballot
//   a value gives each voter mask, and the warp's (trial, row) pairs go a
//   lane each, rows fastest, so the outputs leave as contiguous words; any
//   other n or K takes the voted values 8 a pass in ascending order (a
//   warp minimum, then a ballot), so the work follows the values voted,
//   not K, and where t <= 0 the lowest unvoted id (sum 0) answers, as in
//   the reference.  Where a block's working set does not fit in shared
//   memory (n past about 2200) it works in device memory.  Weights must
//   be finite (the reference's 0 * inf is NaN for every value).
//
// stream_tally_decide_hist replaces kernel.py:stream_tally_decide_hist
//                          (_stream_kernel, _select_sat).
//   Bound: device memory at the main path's shapes.  A chunk's votes and
//   K + 2 arrival rows, S*(K+3)*n*4 bytes, are read once; the work -- per
//   trial one ordering of its K + 2 rows, per (trial, system) the masked
//   tally (G2f*n*K adds) and the weight contractions (G1*k1 + G2c*k2c +
//   G2f*k2f adds) -- takes less time at the f32 rate.  In practice the
//   kernel is bound by the latency of its dependent chains: a lane's adds
//   along an order, one position after another.
//   Design: a trial's rows (its K val_arr rows, arrive, classic) are each
//   ordered once, stable ascending with ties to the lowest lane, which is the
//   order _select_sat extracts, and every system reads that order.  A block
//   stages a tile of 32 trials in shared memory with 16-byte asynchronous
//   copies and ranks each row's (key, lane) pairs.  Then each warp takes one
//   system, one trial a lane: the masked tally over vote bit masks (the
//   lowest value whose voters' weights reach a fast row), the fast phase only
//   when a value reached a fast quorum, the recovery phases only when the
//   fast one did not decide.  Only live rows take part (a row of zero weights
//   and positive threshold never crosses), held in shared memory transposed
//   in groups of four -- one 16-byte load gives four rows' weights of a lane
//   -- where they fit, else read from device memory; a group adds along the
//   order with __fadd_rn until one of its rows crosses, stopping at the
//   earliest crossing found so far, and a phase with one live row walks it
//   alone.  For n <= 16 an instance keeps a trial's order in registers;
//   above it reads it from shared memory, a byte a lane up to n = 256 and
//   two bytes above.  Where a tile of 32 trials and the block's lists of
//   live rows do not fit in shared memory (large n, K or G), the plan
//   takes fewer systems a block, and then stages the tile and the lists in
//   a scratch of device memory instead.  A block covers up to
//   16 systems; counts and the latency sum and max stay in registers, the
//   histogram takes one int32 atomic per distinct bucket of a warp (exact in
//   any order), and the last block of a group, found with a fence and an
//   atomic ticket, reduces the per-block partials in block order, so sum_ms
//   is the same bit for bit from call to call.  A call is one fill (the
//   histogram and the tickets, cudaMemsetAsync) and one launch.
//
// race_card_hist           replaces kernel.py:tally_decide
//                          (_tally_decide_kernel) on the cardinality race
//                          chunk, with the XLA reductions around it in
//                          src/repro/montecarlo/streaming.py:394
//                          (_race_card_update).
//   Bound: by bytes a chunk's votes, arrive and classic are read once and
//   FH and RH written once: 6.0 MB at the sweep's 16384 x 11, P = 66, 1.8
//   us.  In practice by the L2's atomics: a trial makes up to k2f + P
//   histogram increments, 1.23 M a sweep chunk into 12.9 K distinct cells
//   of FH and RH (about 95 a cell), then by the instructions of the f32
//   bucket expression a (trial, column) and the latency of the cross-block
//   reduction.
//   Design: the chunk's tally, first-max decide (first_max, shared with
//   tally_decide_kernel), order statistics and fcap-slot reductions in one
//   launch, without a sort.  A
//   block stages a tile of 64 trials (votes, order keys of arrive and
//   classic), ranks each row by (key, lane) -- for n <= 16 a thread a row
//   in registers, else a thread a lane -- keeping the k2f / k1 / kr first,
//   then walks (trial, column) pairs twice.  For the histograms a warp
//   takes a column and 32 trials, a trial a lane, and the lanes whose
//   increments fall in the same cell are merged (__match_any_sync): one
//   int32 atomic in device memory a distinct cell of the warp, exact in
//   any order (0.79 of the increments remain at the sweep chunk).  For the
//   sums and maxima a thread takes a column, the tile's trials split over
//   groups of column threads, each (group, slot, column) cell one thread's
//   running sum and max, so every sum has one order.  Block partials, then groups of blocks, are reduced by the last
//   block of each, found with a fence and an atomic ticket, in block order:
//   sums the same bit for bit from call to call, maxima exact (order keys).
//   Where the tile, prefixes and cells do not fit in shared memory (large n
//   or k_sat), a block works in its region of device memory instead.  A
//   call is one fill (FH, RH, slot counts, tickets) and one launch.
//
// masked_sat               replaces no TPU kernel: src/repro/montecarlo/
//                          engine.py:_sat_time is plain jnp (a gather of the
//                          weights along each order, cumsum, >=, argmax, a
//                          gather and a min over rows), which the port ran
//                          as about nine torch launches around an (M, G, S,
//                          L) f32 tensor.  It is the masked tables' decide
//                          wherever no fused kernel takes them: the fast
//                          and classic paths, the materializing race, the
//                          regime streams.
//   Bound: device memory.  The presorted prefix is read once (f32 arrivals
//   and int64 ids, S*L each), each system's live rows once and the (M, S)
//   answer written once: 12.8 MB at the benchmark's fast chunk (65,536 x
//   12, 13 systems, 21 live rows), 3.8 us; its adds and compares take 0.5
//   us at the f32 rate.  In practice it is bound by the instructions of the
//   dependent walks, a lane's adds along the order one position after
//   another, and by the staging of the rows at a block's start.
//   Design: a thread a (trial, system), lanes over trials, so each store of
//   out[m, s0 + lane] is one contiguous span; a block takes a group of
//   systems and trial tiles after it.  Each system's rows are staged once a
//   block, classified by one warp: a dead row (zero weights and a positive
//   threshold, or a NaN threshold) never crosses and is dropped, a
//   monotone row (no negative or NaN weight) reaches its threshold exactly
//   when it crosses it, and the live rows go in groups of four transposed
//   (one 16-byte load gives four rows' weights of a lane), the monotone
//   groups first.  A trial's order, where L <= 16 and n < 256, is read
//   with 16-byte loads and held in registers, a byte a position; else it
//   is read where the sort left it.  A monotone group adds along the order
//   with __fadd_rn (the stream kernel's sat_time, JAX's _select_sat) and
//   stops at the earliest crossing any of the system's rows has so far:
//   arrivals ascend, so a later crossing cannot lower the minimum; a group
//   holding another row walks all L positions and keeps each row's first
//   crossing and whether its sum ends at or above its threshold, which is
//   the plain version's test.  Rows that have not crossed by the earliest
//   crossing matter only where its arrival lies above big (they would give
//   big); only then are they walked to the end.  Where one system's rows
//   do not fit a block's shared memory, every row is read from device
//   memory and walked whole.  No atomics: a call gives the same bits every
//   time.  A call is one launch and no fill.
//
// sorted_prefix            replaces no TPU kernel: src/repro/montecarlo/
//                          engine.py:204 _topk_ascending is lax.top_k (a
//                          full argsort where k >= n), which the port ran
//                          as torch.sort (a radix sort, an index fill and a
//                          copy) and a slice.  It is the order statistics
//                          of every decide outside the fused race kernels:
//                          the cardinality fast and classic streams'
//                          prefixes, the masked fast and classic paths'
//                          presorts, the materializing and regime races'.
//   Bound: device memory.  A row of n f32 is read once and its k-prefix
//   written once (with ids, 8 bytes more a position): 184.5 MB, 55.1 us,
//   at the benchmark's fast chunk (2,097,152 x 11, k = n); the network's
//   compare-exchanges (38 a row at n = 11) take 1.2 us at the f32 rate,
//   though each is six integer instructions on a 64-bit word.
//   Design: a thread a row, a block 128 rows.  The block's tile is
//   contiguous in device memory and comes in with 16-byte streaming loads
//   (scalar ones from a base off 16 bytes), landing in shared memory at an
//   odd row stride (n | 1), so the thread reading its row position by
//   position meets no bank conflict.  Each (value, position) pair is one
//   64-bit word, an order-preserving key of the float's bits above the
//   position (torch.sort's radix twiddle, -0 keyed as +0 and marked in bit
//   0 so its sign comes back), and the thread sorts its n words in
//   registers through Batcher's odd-even merge network cut to n, fully
//   unrolled from a template on n (instances 1..32): ties fall to the lower
//   position, as in the stable sort.  The k smallest go back through
//   shared memory (stride k | 1) and leave as 16-byte stores, the ids only
//   where the caller reads the order.  No fill, no scratch, one launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "sm90_mma.cuh"

#define FULL 0xffffffffu
#define PASS_K 8            // values counted in one pass over a row

typedef unsigned long long u64;

// Take the next 16-byte aligned region of `bytes` from offset o.
__host__ __device__ inline size_t st_take(size_t& o, size_t bytes) {
  size_t at = o;
  o += (bytes + 15) & ~(size_t)15;
  return at;
}

// ---------------------------------------------------------------------------
// tally_votes and tally_decide
// ---------------------------------------------------------------------------

// c[v] = number of the n votes of `row` equal to base + v, for v < PASS_K
// (the callers use the first min(K - base, PASS_K)).
__device__ __forceinline__ void count_row(const int* __restrict__ row, int n,
                                          int base, int (&c)[PASS_K]) {
#pragma unroll
  for (int v = 0; v < PASS_K; ++v) c[v] = 0;
  for (int a = 0; a < n; ++a) {
    int x = row[a];
#pragma unroll
    for (int v = 0; v < PASS_K; ++v) c[v] += (x == base + v);
  }
}

#define TV_THREADS 64       // trials a block: S = 16384 gives 256 blocks

// K > PASS_K: a thread a trial, one pass over its row per PASS_K values.
__global__ void __launch_bounds__(TV_THREADS) tally_votes_kernel(
    const int* __restrict__ votes, int S, int n, int K,
    int* __restrict__ counts) {
  int s = blockIdx.x * TV_THREADS + threadIdx.x;
  if (s >= S) return;
  int c[PASS_K];
  for (int base = 0; base < K; base += PASS_K) {
    count_row(votes + (size_t)s * n, n, base, c);
#pragma unroll
    for (int v = 0; v < PASS_K; ++v) {
      if (base + v < K) counts[(size_t)s * K + base + v] = c[v];
    }
  }
}

// K = KC <= PASS_K: a thread a trial, KC counters in registers, KC compares
// a vote.  The thread reads its row straight from device memory (a warp's
// 32 rows share cache lines, so after the first miss its loads hit L1);
// the warp's 32 x KC counts are then passed through shared memory and
// leave as one contiguous span.
template <int KC>
__global__ void __launch_bounds__(TV_THREADS) tally_votes_kernel_k(
    const int* __restrict__ votes, int S, int n, int* __restrict__ counts) {
  __shared__ int stage[TV_THREADS * KC];
  const int lane = threadIdx.x & 31, wb = threadIdx.x - lane;
  const long long w0 = (long long)blockIdx.x * TV_THREADS + wb;
  const long long s = w0 + lane;
  int c[KC];
#pragma unroll
  for (int v = 0; v < KC; ++v) c[v] = 0;
  if (s < S) {
    const int* row = votes + (size_t)s * n;
    for (int a = 0; a < n; ++a) {
      const int x = __ldg(row + a);
#pragma unroll
      for (int v = 0; v < KC; ++v) c[v] += x == v;
    }
  }
  int* st = stage + wb * KC;
#pragma unroll
  for (int v = 0; v < KC; ++v) st[lane * KC + v] = c[v];
  __syncwarp();
  const long long live = min(32LL, (long long)S - w0) * KC;
  for (int i = lane; i < live; i += 32) counts[w0 * KC + i] = st[i];
}

template <int KC>
void tv_launch(int blocks, cudaStream_t st, const int* votes, int S, int n,
               int* counts) {
  tally_votes_kernel_k<KC><<<blocks, TV_THREADS, 0, st>>>(votes, S, n,
                                                          counts);
}

// Fold one pass's counts c (values base .. base + PASS_K - 1, those below K
// real) into the running first maximum (best, w): a strict '>' carried
// across passes, so the first maximum wins, as the TPU kernel's running
// argmax.  tally_decide_kernel and race_card_kernel decide with it.
__device__ __forceinline__ void first_max(const int (&c)[PASS_K], int base,
                                          int K, int& best, int& w) {
#pragma unroll
  for (int v = 0; v < PASS_K; ++v) {
    if (base + v < K && (base + v == 0 || c[v] > best)) {
      best = c[v];
      w = base + v;
    }
  }
}

#define TD_THREADS 64       // trials a block: S = 16384 gives 256 blocks

// A thread owns a trial and reads its row straight from device memory: the
// rows of a warp's 32 trials share cache lines, so after the first miss its
// loads hit L1.  PASS_K counters in registers a pass, one pass over the row
// per PASS_K values, each folded into the first maximum (first_max).
__global__ void __launch_bounds__(TD_THREADS) tally_decide_kernel(
    const int* __restrict__ votes, int S, int n, int K, int q,
    int* __restrict__ counts, int* __restrict__ winner,
    int* __restrict__ max_count, unsigned char* __restrict__ reached) {
  const int s = blockIdx.x * TD_THREADS + threadIdx.x;
  if (s >= S) return;
  int best = 0, w = 0;
  int c[PASS_K];
  for (int base = 0; base < K; base += PASS_K) {
    count_row(votes + (size_t)s * n, n, base, c);
    first_max(c, base, K, best, w);
#pragma unroll
    for (int v = 0; v < PASS_K; ++v)
      if (base + v < K) counts[(size_t)s * K + base + v] = c[v];
  }
  winner[s] = w;
  max_count[s] = best;
  reached[s] = best >= q;
}

// ---------------------------------------------------------------------------
// masked_tally
// ---------------------------------------------------------------------------

// 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

#define MT_TS 32            // trials a tile
#define MT_THREADS 256
#define MT_WARPS (MT_THREADS / 32)
#define MT_TPW (MT_TS / MT_WARPS)   // trials a warp takes of a tile
#define MT_KC 8             // K up to which (n <= 32) an instance keeps
                            // every value's mask in registers
#define MT_VP 8             // voted values a pass, past MT_KC
#define MT_PL 8             // bit planes of an integral row: weights
                            // 0 .. 255
#define MT_EPT 2            // weights a thread loads at once (n <= 32)
#define MT_SMEM (96 * 1024) // shared memory a block may take (2 an SM)
#define MT_MIN_ROWS 32      // rows a chunk that shared memory must hold
#define MT_GLOB_ROWS 256    // rows a chunk where the block works in
                            // device memory

// A block's working set for rc rows a chunk, in bytes, each region 16-byte
// aligned (in shared memory, or in the block's region of device memory
// where that cannot hold MT_MIN_ROWS rows):
// rec   for n <= 32, a row's record in one 16-byte load: {kt, P, plane 0,
//       plane 1} of an integral row, {th, 0, sup, 0} of a float row
// th    the chunk's thresholds
// kt    an integral row's threshold as a count: the least integer k with
//       (float)k >= th (0 for th <= 0, INT_MAX past 2^24 or for NaN)
// npl   per row its bit planes P: every weight an integer in [0, 2^P), P
//       <= MT_PL; 0 for any other row (a float row)
// sup   support masks: bit b of sup[r * W + q] is set when lane 32 q + b of
//       row r has a nonzero weight; for n <= 32, sup[rc + r] is nonzero
//       when a weight of row r is not an integer in [0, 2^MT_PL)
// pln   bit planes: bit b of pln[(p * rc + r) * W + q] is bit p of the
//       weight of lane 32 q + b of an integral row r (0 past its P planes)
// msk   each warp's voter masks of a pass: bit b of msk[(warp * MT_VP + i)
//       * W + q] is set when lane 32 q + b voted the pass's value i
// val   each warp's values of a pass, ascending
struct MaskedLayout {
  int W;
  size_t rec, th, kt, npl, sup, pln, msk, val, bytes;
};

__host__ __device__ inline MaskedLayout masked_layout(int n, int rc) {
  MaskedLayout L;
  L.W = (n + 31) / 32;
  size_t o = 0;
  L.rec = st_take(o, L.W == 1 ? (size_t)rc * 16 : 0);
  L.th = st_take(o, (size_t)rc * 4);
  L.kt = st_take(o, (size_t)rc * 4);
  L.npl = st_take(o, (size_t)rc * 4);
  L.sup = st_take(o, (size_t)rc * (L.W == 1 ? 2 : L.W) * 4);
  L.pln = st_take(o, (size_t)MT_PL * rc * L.W * 4);
  L.msk = st_take(o, (size_t)MT_WARPS * MT_VP * L.W * 4);
  L.val = st_take(o, MT_WARPS * MT_VP * 4);
  L.bytes = o;
  return L;
}

struct MaskedArgs {
  const int* votes;
  const float* w;
  const float* t;
  int S, n, G, K, rc;
  long long ntiles, items;  // tiles of MT_TS trials; items: tiles x chunks
  unsigned char* scratch;   // the blocks' regions of device memory (glob)
  long long region;
  int* out;
};

// The f32 sum, in lane order, of the weights of the voters b (lanes 32 q ..
// 32 q + 31 of a float row, within its support; sum carries across words).
// A zero weight, which the support leaves out, changes no sum a >= can see.
__device__ __forceinline__ float mt_walk(unsigned b, int q, const float* wr,
                                         float sum) {
  for (; b; b &= b - 1)
    sum = __fadd_rn(sum, __ldg(wr + 32 * q + __ffs(b) - 1));
  return sum;
}

// KC > 0: the votes x of trials s0 + j0 .. s0 + j0 + MT_TPW - 1, a lane an
// acceptor (-1 past S or n).
template <int KC>
__device__ __forceinline__ void mt_votes(const MaskedArgs& a, long long s0,
                                         int j0, int lane, int (&x)[MT_TPW]) {
#pragma unroll
  for (int i = 0; i < MT_TPW; ++i)
    x[i] = KC > 0 && s0 + j0 + i < a.S && lane < a.n
               ? __ldg(a.votes + (size_t)(s0 + j0 + i) * a.n + lane)
               : -1;
}

// An item is a tile of MT_TS trials against a chunk of rc rows; a block
// walks items chunk by chunk, so with one chunk (G <= rc) it stages the
// rows once, and then each warp takes its trials with no further barrier.
// The staging classifies each row: a row whose weights are all integers in
// [0, 2^P) is held as P bit planes, and the weight its voters b reach is
// sum_p popc(b & plane p) << p, exact in integers and so the ordered f32
// sum bit for bit (every partial sum is an integer below 2^24); a unit row
// (weights 0 and 1) is one plane.  Any other row (a float row) adds its
// voters' weights in lane order.  For n <= 32 a thread takes a weight and
// ORs its bits into its row's support and planes with shared-memory
// atomics (the chunk's weights are contiguous: one coalesced load), then a
// thread a row finishes the row's record; past 32, a thread a row.
// KC > 0 (n <= 32, K = KC <= MT_KC): a warp holds its MT_TPW trials' votes
// a lane an acceptor (loaded an item ahead), takes every value's voter
// mask by a ballot, then takes the trials' (trial, row) pairs a lane each,
// rows fastest, every mask in registers; a value no acceptor voted has an
// empty mask and sums to 0, as in the reference.  The outputs of a warp's
// trials leave as contiguous words.  Where every row of the chunk is
// integral with at most two planes (lean: the main path's tables), a pair
// is two population counts a value and a compare.
// KC = 0 (any n and K): a pass finds a trial's next MT_VP voted values in
// ascending order (the lowest voted value above the last one by a warp
// minimum, its voters by a ballot), then decides the rows no earlier pass
// decided; the reference sums an unvoted value to 0, so where t <= 0 the
// lowest unvoted id (between two voted values, or past the last one, below
// K) answers before any higher voted value.
template <bool GLOB, int KC>
__global__ void __launch_bounds__(MT_THREADS) masked_tally_kernel(
    MaskedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      GLOB ? a.scratch + (size_t)blockIdx.x * a.region : smem;
  const int n = a.n, G = a.G, K = a.K, rc = a.rc;
  const MaskedLayout L = masked_layout(n, rc);
  const int W = L.W;
  float* th = (float*)(base + L.th);
  int* kt = (int*)(base + L.kt);
  int* npl = (int*)(base + L.npl);
  unsigned* sup = (unsigned*)(base + L.sup);
  unsigned* pln = (unsigned*)(base + L.pln);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* wm = (unsigned*)(base + L.msk) + (size_t)warp * MT_VP * W;
  int* wv = (int*)(base + L.val) + warp * MT_VP;
  long long staged = -1;  // the chunk whose rows are staged
  bool lean = false;      // its rows are integral, 2 planes at most
  long long chunk = 0, tile = blockIdx.x;  // the block's first item
  if (tile >= a.ntiles) {
    chunk = tile / a.ntiles;
    tile %= a.ntiles;
  }
  const int j0 = warp * MT_TPW;  // the warp's trials: j0 .. j0 + MT_TPW - 1
  // KC > 0: the votes of the warp's trials of an item, a lane an acceptor,
  // loaded an item ahead
  int x[MT_TPW];
  mt_votes<KC>(a, tile * MT_TS, j0, lane, x);
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const long long s0 = tile * MT_TS;
    const int g0 = (int)(chunk * rc), gt = min(rc, G - g0);
    const int ts = (int)min((long long)MT_TS, (long long)a.S - s0);
    long long nchunk = chunk, ntile = tile + gridDim.x;  // the next item
    if (ntile >= a.ntiles) {
      nchunk += ntile / a.ntiles;
      ntile %= a.ntiles;
    }
    if (chunk != staged) {
      if (staged >= 0)
        __syncthreads();  // every warp is done with the last chunk's rows
      staged = chunk;
      bool general = false;
      if (W == 1) {
        // a thread a weight (the chunk's rows are contiguous), its bits
        // OR-ed into its row's support and planes; then a thread a row
        const float* src = a.w + (size_t)g0 * n;
        const int ne = gt * n;
        float wl[MT_EPT];
#pragma unroll
        for (int e = 0; e < MT_EPT; ++e)
          wl[e] = tid + e * MT_THREADS < ne
                      ? __ldg(src + tid + e * MT_THREADS)
                      : 0.0f;
        const float t0 = tid < gt ? __ldg(a.t + g0 + tid) : 0.0f;
        for (int i = tid; i < gt * (MT_PL + 2); i += MT_THREADS) {
          const int p = i / gt, r = i - p * gt;  // planes, support, flags
          (p < MT_PL ? pln : sup)[(size_t)(p < MT_PL ? p : p - MT_PL) * rc +
                                  r] = 0u;
        }
        __syncthreads();
        for (int e0 = 0; e0 < ne; e0 += MT_EPT * MT_THREADS) {
#pragma unroll
          for (int e = 0; e < MT_EPT; ++e) {
            const int i = e0 + tid + e * MT_THREADS;
            if (i >= ne) break;
            const float x = e0 ? __ldg(src + i) : wl[e];
            const int r = i / n, b = i - r * n;
            const bool ok =
                x >= 0.0f && x < (float)(1 << MT_PL) && x == truncf(x);
            const unsigned bit = 1u << b;
            if (x != 0.0f) atomicOr(sup + r, bit);
            if (!ok) atomicOr(sup + rc + r, 1u);  // not integral
            for (unsigned iw = ok ? (unsigned)x : 0u; iw; iw &= iw - 1)
              atomicOr(pln + (size_t)(__ffs(iw) - 1) * rc + r, bit);
          }
        }
        __syncthreads();
        for (int r = tid; r < gt; r += MT_THREADS) {
          const float tg = r == tid ? t0 : __ldg(a.t + g0 + r);
          const int kr = !(tg > 0.0f) ? (tg != tg ? INT_MAX : 0)
                         : tg > 16777216.0f ? INT_MAX
                                            : (int)ceilf(tg);
          int P = 0;
#pragma unroll
          for (int p = 0; p < MT_PL; ++p)
            if (pln[(size_t)p * rc + r]) P = p + 1;
          // P planes, every partial sum an integer below 2^24
          const bool exact = ((1LL << P) - 1) * (long long)n < (1LL << 24);
          const int Pr = !sup[rc + r] && exact ? (P ? P : 1) : 0;
          th[r] = tg;
          kt[r] = kr;
          npl[r] = Pr;
          ((int4*)(base + L.rec))[r] =
              Pr ? make_int4(kr, Pr, (int)pln[r], (int)pln[rc + r])
                 : make_int4(__float_as_int(tg), 0, (int)sup[r], 0);
          general |= Pr == 0 || Pr > 2;
        }
      }
      // W > 1: a thread a row: its support, class, bit planes, thresholds
      for (int r = tid; r < gt && W > 1; r += MT_THREADS) {
        const float* wr = a.w + (size_t)(g0 + r) * n;
        const float tg = __ldg(a.t + g0 + r);
        const int kr = !(tg > 0.0f) ? (tg != tg ? INT_MAX : 0)
                       : tg > 16777216.0f ? INT_MAX
                                          : (int)ceilf(tg);
        bool integral = true;
        unsigned all = 0u;
        for (int q = 0; q < W; ++q) {
          unsigned sq = 0u;
          const int lim = min(32, n - 32 * q);
          for (int b = 0; b < lim; ++b) {
            const float wl = __ldg(wr + 32 * q + b);
            const bool ok = wl >= 0.0f && wl < (float)(1 << MT_PL) &&
                            wl == truncf(wl);
            sq |= (unsigned)(wl != 0.0f) << b;
            integral &= ok;
            all |= ok ? (unsigned)wl : 0u;
          }
          sup[(size_t)r * W + q] = sq;
        }
        // P planes, every partial sum an integer below 2^24
        const int P = 32 - __clz(all);
        const bool exact = ((1LL << P) - 1) * (long long)n < (1LL << 24);
        const int Pr = integral && exact ? (P ? P : 1) : 0;
        for (int p = 0; p < MT_PL; ++p) {
          for (int q = 0; q < W; ++q) {
            unsigned pl = 0u;
            const int lim = min(32, n - 32 * q);
            for (int b = 0; p < Pr && b < lim; ++b)
              pl |= ((unsigned)__ldg(wr + 32 * q + b) >> p & 1u) << b;
            pln[((size_t)p * rc + r) * W + q] = pl;
          }
        }
        th[r] = tg;
        kt[r] = kr;
        npl[r] = Pr;
        general = true;
      }
      // lean: every row of the chunk is integral with at most 2 planes
      lean = !__syncthreads_or(general);
    }
    const float* wrows = a.w + (size_t)g0 * n;

    if (KC > 0) {
      // every value's voter mask of the warp's trials, then the (trial,
      // row) pairs a lane each, rows fastest: the warp's trials' outputs
      // leave as contiguous words (one span when G <= rc)
      unsigned m[MT_TPW][KC > 0 ? KC : 1];
#pragma unroll
      for (int i = 0; i < MT_TPW; ++i)
#pragma unroll
        for (int v = 0; v < KC; ++v) m[i][v] = __ballot_sync(FULL, x[i] == v);
      if (item + gridDim.x < a.items)
        mt_votes<KC>(a, ntile * MT_TS, j0, lane, x);
      const int nt = max(0, min(MT_TPW, ts - j0));
      int* o = a.out + (size_t)(s0 + j0) * G + g0;
      const int q32 = 32 / gt, r32 = 32 % gt;
      int jl = lane / gt, r = lane % gt;
      if (lean) {  // every row: k = popc(b & plane 0) + 2 popc(b & plane 1)
        const int4* rec = (const int4*)(base + L.rec);
        for (int p = lane; p < nt * gt; p += 32) {
          const int4 rr = rec[r];
          int ans = -1;
#pragma unroll
          for (int v = KC - 1; v >= 0; --v) {  // the lowest hit wins
            unsigned b = m[0][v];
#pragma unroll
            for (int i = 1; i < MT_TPW; ++i)
              if (jl == i) b = m[i][v];
            const int k = __popc(b & (unsigned)rr.z) +
                          (__popc(b & (unsigned)rr.w) << 1);
            if (k >= rr.x) ans = v;
          }
          o[gt == G ? p : (size_t)jl * G + r] = ans;
          r += r32;
          jl += q32;
          if (r >= gt) {
            r -= gt;
            ++jl;
          }
        }
      } else {
        for (int p = lane; p < nt * gt; p += 32) {
          unsigned mv[KC > 0 ? KC : 1];
#pragma unroll
          for (int v = 0; v < KC; ++v) {
            mv[v] = m[0][v];
#pragma unroll
            for (int i = 1; i < MT_TPW; ++i)
              if (jl == i) mv[v] = m[i][v];
          }
          const int4 rr = ((const int4*)(base + L.rec))[r];
          const int P = rr.y;
          int ans = -1;
          if (P) {
#pragma unroll
            for (int v = KC - 1; v >= 0; --v) {  // the lowest hit wins
              int k = __popc(mv[v] & (unsigned)rr.z);
              if (P > 1) {
                k += __popc(mv[v] & (unsigned)rr.w) << 1;
                for (int pp = 2; pp < P; ++pp)
                  k += __popc(mv[v] & pln[pp * rc + r]) << pp;
              }
              if (k >= rr.x) ans = v;
            }
          } else {
#pragma unroll
            for (int v = KC - 1; v >= 0; --v)
              if (mt_walk(mv[v] & (unsigned)rr.z, 0, wrows + (size_t)r * n,
                          0.0f) >= __int_as_float(rr.x))
                ans = v;
          }
          o[gt == G ? p : (size_t)jl * G + r] = ans;
          r += r32;
          jl += q32;
          if (r >= gt) {
            r -= gt;
            ++jl;
          }
        }
      }
    } else {
      for (int i = 0; i < MT_TPW; ++i) {
        const int j = j0 + i;
        if (j >= ts) break;
        const int* row = a.votes + (size_t)(s0 + j) * n;
        const int x0 = lane < n ? __ldg(row + lane) : -1;
        int* o = a.out + (size_t)(s0 + j) * G + g0;
        int prev = -1;
        for (int pass = 0;; ++pass) {
          // the pass's voted values above prev, ascending, and their masks
          const int pre = prev;
          int cnt = 0;
          while (cnt < MT_VP) {
            int c = INT_MAX;
            for (int q = 0; q < W; ++q) {
              const int l = 32 * q + lane;
              const int xv = q == 0 ? x0 : l < n ? __ldg(row + l) : -1;
              if (xv > prev && xv < K) c = min(c, xv);
            }
            const int v = __reduce_min_sync(FULL, c);
            if (v == INT_MAX) break;
            for (int q = 0; q < W; ++q) {
              const int l = 32 * q + lane;
              const int xv = q == 0 ? x0 : l < n ? __ldg(row + l) : -1;
              const unsigned b = __ballot_sync(FULL, xv == v);
              if (lane == 0) wm[cnt * W + q] = b;
            }
            if (lane == 0) wv[cnt] = v;
            prev = v;
            ++cnt;
          }
          // a pass that filled all MT_VP slots may have more values after it
          const bool last = cnt < MT_VP;
          __syncwarp();
          for (int r = lane; r < gt; r += 32) {
            if (pass > 0 && o[r] != -2) continue;  // an earlier pass decided
            const float tg = th[r];
            const int P = npl[r], kr = kt[r];
            const float* wr = wrows + (size_t)r * n;
            int pv = pre, ans = -2;
            for (int c = 0; c < cnt; ++c) {
              const int v = wv[c];
              if (tg <= 0.0f && v > pv + 1) {  // an unvoted id below v
                ans = pv + 1;
                break;
              }
              int kv = 0;
              float sum = 0.0f;
              for (int q = 0; q < W; ++q) {
                const unsigned b = wm[c * W + q];
                if (P) {
                  for (int pp = 0; pp < P; ++pp)
                    kv += __popc(b & pln[((size_t)pp * rc + r) * W + q])
                          << pp;
                } else {
                  sum = mt_walk(b & sup[(size_t)r * W + q], q, wr, sum);
                }
              }
              if (P ? kv >= kr : sum >= tg) {
                ans = v;
                break;
              }
              pv = v;
            }
            if (ans == -2 && last)
              ans = tg <= 0.0f && pv + 1 < K ? pv + 1 : -1;
            o[r] = ans;  // -2: undecided, a later pass decides it
          }
          __syncwarp();  // the lanes are done with the pass's masks
          if (last) break;
        }
      }
    }
    chunk = nchunk;
    tile = ntile;
  }
}

// ---------------------------------------------------------------------------
// stream_tally_decide_hist
// ---------------------------------------------------------------------------

#define ST_TILE 32          // trials a tile: one per lane of a warp
#define ST_MAX_MG 16        // systems a block: one warp each
#define ST_MIN_WARPS 4      // warps a block has at least, for the staging
#define ST_MAX_SMEM (232448 - 1024)   // dynamic shared memory a block may use
#define ST_MAX_SCRATCH (1 << 30)      // device-memory staging a block may use

// What one launch reads and writes.  Phase p = 0 is phase 1 (arrive), 1 the
// recovery commit (classic), 2 the fast phase (the winner's val_arr row).
struct StreamArgs {
  const int* votes;
  const float* val;
  const float* arr;
  const float* cls;
  const unsigned char* valid;
  const float* w[3];
  const float* t[3];
  int G[3];
  int k[3];
  int S, n, K, M, bins, mg;
  int vec;    // n % 4 == 0 and the inputs 16-byte aligned: 16-byte loads
  unsigned char* scratch;  // the tiles staged in device memory, big bytes
                           // a block; null: in shared memory
  float log_g, und;
  int* hist;
  int* counts;
  int* tickets;
  float* sum;
  float* max;
  float* psum;
  float* pmax;
  int* pcnt;
};

// Shared-memory layout of a block, in bytes, each region 16-byte aligned
// (with glob, the first five regions lie instead in the block's big bytes
// of device memory):
// keys   the tile's K + 2 rows (ST_TILE trials x n each) as order keys
// votes  the tile's votes
// ord    the K + 2 orders of every trial: ord[(r * ST_TILE + trial) * np +
//        j] is the lane at position j of row r's stable ascending order, a
//        byte a lane up to n = 256, two bytes above
// vm     vote bit masks: bit b of vm[(v * W + q) * ST_TILE + trial] is set
//        when lane 32 q + b voted v
// lists  the live rows of each phase of each of the block's systems
// valid  the tile's valid bits
// nlive  the count of each list
// wts    with res, each system's live rows in groups of four, transposed:
//        per phase ng[p] float4 thresholds, then ng[p] x n float4 weights
struct StreamLayout {
  int gt, W, np, ng[3];
  size_t keys, votes, ord, vm, valid, nlive, lists, wts, wsys, bytes, big;
};

// The lane type of an order: LB > 0 keeps it in registers (bytes), LB = 0
// in shared memory as bytes (n <= 256), LB < 0 as two-byte lanes.
template <int LB>
using lane_t = typename std::conditional<(LB < 0), unsigned short,
                                         unsigned char>::type;


// lb > 0: the instance keeps a trial's order in registers, lb bytes; lb <= 0:
// it reads the order from shared memory (lane_t<lb> a lane), whose rows then
// take an odd number of words so that the trials of a warp fall in distinct
// banks.  glob: the tile in device memory.
__host__ __device__ inline StreamLayout stream_layout(int n, int K,
                                                      const int* G, int mg,
                                                      int lb, bool res,
                                                      bool glob) {
  const int T = ST_TILE;
  StreamLayout L;
  L.gt = G[0] + G[1] + G[2];
  L.W = (n + 31) / 32;
  const int esz = lb < 0 ? 2 : 1;
  const int words = (n * esz + 3) / 4;
  L.np = lb > 0 ? lb : 4 * (words + !(words & 1)) / esz;
  L.wsys = 0;
  for (int p = 0; p < 3; ++p) {
    L.ng[p] = (G[p] + 3) / 4;
    L.wsys += (size_t)L.ng[p] * (n + 1) * 16;
  }
  size_t o = 0;
  L.keys = st_take(o, (size_t)(K + 2) * T * n * 4);
  L.votes = st_take(o, (size_t)T * n * 4);
  L.ord = st_take(o, (size_t)(K + 2) * T * L.np * esz);
  L.vm = st_take(o, (size_t)K * L.W * T * 4);
  L.lists = st_take(o, (size_t)mg * L.gt * 2);
  L.big = glob ? o : 0;
  if (glob) o = 0;
  L.valid = st_take(o, T * 4);
  L.nlive = st_take(o, (size_t)mg * 3 * 4);
  L.wts = st_take(o, res ? (size_t)mg * L.wsys : 0);
  L.bytes = o;
  return L;
}

// x[p] for a p known only at run time, without indexing an array (which
// would put it in local memory).
template <class T>
__device__ __forceinline__ T pick(int p, T x0, T x1, T x2) {
  return p == 0 ? x0 : (p == 1 ? x1 : x2);
}

// A total order on f32 that is torch.sort's: -0 ties +0, NaN after +inf.
__device__ __forceinline__ unsigned order_key(unsigned u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of a key (-0 comes back as +0, which compares equal).
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// streaming.bucket_index, the same f32 expression:
// ceil(log(max(x, 1e-2) / 1e-2) / log_g) clipped to [0, bins - 1].
__device__ __forceinline__ int sketch_bucket(float x, float log_g,
                                             int bins) {
  const float r = fmaxf(x, 1e-2f) / 1e-2f;
  float fi = ceilf(logf(r) / log_g);
  fi = fminf(fmaxf(fi, 0.0f), (float)(bins - 1));
  return (int)fi;
}

// One trial's order of one row: the lane at position j.  LB = 16 holds it
// in registers, LB <= 0 reads it from shared memory.
template <int LB>
struct Ord {
  const lane_t<LB>* p;
  __device__ __forceinline__ void load(const lane_t<LB>* q) { p = q; }
  __device__ __forceinline__ int at(int j) const { return p[j]; }
};

template <>
struct Ord<16> {
  u64 a, b;
  __device__ __forceinline__ void load(const unsigned char* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    a = ((u64)v.y << 32) | v.x;
    b = ((u64)v.w << 32) | v.z;
  }
  __device__ __forceinline__ int at(int j) const {
    return (int)(((j < 8 ? a : b) >> ((j & 7) * 8)) & 0xffu);
  }
};

// The live rows of one phase of one system, nl of its G, in ng groups of
// four: resident in shared memory, transposed (st: ng thresholds, sw: ng x n
// weights, a float4 per lane holding the group's four rows), or read from
// device memory through the list of live rows (w (G, n), t (G,), list).
struct Phase {
  const float4* st;
  const float4* sw;
  const float* w;
  const float* t;
  const unsigned short* list;
  int n, nl, ng, G;
};

// Four rows added together: weight(l) holds their weights of lane l, t their
// thresholds (+inf past the last live row: those never cross); weight1(l)
// the first row's weight alone.
struct GroupS {
  const float4* w;
  float4 t;
  __device__ __forceinline__ float4 weight(int l) const { return w[l]; }
  __device__ __forceinline__ float weight1(int l) const {
    return reinterpret_cast<const float*>(w)[4 * l];
  }
};

struct GroupG {
  const float* w0;
  const float* w1;
  const float* w2;
  const float* w3;
  float4 t;
  __device__ __forceinline__ float4 weight(int l) const {
    return make_float4(__ldg(w0 + l), __ldg(w1 + l), __ldg(w2 + l),
                       __ldg(w3 + l));
  }
  __device__ __forceinline__ float weight1(int l) const {
    return __ldg(w0 + l);
  }
};

// Group gi (< ng) of a phase.
template <bool RES>
__device__ __forceinline__ auto group(const Phase& ph, int gi) {
  if constexpr (RES) {
    return GroupS{ph.sw + gi * ph.n, ph.st[gi]};
  } else {
    const int i = 4 * gi, last = ph.nl - 1;
    const int i1 = min(i + 1, last), i2 = min(i + 2, last),
              i3 = min(i + 3, last);
    const unsigned short* l = ph.list;
    const int g0 = l[i], g1 = l[i1], g2 = l[i2], g3 = l[i3];
    return GroupG{ph.w + (size_t)g0 * ph.n, ph.w + (size_t)g1 * ph.n,
                  ph.w + (size_t)g2 * ph.n, ph.w + (size_t)g3 * ph.n,
                  make_float4(__ldg(ph.t + g0),
                              i + 1 <= last ? __ldg(ph.t + g1) : INFINITY,
                              i + 2 <= last ? __ldg(ph.t + g2) : INFINITY,
                              i + 3 <= last ? __ldg(ph.t + g3) : INFINITY)};
  }
}

// c += w, four rows at once, each with __fadd_rn; true when one crosses.
__device__ __forceinline__ bool add4(float4& c, const float4& w,
                                     const float4& t) {
  c.x = __fadd_rn(c.x, w.x);
  c.y = __fadd_rn(c.y, w.y);
  c.z = __fadd_rn(c.z, w.z);
  c.w = __fadd_rn(c.w, w.w);
  return (c.x >= t.x) | (c.y >= t.y) | (c.z >= t.z) | (c.w >= t.w);
}

// Walk positions [0, lim) of the order o with the rows of group gi of a
// phase, each adding its weights in order with __fadd_rn; on the first
// position where a row crosses, set lim to it.  The weights of four
// positions load together before their adds.
template <int LB, bool RES>
__device__ __forceinline__ void walk_group(const Ord<LB>& o, const Phase& ph,
                                           int gi, int& lim, bool& hit) {
  const auto g = group<RES>(ph, gi);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < lim; j0 += 4) {
    float4 w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) w[v] = g.weight(o.at(min(j0 + v, lim - 1)));
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (j0 + v < lim && add4(c, w[v], g.t)) {
        lim = j0 + v;
        hit = true;
      }
    }
  }
}

// The same for a phase with one live row, four positions at a time.
template <int LB, bool RES>
__device__ __forceinline__ void walk_row(const Ord<LB>& o, const Phase& ph,
                                         int& lim, bool& hit) {
  const auto g = group<RES>(ph, 0);
  float c = 0.0f;
  for (int j0 = 0; j0 < lim; j0 += 4) {
    float w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) w[v] = g.weight1(o.at(min(j0 + v, lim - 1)));
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (j0 + v < lim) {
        c = __fadd_rn(c, w[v]);
        if (c >= g.t.x) {
          lim = j0 + v;
          hit = true;
        }
      }
    }
  }
}

// Earliest instant some live row of a phase crosses its threshold over the
// k first positions of the order o; keys holds the trial's row.  Rows walk
// the order four at
// a time, each group stopping at the earliest crossing found so far:
// instants never decrease along the order.  Like the plain version's min
// over rows, rows that do not cross within k count as big, which decides
// only when the earliest instant lies above big.
template <int LB, bool RES>
__device__ __forceinline__ float sat_time(const Ord<LB>& o, const Phase& ph,
                                          int k, float big,
                                          const unsigned* keys) {
  int lim = k;
  bool hit = false;
  if (ph.nl == 1)
    walk_row<LB, RES>(o, ph, lim, hit);
  else
    for (int gi = 0; gi < ph.ng; ++gi)
      walk_group<LB, RES>(o, ph, gi, lim, hit);
  if (!hit) return big;
  const int l = o.at(lim);
  float inst = key_value(keys[l]);
  if (inst > big) {
    bool all = ph.nl == ph.G;
    for (int gi = 0; all && gi < ph.ng; ++gi) {
      const auto g = group<RES>(ph, gi);
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bool x = false, y = 4 * gi + 1 >= ph.nl, z = 4 * gi + 2 >= ph.nl,
           w = 4 * gi + 3 >= ph.nl;
      for (int j = 0; j < k; ++j) {
        add4(c, g.weight(o.at(j)), g.t);
        x |= c.x >= g.t.x;
        y |= c.y >= g.t.y;
        z |= c.z >= g.t.z;
        w |= c.w >= g.t.w;
      }
      all = x && y && z && w;
    }
    if (!all) inst = big;
  }
  return inst;
}

// Masked tally of one trial against a phase's live rows: the lowest value
// whose voters' weights, added in lane order, reach some row's threshold,
// else K.  vm holds the trial's vote bit masks, W words a value, ST_TILE
// apart.
template <bool RES>
__device__ __forceinline__ int tally(const Phase& ph, const unsigned* vm,
                                     int W, int K) {
  if (ph.nl == 1) {  // one live row: scalar sums
    const auto g = group<RES>(ph, 0);
    for (int v = 0; v < K; ++v) {
      float c = 0.0f;
      for (int q = 0; q < W; ++q) {
        unsigned b = vm[(v * W + q) * ST_TILE];
        while (b) {
          c = __fadd_rn(c, g.weight1(32 * q + __ffs(b) - 1));
          b &= b - 1u;
        }
      }
      if (c >= g.t.x) return v;
    }
    return K;
  }
  for (int v = 0; v < K; ++v) {
    for (int gi = 0; gi < ph.ng; ++gi) {
      const auto g = group<RES>(ph, gi);
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int q = 0; q < W; ++q) {
        unsigned b = vm[(v * W + q) * ST_TILE];
        while (b) {
          add4(c, g.weight(32 * q + __ffs(b) - 1), g.t);
          b &= b - 1u;
        }
      }
      if ((c.x >= g.t.x) | (c.y >= g.t.y) | (c.z >= g.t.z) | (c.w >= g.t.w))
        return v;
    }
  }
  return K;
}

// Lanes [I0, I0 + LB / 2) of one row whose keys kk hold (lanes past n the
// largest key, which no real pair follows): o gets, at position rank, the
// lane whose (key, lane) has rank pairs before it.
template <int LB, int I0>
__device__ __forceinline__ void rank_half(const unsigned (&kk)[LB],
                                          unsigned char* o, int n) {
#pragma unroll
  for (int i = I0; i < I0 + LB / 2; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < LB; ++j)
      if (j != i) rank += j < i ? kk[j] <= kk[i] : kk[j] < kk[i];
    if (i < n) o[rank] = (unsigned char)i;
  }
}

// Order the nr rows of the tile's valid trials.  LB > 0: two
// threads per (row, trial), each half of the lanes, the row's keys in
// registers (a warp's threads take the same half); LB <= 0: a thread per
// (row, trial, lane).
template <int LB>
__device__ __forceinline__ void rank_rows(const unsigned* keys,
                                          lane_t<LB>* ord, int np, int n,
                                          int nr, const int* svalid) {
  constexpr int T = ST_TILE;
  if constexpr (LB > 0) {
    const int pairs = nr * T;
    for (int e = threadIdx.x; e < 2 * pairs; e += blockDim.x) {
      const int h = e >= pairs, pair = e - h * pairs;
      const int rl = pair / T, s = pair - rl * T;
      if (!svalid[s] || h * (LB / 2) >= n) continue;
      const unsigned* x = keys + (size_t)(rl * T + s) * n;
      unsigned char* o = ord + (rl * T + s) * np;
      unsigned kk[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) kk[j] = j < n ? x[j] : 0xffffffffu;
      if (h)
        rank_half<LB, LB / 2>(kk, o, n);
      else
        rank_half<LB, 0>(kk, o, n);
    }
  } else {
    for (int e = threadIdx.x; e < nr * T * n; e += blockDim.x) {
      const int pair = e / n, i = e - pair * n;
      const int rl = pair / T, s = pair - rl * T;
      if (!svalid[s]) continue;
      const unsigned* x = keys + (size_t)(rl * T + s) * n;
      const unsigned ki = x[i];
      int rank = 0;
      for (int j = 0; j < i; ++j) rank += x[j] <= ki;
      for (int j = i + 1; j < n; ++j) rank += x[j] < ki;
      ord[(size_t)(rl * T + s) * np + rank] = (lane_t<LB>)i;
    }
  }
}

// Source row r of trial s: the K val_arr rows, then arrive, then classic.
__device__ __forceinline__ const float* row_src(const StreamArgs& a, int r,
                                                size_t s) {
  if (r < a.K) return a.val + (s * a.K + r) * a.n;
  return (r == a.K ? a.arr : a.cls) + s * a.n;
}

// Start the asynchronous copies of the K + 2 rows of the tile's cnt trials
// into keys (ST_TILE rows apart; with glob, plain copies into device
// memory); with conv, turn this thread's copies into order keys once they
// have landed.
__device__ __forceinline__ void stage_rows(const StreamArgs& a, unsigned* keys,
                                           int s0, int cnt, bool glob,
                                           bool conv) {
  const int n = a.n, R = a.K + 2, T = ST_TILE;
  if (a.vec) {
    const int n4 = n / 4, per = cnt * n4;
    for (int e = threadIdx.x; e < R * per; e += blockDim.x) {
      const int r = e / per, rem = e - r * per;
      const int s = rem / n4, i4 = rem - s * n4;
      uint4* d =
          reinterpret_cast<uint4*>(keys + (size_t)(r * T + s) * n) + i4;
      const float* src = row_src(a, r, s0 + s) + 4 * i4;
      if (conv) {
        uint4 v = *d;
        *d = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z),
                        order_key(v.w));
      } else if (glob) {
        *d = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        cp_async16(d, src, 16);
      }
    }
  } else {
    const int per = cnt * n;
    for (int e = threadIdx.x; e < R * per; e += blockDim.x) {
      const int r = e / per, rem = e - r * per;
      const int s = rem / n, i = rem - s * n;
      unsigned* d = keys + (size_t)(r * T + s) * n + i;
      const float* src = row_src(a, r, s0 + s) + i;
      if (conv)
        *d = order_key(*d);
      else if (glob)
        *d = __float_as_uint(__ldg(src));
      else
        cp_async4(d, src);
    }
  }
}

// Warp `warp` lists the live rows of system m, each phase in row order (a
// row whose weights are all zero and whose threshold is positive never
// crosses), a lane per row, 32 rows of all phases at a time; with RES it
// writes them into the system's resident groups instead.  The lists lie at
// tb (shared memory, or the block's device memory with glob).
template <int LB, bool RES>
__device__ __forceinline__ void live_rows(const StreamArgs& a,
                                          const StreamLayout& L,
                                          unsigned char* smem,
                                          unsigned char* tb, int warp,
                                          int m) {
  const int n = a.n, lane = threadIdx.x & 31;
  const int lo1 = a.G[0], lo2 = a.G[0] + a.G[1];
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(tb + L.lists) + warp * L.gt;
  float* res = reinterpret_cast<float*>(smem + L.wts + warp * L.wsys);
  int cnt[3] = {0, 0, 0};
  for (int g0 = 0; g0 < L.gt; g0 += 32) {
    const int ga = g0 + lane;
    const int p = ga < lo1 ? 0 : (ga < lo2 ? 1 : 2);
    const int g = ga - pick(p, 0, lo1, lo2);
    const int G = pick(p, a.G[0], a.G[1], a.G[2]);
    const float* wr =
        pick(p, a.w[0], a.w[1], a.w[2]) + ((size_t)m * G + g) * n;
    const float* tr =
        pick(p, a.t[0], a.t[1], a.t[2]) + (size_t)m * G + g;
    constexpr int LW = LB > 0 ? LB : 4;  // weights held in registers
    float th = 0.0f, wv[LW];
    bool live = false;
    if (ga < L.gt) {
      th = __ldg(tr);
      live = !(th > 0.0f);
      if (LB > 0 && a.vec) {  // n % 4 == 0, rows 16-byte aligned
#pragma unroll
        for (int i = 0; i < LW; i += 4) {
          const float4 v = i < n ? __ldg(reinterpret_cast<const float4*>(wr) +
                                         i / 4)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          wv[i] = v.x;
          wv[i + 1] = v.y;
          wv[i + 2] = v.z;
          wv[i + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < LW; ++i) live |= wv[i] != 0.0f;
      } else if (LB > 0) {
#pragma unroll
        for (int i = 0; i < LW; ++i) {
          wv[i] = i < n ? __ldg(wr + i) : 0.0f;
          live |= wv[i] != 0.0f;
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < n; ++i) live |= __ldg(wr + i) != 0.0f;
      }
    }
    const unsigned b = __ballot_sync(FULL, live);
    const unsigned in0 = b & __ballot_sync(FULL, ga < L.gt && p == 0);
    const unsigned in1 = b & __ballot_sync(FULL, ga < L.gt && p == 1);
    const unsigned in2 = b & __ballot_sync(FULL, ga < L.gt && p == 2);
    if (live) {  // position pos among phase p's live rows
      const int pos = pick(p, cnt[0], cnt[1], cnt[2]) +
                      __popc(pick(p, in0, in1, in2) & ((1u << lane) - 1u));
      if (!RES) {
        lists[pick(p, 0, lo1, lo2) + pos] = (unsigned short)g;
      } else {  // component pos % 4 of group pos / 4
        float* st = res + pick(p, 0, L.ng[0] * (n + 1),
                               (L.ng[0] + L.ng[1]) * (n + 1)) * 4;
        float* d = st + pick(p, L.ng[0], L.ng[1], L.ng[2]) * 4 +
                   (pos >> 2) * n * 4 + (pos & 3);
        st[pos] = th;
        if (LB > 0) {
#pragma unroll
          for (int i = 0; i < LW; ++i)
            if (i < n) d[4 * i] = wv[i];
        } else {
          for (int i = 0; i < n; ++i) d[4 * i] = __ldg(wr + i);
        }
      }
    }
    cnt[0] += __popc(in0);
    cnt[1] += __popc(in1);
    cnt[2] += __popc(in2);
  }
  if (lane == 0) {
    int* nlive = reinterpret_cast<int*>(smem + L.nlive) + warp * 3;
    nlive[0] = cnt[0];
    nlive[1] = cnt[1];
    nlive[2] = cnt[2];
  }
  if (!RES) return;
  // the last group's unused rows: zero weights, a threshold never reached.
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float* st = res + pick(q, 0, L.ng[0] * (n + 1),
                           (L.ng[0] + L.ng[1]) * (n + 1)) * 4;
    float* sw = st + pick(q, L.ng[0], L.ng[1], L.ng[2]) * 4;
    const int nl = cnt[q], end = (nl + 3) & ~3;
    for (int i = lane; i <= n; i += 32)
      for (int pos = nl; pos < end; ++pos) {
        if (i == n)
          st[pos] = INFINITY;
        else
          sw[((pos >> 2) * n + i) * 4 + (pos & 3)] = 0.0f;
      }
  }
}

// Phase p of the system in warp slot w (system m); its list lies at tb.
template <bool RES>
__device__ __forceinline__ Phase phase(const StreamArgs& a,
                                       const StreamLayout& L,
                                       const unsigned char* smem,
                                       const unsigned char* tb, int w, int m,
                                       int p) {
  Phase ph;
  ph.n = a.n;
  ph.G = pick(p, a.G[0], a.G[1], a.G[2]);
  ph.st = reinterpret_cast<const float4*>(smem + L.wts + w * L.wsys) +
          pick(p, 0, L.ng[0] * (ph.n + 1), (L.ng[0] + L.ng[1]) * (ph.n + 1));
  ph.sw = ph.st + pick(p, L.ng[0], L.ng[1], L.ng[2]);
  ph.w = pick(p, a.w[0], a.w[1], a.w[2]) + (size_t)m * ph.G * ph.n;
  ph.t = pick(p, a.t[0], a.t[1], a.t[2]) + (size_t)m * ph.G;
  ph.list = reinterpret_cast<const unsigned short*>(tb + L.lists) +
            w * L.gt + pick(p, 0, a.G[0], a.G[0] + a.G[1]);
  ph.nl = reinterpret_cast<const int*>(smem + L.nlive)[w * 3 + p];
  ph.ng = (ph.nl + 3) / 4;
  return ph;
}

// Grid (blocks per system group, system groups).  A block of
// 32 * max(mg, ST_MIN_WARPS) threads walks the tiles of 32 trials
// blockIdx.x, blockIdx.x + gridDim.x, ...; warp w tallies system
// blockIdx.y * mg + w, one trial a lane.  Per tile: stage the votes and
// rows with 16-byte asynchronous copies (the first tile's copies overlap
// the listing of the live rows), order every row once, then every warp
// decides its system's trials.  Where the tile and the lists do not fit in
// shared memory (a.scratch), they lie in the block's part of a
// device-memory scratch, staged with plain copies.  The counts and the
// latency sum and max stay in each warp's registers across tiles; the
// histogram goes to device memory with one atomic per distinct bucket of a
// warp.  The last block of a group to finish
// reduces the group's per-block partials in block order.  The launch bounds
// hold a block of 16 warps to 64 registers a thread, so that two blocks of
// the main path's 13 warps share an SM.
template <int LB, bool RES>
__global__ void __launch_bounds__(ST_TILE * ST_MAX_MG, 2)
    stream_kernel(const StreamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int n = a.n, K = a.K, R = K + 2, T = ST_TILE;
  const bool glob = !RES && a.scratch;
  const StreamLayout L = stream_layout(n, K, a.G, a.mg, LB, RES, glob);
  // the tile's rows, orders, votes and masks: in shared memory, or in this
  // block's part of the device-memory scratch
  unsigned char* tb =
      glob ? a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * L.big
           : smem;
  unsigned* keys = reinterpret_cast<unsigned*>(tb + L.keys);
  int* svotes = reinterpret_cast<int*>(tb + L.votes);
  lane_t<LB>* ord = reinterpret_cast<lane_t<LB>*>(tb + L.ord);
  unsigned* vm = reinterpret_cast<unsigned*>(tb + L.vm);
  int* svalid = reinterpret_cast<int*>(smem + L.valid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = blockIdx.y * a.mg + warp;
  const bool owner = warp < a.mg && m < a.M;
  const float big = 2.0f * a.und;

  float run_sum = 0.0f, run_max = -INFINITY;
  int cf = 0, cr = 0, cu = 0;
  const int tiles = (a.S + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * T;
    const int cnt = min(T, a.S - s0);
    __syncthreads();  // the previous tile is done with shared memory
    if (glob) {
      for (int e = tid; e < cnt * n; e += blockDim.x)
        svotes[e] = __ldg(a.votes + (size_t)s0 * n + e);
    } else if (a.vec) {
      for (int e = tid; e < cnt * n / 4; e += blockDim.x)
        cp_async16(svotes + 4 * e, a.votes + (size_t)s0 * n + 4 * e, 16);
    } else {
      for (int e = tid; e < cnt * n; e += blockDim.x)
        cp_async4(svotes + e, a.votes + (size_t)s0 * n + e);
    }
    stage_rows(a, keys, s0, cnt, glob, false);
    cp_async_commit();
    if (tid < T) svalid[tid] = tid < cnt && a.valid[s0 + tid];
    if (owner && tile == (int)blockIdx.x)
      live_rows<LB, RES>(a, L, smem, tb, warp, m);
    cp_async_wait<0>();
    stage_rows(a, keys, s0, cnt, glob, true);
    __syncthreads();
    for (int e = tid; e < K * L.W * T; e += blockDim.x) {
      const int s = e % T, vq = e / T;
      const int v = vq / L.W, q = vq - v * L.W;
      unsigned b = 0;
      if (svalid[s]) {
        const int* vr = svotes + s * n + 32 * q;
        const int nb = min(32, n - 32 * q);
        for (int j = 0; j < nb; ++j) b |= (unsigned)(vr[j] == v) << j;
      }
      vm[e] = b;
    }
    rank_rows<LB>(keys, ord, L.np, n, R, svalid);
    __syncthreads();
    if (!owner) continue;
    // Each warp: its system, one trial a lane.
    const int s = lane;
    bool fast = false, recb = false, und = false;
    float lat = 0.0f;
    if (svalid[s]) {
      const Phase ph = phase<RES>(a, L, smem, tb, warp, m, 2);
      const int best = tally<RES>(ph, vm + s, L.W, K);
      Ord<LB> o;
      if (best < K) {
        o.load(ord + (size_t)(best * T + s) * L.np);
        lat = sat_time<LB, RES>(o, ph, a.k[2], big,
                                keys + (size_t)(best * T + s) * n);
        fast = lat < a.und;
      }
      if (!fast) {
        float t[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int r = K + p;
          o.load(ord + (size_t)(r * T + s) * L.np);
          t[p] = sat_time<LB, RES>(o, phase<RES>(a, L, smem, tb, warp, m, p),
                                   a.k[p], big,
                                   keys + (size_t)(r * T + s) * n);
        }
        lat = __fadd_rn(t[0], t[1]);
        und = lat >= a.und;
        recb = !und;
      }
    }
    const bool dec = fast || recb;
    const unsigned dm = __ballot_sync(FULL, dec);
    if (dec) {
      const int bin = sketch_bucket(lat, a.log_g, a.bins);
      const unsigned peers = __match_any_sync(dm, bin);
      if (lane == __ffs(peers) - 1)
        atomicAdd(a.hist + (size_t)m * a.bins + bin, __popc(peers));
    }
    cf += __popc(__ballot_sync(FULL, fast));
    cr += __popc(__ballot_sync(FULL, recb));
    cu += __popc(__ballot_sync(FULL, und));
    float ts = dec ? lat : 0.0f, tm = dec ? lat : -INFINITY;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      ts = __fadd_rn(ts, __shfl_down_sync(FULL, ts, off));
      tm = fmaxf(tm, __shfl_down_sync(FULL, tm, off));
    }
    run_sum = __fadd_rn(run_sum, ts);
    run_max = fmaxf(run_max, tm);
  }

  const int nbx = gridDim.x;
  if (owner && lane == 0) {
    const size_t pb = (size_t)m * nbx + blockIdx.x;
    a.psum[pb] = run_sum;
    a.pmax[pb] = run_max;
    a.pcnt[3 * pb] = cf;
    a.pcnt[3 * pb + 1] = cr;
    a.pcnt[3 * pb + 2] = cu;
    __threadfence();  // the partials before the ticket
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + blockIdx.y, 1) == nbx - 1;
  __syncthreads();
  if (!last) return;
  if (owner) {
    // lane l adds the partials of blocks l, l + 32, ... in order, eight
    // blocks in flight at a time; then a fixed tree over the lanes.
    float ts = 0.0f, tm = -INFINITY;
    int c0 = 0, c1 = 0, c2 = 0;
    for (int b0 = lane; b0 < nbx; b0 += 8 * 32) {
      float ps[8], pm[8];
      int pc[8][3];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + 32 * u;
        const size_t pb = (size_t)m * nbx + b;
        ps[u] = b < nbx ? __ldcg(a.psum + pb) : 0.0f;
        pm[u] = b < nbx ? __ldcg(a.pmax + pb) : -INFINITY;
#pragma unroll
        for (int f = 0; f < 3; ++f)
          pc[u][f] = b < nbx ? __ldcg(a.pcnt + 3 * pb + f) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        ts = __fadd_rn(ts, ps[u]);
        tm = fmaxf(tm, pm[u]);
        c0 += pc[u][0];
        c1 += pc[u][1];
        c2 += pc[u][2];
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      ts = __fadd_rn(ts, __shfl_down_sync(FULL, ts, off));
      tm = fmaxf(tm, __shfl_down_sync(FULL, tm, off));
      c0 += __shfl_down_sync(FULL, c0, off);
      c1 += __shfl_down_sync(FULL, c1, off);
      c2 += __shfl_down_sync(FULL, c2, off);
    }
    if (lane == 0) {
      a.sum[m] = ts;
      a.max[m] = tm;
      a.counts[m] = c0;
      a.counts[a.M + m] = c1;
      a.counts[2 * a.M + m] = c2;
    }
  }
  if (tid == 0) a.tickets[blockIdx.y] = 0;
}

template <int LB, bool RES>
static int stream_plan_for(int n, int K, int M, const int* G, bool glob,
                           int* out) {
  const int cap = M < ST_MAX_MG ? M : ST_MAX_MG;
  for (int mg = cap; mg >= 1; --mg) {
    const StreamLayout L = stream_layout(n, K, G, mg, LB, RES, glob);
    if (L.bytes > ST_MAX_SMEM || L.big > ST_MAX_SCRATCH) continue;
    cudaError_t e = cudaFuncSetAttribute(
        stream_kernel<LB, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ST_MAX_SMEM);
    const int threads = ST_TILE * (mg > ST_MIN_WARPS ? mg : ST_MIN_WARPS);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_kernel<LB, RES>, threads, L.bytes);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    out[0] = mg;
    out[1] = threads;
    out[2] = (int)L.bytes;
    out[3] = (per_sm > 0 ? per_sm : 1) * sms;
    out[4] = RES;
    out[5] = (int)L.big;
    return 0;
  }
  return -1;
}

// The first plan whose layout fits: masks resident in shared memory, else
// read from device memory through lists of live rows in shared memory,
// else the tile and the lists staged in device memory (shared memory then
// holds only the valid bits and the list counts), up to ST_MAX_SCRATCH a
// block: (K + 2) n of about 6.7 M for the tile of 32 trials.
template <int LB>
static int stream_plan(int n, int K, int M, const int* G, int* out) {
  int err = stream_plan_for<LB, true>(n, K, M, G, false, out);
  if (err == -1) err = stream_plan_for<LB, false>(n, K, M, G, false, out);
  if (err == -1) err = stream_plan_for<LB, false>(n, K, M, G, true, out);
  return err;
}

template <int LB, bool RES>
static void stream_launch(const StreamArgs& a, dim3 grid, int threads,
                          int smem, cudaStream_t st) {
  stream_kernel<LB, RES><<<grid, threads, smem, st>>>(a);
}

// ---------------------------------------------------------------------------
// race_card_hist
// ---------------------------------------------------------------------------

#define RC_TILE 64          // trials a tile
#define RC_THREADS 512      // threads a block aims at, in groups of columns
#define RC_MAX_THREADS 1024
#define RC_NR 16            // rows of at most RC_NR lanes are ranked in
                            // registers
#define RC_BATCH 16         // partials a thread loads at once in a reduction

// What one launch reads and writes.  Column c < P is recovery pair c, column
// P + j the fast side's j-th winner arrival; a cell is (slot v, column c).
struct CardArgs {
  const int* votes;
  const float* arr;
  const float* cls;
  const unsigned char* valid;
  const int* pairs;
  int S, n, K, P, k1, kr, k2f, bins;
  int G, q32;   // groups of column threads, column threads a group
  int gb;       // blocks a reduction group
  float log_g, und, big;
  unsigned char* scratch;  // the blocks' regions of `region` bytes of device
  long long region;        // memory, where they work there
  int* FH;
  int* RH;
  int* cnt;
  int* tickets;
  float* Fsum;
  float* Fmax;
  float* Rsum;
  float* Rmax;
  uint2* part;   // per-block partials, then per-reduction-group ones: cells
  uint2* gpart;  // each, a cell (sum bits, max as an order key, 0 = none)
};

// A block's working memory, in bytes, each region 16-byte aligned:
// votes, ka, kc  the tile's votes and the order keys of its arrive and
//                classic rows (RC_TILE x n each)
// ok, mx, nf     a trial's valid bit, its max count and the count of its
//                k2f first winner arrivals below und
// pre            a trial's ascending prefixes, pw floats: k2f winner
//                arrivals, then k1 arrive, then kr classic
// acc            each group's running sum and max of each cell, (group,
//                slot, column)
// cnt            the trials of each slot
struct CardLayout {
  int pw;
  size_t votes, ka, kc, ok, mx, nf, pre, acc, cnt, bytes;
};

__host__ __device__ inline CardLayout card_layout(int n, int P, int k1,
                                                  int kr, int k2f, int G) {
  const int T = RC_TILE;
  const size_t cells = (size_t)(k2f + 1) * (P + k2f);
  CardLayout L;
  L.pw = k2f + k1 + kr;
  size_t o = 0;
  L.votes = st_take(o, (size_t)T * n * 4);
  L.ka = st_take(o, (size_t)T * n * 4);
  L.kc = st_take(o, (size_t)T * n * 4);
  L.ok = st_take(o, T * 4);
  L.mx = st_take(o, T * 4);
  L.nf = st_take(o, T * 4);
  L.pre = st_take(o, (size_t)T * L.pw * 4);
  L.acc = st_take(o, (size_t)G * cells * 8);
  L.cnt = st_take(o, (size_t)(k2f + 1) * 4);
  L.bytes = o;
  return L;
}

// The winner (first maximum of the vote counts) of one row of n votes, and
// its count in best: tally_decide's passes of PASS_K values.
__device__ __forceinline__ int tally_winner(const int* row, int n, int K,
                                            int& best) {
  int w = 0, c[PASS_K];
  best = 0;
  for (int base = 0; base < K; base += PASS_K) {
    count_row(row, n, base, c);
    first_max(c, base, K, best, w);
  }
  return w;
}

// Fold cell partial p into (sum, m) after the ones before it.
__device__ __forceinline__ void fold(float& sum, unsigned& m, uint2 p) {
  sum = __fadd_rn(sum, __uint_as_float(p.x));
  m = max(m, p.y);
}

// Cell e of partial rows [0, nb) (rows `cells` apart) reduced in row order;
// the loads of RC_BATCH rows are in flight at once (a batch past nb
// reloads row nb - 1).
__device__ __forceinline__ uint2 reduce_cell(const uint2* part,
                                             long long cells, long long e,
                                             int nb) {
  float sum = 0.0f;
  unsigned m = 0u;
  for (int b0 = 0; b0 < nb; b0 += RC_BATCH) {
    uint2 x[RC_BATCH];
#pragma unroll
    for (int u = 0; u < RC_BATCH; ++u)
      x[u] = __ldcg(part + (size_t)min(b0 + u, nb - 1) * cells + e);
#pragma unroll
    for (int u = 0; u < RC_BATCH; ++u)
      if (b0 + u < nb) fold(sum, m, x[u]);
  }
  return make_uint2(__float_as_uint(sum), m);
}

// Grid (blocks): block b walks the tiles of RC_TILE trials b, b + gridDim.x,
// ...  Per tile: stage the votes and the order keys of arrive and classic,
// then order each valid trial's three rows -- the winner's arrivals
// (arrive where it voted the winner, else big), arrive, classic -- by
// (key, lane), keeping the k2f / k1 / kr first, values only: for n <=
// RC_NR a thread a row with the row in registers, else a thread a lane
// counting the lanes before it.  The thread of the winner's row decides the
// winner from the staged votes.  Then the histograms, a warp a (column, 32
// trials), equal cells merged before their atomic; then the sums: thread
// (g, cl) takes the trials g, g + G, ... of the tile and columns cl, cl +
// q32, ..., and where the trial adds to the cell, a plain add and max on
// the group's own cell.  Each cell of a group is one thread's, updated in
// trial order, so its sum has one order.  At the end the block's partials (its
// groups' in group order) go to device memory, and the last block of each
// reduction group, then the last group, found with a fence and an atomic
// ticket each, reduce them in block and group order.  GLOB: the block
// works in its region of device memory instead of shared memory.
template <bool GLOB>
__global__ void __launch_bounds__(RC_MAX_THREADS)
    race_card_kernel(const CardArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int n = a.n, T = RC_TILE, V = a.k2f + 1, Q = a.P + a.k2f;
  const long long cells = (long long)V * Q;
  const CardLayout L = card_layout(n, a.P, a.k1, a.kr, a.k2f, a.G);
  unsigned char* tb =
      GLOB ? a.scratch + (size_t)blockIdx.x * a.region : smem;
  int* sv = reinterpret_cast<int*>(tb + L.votes);
  unsigned* ka = reinterpret_cast<unsigned*>(tb + L.ka);
  unsigned* kc = reinterpret_cast<unsigned*>(tb + L.kc);
  int* sok = reinterpret_cast<int*>(tb + L.ok);
  int* smx = reinterpret_cast<int*>(tb + L.mx);
  int* snf = reinterpret_cast<int*>(tb + L.nf);
  float* pre = reinterpret_cast<float*>(tb + L.pre);
  uint2* acc = reinterpret_cast<uint2*>(tb + L.acc);
  int* scnt = reinterpret_cast<int*>(tb + L.cnt);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = tid / a.q32, cl = tid - g * a.q32;
  const unsigned kbig = order_key(__float_as_uint(a.big));
  // the pair of this thread's first column, held in registers
  int q1c = 1, qrc = 1;
  if (cl < a.P) {
    q1c = __ldg(a.pairs + 2 * cl);
    qrc = __ldg(a.pairs + 2 * cl + 1);
  }
  for (long long e = tid; e < a.G * cells; e += nt) acc[e] = make_uint2(0u, 0u);
  for (int v = tid; v < V; v += nt) scnt[v] = 0;

  const int tiles = (a.S + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * T, cnt = min(T, a.S - s0), per = cnt * n;
    const size_t base = (size_t)s0 * n;
    __syncthreads();  // the previous tile's columns are done
    for (int e = tid; e < per; e += nt) {
      sv[e] = __ldg(a.votes + base + e);
      ka[e] = order_key(__float_as_uint(__ldg(a.arr + base + e)));
      kc[e] = order_key(__float_as_uint(__ldg(a.cls + base + e)));
    }
    for (int s = tid; s < cnt; s += nt) {
      sok[s] = a.valid[s0 + s];
      snf[s] = 0;
    }
    __syncthreads();
    if (n <= RC_NR) {
      // a thread a row: its RC_NR keys in registers (lanes past n the
      // largest key, which no real lane follows), every rank at once
      for (int e = tid; e < 3 * cnt; e += nt) {
        const int r = e / cnt, s = e - r * cnt;
        if (!sok[s]) continue;
        const int* vr = sv + s * n;
        const unsigned* kx = (r == 2 ? kc : ka) + s * n;
        int w = 0;
        if (r == 0) {
          int best;
          w = tally_winner(vr, n, a.K, best);
          smx[s] = best;
        }
        unsigned kk[RC_NR];
#pragma unroll
        for (int j = 0; j < RC_NR; ++j) {
          kk[j] = 0xffffffffu;
          if (j < n) kk[j] = (r == 0 && vr[j] != w) ? kbig : kx[j];
        }
        const int k = r == 0 ? a.k2f : (r == 1 ? a.k1 : a.kr);
        float* out = pre + s * L.pw + (r == 0 ? 0 : (r == 1 ? a.k2f
                                                           : a.k2f + a.k1));
        int nf = 0;
#pragma unroll
        for (int i = 0; i < RC_NR; ++i) {
          int rank = 0;
#pragma unroll
          for (int j = 0; j < RC_NR; ++j)
            if (j != i) rank += j < i ? kk[j] <= kk[i] : kk[j] < kk[i];
          if (i < n && rank < k) {
            const float x = key_value(kk[i]);
            out[rank] = x;
            nf += x < a.und;
          }
        }
        if (r == 0) snf[s] = nf;
      }
    } else {
      // a thread a lane: the lanes before it in (key, lane) order
      for (int e = tid; e < 3 * per; e += nt) {
        const int r = e / per, rem = e - r * per;
        const int s = rem / n, i = rem - s * n;
        if (!sok[s]) continue;
        const int* vr = sv + s * n;
        const unsigned* kx = (r == 2 ? kc : ka) + s * n;
        unsigned ki = kx[i];
        int rank = 0;
        if (r == 0) {
          int best;
          const int w = tally_winner(vr, n, a.K, best);
          if (i == 0) smx[s] = best;
          if (vr[i] != w) ki = kbig;
          for (int j = 0; j < n; ++j) {
            const unsigned kj = vr[j] == w ? kx[j] : kbig;
            rank += j < i ? kj <= ki : kj < ki;
          }
        } else {
          for (int j = 0; j < n; ++j)
            rank += j < i ? kx[j] <= ki : kx[j] < ki;
        }
        if (rank < (r == 0 ? a.k2f : (r == 1 ? a.k1 : a.kr))) {
          const float x = key_value(ki);
          pre[s * L.pw + (r == 0 ? 0 : (r == 1 ? a.k2f : a.k2f + a.k1)) +
              rank] = x;
          if (r == 0 && x < a.und) atomicAdd(snf + s, 1);
        }
      }
    }
    __syncthreads();
    // histograms: a warp takes a column and 32 trials, a trial a lane;
    // lanes with the same cell are merged (__match_any_sync) and the
    // lowest adds their count with one atomic
    const int lane = tid & 31, halves = (cnt + 31) >> 5;
    for (int t = tid >> 5; t < Q * halves; t += nt >> 5) {
      const int c = t / halves, s = (t - c * halves) * 32 + lane;
      int key = -1;  // -1: the lane adds nothing
      if (s < cnt && sok[s]) {
        const int v = min(smx[s], snf[s]);
        const float* ps = pre + s * L.pw;
        if (c < a.P) {
          const float x =
              __fadd_rn(ps[a.k2f + __ldg(a.pairs + 2 * c) - 1],
                        ps[a.k2f + a.k1 + __ldg(a.pairs + 2 * c + 1) - 1]);
          key = v * (a.bins + 1) +
                (x < a.und ? sketch_bucket(x, a.log_g, a.bins) : a.bins);
        } else if (c - a.P < v) {
          key = v * a.bins + sketch_bucket(ps[c - a.P], a.log_g, a.bins);
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(peers) - 1)
        atomicAdd((c < a.P ? a.RH + (size_t)c * V * (a.bins + 1)
                           : a.FH + (size_t)(c - a.P) * V * a.bins) +
                      key,
                  __popc(peers));
    }
    // sums and maxima: thread (g, cl) adds trials g, g + G, ... of its
    // columns to its own cells, in trial order
    for (int s = g; s < cnt; s += a.G) {
      if (!sok[s]) continue;
      const int v = min(smx[s], snf[s]);  // the trial's slot: its fcap
      if (cl == 0) atomicAdd(scnt + v, 1);
      const float* ps = pre + s * L.pw;
      for (int c = cl; c < Q; c += a.q32) {
        float x;
        if (c < a.P) {
          int q1 = q1c, qr = qrc;
          if (c != cl) {
            q1 = __ldg(a.pairs + 2 * c);
            qr = __ldg(a.pairs + 2 * c + 1);
          }
          x = __fadd_rn(ps[a.k2f + q1 - 1], ps[a.k2f + a.k1 + qr - 1]);
          if (!(x < a.und)) continue;
        } else {
          const int j = c - a.P;
          if (j >= v) continue;
          x = ps[j];
        }
        uint2& cell = acc[((size_t)g * V + v) * Q + c];
        const uint2 was = cell;
        cell = make_uint2(__float_as_uint(__fadd_rn(__uint_as_float(was.x),
                                                    x)),
                          max(was.y, order_key(__float_as_uint(x))));
      }
    }
  }
  __syncthreads();

  // the block's partials: its groups' cells in group order
  uint2* mine = a.part + (size_t)blockIdx.x * cells;
  for (long long e = tid; e < cells; e += nt) {
    float sum = 0.0f;
    unsigned m = 0u;
    for (int q = 0; q < a.G; ++q) fold(sum, m, acc[q * cells + e]);
    mine[e] = make_uint2(__float_as_uint(sum), m);
  }
  for (int v = tid; v < V; v += nt)
    if (scnt[v]) atomicAdd(a.cnt + v, scnt[v]);
  __threadfence();  // the partials before the ticket
  __syncthreads();
  const int nbx = gridDim.x, gb = a.gb, ngrp = (nbx + gb - 1) / gb;
  const int grp = blockIdx.x / gb, b0 = grp * gb, nb = min(gb, nbx - b0);
  if (tid == 0) last = atomicAdd(a.tickets + grp, 1) == nb - 1;
  __syncthreads();
  if (!last) return;
  // the last block of its reduction group: the group's partials in block
  // order
  for (long long e = tid; e < cells; e += nt)
    a.gpart[(size_t)grp * cells + e] =
        reduce_cell(a.part + (size_t)b0 * cells, cells, e, nb);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + ngrp, 1) == ngrp - 1;
  __syncthreads();
  if (!last) return;
  // the last group: the groups' partials in group order, into the outputs
  for (long long e = tid; e < cells; e += nt) {
    const uint2 r = reduce_cell(a.gpart, cells, e, ngrp);
    const int v = (int)(e / Q), c = (int)(e - (long long)v * Q);
    const float sum = __uint_as_float(r.x);
    const float mx = r.y ? key_value(r.y) : -INFINITY;
    if (c < a.P) {
      a.Rsum[(size_t)c * V + v] = sum;
      a.Rmax[(size_t)c * V + v] = mx;
    } else {
      a.Fsum[(size_t)(c - a.P) * V + v] = sum;
      a.Fmax[(size_t)(c - a.P) * V + v] = mx;
    }
  }
}

// ---------------------------------------------------------------------------
// masked_sat
// ---------------------------------------------------------------------------

#define MS_THREADS 256              // trials a block takes at once, one a thread
#define MS_SOFT_SMEM (96 * 1024)    // a block's rows where two blocks fit an SM
#define MS_MAX_GRID_Y 65535         // system groups of a launch

// What one launch reads and writes.  Row s of system m's order is
// x + m xm + s xs (arrivals) and perm + m pm + s ps (acceptor ids); pm = 0
// is one order for every system.
struct SatArgs {
  const float* x;
  const long long* perm;
  const float* w;     // (M, G, n)
  const float* t;     // (M, G)
  float* out;         // (M, S)
  long long xs, xm, ps, pm;
  int S, L, n, M, G, mg, ngmax;
  int vec;            // perm rows 16-byte aligned: two ids a load
  float big;
};

// A system's rows in shared memory, 16 * (1 + ngmax (n + 1)) bytes: this
// header, ngmax float4 thresholds, then ngmax x n float4 weights (group gi,
// lane l: the four rows' weights of l).  Its nl live rows fill ng groups of
// four, the monotone ones first (ngm groups hold monotone rows only), the
// last group padded with copies of the last live row (a copy crosses where
// its row does, so it changes no minimum); dead: some row never reaches
// its threshold.
struct SatSys {
  int ng, ngm, nl, dead;
};

__host__ __device__ inline size_t sat_sys_bytes(int n, int ngmax) {
  return 16 * (1 + (size_t)ngmax * (n + 1));
}

// Row g's kind.  dead: it can never reach its threshold (a NaN threshold,
// or all weights zero and a positive threshold); mono: no weight negative
// or NaN, so its running sum never falls and it reaches its threshold
// exactly when it crosses it somewhere.
__device__ __forceinline__ void sat_row_kind(const float* wr, float tg, int n,
                                             bool& dead, bool& mono) {
  bool zero = true;
  mono = true;
  for (int l = 0; l < n; ++l) {
    const float v = __ldg(wr + l);
    zero &= v == 0.0f;
    mono &= v >= 0.0f;
  }
  dead = !(tg == tg) || (zero && tg > 0.0f);
}

// Slot q of a system's rows: lane l's weight.
__device__ __forceinline__ float* sat_wslot(float* sw, int n, int q, int l) {
  return sw + ((size_t)(q >> 2) * n + l) * 4 + (q & 3);
}

// One warp stages system m's live rows at sys: the monotone rows upward
// from slot 0 and the others downward from the top slot, in one pass over
// the rows; then the others move down behind the monotone ones (rare: a
// negative or NaN weight) and the last group is padded.
__device__ void sat_stage(const SatArgs& a, int m, unsigned char* sys) {
  const int lane = threadIdx.x & 31, n = a.n, G = a.G, top = 4 * a.ngmax;
  const float* wm = a.w + (size_t)m * G * n;
  const float* tm = a.t + (size_t)m * G;
  float* st = reinterpret_cast<float*>(sys + 16);
  float* sw = st + 4 * a.ngmax;
  const unsigned lt = (1u << lane) - 1u;
  int nm = 0, nn = 0;
  bool dead_any = false;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    bool dead = false, mono = true;
    float tg = 0.0f;
    if (g < G) {
      tg = __ldg(tm + g);
      sat_row_kind(wm + (size_t)g * n, tg, n, dead, mono);
    }
    const bool lm = g < G && !dead && mono, ln = g < G && !dead && !mono;
    const unsigned bm = __ballot_sync(FULL, lm), bn = __ballot_sync(FULL, ln);
    dead_any |= __any_sync(FULL, g < G && dead);
    if (lm || ln) {
      const int q = lm ? nm + __popc(bm & lt) : top - 1 - nn - __popc(bn & lt);
      st[q] = tg;
      const float* wr = wm + (size_t)g * n;
      for (int l = 0; l < n; ++l) *sat_wslot(sw, n, q, l) = __ldg(wr + l);
    }
    nm += __popc(bm);
    nn += __popc(bn);
  }
  __syncwarp();
  // the others lie in [top - nn, top) and belong in [nm, nm + nn): those
  // outside it, [top - c, top), go to the slots of it still free, [nm, nm +
  // c) (the two ranges are disjoint)
  const int c = nn - max(0, nm + 2 * nn - top);
  for (int i = 0; i < c; ++i) {
    const int from = top - c + i, to = nm + i;
    if (lane == 0) st[to] = st[from];
    for (int l = lane; l < n; l += 32)
      *sat_wslot(sw, n, to, l) = *sat_wslot(sw, n, from, l);
  }
  __syncwarp();
  const int nl = nm + nn, ng = (nl + 3) >> 2;
  for (int q = nl; q < 4 * ng; ++q) {
    if (lane == 0) st[q] = st[nl - 1];
    for (int l = lane; l < n; l += 32)
      *sat_wslot(sw, n, q, l) = *sat_wslot(sw, n, nl - 1, l);
  }
  if (lane == 0)
    *reinterpret_cast<SatSys*>(sys) = SatSys{ng, nn ? nm >> 2 : ng, nl,
                                             (int)dead_any};
}

// One trial's order of one system: the acceptor at position j.  REG holds
// up to 16 ids below 256 in registers, a byte each, read from the int64
// ids with 16-byte loads where the rows are aligned; else the ids are read
// where the sort left them.
template <bool REG>
struct SatOrd {
  const long long* p;
  __device__ __forceinline__ void load(const long long* q, int, int) {
    p = q;
  }
  __device__ __forceinline__ int at(int j) const { return (int)__ldg(p + j); }
};

template <>
struct SatOrd<true> {
  u64 a, b;
  __device__ __forceinline__ void put(int j, int v) {
    const u64 byte = (u64)(v & 0xff);
    if (j < 8)
      a |= byte << (8 * j);
    else
      b |= byte << (8 * (j - 8));
  }
  __device__ __forceinline__ void load(const long long* q, int L, int vec) {
    a = b = 0;
    if (vec) {
      const int4* q4 = reinterpret_cast<const int4*>(q);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (2 * k + 1 < L) {
          const int4 v = __ldg(q4 + k);  // ids 2k and 2k + 1: low words x, z
          put(2 * k, v.x);
          put(2 * k + 1, v.z);
        }
      }
      if (L & 1) put(L - 1, (int)__ldg(q + L - 1));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < L) put(j, (int)__ldg(q + j));
    }
  }
  __device__ __forceinline__ int at(int j) const {
    return (int)(((j < 8 ? a : b) >> ((j & 7) * 8)) & 0xffu);
  }
};

// A group of four monotone rows along the order over positions [0, lim),
// each adding its weights with __fadd_rn; lim becomes the first position
// where one crosses.  The weights of four positions load before their adds.
template <class O>
__device__ __forceinline__ void sat_walk4(const O& o, const float4* w,
                                          const float4& t, int& lim) {
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < lim; j0 += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = w[o.at(min(j0 + u, lim - 1))];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < lim && add4(c, v[u], t)) lim = j0 + u;
  }
}

// The same for a system's one live row (the group's first).
template <class O>
__device__ __forceinline__ void sat_walk1(const O& o, const float4* w,
                                          float t, int& lim) {
  const float* w1 = reinterpret_cast<const float*>(w);
  float c = 0.0f;
  for (int j0 = 0; j0 < lim; j0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = w1[4 * o.at(min(j0 + u, lim - 1))];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u < lim) {
        c = __fadd_rn(c, v[u]);
        if (c >= t) lim = j0 + u;
      }
    }
  }
}

// A row whose sum reaches its threshold at the last position (the plain
// version's `reached`) saturates at its first crossing f; one that does
// not gives big.
__device__ __forceinline__ void sat_end(float c, float t, int f, int& lim,
                                        bool& unreached) {
  if (c >= t)
    lim = min(lim, f);
  else
    unreached = true;
}

// A group of four rows of any weights over all L positions: each row's
// first crossing and whether it reaches its threshold at the end.
template <class O>
__device__ __forceinline__ void sat_walk_all(const O& o, int L,
                                             const float4* w, const float4& t,
                                             int& lim, bool& unreached) {
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int f0 = L, f1 = L, f2 = L, f3 = L;
  for (int j = 0; j < L; ++j) {
    const float4 v = w[o.at(j)];
    c.x = __fadd_rn(c.x, v.x);
    c.y = __fadd_rn(c.y, v.y);
    c.z = __fadd_rn(c.z, v.z);
    c.w = __fadd_rn(c.w, v.w);
    if (f0 == L && c.x >= t.x) f0 = j;
    if (f1 == L && c.y >= t.y) f1 = j;
    if (f2 == L && c.z >= t.z) f2 = j;
    if (f3 == L && c.w >= t.w) f3 = j;
  }
  sat_end(c.x, t.x, f0, lim, unreached);
  sat_end(c.y, t.y, f1, lim, unreached);
  sat_end(c.z, t.z, f2, lim, unreached);
  sat_end(c.w, t.w, f3, lim, unreached);
}

// One (trial, system) from the system's rows in shared memory.  The
// monotone groups stop at the earliest crossing found so far: arrivals
// ascend along the order, so a later crossing cannot lower the minimum.
// Rows that have not crossed by then count (as big) only where the
// earliest crossing's arrival lies above big (a LOST or infinite one);
// only then are they walked to the end.
template <bool REG>
__device__ __forceinline__ float sat_res(const SatOrd<REG>& o,
                                         const unsigned char* sys, int L,
                                         int n, int ngmax, const float* xr,
                                         float big) {
  const SatSys h = *reinterpret_cast<const SatSys*>(sys);
  const float4* st = reinterpret_cast<const float4*>(sys + 16);
  const float4* sw = st + ngmax;
  int lim = L;
  bool unreached = false;
  if (h.nl == 1 && h.ngm == 1) {
    sat_walk1(o, sw, st[0].x, lim);
  } else {
    for (int gi = 0; gi < h.ngm; ++gi)
      sat_walk4(o, sw + (size_t)gi * n, st[gi], lim);
    for (int gi = h.ngm; gi < h.ng; ++gi)
      sat_walk_all(o, L, sw + (size_t)gi * n, st[gi], lim, unreached);
  }
  if (lim == L) return big;
  float v = __ldg(xr + lim);
  if (v > big) {
    bool miss = h.dead || unreached;
    for (int gi = 0; !miss && gi < h.ngm; ++gi) {
      int all = L;
      sat_walk_all(o, L, sw + (size_t)gi * n, st[gi], all, miss);
    }
    if (miss) v = big;
  }
  return v;
}

// One (trial, system) from the rows in device memory (a system's rows past
// a block's shared memory): every row walked to the end.
template <bool REG>
__device__ __forceinline__ float sat_glob(const SatOrd<REG>& o,
                                          const SatArgs& a, int m,
                                          const float* xr) {
  const float* wm = a.w + (size_t)m * a.G * a.n;
  const float* tm = a.t + (size_t)m * a.G;
  int lim = a.L;
  bool unreached = false;
  for (int g = 0; g < a.G; ++g) {
    const float* wr = wm + (size_t)g * a.n;
    const float tg = __ldg(tm + g);
    float c = 0.0f;
    int f = a.L;
    for (int j = 0; j < a.L; ++j) {
      c = __fadd_rn(c, __ldg(wr + o.at(j)));
      if (f == a.L && c >= tg) f = j;
    }
    sat_end(c, tg, f, lim, unreached);
  }
  if (lim == a.L) return a.big;
  const float v = __ldg(xr + lim);
  return unreached && v > a.big ? a.big : v;
}

// A block takes the systems [mg y, mg (y + 1)): RES stages their live rows
// in shared memory once, then the block walks trials, a thread each, tile
// after tile, writing out[m, s] for each of its systems (a warp's stores
// contiguous).
template <bool REG, bool RES>
__global__ void __launch_bounds__(MS_THREADS) masked_sat_kernel(SatArgs a) {
  extern __shared__ __align__(16) unsigned char ms_smem[];
  const int m0 = blockIdx.y * a.mg, mc = min(a.mg, a.M - m0);
  const size_t per = sat_sys_bytes(a.n, a.ngmax);
  if (RES) {
    for (int k = threadIdx.x >> 5; k < mc; k += MS_THREADS / 32)
      sat_stage(a, m0 + k, ms_smem + k * per);
    __syncthreads();
  }
  const bool shared = a.pm == 0;
  for (long long s = (long long)blockIdx.x * MS_THREADS + threadIdx.x;
       s < a.S; s += (long long)gridDim.x * MS_THREADS) {
    SatOrd<REG> o;
    if (shared) o.load(a.perm + s * a.ps, a.L, a.vec);
    for (int k = 0; k < mc; ++k) {
      const int m = m0 + k;
      if (!shared) o.load(a.perm + m * a.pm + s * a.ps, a.L, a.vec);
      const float* xr = a.x + m * a.xm + s * a.xs;
      float v;
      if constexpr (RES)
        v = sat_res<REG>(o, ms_smem + k * per, a.L, a.n, a.ngmax, xr, a.big);
      else
        v = sat_glob<REG>(o, a, m, xr);
      a.out[(size_t)m * a.S + s] = v;
    }
  }
}

typedef void (*SatKernel)(SatArgs);
static SatKernel sat_kernel(bool reg, bool res) {
  return reg ? (res ? masked_sat_kernel<true, true>
                    : masked_sat_kernel<true, false>)
             : (res ? masked_sat_kernel<false, true>
                    : masked_sat_kernel<false, false>);
}

// ---------------------------------------------------------------------------
// sorted_prefix
// ---------------------------------------------------------------------------

#define SP_ROWS 128         // rows a block, one a thread
#define SP_MAX_N 32         // the longest row a network instance sorts

// Comparator c of Batcher's odd-even merge sort on n positions, as
// lo * 64 + hi (lo < hi), or the network's size where c is past its end.
// The network for the next power of two, with every comparator that
// touches a position >= n dropped: such a position would hold +inf and
// never move.  n = 11 takes 38 comparators, 32 takes 191.
__host__ __device__ constexpr int sp_comparator(int n, int c) {
  int at = 0;
  for (int p = 1; p < n; p += p)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j + k < n; j += 2 * k)
        for (int i = 0; i < k && i + j + k < n; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (at == c) return (i + j) * 64 + i + j + k;
            ++at;
          }
  return at;
}

__host__ __device__ constexpr int sp_network_size(int n) {
  return sp_comparator(n, -1);
}

// torch.sort's order on f32 as an unsigned key: its radix sort's bit
// twiddle (the sign bit set on a positive value, every bit flipped on a
// negative one), with -0 keyed as +0, so the two tie and keep their input
// order.
__device__ __forceinline__ unsigned sp_key(unsigned u) {
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A row entry as one 64-bit word: the key above its position, so one
// unsigned compare orders by value, ties to the lower position.  Bit 0
// marks a -0, which the key cannot tell from +0.
__device__ __forceinline__ unsigned long long sp_pack(float x, int c) {
  const unsigned u = __float_as_uint(x);
  return ((unsigned long long)sp_key(u) << 32) | ((unsigned)c << 1)
         | (u == 0x80000000u);
}

__device__ __forceinline__ float sp_value(unsigned long long w) {
  if (w & 1ull) return __uint_as_float(0x80000000u);
  const unsigned k = (unsigned)(w >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int A, int N>
__device__ __forceinline__ void sp_exchange(unsigned long long (&v)[N]) {
  constexpr int lo = A >> 6, hi = A & 63;
  const unsigned long long a = v[lo], b = v[hi];
  const bool swap = b < a;
  v[lo] = swap ? b : a;
  v[hi] = swap ? a : b;
}

// The whole network, unrolled: every comparator's positions are constants.
template <int N, int... C>
__device__ __forceinline__ void sp_sort(unsigned long long (&v)[N],
                                        std::integer_sequence<int, C...>) {
  (sp_exchange<sp_comparator(N, C)>(v), ...);
}

// Element e of the block's tile in shared memory, rows at stride P.
template <int N, int P>
__device__ __forceinline__ float& sp_at(float* tile, int e) {
  return tile[(e / N) * P + e % N];
}

// A block takes SP_ROWS rows, a thread each.  Its tile, contiguous in device
// memory, comes in with 16-byte loads where the tensor is 16-byte aligned
// (a tile starts 512 N bytes after the previous one) and lands in shared
// memory at an odd row stride, so a thread reading its own row along
// positions hits 32 banks a warp.  The thread sorts its N (key, position)
// words in registers through the unrolled network, writes its k smallest
// back at stride k | 1, and the block stores the (rows, k) prefix, then the
// ids, with 16-byte stores.
template <int N, bool IDS>
__global__ void __launch_bounds__(SP_ROWS) sorted_prefix_kernel(
    const float* __restrict__ x, long long S, int k, int vec,
    float* __restrict__ vals, long long* __restrict__ ids) {
  constexpr int P = N | 1;
  __shared__ __align__(16) float tile[SP_ROWS * P];
  __shared__ __align__(16) int id_tile[IDS ? SP_ROWS * P : 1];
  const long long r0 = (long long)blockIdx.x * SP_ROWS;
  const int R = (int)min((long long)SP_ROWS, S - r0);
  const int t = threadIdx.x, E = R * N, Q = k | 1, Ek = R * k;
  const float* src = x + r0 * N;
  int e = t;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = t; i < E / 4; i += SP_ROWS) {
      const float4 f = __ldcs(s4 + i);
      if (P == N) {
        *reinterpret_cast<float4*>(tile + 4 * i) = f;
      } else {
        sp_at<N, P>(tile, 4 * i) = f.x;
        sp_at<N, P>(tile, 4 * i + 1) = f.y;
        sp_at<N, P>(tile, 4 * i + 2) = f.z;
        sp_at<N, P>(tile, 4 * i + 3) = f.w;
      }
    }
    e = (E & ~3) + t;
  }
  for (; e < E; e += SP_ROWS) sp_at<N, P>(tile, e) = __ldcs(src + e);
  __syncthreads();

  unsigned long long v[N];
  if (t < R) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = sp_pack(tile[t * P + c], c);
    sp_sort<N>(v, std::make_integer_sequence<int, sp_network_size(N)>{});
  }
  __syncthreads();  // every row read: the tile takes the prefix now
  if (t < R) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < k) {
        tile[t * Q + c] = sp_value(v[c]);
        if (IDS) id_tile[t * Q + c] = (int)((unsigned)v[c] >> 1);
      }
    }
  }
  __syncthreads();

  // The prefix leaves four values (two ids) a store, read from the row and
  // column of its first element on.
  float* dst = vals + r0 * k;
  for (int i = t; i < Ek / 4; i += SP_ROWS) {
    float4 f;
    if (Q == k) {
      f = *reinterpret_cast<const float4*>(tile + 4 * i);
    } else {
      int row = 4 * i / k, col = 4 * i - row * k;
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = tile[row * Q + col];
        if (++col == k) col = 0, ++row;
      }
      f = make_float4(a[0], a[1], a[2], a[3]);
    }
    __stcs(reinterpret_cast<float4*>(dst) + i, f);
  }
  for (int j = (Ek & ~3) + t; j < Ek; j += SP_ROWS)
    dst[j] = tile[(j / k) * Q + j % k];
  if (IDS) {
    long long* idst = ids + r0 * k;
    for (int i = t; i < Ek / 2; i += SP_ROWS) {
      int row = 2 * i / k, col = 2 * i - row * k;
      longlong2 p;
      p.x = id_tile[row * Q + col];
      if (++col == k) col = 0, ++row;
      p.y = id_tile[row * Q + col];
      __stcs(reinterpret_cast<longlong2*>(idst) + i, p);
    }
    if (Ek & 1) {
      if (t == 0) idst[Ek - 1] = id_tile[((Ek - 1) / k) * Q + (Ek - 1) % k];
    }
  }
}

typedef void (*SpLaunch)(unsigned, cudaStream_t, const float*, long long,
                         int, int, float*, long long*);

template <int N, bool IDS>
void sp_launch(unsigned blocks, cudaStream_t st, const float* x, long long S,
               int k, int vec, float* vals, long long* ids) {
  sorted_prefix_kernel<N, IDS><<<blocks, SP_ROWS, 0, st>>>(x, S, k, vec,
                                                           vals, ids);
}

// The instance for rows of n (1..SP_MAX_N), with or without ids.
template <bool IDS, int... I>
static SpLaunch sp_instance(int n, std::integer_sequence<int, I...>) {
  static const SpLaunch table[] = {sp_launch<I + 1, IDS>...};
  return table[n - 1];
}

// ---------------------------------------------------------------------------
// C entry points (ctypes).  Pointers and the stream arrive as void*.
// ---------------------------------------------------------------------------

extern "C" {

int qt_tally_votes(const void* votes, int S, int n, int K, void* counts,
                   void* stream) {
  const int blocks = (S + TV_THREADS - 1) / TV_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= PASS_K) {
    static void (*const launch[PASS_K])(int, cudaStream_t, const int*, int,
                                        int, int*) = {
        tv_launch<1>, tv_launch<2>, tv_launch<3>, tv_launch<4>,
        tv_launch<5>, tv_launch<6>, tv_launch<7>, tv_launch<8>};
    launch[K - 1](blocks, st, (const int*)votes, S, n, (int*)counts);
  } else {
    tally_votes_kernel<<<blocks, TV_THREADS, 0, st>>>((const int*)votes, S,
                                                      n, K, (int*)counts);
  }
  return (int)cudaGetLastError();
}

int qt_tally_decide(const void* votes, int S, int n, int K, int q,
                    void* counts, void* winner, void* max_count,
                    void* reached, void* stream) {
  const int blocks = (S + TD_THREADS - 1) / TD_THREADS;
  tally_decide_kernel<<<blocks, TD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)votes, S, n, K, q, (int*)counts, (int*)winner,
      (int*)max_count, (unsigned char*)reached);
  return (int)cudaGetLastError();
}

// The masked_tally instance for a shape: every value's mask in registers
// for n <= 32 and K <= MT_KC, else the passes of voted values, in device
// memory where a block works there.
typedef void (*MaskedKernel)(MaskedArgs);
static MaskedKernel masked_kernel(int n, int K, bool glob) {
  static const MaskedKernel kc[MT_KC + 1] = {
      masked_tally_kernel<false, 0>, masked_tally_kernel<false, 1>,
      masked_tally_kernel<false, 2>, masked_tally_kernel<false, 3>,
      masked_tally_kernel<false, 4>, masked_tally_kernel<false, 5>,
      masked_tally_kernel<false, 6>, masked_tally_kernel<false, 7>,
      masked_tally_kernel<false, 8>};
  if (glob) return masked_tally_kernel<true, 0>;
  return kc[n <= 32 && K <= MT_KC ? K : 0];
}

// The launch plan of masked_tally for n acceptors, G rows and K values:
// out = {rows a chunk, dynamic shared memory, blocks the card holds at
// once, bytes of device memory a block works in (0: its shared memory),
// trials a tile}.  Returns a CUDA error code.
int qt_masked_plan(int n, int G, int K, long long* out) {
  const long long fixed = (long long)masked_layout(n, 0).bytes;
  const long long row = 36 + 4LL * (1 + MT_PL) * ((n + 31) / 32);
  long long rc = (MT_SMEM - 64 - fixed) / row;
  if (rc > G) rc = G;
  while (rc > 1 && masked_layout(n, (int)rc).bytes > MT_SMEM) --rc;
  const bool glob = rc < (G < MT_MIN_ROWS ? G : MT_MIN_ROWS) ||
                    masked_layout(n, (int)rc).bytes > MT_SMEM;
  if (glob) rc = G < MT_GLOB_ROWS ? G : MT_GLOB_ROWS;
  const MaskedLayout L = masked_layout(n, (int)rc);
  const int smem = glob ? 0 : (int)L.bytes;
  const MaskedKernel kern = masked_kernel(n, K, glob);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MT_SMEM);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      MT_THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = rc;
  out[1] = smem;
  out[2] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  out[3] = glob ? (long long)L.bytes : 0;
  out[4] = MT_TS;
  return 0;
}

int qt_masked_tally(const void* votes, const void* w, const void* t, int S,
                    int n, int G, int K, int rc, int smem, int nbx,
                    void* scratch, long long region, void* out,
                    void* stream) {
  MaskedArgs a;
  a.votes = (const int*)votes;
  a.w = (const float*)w;
  a.t = (const float*)t;
  a.S = S;
  a.n = n;
  a.G = G;
  a.K = K;
  a.rc = rc;
  a.ntiles = (S + MT_TS - 1) / MT_TS;
  a.items = a.ntiles * ((G + rc - 1) / rc);
  a.scratch = (unsigned char*)scratch;
  a.region = region;
  a.out = (int*)out;
  const MaskedKernel kern = masked_kernel(n, K, scratch != nullptr);
  kern<<<nbx, MT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch plan of stream_tally_decide_hist for a shape: out = {systems a
// block, threads a block, dynamic shared memory, blocks the card holds at
// once, masks resident in shared memory, bytes of device memory a block
// stages its tile in (0: shared memory)}.  Returns -1 when the tile does
// not fit in ST_MAX_SCRATCH, else a CUDA error code.
int qt_stream_plan(int n, int K, int M, int G1, int G2c, int G2f, int* out) {
  const int G[3] = {G1, G2c, G2f};
  if (n <= 16) return stream_plan<16>(n, K, M, G, out);
  if (n <= 256) return stream_plan<0>(n, K, M, G, out);
  return stream_plan<-1>(n, K, M, G, out);
}

// The launch plan of race_card_hist for a shape: out = {column groups,
// column threads a group, threads a block, dynamic shared memory, blocks
// the card holds at once, bytes of device memory a block works in (0: its
// shared memory), trials a tile}.  Returns a CUDA error code.
int qt_card_plan(int n, int P, int k1, int kr, int k2f, long long* out) {
  int q32 = (P + k2f + 31) / 32 * 32;
  if (q32 > RC_MAX_THREADS) q32 = RC_MAX_THREADS;
  const int G = RC_THREADS / q32 > 1 ? RC_THREADS / q32 : 1;
  const CardLayout L = card_layout(n, P, k1, kr, k2f, G);
  const bool glob = L.bytes > ST_MAX_SMEM;
  const int threads = G * q32, smem = glob ? 0 : (int)L.bytes;
  void (*kern)(CardArgs) =
      glob ? race_card_kernel<true> : race_card_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ST_MAX_SMEM);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = G;
  out[1] = q32;
  out[2] = threads;
  out[3] = smem;
  out[4] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  out[5] = glob ? (long long)L.bytes : 0;
  out[6] = RC_TILE;
  return 0;
}

int qt_race_card_hist(const void* votes, const void* arrive,
                      const void* classic, const void* valid,
                      const void* pairs, int S, int n, int K, int P, int k1,
                      int kr, int k2f, float log_g, int bins,
                      float undecided_ms, int G, int q32, int threads,
                      int smem, int nbx, int gb, void* scratch,
                      long long region, long long zero_bytes, void* FH,
                      void* RH, void* cnt, void* tickets, void* Fsum,
                      void* Fmax, void* Rsum, void* Rmax, void* part,
                      void* gpart, void* stream) {
  CardArgs a;
  a.votes = (const int*)votes;
  a.arr = (const float*)arrive;
  a.cls = (const float*)classic;
  a.valid = (const unsigned char*)valid;
  a.pairs = (const int*)pairs;
  a.S = S;
  a.n = n;
  a.K = K;
  a.P = P;
  a.k1 = k1;
  a.kr = kr;
  a.k2f = k2f;
  a.bins = bins;
  a.G = G;
  a.q32 = q32;
  a.gb = gb;
  a.log_g = log_g;
  a.und = undecided_ms;
  a.big = 2.0f * undecided_ms;
  a.scratch = (unsigned char*)scratch;
  a.region = region;
  a.FH = (int*)FH;
  a.RH = (int*)RH;
  a.cnt = (int*)cnt;
  a.tickets = (int*)tickets;
  a.Fsum = (float*)Fsum;
  a.Fmax = (float*)Fmax;
  a.Rsum = (float*)Rsum;
  a.Rmax = (float*)Rmax;
  a.part = (uint2*)part;
  a.gpart = (uint2*)gpart;
  cudaStream_t st = (cudaStream_t)stream;
  // the one fill: FH, RH, the slot counts and the tickets, which lie
  // together from FH on.
  const cudaError_t e = cudaMemsetAsync(FH, 0, (size_t)zero_bytes, st);
  if (e != cudaSuccess) return (int)e;
  if (scratch)
    race_card_kernel<true><<<nbx, threads, smem, st>>>(a);
  else
    race_card_kernel<false><<<nbx, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int qt_stream_tally_decide_hist(
    const void* votes, const void* val_arr, const void* arrive,
    const void* classic, const void* w1, const void* t1, const void* w2c,
    const void* t2c, const void* w2f, const void* t2f, const void* valid,
    int S, int n, int K, int M, int G1, int G2c, int G2f, int k1, int k2c,
    int k2f, float log_g, int bins, float undecided_ms, int mg,
    int threads, int smem, int nbx, int res, void* scratch, void* hist, void* counts,
    void* tickets, void* sum, void* max, void* psum, void* pmax,
    void* pcnt, void* stream) {
  StreamArgs a;
  a.votes = (const int*)votes;
  a.val = (const float*)val_arr;
  a.arr = (const float*)arrive;
  a.cls = (const float*)classic;
  a.valid = (const unsigned char*)valid;
  a.w[0] = (const float*)w1;
  a.w[1] = (const float*)w2c;
  a.w[2] = (const float*)w2f;
  a.t[0] = (const float*)t1;
  a.t[1] = (const float*)t2c;
  a.t[2] = (const float*)t2f;
  a.G[0] = G1;
  a.G[1] = G2c;
  a.G[2] = G2f;
  a.k[0] = k1;
  a.k[1] = k2c;
  a.k[2] = k2f;
  a.S = S;
  a.n = n;
  a.K = K;
  a.M = M;
  a.bins = bins;
  a.mg = mg;
  a.scratch = (unsigned char*)scratch;
  a.vec = n % 4 == 0 && ((uintptr_t)votes | (uintptr_t)val_arr |
                         (uintptr_t)arrive | (uintptr_t)classic |
                         (uintptr_t)w1 | (uintptr_t)w2c | (uintptr_t)w2f) %
                                16 ==
                            0;
  a.log_g = log_g;
  a.und = undecided_ms;
  a.hist = (int*)hist;
  a.counts = (int*)counts;
  a.tickets = (int*)tickets;
  a.sum = (float*)sum;
  a.max = (float*)max;
  a.psum = (float*)psum;
  a.pmax = (float*)pmax;
  a.pcnt = (int*)pcnt;
  const dim3 grid(nbx, (M + mg - 1) / mg);
  cudaStream_t st = (cudaStream_t)stream;
  // the one fill: the histogram and, after it, a ticket per system group.
  const cudaError_t e = cudaMemsetAsync(
      hist, 0, sizeof(int) * ((size_t)M * bins + grid.y), st);
  if (e != cudaSuccess) return (int)e;
  void (*launch)(const StreamArgs&, dim3, int, int, cudaStream_t) =
      n <= 16    ? (res ? stream_launch<16, true> : stream_launch<16, false>)
      : n <= 256 ? (res ? stream_launch<0, true> : stream_launch<0, false>)
                 : (res ? stream_launch<-1, true> : stream_launch<-1, false>);
  launch(a, grid, threads, smem, st);
  return (int)cudaGetLastError();
}

// The launch plan of masked_sat for n acceptors, L positions, M systems of
// G rows: out = {systems a block, dynamic shared memory, blocks the card
// holds at once, rows resident in shared memory, orders in registers,
// trials a tile}.
// A block holds as many systems' rows as leave room for two blocks an SM,
// one system's where that is more, and where even one system's do not fit
// a block's shared memory (or 65535 groups of systems would not cover M)
// every system's rows are read from device memory.  Returns a CUDA error
// code.
int qt_sat_plan(int n, int L, int M, int G, long long* out) {
  const long long ngmax = ((long long)G + 3) / 4;
  const double per = 16.0 * (1.0 + (double)ngmax * (n + 1.0));
  const long long need = ((long long)M + MS_MAX_GRID_Y - 1) / MS_MAX_GRID_Y;
  const double budget =
      per * need <= MS_SOFT_SMEM ? MS_SOFT_SMEM : (double)ST_MAX_SMEM;
  long long mg = (long long)(budget / per);
  if (mg > M) mg = M;
  const bool res = mg >= need && per * mg <= ST_MAX_SMEM;
  if (!res) mg = M;
  const bool reg = L <= 16 && n <= 256;
  const int smem = res ? (int)(per * mg) : 0;
  const SatKernel kern = sat_kernel(reg, res);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ST_MAX_SMEM);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      MS_THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = mg;
  out[1] = smem;
  out[2] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  out[3] = res;
  out[4] = reg;
  out[5] = MS_THREADS;
  return 0;
}

int qt_masked_sat(const void* x, const void* perm, const void* w,
                  const void* t, void* out, long long xs, long long xm,
                  long long ps, long long pm, int S, int L, int n, int M,
                  int G, int mg, int gx, int gy, int smem, float big,
                  int res, int reg, int vec, void* stream) {
  SatArgs a;
  a.x = (const float*)x;
  a.perm = (const long long*)perm;
  a.w = (const float*)w;
  a.t = (const float*)t;
  a.out = (float*)out;
  a.xs = xs;
  a.xm = xm;
  a.ps = ps;
  a.pm = pm;
  a.S = S;
  a.L = L;
  a.n = n;
  a.M = M;
  a.G = G;
  a.mg = mg;
  a.ngmax = (int)(((long long)G + 3) / 4);
  a.vec = vec;
  a.big = big;
  sat_kernel(reg != 0, res != 0)<<<dim3(gx, gy), MS_THREADS, smem,
                                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The k smallest of each of S contiguous rows of n f32 (x), ascending, into
// vals (S, k) f32 and, where ids is not null, their positions into ids (S,
// k) int64.  vec: x is 16-byte aligned.  1 <= k <= n <= SP_MAX_N.
int qt_sorted_prefix(const void* x, long long S, int n, int k, int vec,
                     void* vals, void* ids, void* stream) {
  const long long blocks = (S + SP_ROWS - 1) / SP_ROWS;
  if (n < 1 || n > SP_MAX_N || k < 1 || k > n || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto all = std::make_integer_sequence<int, SP_MAX_N>{};
  const SpLaunch launch =
      ids ? sp_instance<true>(n, all) : sp_instance<false>(n, all);
  launch((unsigned)blocks, (cudaStream_t)stream, (const float*)x, S, k, vec,
         (float*)vals, (long long*)ids);
  return (int)cudaGetLastError();
}

}  // extern "C"
