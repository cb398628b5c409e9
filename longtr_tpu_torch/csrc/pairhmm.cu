// Mode-A pair-HMM kernels for NVIDIA Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of longtr_tpu/ops/pairhmm_pallas.py:
//   pairhmm_resident_warp, pairhmm_resident_block
//                     <- _kernel          (launched by _pallas_call)
//   pairhmm_streamed_cluster, pairhmm_streamed
//                     <- _kernel_chunked  (launched by _pallas_call_chunked)
//
// All compute, for each (haplotype, read) pair, the max-product DP of
// HapAligner::align_seq_to_hap (HapAligner.cpp:236-343) without traceback,
// bit for bit like the plain torch scan (longtr_tpu_torch/ops/pairhmm.py)
// and the native C++ scorer (longtr_tpu_torch/native/longtr_native.cc:1413-1568).
// Exactness rests on float32 add, integer-valued products and max, each in
// the native scorer's order.  The build passes --fmad=false so that no
// product is contracted into a fused multiply-add.
//
// In row i
//   M[i][j] = emit(i, j) + P[i-1][j-1]                  (j >= 1)
//   I[i][j] = MA + max(M[i-1][j] + m2i, I[i-1][j] + i2i)
//   D[i][j] = j*d2d + max_{k<j} ((M[i][k] + m2d) - (k+1)*d2d)
//   P[i][j] = max(max(M + m2m, D + d2m), I + i2m)      (fused predecessor)
// so the only dependency along j inside a row is the running max of D,
// an exclusive max-scan.  The band check of row i (a max over the row)
// rides on the scan of row i+1, and a pair stops once its band flag is set
// or its last row is done, since neither changes an output.  Rows i run
// in order; the threads of a pair share the read axis j.
//
// What bounds them: about 21 float operations a cell and one byte a base
// of input, so the work is operations, not bytes; but each row ends in a
// max-scan across the pair's threads, so a row is a chain of shuffles (and
// across warps a barrier) between a few operations per column.  The
// register variants are bound by instruction issue of that row loop:
// fewer instructions, as fmaxf's one FMNMX for a compare and select, made
// them faster, while fewer registers (the block variant at widths the
// warp variant takes) did not.  The workspace kernel waits on its barriers
// and device memory.
//
// K1 comes in two variants, chosen by read width:
//   warp   (width <= 32*32): one warp a pair, several pairs a block.  Lane
//          l owns the K columns [l*K, l*K+K) and keeps their M, I, P of the
//          previous row and their read codes in registers; the left
//          neighbour's P comes by shuffle.  The scan is 5 shuffle steps and
//          the band max 5 more; there is no barrier at all.
//   block  (width <= 512*16): one block of warps a pair, registers as in
//          the warp variant.  One barrier a row: each warp publishes its
//          scan total, band partial and its last column's M, I and running
//          max into slots double-buffered by row parity; after the barrier
//          a warp scans the partials with one shuffle scan and rebuilds its
//          left neighbour's P itself, so nothing else crosses warps.
// Pass 1 of a row forms M and I (which need only the previous row) and the
// running max of the D terms; pass 2, after the scan, forms D, the band
// terms and the new P (the workspace kernel also the corner term; the
// register variants rebuild the score after the last row instead).
//
// K2 comes in two kernels:
//   cluster   (width <= 8 CTAs * 8192 columns on portable clusters): one
//             thread-block cluster a pair, the block variant's register
//             layout spread over the cluster's CTAs, one cluster barrier a
//             row (pairhmm_streamed_cluster_kernel below).
//   workspace (any width): pairhmm_streamed keeps the rows in a
//             device-memory workspace (mostly L2-resident) and walks the
//             read axis in tiles of one element per thread, carrying the D
//             running max and the predecessor edge from tile to tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1000000000.0f;   // IMPOSSIBLE
constexpr float MA = -0.000100005f;     // MATCH_EMIT
constexpr float MI = -9.0f;             // MISMATCH_EMIT
constexpr float BAND_FAIL = -700.0f;
constexpr float BAND_THRESH = -600.0f;
constexpr int LEN_DIFF_LIMIT = 600;
constexpr int MIN_FULL_HAP_LEN = 60;
constexpr int SCAN_SLOTS = 64;          // per-warp partials: 32 + 32

struct Trans {
  float i2i, i2m, d2d, d2m, m2m, m2i, m2d;
};

__device__ __forceinline__ Trans load_trans(const float* t) {
  return Trans{t[0], t[1], t[2], t[3], t[4], t[5], t[6]};
}

// The native scorer's max: any order of max is exact.
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }

// Scores decided without the DP.  The reference applies the |n-m| gate
// after the band flag and the short-haplotype gate last, so the latter wins.
__device__ __forceinline__ bool gated(int n, int m, int full_len, float* score) {
  if (full_len <= MIN_FULL_HAP_LEN) {
    *score = NEG;
    return true;
  }
  int d = n - m;
  if ((d < 0 ? -d : d) > LEN_DIFF_LIMIT) {
    *score = BAND_FAIL;
    return true;
  }
  return false;
}

// Row 0 at column j (HapAligner.cpp:263-272): M0, D0 and the fused
// predecessor P0 (I0 is NEG everywhere).  hap[j] is compared with read[0]
// along the read axis; past the padded haplotype the code is 0.
__device__ __forceinline__ void row0_cell(int j, const uint8_t* hap, int N,
                                          uint8_t r0, const Trans& t,
                                          float& M0, float& D0, float& P0) {
  const float Dk = j >= 1 ? t.m2d + (float)(j - 1) * t.d2d : NEG;
  const float Dk_prev = j >= 2 ? t.m2d + (float)(j - 2) * t.d2d : NEG;
  const uint8_t hj = j < N ? hap[j] : (uint8_t)0;
  const float emit0 = hj == r0 ? MA : MI;
  M0 = j == 0 ? (hap[0] == r0 ? MA : MI) : (Dk_prev + t.d2m) + emit0;
  D0 = Dk;
  P0 = mx(mx(M0 + t.m2m, D0 + t.d2m), NEG + t.i2m);
}

__device__ __forceinline__ float c_term(float Mn, int j, const Trans& t) {
  return (Mn + t.m2d) - (float)(j + 1) * t.d2d;
}

__device__ __forceinline__ float band_cand(float best, int nm, int i, int j,
                                           const Trans& t) {
  int bd = nm - (i - j);
  bd = bd < 0 ? -bd : bd;
  return best + (float)bd * t.d2d;
}

// Block-wide: `excl` = max of `a` over the threads before this one,
// `tot_a` / `tot_b` = max of `a` / `b` over the block.  blockDim.x is a
// multiple of 32.  One barrier inside; the caller puts another barrier, or
// a second buffer, between two calls that use the same `sh`.
__device__ __forceinline__ void block_scan(float a, float b, float* sh,
                                           float& excl, float& tot_a,
                                           float& tot_b) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float x = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(full, x, o);
    if (lane >= o) x = mx(x, y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) b = mx(b, __shfl_xor_sync(full, b, o));
  const float xe = __shfl_up_sync(full, x, 1);
  if (lane == 31) sh[warp] = x;
  if (lane == 0) sh[32 + warp] = b;
  __syncthreads();
  float pre = -INFINITY, ta = -INFINITY, tb = -INFINITY;
  for (int w = 0; w < nw; w++) {
    const float v = sh[w];
    if (w < warp) pre = mx(pre, v);
    ta = mx(ta, v);
    tb = mx(tb, sh[32 + w]);
  }
  excl = mx(pre, lane == 0 ? -INFINITY : xe);
  tot_a = ta;
  tot_b = tb;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_PAIRS = 4;           // pairs (warps) a block, warp variant
constexpr int BLOCK_MAX_THREADS = 512;  // threads a pair, block variant

// The max of the register variants: one FMNMX where mx takes a compare and
// a select.  Both return one of the operands, the same one wherever no
// operand is NaN and the two are not zeros of opposite sign, which the DP
// never forms (every value is a sum of negative logs or -inf), so the bits
// are the native scorer's.
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }

// Lane-wide: `excl` = max of `a` over the lanes before this one, `incl`
// the same with this lane's, `tot_b` = max of `b` over the warp.
__device__ __forceinline__ void warp_scan(float a, float b, int lane,
                                          float& excl, float& incl,
                                          float& tot_b) {
  float x = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = fmx(x, y);
    b = fmx(b, __shfl_xor_sync(FULL, b, o));
  }
  const float xe = __shfl_up_sync(FULL, x, 1);
  excl = lane == 0 ? -INFINITY : xe;
  incl = x;
  tot_b = b;
}

// Row 0 of a lane's K columns, and its read codes.
template <int K>
__device__ __forceinline__ void rows_init(int j0, int m, const uint8_t* hp,
                                          int N, const uint8_t* rd,
                                          uint8_t r0, int n, const Trans& t,
                                          float (&Mr)[K], float (&Ir)[K],
                                          float (&Pr)[K], uint8_t (&rc)[K],
                                          float& out_v) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int j = j0 + k;
    rc[k] = j < m ? rd[j] : (uint8_t)0;
    float M0, D0, P0;
    row0_cell(j, hp, N, r0, t, M0, D0, P0);
    Mr[k] = M0;
    Ir[k] = NEG;
    Pr[k] = P0;
    if (n == 1 && j == m - 1) out_v = fmx(fmx(M0, NEG), D0);
  }
}

// Pass 1 of row i over a lane's columns: M and I of the row, in place of
// the previous row's (I[j] reads the old M[j] and I[j], M[0] the old I[0]),
// from the previous row's P; `p_in` is P[i-1][j0-1].  Returns the lane's
// running max of the D terms and, in `pre_last`, the same over all but the
// last column.  Columns past the read (j >= m) compute values nothing
// reads: they lie right of every real column.
template <int K>
__device__ __forceinline__ float rows_pass1(int j0, int i, uint8_t h,
                                            float p_in, float col0_emit,
                                            const Trans& t, float (&Mr)[K],
                                            float (&Ir)[K],
                                            const float (&Pr)[K],
                                            const uint8_t (&rc)[K],
                                            float& pre_last) {
  float run = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int j = j0 + k;
    float Mn, In;
    if (j == 0) {
      Mn = (Ir[0] + t.i2m) + col0_emit;
      In = (MA + t.m2i) + (float)(i - 1) * t.i2i;
    } else {
      Mn = (h == rc[k] ? MA : MI) + (k == 0 ? p_in : Pr[k - 1]);
      In = MA + fmx(Mr[k] + t.m2i, Ir[k] + t.i2i);
    }
    Mr[k] = Mn;
    Ir[k] = In;
    if (k == K - 1) pre_last = run;
    run = fmx(run, c_term(Mn, j, t));
  }
  return run;
}

// Pass 2 of row i: D from the scan's `runp` (the max of the D terms left of
// the lane), the band terms, and the row's P.  Returns the lane's band max
// (NEG when it has no real column j >= 1).
template <int K>
__device__ __forceinline__ float rows_pass2(int j0, int i, int m, int nm,
                                            float runp, const Trans& t,
                                            const float (&Mr)[K],
                                            const float (&Ir)[K],
                                            float (&Pr)[K]) {
  float rb = NEG;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int j = j0 + k;
    const float Mn = Mr[k];
    const float In = Ir[k];
    const float Dn = j == 0 ? NEG : (float)j * t.d2d + runp;
    runp = fmx(runp, c_term(Mn, j, t));
    const float best = fmx(fmx(Mn, In), Dn);
    if (j >= 1 && j < m) rb = fmx(rb, band_cand(best, nm, i, j, t));
    Pr[k] = fmx(fmx(Mn + t.m2m, Dn + t.d2m), In + t.i2m);
  }
  return rb;
}

// The score, the last row's cell at j = m-1 (pass 2's `best` there), into
// `out_v` of the lane that owns the column: rebuilt after the row loop from
// the row's M and I and the lane's scan value `runp`, so that no cell of
// the loop tests for it.
template <int K>
__device__ __forceinline__ void rows_score(int j0, int m, float runp,
                                           const Trans& t,
                                           const float (&Mr)[K],
                                           const float (&Ir)[K],
                                           float& out_v) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int j = j0 + k;
    if (j == m - 1) {
      const float Dn = j == 0 ? NEG : (float)j * t.d2d + runp;
      out_v = fmx(fmx(Mr[k], Ir[k]), Dn);
    }
    runp = fmx(runp, c_term(Mr[k], j, t));
  }
}

// Warp variant of K1: warp w of block x scores pair x*WARP_PAIRS + w over
// columns [0, 32*K).  Nothing is shared between warps, so a gated or
// band-failed pair ends its warp only.
template <int K>
__global__ void __launch_bounds__(WARP_PAIRS * 32)
pairhmm_resident_warp_kernel(const uint8_t* __restrict__ hap,
                             const uint8_t* __restrict__ read,
                             const int32_t* __restrict__ hap_len,
                             const int32_t* __restrict__ read_len,
                             const int32_t* __restrict__ full_len,
                             const float* __restrict__ trans, int B, int N,
                             int Mdim, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARP_PAIRS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int n = hap_len[b];
  const int m_len = read_len[b];
  float gate_score;
  if (gated(n, m_len, full_len[b], &gate_score)) {
    if (lane == 0) out[b] = gate_score;
    return;
  }
  const Trans t = load_trans(trans);
  const uint8_t* hp = hap + (size_t)b * N;
  const uint8_t* rd = read + (size_t)b * Mdim;
  const int m = min(max(m_len, 0), Mdim);
  const int rows = min(max(n, 0), N);
  const int nm = n - m_len;
  const int j0 = lane * K;
  const uint8_t r0 = rd[0];
  const uint8_t c0r = (m > 1) ? rd[1] : rd[0];
  const float col0_emit = hp[0] == c0r ? MA : MI;

  float Mr[K], Ir[K], Pr[K];
  uint8_t rc[K];
  float out_v = NEG;
  rows_init<K>(j0, m, hp, N, rd, r0, n, t, Mr, Ir, Pr, rc, out_v);

  float rb_prev = INFINITY;
  float runp = -INFINITY;   // the last row's scan value
  bool failed = false;
  for (int i = 1; i < rows; i++) {
    const uint8_t h = hp[i];
    // lane 0 owns column 0, whose M reads no P
    const float p_in = __shfl_up_sync(FULL, Pr[K - 1], 1);
    float pre_last;
    const float run = rows_pass1<K>(j0, i, h, p_in, col0_emit, t, Mr, Ir,
                                    Pr, rc, pre_last);
    float incl, tot_b;
    warp_scan(run, rb_prev, lane, runp, incl, tot_b);
    if (tot_b < BAND_THRESH) {
      failed = true;
      break;
    }
    rb_prev = rows_pass2<K>(j0, i, m, nm, runp, t, Mr, Ir, Pr);
  }
  if (!failed && rows >= 2) {
    float e, x, tb;
    warp_scan(-INFINITY, rb_prev, lane, e, x, tb);
    failed = tb < BAND_THRESH;
    if (rows == n) rows_score<K>(j0, m, runp, t, Mr, Ir, out_v);
  }
  const bool owner = m >= 1 ? (j0 <= m - 1 && m - 1 < j0 + K) : lane == 0;
  if (owner) out[b] = failed ? BAND_FAIL : out_v;
}

// Block variant of K1: one block of blockDim.x/32 warps a pair, thread
// t owning the K columns [t*K, t*K+K).  Per row, lane 31 of each warp
// publishes the warp's scan total and its last column's M, I and running
// max (the D terms left of that column), lane 0 the warp's band partial,
// into slots double-buffered by row parity, so one barrier a row
// suffices: a slot of row i is rewritten at row i+2, after every warp has
// passed row i+1's barrier.  After the barrier each warp scans the
// partials with one shuffle scan and rebuilds P[i][j0-1] of its left
// neighbour's last column from the published M, I and running max.
template <int K>
__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
pairhmm_resident_block_kernel(const uint8_t* __restrict__ hap,
                              const uint8_t* __restrict__ read,
                              const int32_t* __restrict__ hap_len,
                              const int32_t* __restrict__ read_len,
                              const int32_t* __restrict__ full_len,
                              const float* __restrict__ trans, int N,
                              int Mdim, float* __restrict__ out) {
  __shared__ float s_run[2][32], s_rb[2][32], s_m[2][32], s_i[2][32],
      s_pre[2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int n = hap_len[b];
  const int m_len = read_len[b];
  float gate_score;
  if (gated(n, m_len, full_len[b], &gate_score)) {
    if (threadIdx.x == 0) out[b] = gate_score;
    return;
  }
  const Trans t = load_trans(trans);
  const uint8_t* hp = hap + (size_t)b * N;
  const uint8_t* rd = read + (size_t)b * Mdim;
  const int m = min(max(m_len, 0), Mdim);
  const int rows = min(max(n, 0), N);
  const int nm = n - m_len;
  const int j0 = threadIdx.x * K;
  const uint8_t r0 = rd[0];
  const uint8_t c0r = (m > 1) ? rd[1] : rd[0];
  const float col0_emit = hp[0] == c0r ? MA : MI;

  float Mr[K], Ir[K], Pr[K];
  uint8_t rc[K];
  float out_v = NEG;
  rows_init<K>(j0, m, hp, N, rd, r0, n, t, Mr, Ir, Pr, rc, out_v);
  // P[i-1][j0-1] for lane 0 of warps after the first; row 0's from the
  // row itself
  float p_edge = NEG;
  if (warp > 0) {
    float M0, D0, P0;
    row0_cell(j0 - 1, hp, N, r0, t, M0, D0, P0);
    p_edge = P0;
  }

  float rb_prev = INFINITY;
  float runp = -INFINITY;   // the last row's scan value
  bool failed = false;
  int buf = 0;
  for (int i = 1; i < rows; i++, buf ^= 1) {
    const uint8_t h = hp[i];
    const float p_up = __shfl_up_sync(FULL, Pr[K - 1], 1);
    const float p_in = lane == 0 ? p_edge : p_up;
    float pre_last;
    const float run = rows_pass1<K>(j0, i, h, p_in, col0_emit, t, Mr, Ir,
                                    Pr, rc, pre_last);
    float excl, incl, wrb;
    warp_scan(run, rb_prev, lane, excl, incl, wrb);
    if (lane == 31) {
      s_run[buf][warp] = incl;
      s_m[buf][warp] = Mr[K - 1];
      s_i[buf][warp] = Ir[K - 1];
      s_pre[buf][warp] = fmx(excl, pre_last);
    }
    if (lane == 0) s_rb[buf][warp] = wrb;
    __syncthreads();
    float we, wx, tot_b;
    warp_scan(lane < nw ? s_run[buf][lane] : -INFINITY,
              lane < nw ? s_rb[buf][lane] : -INFINITY, lane, we, wx, tot_b);
    if (tot_b < BAND_THRESH) {
      failed = true;
      break;
    }
    // the max of the D terms of the warps left of this one, and of those
    // left of the previous warp
    const float left = __shfl_sync(FULL, we, warp);
    const float left_prev = __shfl_sync(FULL, we, warp > 0 ? warp - 1 : 0);
    runp = fmx(left, excl);
    rb_prev = rows_pass2<K>(j0, i, m, nm, runp, t, Mr, Ir, Pr);
    if (warp > 0) {
      const int jl = j0 - 1;   // >= 31: never column 0
      const float Ml = s_m[buf][warp - 1];
      const float Il = s_i[buf][warp - 1];
      const float Dl = (float)jl * t.d2d + fmx(left_prev, s_pre[buf][warp - 1]);
      p_edge = fmx(fmx(Ml + t.m2m, Dl + t.d2m), Il + t.i2m);
    }
  }
  if (!failed && rows >= 2) {
    float e, x, wrb;
    warp_scan(-INFINITY, rb_prev, lane, e, x, wrb);
    if (lane == 0) s_rb[buf][warp] = wrb;
    __syncthreads();
    float we, wx, tot_b;
    warp_scan(-INFINITY, lane < nw ? s_rb[buf][lane] : -INFINITY, lane, we,
              wx, tot_b);
    failed = tot_b < BAND_THRESH;
    if (rows == n) rows_score<K>(j0, m, runp, t, Mr, Ir, out_v);
  }
  const bool owner = m >= 1 ? (j0 <= m - 1 && m - 1 < j0 + K)
                            : threadIdx.x == 0;
  if (owner) out[b] = failed ? BAND_FAIL : out_v;
}

// Streamed kernel: the rows live in a device-memory workspace of
// 3 * Mdim floats per pair (M, I, P), and the read axis is walked in
// tiles of blockDim.x columns, one per thread, so every load and store is
// coalesced.  Across tiles of a row two values carry: the D running max
// (`carry_run`, the scan's block total) and the previous row's P at the
// column just left of the tile, which the last thread saves before the
// tile overwrites it (`carry_p`, double-buffered by tile parity, like the
// scan scratch, so one barrier per tile suffices).
__global__ void __launch_bounds__(1024)
pairhmm_streamed_kernel(const uint8_t* __restrict__ hap,
                        const uint8_t* __restrict__ read,
                        const int32_t* __restrict__ hap_len,
                        const int32_t* __restrict__ read_len,
                        const int32_t* __restrict__ full_len,
                        const float* __restrict__ trans, int N, int Mdim,
                        float* __restrict__ ws, float* __restrict__ out) {
  __shared__ float sh[2][SCAN_SLOTS];
  __shared__ float carry_p[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n = hap_len[b];
  const int m_len = read_len[b];
  float gate_score;
  if (gated(n, m_len, full_len[b], &gate_score)) {
    if (tid == 0) out[b] = gate_score;
    return;
  }
  const Trans t = load_trans(trans);
  const uint8_t* hp = hap + (size_t)b * N;
  const uint8_t* rd = read + (size_t)b * Mdim;
  const int m = min(max(m_len, 0), Mdim);
  const int rows = min(max(n, 0), N);
  const int nm = n - m_len;
  float* gM = ws + (size_t)b * 3 * Mdim;
  float* gI = gM + Mdim;
  float* gP = gI + Mdim;

  const int tiles = (m + T - 1) / T;
  const uint8_t r0 = rd[0];
  const uint8_t c0r = (m > 1) ? rd[1] : rd[0];
  const float col0_emit = hp[0] == c0r ? MA : MI;

  float out_v = NEG;
  for (int j = tid; j < m; j += T) {
    float M0, D0, P0;
    row0_cell(j, hp, N, r0, t, M0, D0, P0);
    gM[j] = M0;
    gI[j] = NEG;
    gP[j] = P0;
    if (n == 1 && j == m - 1) out_v = mx(mx(M0, NEG), D0);
  }
  __syncthreads();

  float rb_prev = INFINITY;
  bool failed = false;
  for (int i = 1; i < rows && !failed; i++) {
    const uint8_t h = hp[i];
    float carry_run = -INFINITY;
    float rb = NEG;
    for (int k = 0; k < tiles; k++) {
      const int j = k * T + tid;
      const bool act = j < m;
      float Mn = NEG, In = NEG, c = -INFINITY;
      if (act) {
        const float m_old = gM[j];
        const float i_old = gI[j];
        if (j == 0) {
          Mn = (i_old + t.i2m) + col0_emit;
          In = (MA + t.m2i) + (float)(i - 1) * t.i2i;
        } else {
          const float p_left = tid == 0 ? carry_p[k & 1] : gP[j - 1];
          Mn = (h == rd[j] ? MA : MI) + p_left;
          In = MA + mx(m_old + t.m2i, i_old + t.i2i);
        }
        c = c_term(Mn, j, t);
        if (tid == T - 1 && k + 1 < tiles) carry_p[(k + 1) & 1] = gP[j];
      }
      float excl, tot_a, tot_b;
      block_scan(c, k == 0 ? rb_prev : -INFINITY, sh[k & 1], excl, tot_a,
                 tot_b);
      if (k == 0 && tot_b < BAND_THRESH) {
        failed = true;
        break;
      }
      if (act) {
        const float Dn = j == 0 ? NEG : (float)j * t.d2d + mx(carry_run, excl);
        const float best = mx(mx(Mn, In), Dn);
        if (j >= 1) rb = mx(rb, band_cand(best, nm, i, j, t));
        if (i == n - 1 && j == m - 1) out_v = best;
        gM[j] = Mn;
        gI[j] = In;
        gP[j] = mx(mx(Mn + t.m2m, Dn + t.d2m), In + t.i2m);
      }
      carry_run = mx(carry_run, tot_a);
    }
    rb_prev = rb;
    __syncthreads();
  }
  if (!failed && rows >= 2) {
    float e, ta, tb;
    block_scan(-INFINITY, rb_prev, sh[0], e, ta, tb);
    failed = tb < BAND_THRESH;
  }
  const bool owner = m >= 1 ? tid == (m - 1) % T : tid == 0;
  if (owner) out[b] = failed ? BAND_FAIL : out_v;
}

// Cluster kernel of K2, the counterpart of _kernel_chunked
// (longtr_tpu/ops/pairhmm_pallas.py), which streams a long read through
// VMEM in chunks and carries the chunk edges from one grid step to the
// next.  Here no chunk is streamed: a thread-block cluster of C CTAs scores
// one pair, CTA rank r owning the read columns [r*W, (r+1)*W), W = threads
// * K, laid out as in the block variant (thread t of rank r keeps M, I, P
// and the read codes of its K columns in registers).  So M, I and P never
// leave the registers, and a pair fills C SMs instead of one.
//
// What bounds it on this card: as in the block variant, the issue of the
// row loop, plus, once a row, a barrier across the cluster.  The row
// exchange is the block variant's, lifted from the warps of a block to the
// warps of the cluster: after its warp scan each warp sends its scan total
// and band partial (s_scan) and its last column's M, I and running max
// (s_edge) into the slots of every CTA of the cluster (distributed shared
// memory, lanes 0..C-1 one CTA each), double-buffered by row parity, and
// meets the others at one cluster barrier (release / acquire).  After it
// every read is local: each warp reduces the totals of the warps to its
// left and the band partials of all, and lane 0 rebuilds P[i][j0-1] of its
// left neighbour's last column, which may live in another CTA.  Max is
// exact in any grouping, so every score equals the plain scan's bits.
// On an H100 the cluster barrier costs about 0.6 us a row more than the
// block variant's __syncthreads (C = 1 against the block variant at 8 kb),
// and sets the row's time at small batches (~1.2 us a row at C = 6-8);
// point-to-point signalling through mbarriers with cluster-scope
// release/acquire was slower still (PERF.md, K2's findings).
//
// Exit rules: every CTA of a cluster reads the same lengths and the same
// slot values, so the gate, the band break and the row count are one
// decision for the whole cluster, and CTAs whose columns all lie past a
// short pair's m still take every barrier.  A cluster barrier precedes
// the first store into another CTA (every CTA has started) and follows
// the last one, so no CTA exits while another may still store into it.
constexpr int CLUSTER_MAX_CTAS = 8;     // the portable cluster size
constexpr int CLUSTER_MAX_WARPS = CLUSTER_MAX_CTAS * BLOCK_MAX_THREADS / 32;
constexpr int CLUSTER_K = 16;          // columns a thread

__global__ void __launch_bounds__(BLOCK_MAX_THREADS)
pairhmm_streamed_cluster_kernel(const uint8_t* __restrict__ hap,
                                const uint8_t* __restrict__ read,
                                const int32_t* __restrict__ hap_len,
                                const int32_t* __restrict__ read_len,
                                const int32_t* __restrict__ full_len,
                                const float* __restrict__ trans, int N,
                                int Mdim, float* __restrict__ out) {
  constexpr int K = CLUSTER_K;
  // per warp of the cluster: (scan total, band partial) and (M, I, running
  // max before the last column, unused) of its last column
  __shared__ float2 s_scan[2][CLUSTER_MAX_WARPS];
  __shared__ float4 s_edge[2][CLUSTER_MAX_WARPS];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int gw = rank * nw + (threadIdx.x >> 5);   // warp of the cluster
  const int nwc = C * nw;
  const int b = blockIdx.x / C;
  const int n = hap_len[b];
  const int m_len = read_len[b];
  const int j0 = (rank * blockDim.x + threadIdx.x) * K;
  float gate_score;
  if (gated(n, m_len, full_len[b], &gate_score)) {
    if (j0 == 0) out[b] = gate_score;
    cluster.sync();
    return;
  }
  const Trans t = load_trans(trans);
  const uint8_t* hp = hap + (size_t)b * N;
  const uint8_t* rd = read + (size_t)b * Mdim;
  const int m = min(max(m_len, 0), Mdim);
  const int rows = min(max(n, 0), N);
  const int nm = n - m_len;
  const uint8_t r0 = rd[0];
  const uint8_t c0r = (m > 1) ? rd[1] : rd[0];
  const float col0_emit = hp[0] == c0r ? MA : MI;
  // lane d < C stores this warp's slots into CTA d
  float2* const to_scan =
      cluster.map_shared_rank(&s_scan[0][0], lane < C ? lane : 0);
  float4* const to_edge =
      cluster.map_shared_rank(&s_edge[0][0], lane < C ? lane : 0);

  float Mr[K], Ir[K], Pr[K];
  uint8_t rc[K];
  float out_v = NEG;
  rows_init<K>(j0, m, hp, N, rd, r0, n, t, Mr, Ir, Pr, rc, out_v);
  float p_edge = NEG;
  if (gw > 0) {
    float M0, D0, P0;
    row0_cell(j0 - 1, hp, N, r0, t, M0, D0, P0);
    p_edge = P0;
  }
  cluster.sync();

  float rb_prev = INFINITY;
  float runp = -INFINITY;   // the last row's scan value
  bool failed = false;
  int buf = 0;
  for (int i = 1; i < rows; i++, buf ^= 1) {
    const uint8_t h = hp[i];
    const float p_up = __shfl_up_sync(FULL, Pr[K - 1], 1);
    const float p_in = lane == 0 ? p_edge : p_up;
    float pre_last;
    const float run = rows_pass1<K>(j0, i, h, p_in, col0_emit, t, Mr, Ir,
                                    Pr, rc, pre_last);
    float excl, incl, wrb;
    warp_scan(run, rb_prev, lane, excl, incl, wrb);
    const float2 sv = make_float2(__shfl_sync(FULL, incl, 31), wrb);
    const float4 ev = make_float4(__shfl_sync(FULL, Mr[K - 1], 31),
                                  __shfl_sync(FULL, Ir[K - 1], 31),
                                  __shfl_sync(FULL, fmx(excl, pre_last), 31),
                                  0.0f);
    if (lane < C) {
      to_scan[buf * CLUSTER_MAX_WARPS + gw] = sv;
      to_edge[buf * CLUSTER_MAX_WARPS + gw] = ev;
    }
    cluster.sync();
    // lp: the max of the totals of the warps left of the previous warp;
    // tot_b: the band max of the whole row
    float lp = -INFINITY, tot_b = -INFINITY;
    for (int w = lane; w < nwc; w += 32) {
      const float2 s = s_scan[buf][w];
      if (w < gw - 1) lp = fmx(lp, s.x);
      tot_b = fmx(tot_b, s.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lp = fmx(lp, __shfl_xor_sync(FULL, lp, o));
      tot_b = fmx(tot_b, __shfl_xor_sync(FULL, tot_b, o));
    }
    if (tot_b < BAND_THRESH) {
      failed = true;
      break;
    }
    float left = -INFINITY;
    float4 el = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gw > 0) {
      left = fmx(lp, s_scan[buf][gw - 1].x);
      el = s_edge[buf][gw - 1];
    }
    runp = fmx(left, excl);
    rb_prev = rows_pass2<K>(j0, i, m, nm, runp, t, Mr, Ir, Pr);
    if (gw > 0) {
      const int jl = j0 - 1;   // >= 32*K - 1: never column 0
      const float Dl = (float)jl * t.d2d + fmx(lp, el.z);
      p_edge = fmx(fmx(el.x + t.m2m, Dl + t.d2m), el.y + t.i2m);
    }
  }
  if (!failed && rows >= 2) {
    float e, x, wrb;
    warp_scan(-INFINITY, rb_prev, lane, e, x, wrb);
    if (lane < C)
      to_scan[buf * CLUSTER_MAX_WARPS + gw] = make_float2(-INFINITY, wrb);
    cluster.sync();
    float tot_b = -INFINITY;
    for (int w = lane; w < nwc; w += 32) tot_b = fmx(tot_b, s_scan[buf][w].y);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tot_b = fmx(tot_b, __shfl_xor_sync(FULL, tot_b, o));
    failed = tot_b < BAND_THRESH;
    if (rows == n) rows_score<K>(j0, m, runp, t, Mr, Ir, out_v);
  }
  const bool owner = m >= 1 ? (j0 <= m - 1 && m - 1 < j0 + K) : j0 == 0;
  if (owner) out[b] = failed ? BAND_FAIL : out_v;
}

// Launch the cluster kernel on B clusters of C CTAs, after checking that
// the card can hold such a cluster.
int launch_cluster(const uint8_t* hap, const uint8_t* read,
                   const int32_t* hap_len, const int32_t* read_len,
                   const int32_t* full_len, const float* trans, int B, int N,
                   int Mdim, int C, float* out, void* stream) {
  const int per = (Mdim + C - 1) / C;   // columns a CTA
  const int threads = ((per + CLUSTER_K - 1) / CLUSTER_K + 31) / 32 * 32;
  if (threads > BLOCK_MAX_THREADS || (long)B * C > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const uint8_t*, const uint8_t*, const int32_t*,
               const int32_t*, const int32_t*, const float*, int, int,
               float*) = pairhmm_streamed_cluster_kernel;
  cudaError_t e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters == 0) return (int)cudaErrorInvalidClusterSize;
  e = cudaLaunchKernelEx(&cfg, kern, hap, read, hap_len, read_len, full_len,
                         trans, N, Mdim, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K>
int launch_warp(const uint8_t* hap, const uint8_t* read,
                       const int32_t* hap_len, const int32_t* read_len,
                       const int32_t* full_len, const float* trans, int B,
                       int N, int Mdim, float* out, void* stream) {
  const int grid = (B + WARP_PAIRS - 1) / WARP_PAIRS;
  pairhmm_resident_warp_kernel<K><<<grid, WARP_PAIRS * 32, 0,
                                    (cudaStream_t)stream>>>(
      hap, read, hap_len, read_len, full_len, trans, B, N, Mdim, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory one block may opt in to on `device`.
int pairhmm_max_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// All pointers are device pointers; hap (B, N) and read (B, Mdim) uint8
// row-major; lengths (B,) int32; trans (7,) float32; out (B,) float32.

// Warp variant: K, the columns a lane, is the least instantiated value
// with 32*K >= Mdim.
int pairhmm_resident_warp(const uint8_t* hap, const uint8_t* read,
                          const int32_t* hap_len, const int32_t* read_len,
                          const int32_t* full_len, const float* trans, int B,
                          int N, int Mdim, float* out, void* stream) {
  const int need = (Mdim + 31) / 32;
#define LTR_WARP(K)                                                        \
  if (need <= K)                                                           \
    return launch_warp<K>(hap, read, hap_len, read_len, full_len, trans, B, \
                          N, Mdim, out, stream);
  LTR_WARP(2)
  LTR_WARP(4)
  LTR_WARP(6)
  LTR_WARP(8)
  LTR_WARP(12)
  LTR_WARP(16)
  LTR_WARP(24)
  LTR_WARP(32)
#undef LTR_WARP
  return (int)cudaErrorInvalidValue;
}

// Block variant: 8 columns a thread up to 8*512 columns, else 16; as many
// whole warps as the width needs.
int pairhmm_resident_block(const uint8_t* hap, const uint8_t* read,
                           const int32_t* hap_len, const int32_t* read_len,
                           const int32_t* full_len, const float* trans, int B,
                           int N, int Mdim, float* out, void* stream) {
  if (Mdim > BLOCK_MAX_THREADS * 16) return (int)cudaErrorInvalidValue;
  const int K = Mdim <= BLOCK_MAX_THREADS * 8 ? 8 : 16;
  const int threads = ((Mdim + K - 1) / K + 31) / 32 * 32;
  if (K == 8)
    pairhmm_resident_block_kernel<8><<<B, threads, 0, (cudaStream_t)stream>>>(
        hap, read, hap_len, read_len, full_len, trans, N, Mdim, out);
  else
    pairhmm_resident_block_kernel<16><<<B, threads, 0, (cudaStream_t)stream>>>(
        hap, read, hap_len, read_len, full_len, trans, N, Mdim, out);
  return (int)cudaGetLastError();
}

// Cluster kernel of K2: C CTAs a pair (1 <= C <= 8, the portable cluster
// size), 16 columns a thread, as many whole warps a CTA as ceil(Mdim / C)
// columns need, at most 512.  Refuses a shape it cannot launch, and a
// cluster the card cannot hold (cudaOccupancyMaxActiveClusters of 0), with
// an error code.
int pairhmm_streamed_cluster(const uint8_t* hap, const uint8_t* read,
                             const int32_t* hap_len, const int32_t* read_len,
                             const int32_t* full_len, const float* trans,
                             int B, int N, int Mdim, int C, float* out,
                             void* stream) {
  if (C < 1 || C > CLUSTER_MAX_CTAS) return (int)cudaErrorInvalidValue;
  return launch_cluster(hap, read, hap_len, read_len, full_len, trans, B, N,
                        Mdim, C, out, stream);
}

// Workspace kernel of K2: threads a block as given (a multiple of 32, at
// most 1024), plus ws: a (B, 3, Mdim) float32 device workspace.
int pairhmm_streamed(const uint8_t* hap, const uint8_t* read,
                     const int32_t* hap_len, const int32_t* read_len,
                     const int32_t* full_len, const float* trans, int B,
                     int N, int Mdim, int threads, float* ws, float* out,
                     void* stream) {
  pairhmm_streamed_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      hap, read, hap_len, read_len, full_len, trans, N, Mdim, ws, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
