// Mode-A pair-HMM kernels for NVIDIA Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of longtr_tpu/ops/pairhmm_pallas.py:
//   pairhmm_resident  <- _kernel          (launched by _pallas_call)
//   pairhmm_streamed  <- _kernel_chunked  (launched by _pallas_call_chunked)
//
// Both compute, for each (haplotype, read) pair, the max-product DP of
// HapAligner::align_seq_to_hap (HapAligner.cpp:236-343) without traceback,
// bit for bit like the plain torch scan (longtr_tpu_torch/ops/pairhmm.py)
// and the native C++ scorer (longtr_tpu/native/longtr_native.cc:1413-1568).
// Exactness rests on float32 add, integer-valued products and max, each in
// the native scorer's order.  The build passes --fmad=false so that no
// product is contracted into a fused multiply-add.
//
// Mapping: one thread block per pair.  Rows i (haplotype positions) run
// sequentially; the block's threads share the read axis j.  In row i
//   M[i][j] = emit(i, j) + P[i-1][j-1]                  (j >= 1)
//   I[i][j] = MA + max(M[i-1][j] + m2i, I[i-1][j] + i2i)
//   D[i][j] = j*d2d + max_{k<j} ((M[i][k] + m2d) - (k+1)*d2d)
//   P[i][j] = max(max(M + m2m, D + d2m), I + i2m)      (fused predecessor)
// so the only dependency along j inside a row is the running max of D,
// which the block computes as an exclusive max-scan.  The band check of
// row i (a block-wide max) rides on the scan of row i+1, and a pair stops
// once its band flag is set or its last row is done, since neither
// changes an output.
//
// What bounds them: each row costs a block-wide scan (warp shuffles plus
// a barrier) between a few float ops per cell, so both kernels are bound
// by latency of the row loop, not by bytes or FLOPs.  The resident
// kernel keeps M, I, P of the previous row and the read in shared memory
// and gives each thread a contiguous run of j, so a row needs one scan
// whatever the read length.  The streamed kernel keeps the rows in a
// device-memory workspace (mostly L2-resident) and walks the read axis in
// tiles of one element per thread, carrying the D running max and the
// predecessor edge from tile to tile; it takes any length.

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

// Resident kernel: the previous row's M, I and fused predecessor P, and
// the read codes, live in dynamic shared memory.  Thread t owns the
// contiguous columns [j0, j1).  A row is two passes over them: pass 1
// forms M and the local running max of the D terms; after the block scan,
// pass 2 recomputes M (same ops, same bits), forms I, D, the band and
// corner terms and writes the new row.  Pass 1 reads the one column a
// neighbour owns (P[j0-1]) before the scan's barrier, so pass 2 may
// overwrite freely.
__global__ void __launch_bounds__(1024)
pairhmm_resident_kernel(const uint8_t* __restrict__ hap,
                        const uint8_t* __restrict__ read,
                        const int32_t* __restrict__ hap_len,
                        const int32_t* __restrict__ read_len,
                        const int32_t* __restrict__ full_len,
                        const float* __restrict__ trans, int N, int Mdim,
                        float* __restrict__ out) {
  extern __shared__ float smem[];
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

  float* sM = smem;
  float* sI = sM + Mdim;
  float* sP = sI + Mdim;
  float* sh = sP + Mdim;
  uint8_t* sR = reinterpret_cast<uint8_t*>(sh + SCAN_SLOTS);

  const int K = (m + T - 1) / T;
  const int j0 = min(tid * K, m);
  const int j1 = min(j0 + K, m);
  const uint8_t r0 = rd[0];
  const uint8_t c0r = (m > 1) ? rd[1] : rd[0];
  const float col0_emit = hp[0] == c0r ? MA : MI;

  float out_v = NEG;
  for (int j = j0; j < j1; j++) {
    float M0, D0, P0;
    row0_cell(j, hp, N, r0, t, M0, D0, P0);
    sM[j] = M0;
    sI[j] = NEG;
    sP[j] = P0;
    sR[j] = rd[j];
    if (n == 1 && j == m - 1) out_v = mx(mx(M0, NEG), D0);
  }
  __syncthreads();

  // Band row-max of the previous row, reduced in the next row's scan;
  // +inf marks "no row to check yet".
  float rb_prev = INFINITY;
  bool failed = false;
  for (int i = 1; i < rows; i++) {
    const uint8_t h = hp[i];
    float run = -INFINITY;
    for (int j = j0; j < j1; j++) {
      const float Mn = j == 0 ? (sI[0] + t.i2m) + col0_emit
                              : (h == sR[j] ? MA : MI) + sP[j - 1];
      run = mx(run, c_term(Mn, j, t));
    }
    const float p_left = (j0 >= 1 && j0 < j1) ? sP[j0 - 1] : 0.0f;
    float excl, tot_a, tot_b;
    block_scan(run, rb_prev, sh, excl, tot_a, tot_b);
    if (tot_b < BAND_THRESH) {
      failed = true;
      break;
    }
    float runp = excl;
    float p_prev = p_left;
    float rb = NEG;
    for (int j = j0; j < j1; j++) {
      const float p_old = sP[j];
      float Mn, In;
      if (j == 0) {
        Mn = (sI[0] + t.i2m) + col0_emit;
        In = (MA + t.m2i) + (float)(i - 1) * t.i2i;
      } else {
        Mn = (h == sR[j] ? MA : MI) + p_prev;
        In = MA + mx(sM[j] + t.m2i, sI[j] + t.i2i);
      }
      const float Dn = j == 0 ? NEG : (float)j * t.d2d + runp;
      runp = mx(runp, c_term(Mn, j, t));
      const float best = mx(mx(Mn, In), Dn);
      if (j >= 1) rb = mx(rb, band_cand(best, nm, i, j, t));
      if (i == n - 1 && j == m - 1) out_v = best;
      sM[j] = Mn;
      sI[j] = In;
      sP[j] = mx(mx(Mn + t.m2m, Dn + t.d2m), In + t.i2m);
      p_prev = p_old;
    }
    rb_prev = rb;
    __syncthreads();
  }
  if (!failed && rows >= 2) {
    float e, ta, tb;
    block_scan(-INFINITY, rb_prev, sh, e, ta, tb);
    failed = tb < BAND_THRESH;
  }
  const bool owner = m >= 1 ? (j0 <= m - 1 && m - 1 < j1) : tid == 0;
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

}  // namespace

extern "C" {

// Dynamic shared memory the resident kernel needs for a read width Mdim.
long pairhmm_resident_smem_bytes(int Mdim) {
  const long bytes = (3L * Mdim + SCAN_SLOTS) * (long)sizeof(float) + Mdim;
  return (bytes + 15) / 16 * 16;
}

// The most dynamic shared memory one block may opt in to on `device`.
int pairhmm_max_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// All pointers are device pointers; hap (B, N) and read (B, Mdim) uint8
// row-major; lengths (B,) int32; trans (7,) float32; out (B,) float32.
int pairhmm_resident(const uint8_t* hap, const uint8_t* read,
                     const int32_t* hap_len, const int32_t* read_len,
                     const int32_t* full_len, const float* trans, int B,
                     int N, int Mdim, int threads, float* out, void* stream) {
  const long smem = pairhmm_resident_smem_bytes(Mdim);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pairhmm_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pairhmm_resident_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      hap, read, hap_len, read_len, full_len, trans, N, Mdim, out);
  return (int)cudaGetLastError();
}

// As pairhmm_resident, plus ws: a (B, 3, Mdim) float32 device workspace.
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
