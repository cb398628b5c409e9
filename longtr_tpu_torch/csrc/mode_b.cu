// Mode B (the legacy stutter HMM of --stutter-align-len) for NVIDIA Hopper
// (sm_90a): the row DP that reads the artifact tables
// (csrc/mode_b_artifacts.cu builds them on the card).
//
// The row DP, mode_b_cols, replaces longtr_tpu/ops/mode_b_device.py::
// mode_b_cols, a jnp lax.scan over haplotype rows that XLA compiles into
// one program per locus.  For each element b (read segment x haplotype
// config x side) it runs the rows of HapAligner::align_seq_to_hap_short
// (HapAligner.cpp:27-163) and writes M[row, last[b]] for every row, bit for
// bit like the plain torch rows
// (longtr_tpu_torch/ops/mode_b_device.py::mode_b_cols_plain) on the card:
// every expression in the same association order, no fused multiply-add
// (the build passes --fmad=false), and the accurate expf/logf that
// torch.exp/torch.log call for float32 on CUDA.
//
// Row kinds (per element, per row):
//   0 flank row:  I[j] = ((blc + prefix) + j*i2i) + cummax_k<=j(src[k] -
//                 prefix[k] - k*i2i), src[0] = 0, src[k] = M'[k-1] + i2m;
//                 M[j] = emit[j] + max(I[j-1] + m2i, max(M'[j-1] + m2m,
//                 D'[j-1] + m2d)); D[j] = max(M'[j] + d2m, D'[j] + d2d);
//                 column 0: I = blc, M = emit, D = max(D' + d2d, M' + d2m)
//   1 after a stutter row:  M[j] = emit[j] + M'[j-1]; D = IMPOSSIBLE
//   2 stutter row:  M[j] = m + log(sum_d [diff_d > thresh] exp(diff_d)),
//                 terms_d = A[tab[b, s], d, j] + M'[j - bl - (d0 + d*dstep)]
//                 (0 outside [0, j]), m = max_d terms_d, summed in d order
//   3 repeat-block interior: carry M and D
// (primes are the previous row).  A is read in place, as kernel 1 wrote
// it: (tables, n_d, L) with an int32 table index per element and stutter
// ordinal.
//
// Two variants.  The warp kernel (rows up to 1024 columns, n_d <= 16, the
// main path) runs one element a warp, several warps a block: a lane holds
// K contiguous columns of M and D in registers, the cummax of a flank row is
// a shuffle scan, a neighbour's column crosses by shuffle, and a stutter row
// gathers M' from the warp's own shared-memory copy of the previous row
// after one __syncwarp and writes the new row through a second one; A's n_d
// terms are read once, into registers, for the max and the sum.  No block barrier.  What bounds it: the rows of an
// element are a dependent chain, so it is latency-bound; the warps of many
// elements hide each other's latency.  The block kernel (wider rows, or
// more artifact sizes) runs one element a block: the threads share the
// columns, each a contiguous run [j0, j1), and the previous row's M and D
// and a third row (I, or the new stutter row) live in shared memory, 3*L
// floats; a flank row needs one block-wide max-scan (one barrier).  Rows
// wider than the opt-in shared memory (3*L*4 bytes: L above ~19.3k on an
// H100) run the same code on a device-memory workspace of 3*L floats per
// element, so no width goes to the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SCAN_SLOTS = 32;   // one partial per warp

// torch.maximum: a NaN operand wins, else the larger value.
__device__ __forceinline__ float mx(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Block-wide exclusive max-scan of one value per thread (-inf before
// thread 0).  blockDim.x is a multiple of 32.  One barrier inside; the
// caller puts another barrier before `sh` is used again.
__device__ __forceinline__ float block_excl_max(float v, float* sh) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(full, x, o);
    if (lane >= o) x = mx(y, x);
  }
  const float xe = __shfl_up_sync(full, x, 1);
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  float pre = -INFINITY;
  for (int w = 0; w < warp; w++) pre = mx(pre, sh[w]);
  return lane == 0 ? pre : mx(pre, xe);
}

__global__ void __launch_bounds__(1024)
mode_b_cols_block_kernel(const uint8_t* __restrict__ codes,
                   const uint8_t* __restrict__ quals,
                   const float* __restrict__ lw_tab,
                   const float* __restrict__ lc_tab,
                   const float* __restrict__ prefix,
                   const int32_t* __restrict__ last,
                   const uint8_t* __restrict__ hapchar,
                   const uint8_t* __restrict__ kind,
                   const uint8_t* __restrict__ stut_ord,
                   const float* __restrict__ A,
                   const int32_t* __restrict__ tab,
                   const int32_t* __restrict__ bl,
                   const int32_t* __restrict__ d0,
                   const int32_t* __restrict__ dstep,
                   const float* __restrict__ params, int L, int R, int S,
                   int NT, int n_d, float impossible, float thresh,
                   float* __restrict__ ws, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  float* sh = smem;
  float* sM = ws != nullptr ? ws + (size_t)b * 3 * L : smem + SCAN_SLOTS;
  float* sD = sM + L;
  float* sX = sD + L;   // the I row (kind 0) or the new stutter row (kind 2)

  const float i2i = params[0], i2m = params[1], d2d = params[2],
              d2m = params[3], m2m = params[4], m2i = params[5],
              m2d = params[6];
  const uint8_t* cd = codes + (size_t)b * L;
  const uint8_t* qd = quals + (size_t)b * L;
  const float* pf = prefix + (size_t)b * L;
  const uint8_t* hc = hapchar + (size_t)b * R;
  const uint8_t* kd = kind + (size_t)b * R;
  const uint8_t* so = stut_ord + (size_t)b * R;
  float* ob = out + (size_t)b * R;
  // The plain version raises on an index out of range; the kernel clamps
  // instead of reading outside its inputs.
  const int lst = min(max(last[b], 0), L - 1);

  const int K = (L + T - 1) / T;
  const int j0 = min(tid * K, L);
  const int j1 = min(j0 + K, L);
  const bool owner = j0 <= lst && lst < j1;

  const uint8_t h0 = hc[0];
  for (int j = j0; j < j1; j++) {
    const uint8_t q = qd[j];
    const float emit = cd[j] == h0 ? lc_tab[q] : lw_tab[q];
    sM[j] = emit + pf[j];
    sD[j] = impossible;
  }
  if (owner) ob[0] = sM[lst];
  __syncthreads();

  for (int r = 1; r < R; r++) {
    const int k = kd[r];
    const uint8_t h = hc[r];
    if (k == 0) {
      float local = -INFINITY;
      for (int j = j0; j < j1; j++) {
        const float src = j == 0 ? 0.0f : sM[j - 1] + i2m;
        local = mx(local, (src - pf[j]) - (float)j * i2i);
      }
      const float mP0 = j0 >= 1 && j0 < j1 ? sM[j0 - 1] : 0.0f;
      const float dP0 = j0 >= 1 && j0 < j1 ? sD[j0 - 1] : 0.0f;
      float run = block_excl_max(local, sh);
      for (int j = j0; j < j1; j++) {
        const float src = j == 0 ? 0.0f : sM[j - 1] + i2m;
        run = mx(run, (src - pf[j]) - (float)j * i2i);
        const float blc = lc_tab[qd[j]];
        sX[j] = j == 0 ? blc : ((blc + pf[j]) + (float)j * i2i) + run;
      }
      __syncthreads();
      float mP = mP0, dP = dP0;
      for (int j = j0; j < j1; j++) {
        const uint8_t q = qd[j];
        const float emit = cd[j] == h ? lc_tab[q] : lw_tab[q];
        const float om = sM[j], od = sD[j];
        float Mn, Dn;
        if (j == 0) {
          Mn = emit;
          Dn = mx(od + d2d, om + d2m);
        } else {
          Mn = emit + mx(sX[j - 1] + m2i, mx(mP + m2m, dP + m2d));
          Dn = mx(om + d2m, od + d2d);
        }
        sM[j] = Mn;
        sD[j] = Dn;
        mP = om;
        dP = od;
      }
      __syncthreads();
    } else if (k == 1) {
      float mP = j0 >= 1 && j0 < j1 ? sM[j0 - 1] : 0.0f;
      __syncthreads();
      for (int j = j0; j < j1; j++) {
        const uint8_t q = qd[j];
        const float emit = cd[j] == h ? lc_tab[q] : lw_tab[q];
        const float om = sM[j];
        sM[j] = j == 0 ? emit : emit + mP;
        sD[j] = impossible;
        mP = om;
      }
      __syncthreads();
    } else if (k == 2) {
      const int s = min((int)so[r], S - 1);
      const int bl_r = bl[(size_t)b * S + s];
      const int d0_r = d0[(size_t)b * S + s];
      const int ds_r = dstep[(size_t)b * S + s];
      const int t = min(max(tab[(size_t)b * S + s], 0), NT - 1);
      const float* Ab = A + (size_t)t * n_d * L;
      for (int j = j0; j < j1; j++) {
        float m = -INFINITY;
        for (int d = 0; d < n_d; d++) {
          const int idx = (j - bl_r) - (d0_r + d * ds_r);
          const float pre = idx >= 0 && idx <= j ? sM[idx] : 0.0f;
          m = mx(m, Ab[(size_t)d * L + j] + pre);
        }
        float acc = 0.0f;
        for (int d = 0; d < n_d; d++) {
          const int idx = (j - bl_r) - (d0_r + d * ds_r);
          const float pre = idx >= 0 && idx <= j ? sM[idx] : 0.0f;
          const float diff = (Ab[(size_t)d * L + j] + pre) - m;
          acc = acc + (diff > thresh ? expf(diff) : 0.0f);
        }
        sX[j] = m + logf(acc);
      }
      __syncthreads();
      for (int j = j0; j < j1; j++) {
        sM[j] = sX[j];
        sD[j] = impossible;
      }
      __syncthreads();
    } else if (k != 3) {
      // any other kind: M carried, D IMPOSSIBLE (the plain version's
      // where-chain)
      for (int j = j0; j < j1; j++) sD[j] = impossible;
      __syncthreads();
    }
    if (owner) ob[r] = sM[lst];
  }
}

// ---------------------------------------------------------------------------
// The warp kernel: one element a warp.
// ---------------------------------------------------------------------------

constexpr int WARP_ELEMS = 4;   // elements (warps) a block
constexpr int ND_MAX = 16;      // artifact sizes held in registers

template <int K>
__global__ void __launch_bounds__(WARP_ELEMS * 32)
mode_b_cols_warp_kernel(const uint8_t* __restrict__ codes,
                        const uint8_t* __restrict__ quals,
                        const float* __restrict__ lw_tab,
                        const float* __restrict__ lc_tab,
                        const float* __restrict__ prefix,
                        const int32_t* __restrict__ last,
                        const uint8_t* __restrict__ hapchar,
                        const uint8_t* __restrict__ kind,
                        const uint8_t* __restrict__ stut_ord,
                        const float* __restrict__ A,
                        const int32_t* __restrict__ tab,
                        const int32_t* __restrict__ bl,
                        const int32_t* __restrict__ d0,
                        const int32_t* __restrict__ dstep,
                        const float* __restrict__ params, int B, int L, int R,
                        int S, int NT, int n_d, float impossible, float thresh,
                        float* __restrict__ out) {
  // per warp: the previous row (a stutter row gathers from it) and the
  // new stutter row
  __shared__ float prev_rows[WARP_ELEMS][32 * K];
  __shared__ float cur_rows[WARP_ELEMS][32 * K];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARP_ELEMS + w;
  if (b >= B) return;   // the whole warp: nothing below waits on others
  float* prev = prev_rows[w];
  float* cur = cur_rows[w];

  const float i2i = params[0], i2m = params[1], d2d = params[2],
              d2m = params[3], m2m = params[4], m2i = params[5],
              m2d = params[6];
  const uint8_t* cd = codes + (size_t)b * L;
  const uint8_t* qd = quals + (size_t)b * L;
  const float* pfr = prefix + (size_t)b * L;
  const uint8_t* hc = hapchar + (size_t)b * R;
  const uint8_t* kd = kind + (size_t)b * R;
  const uint8_t* so = stut_ord + (size_t)b * R;
  float* ob = out + (size_t)b * R;
  const int lst = min(max(last[b], 0), L - 1);
  const int olane = lst / K;
  const int ocol = lst - olane * K;
  const int jb = lane * K;

  // the element's columns [jb, jb + K): per-column inputs and M, D
  float M[K], D[K], pf[K], lc[K], lw[K];
  uint8_t ch[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int j = jb + k;
    const bool in = j < L;
    const uint8_t q = in ? qd[j] : 0;
    lc[k] = in ? lc_tab[q] : 0.0f;
    lw[k] = in ? lw_tab[q] : 0.0f;
    pf[k] = in ? pfr[j] : 0.0f;
    ch[k] = in ? cd[j] : 0;
  }

  const uint8_t h0 = hc[0];
#pragma unroll
  for (int k = 0; k < K; k++) {
    M[k] = (ch[k] == h0 ? lc[k] : lw[k]) + pf[k];
    D[k] = impossible;
  }
  if (lane == olane) {
    float v = M[0];
#pragma unroll
    for (int k = 1; k < K; k++) v = k == ocol ? M[k] : v;
    ob[0] = v;
  }

  for (int r = 1; r < R; r++) {
    const int kr = kd[r];
    const uint8_t h = hc[r];
    if (kr == 0) {
      // the left neighbour's last column of the previous row
      const float mL = __shfl_up_sync(full, M[K - 1], 1);
      const float dL = __shfl_up_sync(full, D[K - 1], 1);
      float local = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int j = jb + k;
        if (j < L) {
          const float src = j == 0 ? 0.0f : (k == 0 ? mL : M[k > 0 ? k - 1 : 0]) + i2m;
          local = mx(local, (src - pf[k]) - (float)j * i2i);
        }
      }
      float x = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(full, x, o);
        if (lane >= o) x = mx(y, x);
      }
      const float xe = __shfl_up_sync(full, x, 1);
      float run = lane == 0 ? -INFINITY : mx(-INFINITY, xe);
      float I[K];
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int j = jb + k;
        I[k] = 0.0f;
        if (j < L) {
          const float src = j == 0 ? 0.0f : (k == 0 ? mL : M[k > 0 ? k - 1 : 0]) + i2m;
          run = mx(run, (src - pf[k]) - (float)j * i2i);
          I[k] = j == 0 ? lc[k] : ((lc[k] + pf[k]) + (float)j * i2i) + run;
        }
      }
      const float iL = __shfl_up_sync(full, I[K - 1], 1);
      float mP = mL, dP = dL, iP = iL;
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int j = jb + k;
        const float om = M[k], od = D[k];
        if (j < L) {
          const float emit = ch[k] == h ? lc[k] : lw[k];
          if (j == 0) {
            M[k] = emit;
            D[k] = mx(od + d2d, om + d2m);
          } else {
            M[k] = emit + mx(iP + m2i, mx(mP + m2m, dP + m2d));
            D[k] = mx(om + d2m, od + d2d);
          }
        }
        mP = om;
        dP = od;
        iP = I[k];
      }
    } else if (kr == 1) {
      float mP = __shfl_up_sync(full, M[K - 1], 1);
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int j = jb + k;
        const float om = M[k];
        if (j < L) {
          const float emit = ch[k] == h ? lc[k] : lw[k];
          M[k] = j == 0 ? emit : emit + mP;
          D[k] = impossible;
        }
        mP = om;
      }
    } else if (kr == 2) {
#pragma unroll
      for (int k = 0; k < K; k++)
        if (jb + k < L) prev[jb + k] = M[k];
      __syncwarp();
      const int s = min((int)so[r], S - 1);
      const size_t bs = (size_t)b * S + s;
      const int t = min(max(tab[bs], 0), NT - 1);
      const int bl_r = bl[bs], d0_r = d0[bs], ds_r = dstep[bs];
      const float* Ab = A + (size_t)t * n_d * L;
      // one column at a time (not unrolled: the row is rare and its body
      // long), into the lane's own slots of `cur`
#pragma unroll 1
      for (int k = 0; k < K; k++) {
        const int j = jb + k;
        if (j < L) {
          float tv[ND_MAX];
          float m = -INFINITY;
#pragma unroll
          for (int d = 0; d < ND_MAX; d++) {
            if (d < n_d) {
              const int idx = (j - bl_r) - (d0_r + d * ds_r);
              const float pre = idx >= 0 && idx <= j ? prev[idx] : 0.0f;
              tv[d] = Ab[(size_t)d * L + j] + pre;
              m = mx(m, tv[d]);
            }
          }
          float acc = 0.0f;
#pragma unroll
          for (int d = 0; d < ND_MAX; d++) {
            if (d < n_d) {
              const float diff = tv[d] - m;
              acc = acc + (diff > thresh ? expf(diff) : 0.0f);
            }
          }
          cur[j] = m + logf(acc);
        }
      }
#pragma unroll
      for (int k = 0; k < K; k++) {
        if (jb + k < L) {
          M[k] = cur[jb + k];
          D[k] = impossible;
        }
      }
      __syncwarp();   // every lane has read prev before it is written again
    } else if (kr != 3) {
#pragma unroll
      for (int k = 0; k < K; k++) D[k] = impossible;
    }
    if (lane == olane) {
      float v = M[0];
#pragma unroll
      for (int k = 1; k < K; k++) v = k == ocol ? M[k] : v;
      ob[r] = v;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block-kernel launch whose rows live on chip.
long mode_b_smem_bytes(int L) {
  return (SCAN_SLOTS + 3L * L) * (long)sizeof(float);
}

// Widest rows (columns) and most artifact sizes the warp kernel takes.
int mode_b_warp_max_width() { return 32 * 32; }
int mode_b_warp_max_nd() { return ND_MAX; }

// All pointers are device pointers.  codes, quals (B, L) uint8; lw_tab,
// lc_tab (256,) float32; prefix (B, L) float32; last (B,) int32; hapchar,
// kind, stut_ord (B, R) uint8; A (NT, n_d, L) float32; tab, bl, d0, dstep
// (B, S) int32; params (7,) float32; out (B, R) float32.  ws is null (rows
// in shared memory) or a (B, 3, L) float32 device workspace.
int mode_b_cols_block(const uint8_t* codes, const uint8_t* quals,
                      const float* lw_tab, const float* lc_tab,
                      const float* prefix, const int32_t* last,
                      const uint8_t* hapchar, const uint8_t* kind,
                      const uint8_t* stut_ord, const float* A,
                      const int32_t* tab, const int32_t* bl, const int32_t* d0,
                      const int32_t* dstep, const float* params, int B, int L,
                      int R, int S, int NT, int n_d, float impossible,
                      float thresh, int threads, float* ws, float* out,
                      void* stream) {
  const long smem = ws != nullptr ? SCAN_SLOTS * (long)sizeof(float)
                                  : mode_b_smem_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mode_b_cols_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mode_b_cols_block_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind, stut_ord, A,
      tab, bl, d0, dstep, params, L, R, S, NT, n_d, impossible, thresh, ws,
      out);
  return (int)cudaGetLastError();
}

// The warp kernel: arguments as mode_b_cols_block, L <= 1024, n_d <= 16.
int mode_b_cols_warp(const uint8_t* codes, const uint8_t* quals,
                     const float* lw_tab, const float* lc_tab,
                     const float* prefix, const int32_t* last,
                     const uint8_t* hapchar, const uint8_t* kind,
                     const uint8_t* stut_ord, const float* A,
                     const int32_t* tab, const int32_t* bl, const int32_t* d0,
                     const int32_t* dstep, const float* params, int B, int L,
                     int R, int S, int NT, int n_d, float impossible,
                     float thresh, float* out, void* stream) {
  if (L < 1 || L > 32 * 32 || n_d < 1 || n_d > ND_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + WARP_ELEMS - 1) / WARP_ELEMS);
  const dim3 block(WARP_ELEMS * 32);
  cudaStream_t st = (cudaStream_t)stream;
#define MODE_B_WARP(KK)                                                     \
  mode_b_cols_warp_kernel<KK><<<grid, block, 0, st>>>(                       \
      codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind, stut_ord, A, \
      tab, bl, d0, dstep, params, B, L, R, S, NT, n_d, impossible, thresh,   \
      out)
  const int need = (L + 31) / 32;
  if (need <= 1) MODE_B_WARP(1);
  else if (need <= 2) MODE_B_WARP(2);
  else if (need <= 3) MODE_B_WARP(3);
  else if (need <= 4) MODE_B_WARP(4);
  else if (need <= 6) MODE_B_WARP(6);
  else if (need <= 8) MODE_B_WARP(8);
  else if (need <= 12) MODE_B_WARP(12);
  else if (need <= 16) MODE_B_WARP(16);
  else if (need <= 24) MODE_B_WARP(24);
  else MODE_B_WARP(32);
#undef MODE_B_WARP
  return (int)cudaGetLastError();
}

}  // extern "C"
