// The window posteriors (J3) and the EM stutter train loop (J4) for NVIDIA
// Hopper (sm_90a), each one launch.
//
// window_posteriors_kernel replaces longtr_tpu/ops/posterior.py::
// batched_posteriors, which runs calc_log_sample_posteriors under
// jax.jit(jax.vmap(...)): one compiled program a window.  Its plain version
// is longtr_tpu_torch/ops/posterior.py::calc_log_sample_posteriors.  One
// thread-block cluster of KB blocks a locus of the padded window (KB up to
// 8 where the locus has fewer outputs than the cluster has threads, set by
// the wrapper from (S, A)):
//   1. block 0 sorts the locus's unmasked reads by sample, stably, into the
//      locus's slice of a device-memory workspace (block_sort below);
//   2. block k takes every KB-th tile of CH sorted reads, stages their
//      operands in shared memory,
//        a = (clamp(LL[r, x]) + p1[r]) + log 1/2,
//        b = (clamp(LL[r, x]) + p2[r]) + log 1/2   (LL clamped at -600),
//      and a thread an output (s, a1, a2) adds logaddexp(a[a1], b[a2]) of
//      its sample's reads in the tile, in read order, into a float64
//      partial;
//   3. the blocks' partials are added in block order and rounded once, the
//      prior added; a warp a sample takes the logsumexp of its A*A entries
//      (warp_lse), and every entry is normalized by it.
// KB and CH follow from the padded window's (S, A), so a locus gets the
// same bits whichever shard of a mesh it lands on, and on every launch.
//
// em_train_kernel replaces longtr_tpu/parallel/mesh.py::_em_train_local, a
// lax.while_loop inside shard_map: the whole train loop in one device
// dispatch.  Its plain version is longtr_tpu_torch/parallel/mesh.py::
// _em_train, a Python loop of ~235 kernel launches an iteration.  Here one
// thread-block cluster of EM_CTAS blocks runs every iteration of one train
// (em_stutter_genotyper.cpp:170-226).  Before the first, block 0 sorts the
// valid reads by (shard, sample) and cuts each (shard, sample) into chunks
// of `chunk` reads.  An iteration's phases, separated by cluster barriers:
//   B  the first E-step half: a block stages the operands of a few chunks
//      in shared memory (the stutter PMF computed from the diff tables),
//      then a thread a (chunk, a1, a2) sums the chunk's diplotype terms in
//      read order;
//   C  a thread an (s, a1, a2) adds the chunks of each shard in order, then
//      the shards in shard order (mesh._psum's order), then the prior;
//   D  a warp a sample: the logsumexp of its A*A entries (totals);
//   F  a block stages the normalized posteriors (when they fit) and the PMF
//      rows of its items in shared memory; a thread a (read, allele): the
//      second E-step half, the read's phase posteriors f0, f1 and lin =
//      exp(f0) + exp(f1); a thread a (s, a): the logsumexps over one
//      allele axis that the prior update takes;
//   G  a warp a (shard, 32 consecutive (read, allele) entries): the seven
//      category sums of lin (warp_sum); a warp an allele: the prior
//      update's logsumexps over the samples and their logaddexp;
//   H  block 0: a warp a statistic adds the chunks of each shard (lane-
//      strided, then warp_sum) and the shards in shard order; thread 0
//      takes the closed-form M step, the new priors and the convergence
//      test (mesh.py:_em_train's rules) and writes the state the next
//      iteration reads.
// The host reads the result once, after the loop.  The partial sums of
// each shard are formed apart and added in shard order, so the result
// follows the mesh's shard count, as the plain version's does, and not
// where the shards lie, nor the cluster's size.  No float atomics: every
// sum has one order, so two launches on the same inputs give the same bits.
//
// Both compute in float32, like the reference: torch's logaddexp (equal
// infinities return themselves, where m + log1p(exp(-|a-b|)) would give
// NaN for two -inf), torch's logsumexp (an infinite max counts as 0),
// torch.clamp's NaN, the accurate expf/logf/log1pf (the build passes no
// fast-math flag) and no fused multiply-add (--fmad=false).  The long sums
// (a sample's reads, a shard's statistics) accumulate in float64 and round
// once to float32, so each lands within an ulp of the exact sum whatever
// its order, where a float32 running sum over a thousand reads drifts by
// tens.  The shards' float32 partials are added in float32, in shard
// order, as mesh._psum adds them.  The two versions agree within a
// tolerance, not bit for bit.
//
// What bounds them: their work is small (J4 at R=2000 reads, A=12 alleles,
// S=3 samples: ~5 R A^2 logaddexps an iteration, the tables ~0.5 MB), so
// the plain versions were launch-bound.  One launch removes that; what is
// left is latency: J3 gives a locus one cluster, and J4 runs ~7 iterations of
// six dependent phases on the cluster's EM_CTAS SMs, reading what another
// block wrote from L2 (__ldcg: a block's L1 does not see the others'
// stores).  So no thread walks a chain of dependent loads: the operands a
// loop reads are staged in shared memory by parallel loads first, and a
// reduction is a warp's lanes, each over a strided share, then a butterfly
// (warp_sum).  A design in which a thread walked a sum reading L2 one
// value after another was several times slower on an H100.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float LL_CLAMP = -600.0f;
constexpr int WP_THREADS = 512;       // window posteriors: threads a block
constexpr int SORT_BATCH = 4096;      // keys a block stages at once (sort)
constexpr int EM_CTAS = 16;           // EM train: blocks of its cluster,
                                      // Hopper's largest (non-portable)
constexpr int EM_THREADS = 512;
constexpr int EM_MAX_GROUP = 16;      // chunks a block stages at once (B)
constexpr int EM_PN_SMEM = 40960;     // floats of S*A*A staged in F (160 KB)
constexpr int EM_STATE = 16;          // params (6), PMF constants (7)
constexpr int EM_ISTATE = 4;          // done

// torch.clamp(x, min=-600): NaN stays NaN.
__device__ __forceinline__ float clamp_ll(float x) {
  return x < LL_CLAMP ? LL_CLAMP : x;
}

// torch.logaddexp.
__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// torch.logsumexp over x(0) .. x(n-1), one thread: the max (an infinite
// max counts as 0), the sum of exp(x - max) in order, its log plus the
// max.
template <class X>
__device__ float lse(X x, int n) {
  float m = -INFINITY;
  for (int i = 0; i < n; ++i) m = fmaxf(m, x(i));
  if (isinf(m)) m = 0.0f;
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += expf(x(i) - m);
  return logf(s) + m;
}

// A warp's sum: each lane's value, then a butterfly (lane l adds lane
// l + off's value, off = 16, 8, 4, 2, 1); every lane returns lane 0's.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// torch.logsumexp over x(0) .. x(n-1), one warp: lane l takes the values
// l, l + 32, ...: the max over the warp (an infinite max counts as 0),
// each lane's sum of exp(x - max) in order, warp_sum, log plus the max.
template <class X>
__device__ float warp_lse(X x, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, x(i));
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (isinf(m)) m = 0.0f;
  float s = 0.0f;
  for (int i = lane; i < n; i += 32) s += expf(x(i) - m);
  return logf(warp_sum(s)) + m;
}

// The block sorts the items 0 .. n-1 whose key(i) lies in [0, nkeys) by
// key, stably: order[start[k] .. start[k + 1]) are the items of key k in
// increasing order.  start (nkeys + 1 ints), cursor (nkeys) and kbuf
// (SORT_BATCH) are shared memory.  Every thread computes the keys of a
// batch into kbuf; warp 0 takes them in rounds of 32, where the lanes of
// one key find each other with __match_any_sync and the lowest of them adds
// their count (first pass) or moves the key's cursor (second pass).  No
// atomics.
template <class Key>
__device__ void block_sort(Key key, int n, int nkeys, int* start,
                           int* cursor, int* kbuf, int* order) {
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  if (tid < 32)
    for (int k = lane; k <= nkeys; k += 32) start[k] = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && tid < 32) {
      if (lane == 0)
        for (int k = 1; k <= nkeys; ++k) start[k] += start[k - 1];
      __syncwarp();
      for (int k = lane; k < nkeys; k += 32) cursor[k] = start[k];
    }
    for (int b0 = 0; b0 < n; b0 += SORT_BATCH) {
      const int nb = min(SORT_BATCH, n - b0);
      __syncthreads();
      for (int x = tid; x < nb; x += blockDim.x) kbuf[x] = key(b0 + x);
      __syncthreads();
      if (tid >= 32) continue;
      for (int b = 0; b < nb; b += 32) {
        const int k = b + lane < nb ? kbuf[b + lane] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        const bool lead = k >= 0 && (peers & below) == 0;
        if (pass == 0) {
          if (lead) start[k + 1] += __popc(peers);
        } else {
          if (k >= 0) order[cursor[k] + __popc(peers & below)] = b0 + b + lane;
          __syncwarp();
          if (lead) cursor[k] += __popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(WP_THREADS)
window_posteriors_kernel(const float* __restrict__ LL,
                         const float* __restrict__ p1,
                         const float* __restrict__ p2,
                         const int64_t* __restrict__ label,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ prior, int R, int A, int S,
                         int CH, float log_half, int* __restrict__ order,
                         int* __restrict__ starts, double* __restrict__ part,
                         float* __restrict__ P, float* __restrict__ totals) {
  extern __shared__ __align__(16) int wp_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int KB = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  int* start = wp_smem;            // S + 1
  int* cursor = wp_smem + S + 1;   // S
  int* kbuf = wp_smem + ((2 * S + 1 + 3) & ~3);   // the sort's, then the tile
  float* a_s = (float*)kbuf;
  float* b_s = a_s + CH * A;
  const long l = blockIdx.x / KB;
  const int AA = A * A, tid = threadIdx.x, T = blockDim.x;
  const int g = k * T + tid, G = KB * T;
  LL += l * R * A;
  p1 += l * R;
  p2 += l * R;
  label += l * R;
  mask += l * R;
  prior += l * AA;
  order += l * R;
  starts += l * (S + 1);
  part += l * KB * S * AA;
  P += l * S * AA;
  totals += l * S;
  auto sync = [&] {
    __threadfence();
    cluster.sync();
  };
  if (k == 0) {
    block_sort([&](int r) {
                 const int64_t s = label[r];
                 return mask[r] && s >= 0 && s < S ? (int)s : -1;
               },
               R, S, start, cursor, kbuf, order);
    for (int x = tid; x <= S; x += T) starts[x] = start[x];
  }
  sync();
  if (k != 0) {
    for (int x = tid; x <= S; x += T) start[x] = __ldcg(starts + x);
    __syncthreads();
  }
  const int nq = start[S];         // the sorted reads
  for (int o0 = 0; o0 < S * AA; o0 += T) {
    const int i = o0 + tid;
    int s = 0, a1 = 0, a2 = 0, qa = 0, qb = 0;
    if (i < S * AA) {
      s = i / AA;
      a1 = (i - s * AA) / A;
      a2 = i - s * AA - a1 * A;
      qa = start[s];
      qb = start[s + 1];
    }
    double acc = 0.0;
    for (int q0 = k * CH; q0 < nq; q0 += KB * CH) {   // this block's tiles
      const int nt = min(CH, nq - q0);
      __syncthreads();             // the last tile is read
      for (int e = tid; e < nt * A; e += T) {
        const int qq = e / A, x = e - qq * A;
        const int r = __ldcg(order + q0 + qq);
        const float v = clamp_ll(LL[r * A + x]);
        a_s[e] = (v + p1[r]) + log_half;
        b_s[e] = (v + p2[r]) + log_half;
      }
      __syncthreads();
      const int hi = min(qb, q0 + nt) - q0;
#pragma unroll 4
      for (int qq = max(qa, q0) - q0; qq < hi; ++qq)
        acc += lae(a_s[qq * A + a1], b_s[qq * A + a2]);
    }
    if (i < S * AA) part[(long)k * S * AA + i] = acc;
  }
  sync();
  // the blocks' partials in block order, rounded once, then the prior
  for (int i = g; i < S * AA; i += G) {
    double acc = 0.0;
    for (int kk = 0; kk < KB; ++kk) acc += __ldcg(part + (long)kk * S * AA + i);
    P[i] = (float)acc + prior[i % AA];
  }
  sync();
  for (int s = g >> 5; s < S; s += G >> 5) {
    const float* Ps = P + (long)s * AA;
    const float t = warp_lse([&](int i) { return __ldcg(Ps + i); }, AA);
    if ((tid & 31) == 0) totals[s] = t;
  }
  sync();
  for (int i = g; i < S * AA; i += G) P[i] -= __ldcg(totals + i / AA);
}

// The EM train's device-memory workspace, in floats (the int regions are
// read as int, the double regions, at even offsets, as double).  nch_max
// bounds the read chunks of phase B: each (shard, sample) of c reads takes
// ceil(c / chunk) <= c / chunk + 1 of them; ncs is the 32-entry chunks of
// a shard's (read, allele) entries in phase G.
struct EmLayout {
  int nkeys, nch_max, ncs;
  long order, chunk_base, ch_lo, ch_hi, part, P, totals, lin, rowl, coll,
      stat, comb, priors, state, istate, total;
};

__host__ __device__ EmLayout em_layout(int R, int A, int S, int n,
                                       int chunk) {
  EmLayout w;
  w.nkeys = n * S;
  w.nch_max = (R + chunk - 1) / chunk + w.nkeys;
  w.ncs = (R / n * A + 31) / 32;
  long o = 0;
  w.order = o;       o += R;
  w.chunk_base = o;  o += w.nkeys + 1;
  w.ch_lo = o;       o += w.nch_max;
  w.ch_hi = o;       o += w.nch_max;
  o += o & 1;
  w.part = o;        o += 2L * w.nch_max * A * A;
  w.P = o;           o += (long)S * A * A;
  w.totals = o;      o += S;
  w.lin = o;         o += (long)R * A;
  w.rowl = o;        o += (long)S * A;
  w.coll = o;        o += (long)S * A;
  o += o & 1;
  w.stat = o;        o += 2L * n * w.ncs * 7;
  w.comb = o;        o += A;
  w.priors = o;      o += A;
  w.state = o;       o += EM_STATE;
  w.istate = o;      o += EM_ISTATE;
  w.total = o;
  return w;
}

// Chunks a block of EM_THREADS stages at once in phase B.
__host__ __device__ inline int em_group(int A) {
  const int g = EM_THREADS / (A * A);
  return g < 1 ? 1 : (g > EM_MAX_GROUP ? EM_MAX_GROUP : g);
}

// The PMF constants of mesh.py:_em_pmf_from_params, in its order:
// (log(outd) + out_log_nostep, log(outu) + out_log_nostep, out_log_step,
//  log(ind) + in_log_nostep, log(inu) + in_log_nostep, in_log_step,
//  log_equal).
__device__ void pmf_consts(const float* p, float* c) {
  const float in_log_step = logf(1.0f - p[0]);
  const float in_log_nostep = logf(p[0]);
  const float out_log_step = logf(1.0f - p[3]);
  const float out_log_nostep = logf(p[3]);
  c[0] = logf(p[5]) + out_log_nostep;
  c[1] = logf(p[4]) + out_log_nostep;
  c[2] = out_log_step;
  c[3] = logf(p[2]) + in_log_nostep;
  c[4] = logf(p[1]) + in_log_nostep;
  c[5] = in_log_step;
  c[6] = logf((((1.0f - p[1]) - p[2]) - p[4]) - p[5]);
}

// The stutter PMF of one (read, allele), clamped at -600.
struct Pmf {
  float c[7];
  const int32_t* rep;
  const int32_t* eff;
  const uint8_t* in_frame;
  __device__ float operator()(int i) const {
    const int e = __ldg(eff + i), d = __ldg(rep + i);
    const float out_val = e < 0 ? c[0] + c[2] * (float)(-e - 1)
                                : c[1] + c[2] * (float)(e - 1);
    const float in_val = d == 0 ? c[6]
                         : d < 0 ? c[3] + c[5] * (float)(-d - 1)
                                 : c[4] + c[5] * (float)(d - 1);
    return clamp_ll(__ldg(in_frame + i) ? in_val : out_val);
  }
};

// The closed-form M step (mesh.py:_em_mstep_params) from the seven sums
// (in_eq, in_up, in_down, out_up, out_down, in diffs, out diffs).
__device__ void mstep(const float* st, float* p) {
  const float in_tot_up = logf(1.0f + st[1]);
  const float in_tot_down = logf(1.0f + st[2]);
  const float in_tot_eq = logf(1.0f + st[0]);
  const float in_tot_diffs = logf(2.1f + st[5]);    // (1.0 + 1.1) + din
  const float out_tot_up = logf(1.0f + st[3]);
  const float out_tot_down = logf(1.0f + st[4]);
  const float out_tot_diffs = logf(2.1f + st[6]);
  const float out_tot = lae(out_tot_up, out_tot_down);
  const float in_pgeom = expf(lae(in_tot_up, in_tot_down) - in_tot_diffs);
  const float out_pgeom = expf(out_tot - out_tot_diffs);
  const float three[3] = {in_tot_up, in_tot_down, in_tot_eq};
  const float log_total =
      lae(lse([&](int i) { return three[i]; }, 3), out_tot);
  p[0] = in_pgeom > 0.999f ? 0.999f : in_pgeom;     // clamp(max=0.999)
  p[1] = expf(in_tot_up - log_total);
  p[2] = expf(in_tot_down - log_total);
  p[3] = out_pgeom > 0.999f ? 0.999f : out_pgeom;
  p[4] = expf(out_tot_up - log_total);
  p[5] = expf(out_tot_down - log_total);
}

__global__ void __launch_bounds__(EM_THREADS)
em_train_kernel(const int32_t* __restrict__ rep,
                const int32_t* __restrict__ eff,
                const uint8_t* __restrict__ in_frame,
                const float* __restrict__ lp1, const float* __restrict__ lp2,
                const int64_t* __restrict__ label,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ cat,
                const float* __restrict__ w_in,
                const float* __restrict__ w_out,
                const float* __restrict__ init_priors, int R, int A, int S,
                int n, int haploid, int max_iter, float min_abs,
                float min_frac, float log_half, int chunk,
                float* __restrict__ ws, float* __restrict__ out) {
  extern __shared__ __align__(16) int em_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int CL = gridDim.x;                        // blocks of the cluster
  const int g = rank * T + tid, G = CL * T;        // thread of the cluster
  const int gw = g >> 5, GW = G >> 5;              // warp of the cluster
  const EmLayout w = em_layout(R, A, S, n, chunk);
  const int AA = A * A, Rs = R / n, RA = R * A;
  int* order = (int*)(ws + w.order);
  int* chunk_base = (int*)(ws + w.chunk_base);
  int* ch_lo = (int*)(ws + w.ch_lo);
  int* ch_hi = (int*)(ws + w.ch_hi);
  double* part = (double*)(ws + w.part);
  float* P = ws + w.P;
  float* totals = ws + w.totals;
  float* lin = ws + w.lin;
  float* rowl = ws + w.rowl;
  float* coll = ws + w.coll;
  double* stat = (double*)(ws + w.stat);
  float* comb = ws + w.comb;
  float* priors = ws + w.priors;
  float* state = ws + w.state;
  int* istate = (int*)(ws + w.istate);
  float* sm = (float*)em_smem;
  auto sync = [&] {
    __threadfence();
    cluster.sync();
  };

  // Set-up, block 0: the valid reads sorted by (shard, sample), the read
  // chunks of each (shard, sample), the initial state.
  float LL = -INFINITY;         // thread 0 of block 0 keeps the LL
  int converged = 0;
  if (rank == 0) {
    int* start = em_smem;
    block_sort([&](int r) {
                 const int64_t s = label[r];
                 return valid[r] && s >= 0 && s < S ? (r / Rs) * S + (int)s
                                                    : -1;
               },
               R, w.nkeys, start, em_smem + w.nkeys + 1,
               em_smem + ((2 * w.nkeys + 1 + 3) & ~3), order);
    if (tid == 0) {
      int c = 0;
      for (int k = 0; k < w.nkeys; ++k) {
        chunk_base[k] = c;
        for (int q = start[k]; q < start[k + 1]; q += chunk, ++c) {
          ch_lo[c] = q;
          ch_hi[c] = min(q + chunk, start[k + 1]);
        }
      }
      chunk_base[w.nkeys] = c;
      const float init[6] = {0.9f, 0.1f, 0.1f, 0.8f, 0.01f, 0.01f};
      for (int i = 0; i < 6; ++i) state[i] = init[i];
      pmf_consts(state, state + 6);
      istate[0] = 0;
    }
    for (int a = tid; a < A; a += T) priors[a] = init_priors[a];
  }
  sync();

  int it = 0;
  while (it < max_iter && !__ldcg(istate)) {
    Pmf pmf;
    for (int i = 0; i < 7; ++i) pmf.c[i] = __ldcg(state + 6 + i);
    pmf.rep = rep;
    pmf.eff = eff;
    pmf.in_frame = in_frame;
    // B: Gc chunks' operands staged, then a thread a (chunk, a1, a2)
    {
      const int nch = __ldcg(chunk_base + w.nkeys), Gc = em_group(A);
      float* a_s = sm;
      float* b_s = sm + Gc * chunk * A;
      for (int c0 = rank * Gc; c0 < nch; c0 += CL * Gc) {
        __syncthreads();
        for (int e = tid; e < Gc * chunk * A; e += T) {
          const int sl = e / (chunk * A), rem = e - sl * chunk * A;
          const int qq = rem / A, x = rem - qq * A, c = c0 + sl;
          if (c < nch && __ldcg(ch_lo + c) + qq < __ldcg(ch_hi + c)) {
            const int r = __ldcg(order + __ldcg(ch_lo + c) + qq);
            const float v = pmf(r * A + x);
            a_s[e] = (v + __ldg(lp1 + r)) + log_half;
            b_s[e] = (v + __ldg(lp2 + r)) + log_half;
          }
        }
        __syncthreads();
        for (int jj = tid; jj < Gc * AA; jj += T) {
          const int sl = jj / AA, j = jj - sl * AA, c = c0 + sl;
          if (c >= nch) continue;
          const int a1 = j / A, a2 = j - a1 * A;
          const int cnt = __ldcg(ch_hi + c) - __ldcg(ch_lo + c);
          const float* as = a_s + sl * chunk * A + a1;
          const float* bs = b_s + sl * chunk * A + a2;
          double acc = 0.0;
          for (int qq = 0; qq < cnt; ++qq) acc += lae(as[qq * A], bs[qq * A]);
          part[(long)c * AA + j] = acc;
        }
      }
    }
    sync();
    // C: chunks in order within a shard, shards in shard order, the prior
    for (int i = g; i < S * AA; i += G) {
      const int s = i / AA, j = i - s * AA, a1 = j / A, a2 = j - a1 * A;
      float tot = 0.0f;
      for (int k = 0; k < n; ++k) {
        const int key = k * S + s, c1 = __ldcg(chunk_base + key + 1);
        double sh = 0.0;
        for (int c = __ldcg(chunk_base + key); c < c1; ++c)
          sh += __ldcg(part + (long)c * AA + j);
        tot = k == 0 ? (float)sh : tot + (float)sh;
      }
      const float pm = haploid ? (a1 == a2 ? __ldcg(priors + a1) : -1e30f)
                               : __ldcg(priors + a1) + __ldcg(priors + a2);
      P[i] = tot + pm;
    }
    sync();
    // D: the per-sample totals, a warp a sample
    for (int s = gw; s < S; s += GW) {
      const float* Ps = P + (long)s * AA;
      const float t = warp_lse([&](int i) { return __ldcg(Ps + i); }, AA);
      if (lane == 0) totals[s] = t;
    }
    sync();
    // F: lin of each (read, allele); the prior update's logsumexps over
    // one allele axis.  A block takes T consecutive items a round; the
    // normalized posteriors (when they fit) and its items' PMF rows are
    // staged in shared memory.
    {
      const bool pn_on_chip = S * AA <= EM_PN_SMEM;
      float* pn_s = sm;
      float* prow = sm + (pn_on_chip ? S * AA : 0);
      if (pn_on_chip)
        for (int x = tid; x < S * AA; x += T)
          pn_s[x] = __ldcg(P + x) - __ldcg(totals + x / AA);
      auto Pn = [&](int s, int x) {
        return pn_on_chip ? pn_s[s * AA + x]
                          : __ldcg(P + (long)s * AA + x) - __ldcg(totals + s);
      };
      const int n_items = RA + 2 * S * A;
      for (int i0 = rank * T; i0 < n_items; i0 += G) {
        const int r0 = min(i0, RA) / A;
        const int e1 = min(RA, ((min(i0 + T, RA) + A - 1) / A) * A);
        __syncthreads();
        for (int e = r0 * A + tid; e < e1; e += T) prow[e - r0 * A] = pmf(e);
        __syncthreads();
        const int i = i0 + tid;
        if (i < RA) {
          const int r = i / A, a = i - r * A;
          float v = 0.0f;
          if (valid[r]) {
            const int s = (int)label[r];
            const float* row = prow + (r - r0) * A;
            const float h1 = log_half + __ldg(lp1 + r);
            const float h2 = log_half + __ldg(lp2 + r);
            const float one_a = h1 + row[a], two_a = h2 + row[a];
            // f0: over a2 of Pn[s, a, a2] + (one[a] - lae(one[a], two[a2]))
            const float f0 = lse([&](int a2) {
              return Pn(s, a * A + a2) + (one_a - lae(one_a, h2 + row[a2]));
            }, A);
            // f1: over a1 of Pn[s, a1, a] + (two[a] - lae(one[a1], two[a]))
            const float f1 = lse([&](int a1) {
              return Pn(s, a1 * A + a) + (two_a - lae(h1 + row[a1], two_a));
            }, A);
            v = expf(f0) + expf(f1);
          }
          lin[i] = v;
        } else if (i < n_items) {
          const int j = i - RA, is_row = j < S * A;
          const int sa = is_row ? j : j - S * A;
          const int s = sa / A, a = sa - s * A;
          if (is_row)
            rowl[sa] = lse([&](int x) { return Pn(s, a * A + x); }, A);
          else
            coll[sa] = lse([&](int x) { return Pn(s, x * A + a); }, A);
        }
      }
    }
    sync();
    // G: the seven sums of each shard's 32-entry chunks; the prior update
    for (int wi = gw; wi < n * w.ncs + A; wi += GW) {
      if (wi < n * w.ncs) {
        const int k = wi / w.ncs, e = (wi - k * w.ncs) * 32 + lane;
        double v7[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
        if (e < Rs * A) {
          const long x = (long)k * Rs * A + e;
          const float v = __ldcg(lin + x);
          const int c = __ldg(cat + x);
          v7[0] = c == 0 ? v : 0.0f;
          v7[1] = c == 1 ? v : 0.0f;
          v7[2] = c == 2 ? v : 0.0f;
          v7[3] = c == 3 ? v : 0.0f;
          v7[4] = c == 4 ? v : 0.0f;
          v7[5] = v * __ldg(w_in + x);
          v7[6] = v * __ldg(w_out + x);
        }
#pragma unroll
        for (int q = 0; q < 7; ++q) v7[q] = warp_sum(v7[q]);
        if (lane < 7) {
          double mine = v7[0];
#pragma unroll
          for (int q = 1; q < 7; ++q) mine = lane == q ? v7[q] : mine;
          stat[(long)wi * 7 + lane] = mine;
        }
      } else {
        const int a = wi - n * w.ncs;
        const float c1 =
            warp_lse([&](int s) { return __ldcg(rowl + s * A + a); }, S);
        const float c2 =
            warp_lse([&](int s) { return __ldcg(coll + s * A + a); }, S);
        if (lane == 0) comb[a] = lae(c1, c2);
      }
    }
    sync();
    // H: the statistics, the M step and the convergence test, block 0
    if (rank == 0) {
      __shared__ float st[7];
      float* s_tot = sm;
      float* s_comb = sm + S;
      const int wq = tid >> 5;
      if (wq < 7) {
        float tot = 0.0f;
        for (int k = 0; k < n; ++k) {
          double sh = 0.0;
          for (int j = lane; j < w.ncs; j += 32)
            sh += __ldcg(stat + ((long)k * w.ncs + j) * 7 + wq);
          sh = warp_sum(sh);
          tot = k == 0 ? (float)sh : tot + (float)sh;
        }
        if (lane == 0) st[wq] = tot;
      }
      for (int x = tid; x < S; x += T) s_tot[x] = __ldcg(totals + x);
      for (int x = tid; x < A; x += T) s_comb[x] = __ldcg(comb + x);
      __syncthreads();
      if (tid == 0) {
        float new_LL = 0.0f;
        for (int s = 0; s < S; ++s) new_LL += s_tot[s];
        const float lc = lse([&](int a) { return s_comb[a]; }, A);
        float np[6], old[6];
        mstep(st, np);
        bool small = true;
        for (int p = 0; p < 6; ++p) {
          old[p] = __ldcg(state + p);
          small = small && fabsf(np[p] - old[p]) < 1e-4f;
        }
        // On the first iteration LL is -inf: abs_change is +inf and
        // frac_change NaN, so only the parameter test can stop it there.
        const bool nonmono = new_LL < LL + 1e-10f;
        const float abs_change = new_LL - LL;
        const float frac_change = -(new_LL - LL) / LL;
        const bool conv_after =
            (abs_change < min_abs && frac_change < min_frac) || small;
        if (!nonmono) {
          for (int p = 0; p < 6; ++p) state[p] = np[p];
          pmf_consts(np, state + 6);
          for (int a = 0; a < A; ++a) priors[a] = s_comb[a] - lc;
        }
        LL = new_LL;
        converged = nonmono || conv_after;
        istate[0] = converged;
      }
    }
    ++it;
    sync();
  }

  // The result: converged, n_iter, params (6), totals (S), the normalized
  // posteriors (S, A, A) of the final E-step (zeros if none ran).
  if (g == 0) {
    out[0] = (float)converged;
    out[1] = (float)it;
    for (int p = 0; p < 6; ++p) out[2 + p] = __ldcg(state + p);
  }
  for (int s = g; s < S; s += G) out[8 + s] = it ? __ldcg(totals + s) : 0.0f;
  for (int i = g; i < S * AA; i += G)
    out[8 + S + i] = it ? __ldcg(P + i) - __ldcg(totals + i / AA) : 0.0f;
}

template <typename K>
int set_smem(K kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline long lmax(long a, long b) { return a > b ? a : b; }

}  // namespace

extern "C" {

long em_train_workspace_floats(int R, int A, int S, int n, int chunk) {
  return em_layout(R, A, S, n, chunk).total;
}

// Dynamic shared memory of an EM train: the set-up's sort (block 0), the
// staged chunks of phase B, the normalized posteriors (when S*A*A fits
// EM_PN_SMEM) and PMF rows of phase F, the totals and the prior update's
// sums of phase H.
long em_train_smem_bytes(int A, int S, int n, int chunk) {
  const long f = sizeof(float);
  const long sort = (((2L * n * S + 1 + 3) & ~3L) + SORT_BATCH)
                    * (long)sizeof(int);
  const long b = 2L * em_group(A) * chunk * A * f;
  const long pn = (long)S * A * A <= EM_PN_SMEM ? (long)S * A * A : 0;
  const long fF = (pn + EM_THREADS + 2L * A) * f;
  const long h = (long)(S + A) * f;
  return lmax(lmax(sort, b), lmax(fF, h));
}

long window_posteriors_smem_bytes(int A, int S, int CH) {
  const long tile = 2L * CH * A * (long)sizeof(float);
  const long sort = SORT_BATCH * (long)sizeof(int);
  return ((2L * S + 1 + 3) & ~3L) * (long)sizeof(int)
         + (tile > sort ? tile : sort);
}

// J3: a cluster of KB blocks a locus of the (L, R, A) window, each block
// taking every KB-th tile of CH sorted reads; order (L, R) and starts (L,
// S + 1) int32 and part (L, KB, S, A, A) float64 are workspace; P (L, S, A,
// A) and totals (L, S) are written.
int window_posteriors(const float* LL, const float* p1, const float* p2,
                      const int64_t* label, const uint8_t* mask,
                      const float* prior, int L, int R, int A, int S, int KB,
                      int CH, float log_half, int* order, int* starts,
                      double* part, float* P, float* totals, void* stream) {
  if (L < 1 || R < 1 || A < 1 || S < 1 || KB < 1 || KB > 8 || CH < 1)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const float*, const float*, const float*, const int64_t*,
               const uint8_t*, const float*, int, int, int, int, float, int*,
               int*, double*, float*, float*) = window_posteriors_kernel;
  const long smem = window_posteriors_smem_bytes(A, S, CH);
  int e = set_smem(kern, smem);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)L * KB);
  cfg.blockDim = dim3(WP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t ce = cudaLaunchKernelEx(&cfg, kern, LL, p1, p2, label, mask,
                                      prior, R, A, S, CH, log_half, order,
                                      starts, part, P, totals);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// J4: one cluster of EM_CTAS blocks trains one locus; ws holds
// em_train_workspace_floats floats; out (8 + S + S*A*A floats) is written.
int em_train(const int32_t* rep, const int32_t* eff, const uint8_t* in_frame,
             const float* lp1, const float* lp2, const int64_t* label,
             const uint8_t* valid, const int32_t* cat, const float* w_in,
             const float* w_out, const float* init_priors, int R, int A,
             int S, int n, int haploid, int max_iter, float min_abs,
             float min_frac, float log_half, int chunk, float* ws, float* out,
             void* stream) {
  if (R < 1 || A < 1 || S < 1 || n < 1 || R % n || chunk < 1)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const int32_t*, const int32_t*, const uint8_t*, const float*,
               const float*, const int64_t*, const uint8_t*, const int32_t*,
               const float*, const float*, const float*, int, int, int, int,
               int, int, float, float, float, int, float*, float*) =
      em_train_kernel;
  const long smem = em_train_smem_bytes(A, S, n, chunk);
  int e = set_smem(kern, smem);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = EM_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(EM_CTAS);
  cfg.blockDim = dim3(EM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t ce =
      cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (ce != cudaSuccess) return (int)ce;
  if (clusters == 0) return (int)cudaErrorInvalidClusterSize;
  ce = cudaLaunchKernelEx(&cfg, kern, rep, eff, in_frame, lp1, lp2, label,
                          valid, cat, w_in, w_out, init_priors, R, A, S, n,
                          haploid, max_iter, min_abs, min_frac, log_half,
                          chunk, ws, out);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

}  // extern "C"
