// The window posteriors (J3) and the EM stutter train loop (J4) for NVIDIA
// Hopper (sm_90a), each one launch.
//
// window_posteriors_kernel replaces longtr_tpu/ops/posterior.py::
// batched_posteriors, which runs calc_log_sample_posteriors under
// jax.jit(jax.vmap(...)): one compiled program a window.  Its plain version
// is longtr_tpu_torch/ops/posterior.py::calc_log_sample_posteriors.  For
// each locus of the padded window it forms, for each unmasked read r,
//   a = (clamp(LL[r, x]) + p1[r]) + log 1/2,
//   b = (clamp(LL[r, x]) + p2[r]) + log 1/2   (LL clamped at -600),
// adds logaddexp(a[a1], b[a2]) of each sample's reads into output (s, a1,
// a2) in float64, rounds once, adds the prior, and normalizes each sample
// by the logsumexp of its A*A entries (warp_lse).
//
// What bounds J3: bytes.  A real window of the 512-STR catalog, (L, R_max,
// A_max, S_max) = (256, 60, 4, 3), moves 575,488 bytes (0.17 us at 3.35
// TB/s) for 1.5e6 operations (0.02 us); a launch alone costs microseconds,
// so the kernel's time is the latency of its structure.  The design:
//   - A locus's work follows its own count n of reads (the rows [0, n) of
//     its slice, which the host knows before padding), never R_max.
//   - No sort.  Each tile of CH staged reads is cut into rounds of 32, and
//     a warp gives each sample of a round the bit mask of its reads
//     (__ballot_sync(key == s), one ballot a sample present).  The thread
//     of output (s, a1, a2) walks its sample's set bits in order: it sums
//     its sample's reads in read order, the order a stable sort by sample
//     gives, and a warp whose lanes hold different samples takes as long
//     as its longest sample, not as all of them.
//   - Small loci (em_cuda.window_plan: a thread's walk of about n / S
//     reads for each of its outputs at most WINDOW_SMALL_STEPS long, so
//     a count of at most small_max): a team of 1-4 warps a locus, teams
//     of four warps at most a block, no cluster; each sample's outputs
//     start a warp of their own.  The team stages its locus's operands in
//     shared memory with coalesced loads, keeps the float64 sums there,
//     takes the logsumexps and writes P and the totals once: no
//     device-memory workspace, no fence, no barrier but the team's own (a
//     named barrier, or __syncwarp).  The 256 loci of a real window take
//     256 blocks of three warps (a sample each), all resident at once on
//     132 SMs: one wave.
//   - Large loci: a cluster of WP_CLUSTER blocks a locus.  Block k sums
//     the rounds k, k + 8, k + 16, ... (so that each block holds every
//     sample's share where a locus lists its reads sample by sample) into
//     float64 partials in its own shared memory (in J sub-teams of warps
//     where the outputs would leave threads idle: sub-team j takes the
//     block's rounds j, j + J, ..., and the block adds the sub-teams'
//     partials in order); one cluster barrier; block k adds every block's
//     partials of its samples (k, k + 8, ...) over DSMEM in block order;
//     a last cluster barrier keeps each block's shared memory until the
//     others have read it.  Samples whose sums do not fit shared memory at
//     once are taken in batches, each batch behind its own two barriers.
// One launch a window: the large loci's clusters, then the small loci's
// blocks.  The kernel reads the loci's counts (int32, copied with the
// launch) and maps its blocks to loci itself: small block b's team t takes
// locus b * teams + t if that locus is small, cluster c the c-th large
// locus in window order (a ballot over the counts).  The route and J
// follow from the locus's count and the padded (A, S) alone, and every
// sum has one order, so a locus gets the same bits whichever shard of a
// mesh it lands on, and on every launch.
//
// em_train_kernel replaces longtr_tpu/parallel/mesh.py::_em_train_local, a
// lax.while_loop inside shard_map: the whole train loop in one device
// dispatch.  Its plain version is longtr_tpu_torch/parallel/mesh.py::
// _em_train, a Python loop of ~235 kernel launches an iteration.  Here one
// thread-block cluster of EM_CTAS blocks runs every iteration of one train
// (em_stutter_genotyper.cpp:170-226).  Before the first, block 0 sorts the
// valid reads by (shard, sample) and cuts each (shard, sample) into chunks
// of `chunk` reads; block r owns chunks r nch / EM_CTAS .. (r + 1) nch /
// EM_CTAS - 1 of the nch for the whole train.  Every block keeps its own
// copy of the state (parameters, PMF constants, priors, LL, stop flag) in
// shared memory and updates it alike.  An iteration:
//   B  a block stages its reads' operands (the stutter PMF from the diff
//      tables), forms each read's A*A diplotype terms, sums each chunk's in
//      read order, then its chunks of one (shard, sample) in order (a
//      segment);
//      -- cluster barrier 1 --
//   C  P = each (shard, sample)'s segments added in block order, the shards
//      in shard order (mesh._psum's), plus the prior; the totals (a warp a
//      sample's logsumexp), the normalized posteriors, the logsumexps over
//      one allele axis and the prior update's logaddexps;
//   F  a thread an owned (read, allele): the read's phase posteriors f0, f1
//      from its terms and lin = exp(f0) + exp(f1);
//   G  a warp an owned chunk: its seven category sums of lin;
//      -- cluster barrier 2 --
//   H  every block: a warp a statistic adds each shard's chunks (lane-
//      strided, then warp_sum) and the shards in shard order; thread 0 takes
//      the closed-form M step, the new priors and the convergence test
//      (mesh.py:_em_train's rules) into the block's state.
// The host picks one of two branches from the shape (em_train_smem_bytes
// against the card's shared memory):
//   terms kept: a block keeps its reads' terms in shared memory from B to
//     F; C's segments and G's statistics are read from the blocks' shared
//     memory over DSMEM, and every block forms all of C itself.  Two
//     cluster barriers an iteration.
//   terms recomputed, where they or the posteriors do not fit (a cohort of
//     hundreds of samples): B writes the segments to device memory, block r
//     forms C for samples r, r + EM_CTAS, ... into device memory behind a
//     third barrier, and F restages its chunks a group at a time and forms
//     the terms again.  Three cluster barriers an iteration.
// Both do the same arithmetic in the same order and give the same bits.
// Besides, one barrier follows the set-up and one precedes the exit: no
// block leaves while another reads its shared memory.  The host reads the
// result once, after the loop.  Each shard's partial sums are formed apart
// and added in shard order, so the result follows the mesh's shard count,
// as the plain version's does, and not where the shards lie.  No float
// atomics: every sum has one order, so two launches on the same inputs
// give the same bits.
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
// left is latency: J3's few dependent steps a locus (above), and J4's ~7
// iterations of dependent phases on the cluster's EM_CTAS SMs.  So no
// thread walks a chain of dependent loads: the operands a loop reads are
// staged in shared memory by parallel loads first, and a reduction is a
// warp's lanes, each over a strided share, then a butterfly (warp_sum).  A
// design in which a thread walked a sum reading L2 one value after another
// was several times slower on an H100.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float LL_CLAMP = -600.0f;
constexpr int WP_THREADS = 512;       // window posteriors: a large
                                      // locus's block,
constexpr int WP_CLUSTER = 8;         // and its cluster (portable)
constexpr int SORT_BATCH = 4096;      // keys a block stages at once (sort)
constexpr int EM_CTAS = 16;           // EM train: blocks of its cluster,
                                      // Hopper's largest (non-portable)
constexpr int EM_THREADS = 512;
constexpr int EM_MAX_GROUP = 16;      // recomputed: a group's reads, in
                                      // chunks of its size
constexpr int EM_P_FLOATS = 16384;    // recomputed: a batch of samples' P

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

// The shared memory of one J3 team (a small locus's warps, or a large
// locus's block), byte offsets of its regions: the float64 sums of J
// sub-teams (J x SB x A x A), the staged operands of a tile of CH reads (a,
// b: CH x A floats), the batch's posteriors before normalization (SB x A x
// A floats), its totals (SB) and the tile's round masks (CH / 32 x SB).  SB
// is the samples of a batch.
struct WpSmem {
  long part, a, b, P, tot, msk, total;
};

__host__ __device__ inline WpSmem wp_smem(int A, int SB, int CH, int J) {
  const long O = (long)SB * A * A;
  WpSmem w;
  long o = 0;
  w.part = o;  o += (long)J * O * (long)sizeof(double);
  w.a = o;     o += (long)CH * A * (long)sizeof(float);
  w.b = o;     o += (long)CH * A * (long)sizeof(float);
  w.P = o;     o += O * (long)sizeof(float);
  w.tot = o;   o += (long)SB * (long)sizeof(float);
  w.msk = o;   o += (long)(CH / 32) * SB * (long)sizeof(unsigned);
  w.total = (o + 15) & ~15L;
  return w;
}

// The threads of a J3 team and their barrier: the whole block (id 0), one
// warp, or a named barrier of W threads.
struct Team {
  int tid, W, id;
  __device__ __forceinline__ void sync() const {
    if (id == 0)
      __syncthreads();
    else if (W == 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(W) : "memory");
  }
};

// One J3 team sums the reads of samples [s0, s0 + SB) of one locus of n
// reads into part (J x SB*A*A doubles; sub-team j's sums at j * SB*A*A).
// Round g is the reads [32 g, 32 g + 32) below n; the team takes the
// rounds g0, g0 + gs, g0 + 2 gs, ..., CH / 32 of them a tile, and its
// sub-team j the team's rounds j, j + J, ...  A thread of output (s, a1,
// a2) of sub-team j adds logaddexp(a[a1], b[a2]) of each read of sample s
// in its rounds, in read order, to its float64 sum.  Each sample's
// outputs start a warp of their own (SS = roundup(A*A, 32) thread slots a
// sample), so no warp waits on two samples' reads where a round holds one
// sample's.  With J > 1, J * SB * SS <= W and each thread holds one
// output.
__device__ void wp_team_sums(const Team& tm, const float* __restrict__ LL,
                             const float* __restrict__ p1,
                             const float* __restrict__ p2,
                             const int64_t* __restrict__ label,
                             const uint8_t* __restrict__ mask, int A, int s0,
                             int SB, int n, int g0, int gs, int CH, int J,
                             float log_half, double* part, float* a_s,
                             float* b_s, unsigned* msk) {
  const int AA = A * A, O = SB * AA, SS = (AA + 31) & ~31, U = SB * SS;
  const int lane = tm.tid & 31, w = tm.tid >> 5, nw = tm.W >> 5;
  const int j = J > 1 ? tm.tid / U : 0;
  const int u_first = J > 1 ? tm.tid - j * U : tm.tid;
  const int u_step = J > 1 ? U : tm.W;
  const int TR = CH >> 5;                    // rounds a tile
  const int nt = g0 < (n + 31) >> 5 ? ((n + 31) / 32 - g0 + gs - 1) / gs : 0;
  for (int o = tm.tid; o < J * O; o += tm.W) part[o] = 0.0;
  for (int t0 = 0; t0 < nt; t0 += TR) {      // t0: the tile's first round
    const int nr = min(TR, nt - t0);
    tm.sync();                               // the last tile is read
    for (int e = tm.tid; e < nr * 32 * A; e += tm.W) {
      const int qq = e / A, x = e - qq * A;
      const int r = (g0 + (t0 + (qq >> 5)) * gs) * 32 + (qq & 31);
      if (r < n) {
        const float v = clamp_ll(LL[(long)r * A + x]);
        a_s[e] = (v + p1[r]) + log_half;
        b_s[e] = (v + p2[r]) + log_half;
      }
    }
    // each round's masks: bit q of msk[rr * SB + s] is read q of the
    // tile's round rr if that read is unmasked and of sample s0 + s
    for (int rr = w; rr < nr; rr += nw) {
      const int r = (g0 + (t0 + rr) * gs) * 32 + lane;
      int key = -1;
      if (r < n && mask[r]) {
        const int64_t s = label[r] - s0;
        if (s >= 0 && s < SB) key = (int)s;
      }
      for (int s = lane; s < SB; s += 32) msk[rr * SB + s] = 0u;
      __syncwarp();
      unsigned left = __ballot_sync(0xffffffffu, key >= 0);
      while (left) {
        const int k = __shfl_sync(0xffffffffu, key, __ffs(left) - 1);
        const unsigned m = __ballot_sync(0xffffffffu, key == k);
        if (lane == 0) msk[rr * SB + k] = m;
        left &= ~m;
      }
      __syncwarp();
    }
    tm.sync();
    if (j >= J) continue;
    const int rr0 = ((j - t0) % J + J) % J;   // this sub-team's first round
    for (int u = u_first; u < U; u += u_step) {   // thread slot u
      const int s = u / SS, i = u - s * SS, a1 = i / A, a2 = i - a1 * A;
      if (i >= AA) continue;
      const int o = s * AA + i;
      double acc = part[j * O + o];
      for (int rr = rr0; rr < nr; rr += J) {
        unsigned m = msk[rr * SB + s];
        const float* ar = a_s + (rr << 5) * A + a1;
        const float* br = b_s + (rr << 5) * A + a2;
        while (m) {
          const int q = __ffs(m) - 1;
          m &= m - 1;
          acc += lae(ar[q * A], br[q * A]);
        }
      }
      part[j * O + o] = acc;
    }
  }
  tm.sync();
}

// The c-th locus (window order) of the L whose count exceeds small_max, or
// -1, for every thread of a block of whole warps: each warp's ballot over
// a slice of the counts, then thread 0 walks the words.  words: blockDim.x
// / 32 + 1 words of shared memory.
__device__ int wp_nth_large(const int* __restrict__ counts, int L,
                            int small_max, int c, unsigned* words) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  int l = -1;
  for (int base = 0; l < 0 && base < L; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned big =
        __ballot_sync(0xffffffffu, i < L && counts[i] > small_max);
    if (lane == 0) words[w] = big;
    __syncthreads();
    if (threadIdx.x == 0) {
      int f = -1;
      for (int x = 0; x < nw && f < 0; ++x) {
        unsigned m = words[x];
        const int nb = __popc(m);
        if (c < nb) {
          for (int q = 0; q < c; ++q) m &= m - 1;
          f = base + 32 * x + __ffs(m) - 1;
        } else {
          c -= nb;
        }
      }
      words[nw] = (unsigned)f;
    }
    __syncthreads();
    l = (int)words[nw];
    __syncthreads();                       // before the words are rewritten
  }
  return l;
}

// J3: one launch a window.  counts (int32): the L loci's counts n.  The
// first n_large * WP_CLUSTER blocks are the clusters of the n_large loci
// whose count exceeds small_max (cluster c: the c-th in window order); the
// small blocks that follow take `teams` teams each, team t of small block
// b locus b * teams + t where that locus is small.  A small team is SW
// warps; a large locus's block takes J sub-teams.  CH_S, CH_L: the tile of
// a small team and of a large block; SB_S, SB_L: the samples of a batch.
__global__ void __launch_bounds__(WP_THREADS)
window_posteriors_kernel(const float* __restrict__ LL,
                         const float* __restrict__ p1,
                         const float* __restrict__ p2,
                         const int64_t* __restrict__ label,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ prior, int R, int A, int S,
                         const int* __restrict__ counts, int L, int n_large,
                         int small_max, int J, int SW, int teams, int CH_S,
                         int CH_L, int SB_S, int SB_L, float log_half,
                         float* __restrict__ P, float* __restrict__ totals) {
  constexpr int KB = WP_CLUSTER;
  extern __shared__ __align__(16) unsigned char wp_raw[];
  const int AA = A * A, tid = threadIdx.x, lane = tid & 31;
  const bool large = (int)blockIdx.x < n_large * KB;
  int l, n, g0, gs, SB, CH, JJ;
  Team tm;
  unsigned char* base = wp_raw;
  int k = 0;
  if (large) {
    k = (int)(blockIdx.x % KB);
    // every block of the cluster finds the same locus
    l = wp_nth_large(counts, L, small_max, (int)(blockIdx.x / KB),
                     (unsigned*)wp_raw);
    if (l < 0) return;
    n = counts[l];
    g0 = k, gs = KB;
    SB = SB_L, CH = CH_L, JJ = J;
    tm = Team{tid, (int)blockDim.x, 0};
  } else {
    const int t = tid / (32 * SW);
    if (t >= teams) return;
    l = (int)(blockIdx.x - n_large * KB) * teams + t;
    if (l >= L) return;
    n = counts[l];
    if (n > small_max) return;             // a large locus: its cluster's
    g0 = 0, gs = 1;
    SB = SB_S, CH = CH_S, JJ = 1;
    tm = Team{tid - t * 32 * SW, 32 * SW, SW == 1 ? 1 : 1 + t};
    base += (long)t * wp_smem(A, SB, CH, 1).total;
  }
  const WpSmem sm = wp_smem(A, SB, CH, JJ);
  double* part = (double*)(base + sm.part);
  float* a_s = (float*)(base + sm.a);
  float* b_s = (float*)(base + sm.b);
  float* P_s = (float*)(base + sm.P);
  float* tot_s = (float*)(base + sm.tot);
  unsigned* msk = (unsigned*)(base + sm.msk);
  LL += (long)l * R * A;
  p1 += (long)l * R;
  p2 += (long)l * R;
  label += (long)l * R;
  mask += (long)l * R;
  prior += (long)l * AA;
  P += (long)l * S * AA;
  totals += (long)l * S;
  const int w = tm.tid >> 5, nw = tm.W >> 5;
  for (int s0 = 0; s0 < S; s0 += SB) {
    const int sb = min(SB, S - s0);
    wp_team_sums(tm, LL, p1, p2, label, mask, A, s0, sb, n, g0, gs, CH, JJ,
                 log_half, part, a_s, b_s, msk);
    // the samples this team or block finishes: all of the batch's (small),
    // or its (s0 + k, s0 + k + KB, ...) (large); ns of them, stride sk
    int ns = sb, sk = 1;
    if (large) {
      const int O = sb * AA;
      if (JJ > 1)                          // the sub-teams' sums in order
        for (int o = tid; o < O; o += tm.W) {
          double v = 0.0;
          for (int jj = 0; jj < JJ; ++jj) v += part[jj * O + o];
          part[o] = v;
        }
      cg::this_cluster().sync();           // barrier 1: the partials
      ns = k < sb ? (sb - k + KB - 1) / KB : 0;
      sk = KB;
    }
    for (int x = tm.tid; x < ns * AA; x += tm.W) {
      const int m = x / AA, i = x - m * AA;
      double acc;
      if (large) {
        cg::cluster_group cluster = cg::this_cluster();
        acc = 0.0;
        for (int kk = 0; kk < KB; ++kk)
          acc += cluster.map_shared_rank(part, kk)[(k + m * KB) * AA + i];
      } else {
        acc = part[x];
      }
      P_s[x] = (float)acc + prior[i];
    }
    tm.sync();
    for (int m = w; m < ns; m += nw) {
      const float* Pm = P_s + m * AA;
      const float t = warp_lse([&](int i) { return Pm[i]; }, AA);
      if (lane == 0) {
        tot_s[m] = t;
        totals[s0 + (large ? k : 0) + m * sk] = t;
      }
    }
    tm.sync();
    for (int x = tm.tid; x < ns * AA; x += tm.W) {
      const int m = x / AA, i = x - m * AA;
      P[(long)(s0 + (large ? k : 0) + m * sk) * AA + i] = P_s[x] - tot_s[m];
    }
    // barrier 2: no block rewrites or leaves its shared memory while
    // another reads it
    if (large) cg::this_cluster().sync();
  }
}

// The EM train's device-memory workspace, in floats (the int regions are
// read as int, the double region, at an even offset, as double): the sorted
// reads and the chunk table, which block 0 writes once; with the terms
// recomputed, also each chunk's (then each segment's) sums of phase B and
// the per-(sample, allele) logsumexps of phase C.  nch_max bounds the
// chunks: each (shard, sample) of c reads takes ceil(c / chunk) <= c /
// chunk + 1 of them.
struct EmLayout {
  int nkeys, nch_max;
  long order, chunk_base, ch_lo, ch_hi, ch_key, part, rowl, coll, total;
};

__host__ __device__ EmLayout em_layout(int R, int A, int S, int n, int chunk,
                                       bool keep) {
  EmLayout w;
  w.nkeys = n * S;
  w.nch_max = (R + chunk - 1) / chunk + w.nkeys;
  long o = 0;
  w.order = o;       o += R;
  w.chunk_base = o;  o += w.nkeys + 1;
  w.ch_lo = o;       o += w.nch_max;
  w.ch_hi = o;       o += w.nch_max;
  w.ch_key = o;      o += w.nch_max;
  o += o & 1;
  w.part = o;        o += keep ? 0 : 2L * w.nch_max * A * A;
  w.rowl = o;        o += keep ? 0 : (long)S * A;
  w.coll = o;        o += keep ? 0 : (long)S * A;
  w.total = o;
  return w;
}

// Chunks of reads a group stages at once when the terms are recomputed.
__host__ __device__ inline int em_group(int A) {
  const int g = EM_THREADS / (A * A);
  return g < 1 ? 1 : (g > EM_MAX_GROUP ? EM_MAX_GROUP : g);
}

// A block's shared memory, byte offsets of its regions.  M is the most
// chunks a block owns and Qr the most reads, which the host counts from the
// reads' samples (em_cuda.em_layout); Q the reads a block stages at once:
// all its reads when the terms are kept, a group's otherwise; SB the
// samples of phase C a block takes at once when they are recomputed.  part (the
// chunks' sums, then the segments') and stat (the chunks' seven sums) are
// what the other blocks read over DSMEM.  The set-up's sort (block 0) uses
// the same bytes before any of them.
struct EmSmem {
  int Q, SB;
  long part, stat, cb, kr, fst, c_lo, c_hi, c_key, rid, smp, lp1, lp2, rep, eff,
      inf, cat, win, wout, a, b, lin, T, P, tot, rowl, coll, comb, pri, st,
      state, total;
};

// The next region of `bytes`, 16-aligned, at offset o.
__host__ __device__ inline long take(long& o, long bytes) {
  const long at = o;
  o += (bytes + 15) & ~15L;
  return at;
}

__host__ __device__ EmSmem em_smem(int A, int S, int n, int chunk, int M,
                                   int Qr, bool keep) {
  EmSmem m;
  m.Q = keep ? Qr : em_group(A) * chunk;
  const int per_block = (S + EM_CTAS - 1) / EM_CTAS;
  const int fit = EM_P_FLOATS / (A * A) < 1 ? 1 : EM_P_FLOATS / (A * A);
  m.SB = per_block < fit ? per_block : fit;
  const long AA = (long)A * A, QA = (long)m.Q * A, f = sizeof(float);
  const long i = sizeof(int), d = sizeof(double);
  long o = 0;
  m.part = take(o, keep ? M * AA * d : 0);
  m.stat = take(o, M * 7L * d);
  m.cb = take(o, ((long)n * S + 1) * i);
  m.kr = take(o, 2L * n * S * i);
  m.fst = take(o, (EM_CTAS + 1L) * i);
  m.c_lo = take(o, M * i);
  m.c_hi = take(o, M * i);
  m.c_key = take(o, M * i);
  m.rid = take(o, m.Q * i);
  m.smp = take(o, m.Q * i);
  m.lp1 = take(o, m.Q * f);
  m.lp2 = take(o, m.Q * f);
  m.rep = take(o, QA * i);
  m.eff = take(o, QA * i);
  m.inf = take(o, QA);
  m.cat = take(o, QA);
  m.win = take(o, QA * f);
  m.wout = take(o, QA * f);
  m.a = take(o, QA * f);
  m.b = take(o, QA * f);
  m.lin = take(o, QA * f);
  m.T = take(o, keep ? m.Q * AA * f : 0);
  m.P = take(o, (keep ? S : m.SB) * AA * f);
  m.tot = take(o, S * f);
  m.rowl = take(o, keep ? S * A * f : 0);
  m.coll = take(o, keep ? S * A * f : 0);
  m.comb = take(o, A * f);
  m.pri = take(o, A * f);
  m.st = take(o, 8 * f);
  m.state = take(o, 16 * f);
  const long sort = ((((long)n * S * 2 + 1 + 3) & ~3L) + SORT_BATCH) * i;
  m.total = o > sort ? o : sort;
  return m;
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

// The stutter PMF of one (read, allele) from its repeat and effective bp
// differences (d, e) and in-frame flag, clamped at -600; c the PMF
// constants.
__device__ __forceinline__ float pmf(const float* c, int d, int e,
                                     bool in_frame) {
  const float out_val = e < 0 ? c[0] + c[2] * (float)(-e - 1)
                              : c[1] + c[2] * (float)(e - 1);
  const float in_val = d == 0 ? c[6]
                       : d < 0 ? c[3] + c[5] * (float)(-d - 1)
                               : c[4] + c[5] * (float)(d - 1);
  return clamp_ll(in_frame ? in_val : out_val);
}

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

// state: the parameters (6), the PMF constants (7), the LL, the stop flag,
// and whether the host's layout bounds held.
constexpr int ST_PMF = 6, ST_LL = 13, ST_DONE = 14, ST_BAD = 15;

template <bool KEEP>
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
                float min_frac, float log_half, int chunk, int M, int Qr,
                float* __restrict__ ws, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char em_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int wid = tid >> 5, NW = T >> 5;
  const int CL = EM_CTAS;                          // blocks of the cluster
  const EmLayout w = em_layout(R, A, S, n, chunk, KEEP);
  const EmSmem sm = em_smem(A, S, n, chunk, M, Qr, KEEP);
  const int AA = A * A, Rs = R / n, nkeys = w.nkeys;
  int* order = (int*)(ws + w.order);
  int* chunk_base = (int*)(ws + w.chunk_base);
  int* ch_lo = (int*)(ws + w.ch_lo);
  int* ch_hi = (int*)(ws + w.ch_hi);
  int* ch_key = (int*)(ws + w.ch_key);
  double* part_g = (double*)(ws + w.part);
  float* rowl_g = ws + w.rowl;
  float* coll_g = ws + w.coll;
  float* out_tot = out + 8;
  float* out_P = out + 8 + S;
  double* part_s = (double*)(em_raw + sm.part);
  double* stat_s = (double*)(em_raw + sm.stat);
  int* cb_s = (int*)(em_raw + sm.cb);
  int* fst = (int*)(em_raw + sm.fst);
  int* kr = (int*)(em_raw + sm.kr);
  int* c_lo = (int*)(em_raw + sm.c_lo);
  int* c_hi = (int*)(em_raw + sm.c_hi);
  int* c_key = (int*)(em_raw + sm.c_key);
  int* rid = (int*)(em_raw + sm.rid);
  int* smp = (int*)(em_raw + sm.smp);
  float* lp1_s = (float*)(em_raw + sm.lp1);
  float* lp2_s = (float*)(em_raw + sm.lp2);
  int* rep_s = (int*)(em_raw + sm.rep);
  int* eff_s = (int*)(em_raw + sm.eff);
  uint8_t* inf_s = em_raw + sm.inf;
  uint8_t* cat_s = em_raw + sm.cat;
  float* win_s = (float*)(em_raw + sm.win);
  float* wout_s = (float*)(em_raw + sm.wout);
  float* a_s = (float*)(em_raw + sm.a);
  float* b_s = (float*)(em_raw + sm.b);
  float* lin_s = (float*)(em_raw + sm.lin);
  float* T_s = (float*)(em_raw + sm.T);
  float* P_s = (float*)(em_raw + sm.P);
  float* tot_s = (float*)(em_raw + sm.tot);
  float* rowl_s = (float*)(em_raw + sm.rowl);
  float* coll_s = (float*)(em_raw + sm.coll);
  float* comb_s = (float*)(em_raw + sm.comb);
  float* pri = (float*)(em_raw + sm.pri);
  float* st = (float*)(em_raw + sm.st);
  float* state = (float*)(em_raw + sm.state);

  // Set-up, block 0: the valid reads sorted by (shard, sample), the chunks
  // of each (shard, sample), into device memory; one cluster barrier.
  if (rank == 0) {
    int* start = (int*)em_raw;
    block_sort([&](int r) {
                 const int64_t s = label[r];
                 return valid[r] && s >= 0 && s < S ? (r / Rs) * S + (int)s
                                                    : -1;
               },
               R, nkeys, start, start + nkeys + 1,
               start + ((2 * nkeys + 1 + 3) & ~3), order);
    if (tid == 0) {
      int c = 0;
      for (int k = 0; k < nkeys; ++k) {
        chunk_base[k] = c;
        for (int q = start[k]; q < start[k + 1]; q += chunk, ++c) {
          ch_lo[c] = q;
          ch_hi[c] = min(q + chunk, start[k + 1]);
          ch_key[c] = k;
        }
      }
      chunk_base[nkeys] = c;
    }
  }
  __threadfence();
  cluster.sync();
  // Every block: the chunk table, its own chunks, its copy of the state.
  for (int x = tid; x <= nkeys; x += T) cb_s[x] = __ldcg(chunk_base + x);
  __syncthreads();
  const int nch = cb_s[nkeys];
  for (int r = tid; r <= CL; r += T) fst[r] = (int)((long)r * nch / CL);
  __syncthreads();
  // the block that owns chunk c: the last r with fst[r] <= c
  auto owner = [&](int c) { return (int)(((long)c + 1) * CL - 1) / nch; };
  const int f0 = fst[rank], m = fst[rank + 1] - f0;
  // each (shard, sample)'s blocks: kr[2 key] .. kr[2 key + 1] - 1
  for (int k = tid; k < nkeys; k += T) {
    const int ca = cb_s[k], cb = cb_s[k + 1];
    kr[2 * k] = ca < cb ? owner(ca) : 0;
    kr[2 * k + 1] = ca < cb ? owner(cb - 1) + 1 : 0;
  }
  for (int l = tid; l < min(m, M); l += T) {
    c_lo[l] = __ldcg(ch_lo + f0 + l);
    c_hi[l] = __ldcg(ch_hi + f0 + l);
    c_key[l] = __ldcg(ch_key + f0 + l);
  }
  for (int a = tid; a < A; a += T) pri[a] = init_priors[a];
  // Every block checks every block's chunks and reads against the host's
  // bounds (a thread a block), so all agree whether to train.
  const int bad = __syncthreads_or(
      tid < CL && (fst[tid + 1] - fst[tid] > M
                   || (fst[tid + 1] > fst[tid]
                       && __ldcg(ch_hi + fst[tid + 1] - 1)
                              - __ldcg(ch_lo + fst[tid]) > Qr)));
  if (tid == 0) {
    const float init[6] = {0.9f, 0.1f, 0.1f, 0.8f, 0.01f, 0.01f};
    for (int i = 0; i < 6; ++i) state[i] = init[i];
    pmf_consts(state, state + ST_PMF);
    state[ST_LL] = -INFINITY;
    state[ST_DONE] = 0.0f;
    state[ST_BAD] = bad ? 1.0f : 0.0f;
  }
  __syncthreads();

  int glo = 0;              // the sorted position of the staged reads' first
  // The reads of owned chunks g0 .. g0 + ng - 1, staged: each read's index,
  // sample and phase weights, and its tables (they stay the same through
  // the train).  Returns the count.
  auto stage_reads = [&](int g0, int ng) {
    glo = c_lo[g0];
    const int nq = c_hi[g0 + ng - 1] - glo;
    for (int q = tid; q < nq; q += T) {
      const int r = __ldcg(order + glo + q);
      rid[q] = r;
      smp[q] = (int)label[r];
      lp1_s[q] = lp1[r];
      lp2_s[q] = lp2[r];
    }
    __syncthreads();
    for (int e = tid; e < nq * A; e += T) {
      const int q = e / A;
      const long x = (long)rid[q] * A + (e - q * A);
      rep_s[e] = rep[x];
      eff_s[e] = eff[x];
      inf_s[e] = in_frame[x];
      cat_s[e] = (uint8_t)cat[x];
      win_s[e] = w_in[x];
      wout_s[e] = w_out[x];
    }
    return nq;
  };
  // The staged reads' operands of this iteration's terms:
  //   a = (PMF + lp1) + log 1/2,  b = (PMF + lp2) + log 1/2.
  auto stage_terms = [&](int nq) {
    for (int e = tid; e < nq * A; e += T) {
      const int q = e / A;
      const float v = pmf(state + ST_PMF, rep_s[e], eff_s[e], inf_s[e]);
      a_s[e] = (v + lp1_s[q]) + log_half;
      b_s[e] = (v + lp2_s[q]) + log_half;
    }
  };
  // Recomputed: the owned chunks g0 .. group_end(g0) - 1 are a group, as
  // many as hold at most Q reads.
  auto group_end = [&](int g0) {
    int g1 = g0 + 1;
    while (g1 < m && c_hi[g1] - c_lo[g0] <= sm.Q) ++g1;
    return g1;
  };
  // A staged read's term (a1, a2): kept by phase B, or recomputed.
  auto term = [&](int q, int a1, int a2) {
    if constexpr (KEEP)
      return T_s[q * AA + a1 * A + a2];
    else
      return lae(a_s[q * A + a1], b_s[q * A + a2]);
  };
  // Each staged chunk's sums of its reads' terms, in read order.
  auto partials = [&](int g0, int ng, double* dst) {
    for (int t = tid; t < ng * AA; t += T) {
      const int l = t / AA, j = t - l * AA, a1 = j / A, a2 = j - a1 * A;
      double acc = 0.0;
      for (int q = c_lo[g0 + l] - glo; q < c_hi[g0 + l] - glo; ++q)
        acc += term(q, a1, a2);
      dst[(long)l * AA + j] = acc;
    }
  };
  // The owned chunks of one (shard, sample) added in order into the first
  // one's sums: a segment.
  auto segments = [&](double* p) {
    for (int t = tid; t < m * AA; t += T) {
      const int l = t / AA, j = t - l * AA;
      if (l > 0 && c_key[l] == c_key[l - 1]) continue;
      double acc = p[(long)l * AA + j];
      for (int l2 = l + 1; l2 < m && c_key[l2] == c_key[l]; ++l2)
        acc += p[(long)l2 * AA + j];
      p[(long)l * AA + j] = acc;
    }
  };
  // Entry j of the (shard, sample) key's sum: its segments in block order,
  // rounded once.
  auto key_sum = [&](int key, int j) {
    const int ca = cb_s[key];
    double acc = 0.0;
#pragma unroll 4
    for (int r = kr[2 * key]; r < kr[2 * key + 1]; ++r) {
      const int c = max(ca, fst[r]);
      if (c >= fst[r + 1]) continue;           // a block that owns no chunk
      if constexpr (KEEP)
        acc += cluster.map_shared_rank(part_s, r)[(long)(c - fst[r]) * AA
                                                  + j];
      else
        acc += __ldcg(part_g + (long)c * AA + j);
    }
    return (float)acc;
  };
  // P[s, j]: the shards in shard order (mesh._psum's), then the prior.
  auto post = [&](int s, int j) {
    float tot = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float v = key_sum(k * S + s, j);
      tot = k == 0 ? v : tot + v;
    }
    const int a1 = j / A, a2 = j - a1 * A;
    const float pm = haploid ? (a1 == a2 ? pri[a1] : -1e30f)
                             : pri[a1] + pri[a2];
    return tot + pm;
  };
  auto Pn = [&](int s, int x) {
    if constexpr (KEEP)
      return P_s[s * AA + x];
    else
      return __ldcg(out_P + (long)s * AA + x);
  };
  // One warp's sample s, its P at Ps (A*A entries): the total (warp_lse),
  // the posteriors normalized in place, and each allele's logsumexps over
  // one allele axis into rowl[s A + a] and coll[s A + a].
  auto sample_warp = [&](float* Ps, int s, float* rowl, float* coll) {
    const float t = warp_lse([&](int x) { return Ps[x]; }, AA);
    if (lane == 0) tot_s[s] = t;
    for (int x = lane; x < AA; x += 32) Ps[x] -= t;
    __syncwarp();
    for (int k = lane; k < 2 * A; k += 32) {
      if (k < A)
        rowl[s * A + k] = lse([&](int x) { return Ps[k * A + x]; }, A);
      else
        coll[s * A + k - A] = lse([&](int x) { return Ps[x * A + k - A]; }, A);
    }
    return t;
  };
  // F and G on staged chunks g0 .. g0 + ng - 1: each (read, allele)'s
  // phase posteriors f0, f1 and lin = exp(f0) + exp(f1); then a warp a
  // chunk: its seven sums, lane-strided in float64, then warp_sum.
  auto phase_f = [&](int g0, int ng, int nq) {
    // item e = (q, a), stepped by T without a division
    const int dq = T / A, da = T - dq * A;
    for (int e = tid, q = tid / A, a = tid - q * A; e < nq * A;
         e += T, q += dq, a += da) {
      if (a >= A) {
        a -= A;
        ++q;
      }
      const int s = smp[q];
      const float one_a = a_s[e], two_a = b_s[e];
      // f0: over a2 of Pn[s, a, a2] + (one[a] - term(a, a2))
      const float f0 = lse([&](int a2) {
        return Pn(s, a * A + a2) + (one_a - term(q, a, a2));
      }, A);
      // f1: over a1 of Pn[s, a1, a] + (two[a] - term(a1, a))
      const float f1 = lse([&](int a1) {
        return Pn(s, a1 * A + a) + (two_a - term(q, a1, a));
      }, A);
      lin_s[e] = expf(f0) + expf(f1);
    }
    __syncthreads();
    for (int l = wid; l < ng; l += NW) {
      const int e0 = (c_lo[g0 + l] - glo) * A;
      const int ne = (c_hi[g0 + l] - c_lo[g0 + l]) * A;
      double v7[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int e = e0 + lane; e < e0 + ne; e += 32) {
        const float v = lin_s[e];
        const int c = cat_s[e];
        v7[0] += c == 0 ? v : 0.0f;
        v7[1] += c == 1 ? v : 0.0f;
        v7[2] += c == 2 ? v : 0.0f;
        v7[3] += c == 3 ? v : 0.0f;
        v7[4] += c == 4 ? v : 0.0f;
        v7[5] += v * win_s[e];
        v7[6] += v * wout_s[e];
      }
#pragma unroll
      for (int q = 0; q < 7; ++q) v7[q] = warp_sum(v7[q]);
      if (lane < 7) {
        double mine = v7[0];
#pragma unroll
        for (int q = 1; q < 7; ++q) mine = lane == q ? v7[q] : mine;
        stat_s[(long)(g0 + l) * 7 + lane] = mine;
      }
    }
  };

  // Kept: every owned read staged once, for the whole train.
  int nq_all = 0;
  if (KEEP && m > 0 && state[ST_BAD] == 0.0f) nq_all = stage_reads(0, m);
  __syncthreads();

  int it = 0;
  while (it < max_iter && state[ST_DONE] == 0.0f && state[ST_BAD] == 0.0f) {
    // B: each owned chunk's sums of its reads' terms, then the segments.
    // Kept: its A*A terms stored for F.
    if constexpr (KEEP) {
      if (m > 0) {
        const int nq = nq_all;
        stage_terms(nq);
        __syncthreads();
        // item t = (q, a1, a2), stepped by T without a division
        int q = tid / AA, a1 = (tid - q * AA) / A, a2 = tid - q * AA - a1 * A;
        const int dq = T / AA, d1 = (T - dq * AA) / A;
        const int d2 = T - dq * AA - d1 * A;
        for (int t = tid; t < nq * AA; t += T) {
          T_s[t] = lae(a_s[q * A + a1], b_s[q * A + a2]);
          a2 += d2;
          a1 += d1;
          q += dq;
          if (a2 >= A) {
            a2 -= A;
            ++a1;
          }
          if (a1 >= A) {
            a1 -= A;
            ++q;
          }
        }
        __syncthreads();
        partials(0, m, part_s);
        __syncthreads();
        segments(part_s);
      }
      cluster.sync();                                   // barrier 1
    } else {
      for (int g0 = 0, ng; g0 < m; g0 += ng) {
        ng = group_end(g0) - g0;
        __syncthreads();
        stage_terms(stage_reads(g0, ng));
        __syncthreads();
        partials(g0, ng, part_g + (long)(f0 + g0) * AA);
      }
      __syncthreads();
      segments(part_g + (long)f0 * AA);
      __threadfence();
      cluster.sync();                                   // barrier 1
    }
    // C: P = the shards' sums plus the prior, the totals (a warp a
    // sample's logsumexp), the normalized posteriors, each (s, a)'s
    // logsumexps over one allele axis.  Kept: every block forms all of
    // them from the segments it reads over DSMEM, and the prior update's
    // logaddexps.  Recomputed: block r takes samples r, r + CL, ... into
    // device memory (the posteriors and totals into the result).
    if constexpr (KEEP) {
      for (int i = tid; i < S * AA; i += T) {
        const int s = i / AA;
        P_s[i] = post(s, i - s * AA);
      }
      __syncthreads();
      for (int s = wid; s < S; s += NW)
        sample_warp(P_s + s * AA, s, rowl_s, coll_s);
      __syncthreads();
      for (int a = wid; a < A; a += NW) {
        const float c1 = warp_lse([&](int s) { return rowl_s[s * A + a]; }, S);
        const float c2 = warp_lse([&](int s) { return coll_s[s * A + a]; }, S);
        if (lane == 0) comb_s[a] = lae(c1, c2);
      }
    } else {
      // batches of SB samples: rank, rank + CL, ... (local i: s0 + i CL)
      for (int s0 = rank; s0 < S; s0 += sm.SB * CL) {
        const int nb = min(sm.SB, (S - s0 + CL - 1) / CL);
        for (int t = tid; t < nb * AA; t += T) {
          const int i = t / AA;
          P_s[t] = post(s0 + i * CL, t - i * AA);
        }
        __syncthreads();
        for (int i = wid; i < nb; i += NW) {
          const int s = s0 + i * CL;
          const float t = sample_warp(P_s + i * AA, s, rowl_g, coll_g);
          for (int x = lane; x < AA; x += 32)
            out_P[(long)s * AA + x] = P_s[i * AA + x];
          if (lane == 0) out_tot[s] = t;
        }
        __syncthreads();
      }
      __threadfence();
      cluster.sync();                                   // barrier 2
    }
    // F, G: on the kept terms, or on each group restaged.
    if constexpr (KEEP) {
      if (m > 0) phase_f(0, m, c_hi[m - 1] - glo);
    } else {
      for (int g0 = 0, ng; g0 < m; g0 += ng) {
        ng = group_end(g0) - g0;
        __syncthreads();
        const int nq = stage_reads(g0, ng);
        stage_terms(nq);
        __syncthreads();
        phase_f(g0, ng, nq);
      }
    }
    cluster.sync();                       // barrier 2 (kept), 3 (recomputed)
    // H, every block: a warp a statistic adds each shard's chunks (lane-
    // strided over DSMEM, then warp_sum) and the shards in shard order;
    // recomputed, the other warps take the prior update's logaddexps and
    // the totals from device memory; thread 0 takes the closed-form M step,
    // the new priors and the convergence test (mesh.py:_em_train's rules)
    // into the block's state.
    if (wid < 7) {
      float tot = 0.0f;
      for (int k = 0; k < n; ++k) {
        double sh = 0.0;
        for (int c = cb_s[k * S] + lane; c < cb_s[(k + 1) * S]; c += 32) {
          const int r = owner(c);
          sh += cluster.map_shared_rank(stat_s, r)[(long)(c - fst[r]) * 7
                                                   + wid];
        }
        sh = warp_sum(sh);
        tot = k == 0 ? (float)sh : tot + (float)sh;
      }
      if (lane == 0) st[wid] = tot;
    }
    if constexpr (!KEEP) {
      for (int a = wid - 7; a >= 0 && a < A; a += NW - 7) {
        const float c1 =
            warp_lse([&](int s) { return __ldcg(rowl_g + s * A + a); }, S);
        const float c2 =
            warp_lse([&](int s) { return __ldcg(coll_g + s * A + a); }, S);
        if (lane == 0) comb_s[a] = lae(c1, c2);
      }
      for (int x = tid; x < S; x += T) tot_s[x] = __ldcg(out_tot + x);
    }
    __syncthreads();
    if (tid == 0) {
      float new_LL = 0.0f;
      for (int s = 0; s < S; ++s) new_LL += tot_s[s];
      const float lc = lse([&](int a) { return comb_s[a]; }, A);
      float np[6];
      mstep(st, np);
      bool small = true;
      for (int p = 0; p < 6; ++p)
        small = small && fabsf(np[p] - state[p]) < 1e-4f;
      // On the first iteration LL is -inf: abs_change is +inf and
      // frac_change NaN, so only the parameter test can stop it there.
      const float LL = state[ST_LL];
      const bool nonmono = new_LL < LL + 1e-10f;
      const float abs_change = new_LL - LL;
      const float frac_change = -(new_LL - LL) / LL;
      const bool conv_after =
          (abs_change < min_abs && frac_change < min_frac) || small;
      if (!nonmono) {
        for (int p = 0; p < 6; ++p) state[p] = np[p];
        pmf_consts(np, state + ST_PMF);
        for (int a = 0; a < A; ++a) pri[a] = comb_s[a] - lc;
      }
      state[ST_LL] = new_LL;
      state[ST_DONE] = nonmono || conv_after ? 1.0f : 0.0f;
    }
    __syncthreads();
    ++it;
  }
  cluster.sync();    // no block leaves while another reads its shared memory

  // The result: converged, n_iter, params (6), totals (S), the normalized
  // posteriors (S, A, A) of the final E-step (zeros if none ran).
  if (rank == 0) {
    if (tid == 0) {
      out[0] = state[ST_DONE];
      out[1] = state[ST_BAD] != 0.0f ? -1.0f : (float)it;
      for (int p = 0; p < 6; ++p) out[2 + p] = state[p];
    }
    if (it == 0) {
      for (int s = tid; s < S; s += T) out_tot[s] = 0.0f;
      for (int i = tid; i < S * AA; i += T) out_P[i] = 0.0f;
    } else if (KEEP) {
      for (int s = tid; s < S; s += T) out_tot[s] = tot_s[s];
      for (int i = tid; i < S * AA; i += T) out_P[i] = P_s[i];
    }
  }
}

template <typename K>
int set_smem(K kernel, long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

long em_train_workspace_floats(int R, int A, int S, int n, int chunk,
                               int keep) {
  return em_layout(R, A, S, n, chunk, keep).total;
}

// Dynamic shared memory of an EM train's blocks (em_smem), with its terms
// kept (keep = 1) or recomputed; M and Qr the most chunks and reads a block
// owns.
long em_train_smem_bytes(int A, int S, int n, int chunk, int M, int Qr,
                         int keep) {
  return em_smem(A, S, n, chunk, M, Qr, keep).total;
}

// The most samples (at most S) of a J3 batch whose `teams` team regions,
// with tiles of CH reads and J sub-teams, fit `limit` bytes of shared
// memory; 0 if not even one sample's do.
int window_posteriors_batch(int A, int S, int CH, int J, int teams,
                            long limit) {
  for (int sb = S; sb > 0; --sb)
    if (teams * wp_smem(A, sb, CH, J).total <= limit) return sb;
  return 0;
}

// J3: the (L, R, A) window in one launch.  counts (int32, on the card):
// each locus's count, those above small_max the n_large large loci
// (window_posteriors_kernel).  A large locus takes a cluster of
// WP_CLUSTER blocks of WP_THREADS threads in J sub-teams, tiles of CH_L
// reads, batches of SB_L samples; a small one a team of SW warps in one
// of the n_small_blocks blocks, tiles of CH_S reads, batches of SB_S
// samples.  P (L, S, A, A) and totals (L, S) are written.
int window_posteriors(const float* LL, const float* p1, const float* p2,
                      const int64_t* label, const uint8_t* mask,
                      const float* prior, int L, int R, int A, int S,
                      const int* counts, int n_large, int n_small_blocks,
                      int small_max, int J, int SW, int teams, int CH_S,
                      int CH_L, int SB_S, int SB_L, float log_half, float* P,
                      float* totals, void* stream) {
  const long U = (long)SB_L * (((long)A * A + 31) & ~31L);
  if (L < 1 || R < 1 || A < 1 || S < 1 || n_large < 0 || n_large > L
      || n_small_blocks < 0
      || (n_large < L && (long)n_small_blocks * teams < L)
      || n_large + n_small_blocks < 1 || small_max < 0 || J < 1 || SW < 1
      || teams < 1 || 32 * SW * teams > WP_THREADS || teams > 15
      || CH_S < 32 || CH_S % 32 || CH_L < 32 || CH_L % 32 || SB_S < 1
      || SB_S > S || SB_L < 1 || SB_L > S
      || (J > 1 && (SB_L < S || J * U > WP_THREADS))
      || (n_large && n_small_blocks % WP_CLUSTER))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const float*, const float*, const float*, const int64_t*,
               const uint8_t*, const float*, int, int, int, const int*, int,
               int, int, int, int, int, int, int, int, int, float, float*,
               float*) = window_posteriors_kernel;
  long smem = 0;
  if (n_small_blocks) smem = teams * wp_smem(A, SB_S, CH_S, 1).total;
  if (n_large) {
    const long big = wp_smem(A, SB_L, CH_L, J).total;
    smem = big > smem ? big : smem;
  }
  int e = set_smem(kern, smem);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_large * WP_CLUSTER + n_small_blocks));
  cfg.blockDim = dim3(n_large ? WP_THREADS : 32 * SW * teams);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  if (n_large) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = WP_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t ce = cudaLaunchKernelEx(&cfg, kern, LL, p1, p2, label, mask,
                                      prior, R, A, S, counts, L, n_large,
                                      small_max, J, SW, teams, CH_S, CH_L,
                                      SB_S, SB_L, log_half, P, totals);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// J4: one cluster of EM_CTAS blocks trains one locus, its terms kept in
// shared memory (keep = 1) or recomputed; no block owns more than M chunks
// or Qr reads (n_iter is written as -1, and nothing trained, if one does);
// ws holds em_train_workspace_floats floats; out (8 + S + S*A*A floats) is
// written.
int em_train(const int32_t* rep, const int32_t* eff, const uint8_t* in_frame,
             const float* lp1, const float* lp2, const int64_t* label,
             const uint8_t* valid, const int32_t* cat, const float* w_in,
             const float* w_out, const float* init_priors, int R, int A,
             int S, int n, int haploid, int max_iter, float min_abs,
             float min_frac, float log_half, int chunk, int M, int Qr,
             int keep, float* ws, float* out, void* stream) {
  if (R < 1 || A < 1 || S < 1 || n < 1 || R % n || chunk < 1 || M < 0
      || Qr < 0)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const int32_t*, const int32_t*, const uint8_t*, const float*,
               const float*, const int64_t*, const uint8_t*, const int32_t*,
               const float*, const float*, const float*, int, int, int, int,
               int, int, float, float, float, int, int, int, float*,
               float*) =
      keep ? em_train_kernel<true> : em_train_kernel<false>;
  const long smem = em_train_smem_bytes(A, S, n, chunk, M, Qr, keep);
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
                          chunk, M, Qr, ws, out);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

}  // extern "C"
