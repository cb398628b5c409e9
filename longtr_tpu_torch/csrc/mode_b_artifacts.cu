// Mode B's artifact tables A for NVIDIA Hopper (sm_90a).
//
// The JAX package builds A on the host in float64 numpy
// (longtr_tpu/pipeline/mode_b.py::_artifact_table_batch over
// longtr_tpu's StutterAligner.load_read_batch, align_all_batch and
// fast_lse_cols) and
// copies it to the device with every batch; the plain version is
// longtr_tpu_torch/ops/mode_b_artifacts.py::mode_b_artifacts_plain.  For
// one table t (side, repeat block, allele option) and one reversed read
// segment p of length L, A[t * P + p, d, j] is the prior of artifact size
// D = d_first + d * period plus the log-sum over the entries of the
// block's descent for column j (offset L - 1 - j), IMPOSSIBLE where
// block_len + D < 0 and -inf past the segment's end or n_dl.  Every value
// is computed in float64 in numpy's order -- prefix sums in j order, the
// descent's lp updates in entry order, the max of the entries, then the
// sum of exp(e - m) over the terms above LOG_THRESH in entry order, then
// m + log(total) -- and cast at the store.  Every operation is the host's
// but exp and log, whose float64 results may differ from glibc's in the
// last bit; the float32 tables the row DP reads have not shown it.
//
// What bounds the work: the output, 4 bytes a (table, segment, D, column)
// (15.3 MB at bench.py's shape) is the byte bound, but each valid
// (column, D) is a chain of dependent shared-memory reads, float64 adds,
// an exp an entry and a log, and the chains of ~40 resident warps an SM do
// not fill its issue slots (PERF.md §6, H1): the kernel is latency-bound.
// Its design gives every lane a column (no padding lanes), keeps every
// read of the walks on chip, and shortens the chains where the order of
// the float64 operations allows it.
//
// mode_b_artifacts_warp_kernel: one block of ART_THREADS threads takes one
// table and G consecutive segments of its side (G from the wrapper: enough
// segments that the block's valid columns fill its threads).  It
//   1. stages each segment's per-position base byte and its lw/lc (the
//      float64 log-probabilities of its quality byte) in shared memory;
//   2. sums longtr_tpu's load_read_batch prefixes (match, one per deletion
//      multiple, one per insertion multiple) for every valid offset of its
//      segments, one offset a thread, from the staged bytes, into rows of
//      the same region ([row][offset]: a lane's neighbour reads the next
//      double), the match prefix four positions a step so that a step's loads
//      overlap; then its warps store the -inf of the columns past each
//      segment's end, which take no lane below;
//   3. walks the descent for every (D, valid column) of its segments,
//      D-major: consecutive lanes take consecutive valid columns (of one
//      segment, or of the next one at its end) of one (table, D), so a
//      warp shares its descent -- the same i, up[], blk[] and int_log reads
//      in lockstep -- and its lanes differ only in where they exit (lim
//      depends on the column) and in the staged positions they read.
//      Writes are coalesced along j.
// The region (staged bytes and prefixes, (pre_n + 2) * Lp doubles and Lp
// bytes a segment) lives in shared memory, or, for one segment a block
// when even that does not fit, in a device workspace; the kernel is
// compiled for each place, so that shared memory is read with LDS, not
// generic loads.  The table's descriptor, int_log, upstream arrays and
// block bytes are staged in shared memory once a block, so that a walk's
// dependent reads (up[], then int_log[um]) stay on chip; their sizes are
// bounded by int_log's length (block_len + 2 at most), which the host
// knows without reading the descriptors back.
//
// The LSE's entries: a lane walks its descent twice (max, then sum).  Mode
// B runs only on period-1 blocks, whose descents jump (two or three
// entries a column, nothing rescanned), so a second walk costs less than
// the resident blocks that keeping the entries in shared memory would
// take (PERF.md §6, H1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ART_THREADS = 128;    // threads a block of the warp kernel
constexpr int ART_MAX_SEGS = 16;    // segments a block of the warp kernel

// tdesc fields (longtr_tpu_torch/ops/mode_b_artifacts.py::DESC_FIELDS)
enum { TD_SIDE, TD_BLEN, TD_PERIOD, TD_DFIRST, TD_NDL, TD_NDEL, TD_NINS,
       TD_BLKOFF, TD_UPOFF, TD_N };

// One staged read segment: StutterAligner's _score at position r, from
// shared memory (or the workspace).
struct Staged {
  const uint8_t* code;
  const double* lw;
  const double* lc;
  __device__ __forceinline__ double at(int r, uint8_t c) const {
    const double w = lw[r], k = lc[r];   // both loads in flight at once
    return code[r] == c ? k : w;
  }
  __device__ __forceinline__ double correct(int r) const { return lc[r]; }
};

// longtr_tpu's load_read_batch prefixes, row-major: row k holds every offset.
struct PreByRow {
  const double* match;
  const double* dels;
  const double* ins;
  int Lp;
  __device__ __forceinline__ double m(int o) const { return match[o]; }
  __device__ __forceinline__ double del(int o, int k) const {
    return dels[k * Lp + o];
  }
  __device__ __forceinline__ double in(int o, int k) const {
    return ins[k * Lp + o];
  }
};

// longtr_tpu's load_read_batch for offset o of a segment of length L: the
// match prefix over the block, its deletion snapshots and the insertion
// prefixes, summed in j order.  set_del(k, v) and set_ins(k, v) store
// snapshot k.  It counts j modulo the period instead of dividing and
// unrolls the match prefix by four.
template <class S, class SetDel, class SetIns>
__device__ __forceinline__ double prefixes(
    const int o, const int L, const int blk_len, const int period,
    const int n_del, const int nDc, const int n_ins,
    const uint8_t* __restrict__ blk, const S& sg, SetDel& set_del,
    SetIns& set_ins) {
  double run = 0.0;
  int di = 0, jm = 0;
#pragma unroll 4
  for (int j = 0; j < blk_len; j++) {
    const bool in = o + j < L;
    if (in) run = run + sg.at(o + j, blk[j]);
    const bool snap = ++jm == period;
    if (snap) {
      jm = 0;
      if (j < period * n_del && di < nDc) {
        set_del(di, in ? run : 0.0);
        di++;
      }
    }
  }
  double ri = 0.0;
  int ii = 0;
  jm = 0;
  for (int j = 0; j < period * n_ins; j++) {
    const int jr = jm;
    if (o + j < L)
      ri = ri + (jr < blk_len ? sg.at(o + j, blk[jr]) : sg.correct(o + j));
    const bool snap = ++jm == period;
    if (snap) {
      jm = 0;
      set_ins(ii, ri);
      ii++;
    }
  }
  return run;
}

// The entries of longtr_tpu's align_all_batch descent for one column, in
// entry order:
// lp, one a step while i > lim, and the tail at the exit (the scalar
// StutterAligner._align_insertion / _align_deletion walk).  The steps
// depend on (table, D) alone; lp, lim and the positions read on the
// column.
template <class S, class Visit>
__device__ __forceinline__ void walk_entries(
    const int D, const int offset, double lp, const int lim, const int blk_len,
    const int period, const int32_t* __restrict__ up,
    const uint8_t* __restrict__ blk, const S& sg,
    const double* __restrict__ il, Visit& visit) {
  visit(lp);
  int i = 0;
  while (i > lim) {
    if (D > 0 && !(-i + period < blk_len)) {
      visit(lp);
      i -= 1;
      continue;
    }
    const int um = up[blk_len - 1 + i];
    if (um == 0) {
      if (D > 0) {
        for (int idx = i - period; idx >= i - D; idx -= period) {
          const int r = offset - idx;
          lp = lp - sg.at(r, blk[-i]);
          lp = lp + sg.at(r, blk[-(i - period)]);
        }
      } else {
        const int r = offset - i;
        lp = lp - sg.at(r, blk[-(i + D)]);
        lp = lp + sg.at(r, blk[-i]);
      }
      visit(lp);
      i -= 1;
    } else {
      visit(il[um] + lp);
      i = i - (um - 1) - 1;
    }
  }
  const int t_base = D > 0 ? blk_len : blk_len + D;
  if (i > -t_base) visit(il[t_base + i] + lp);
}

// The constants of artifact size D != 0 that every column shares: k, the
// insertion (D > 0) or deletion (D < 0) multiple's index, and the log
// prior of the artifact's length.
__device__ __forceinline__ int size_index(int D, int period) {
  return D > 0 ? D / period - 1 : -D / period - 1;
}
__device__ __forceinline__ double size_log_prior(int D, int blk_len,
                                                 const double* il) {
  return D > 0 ? -il[blk_len + 1] : -il[blk_len + D + 1];
}

// A[d, j] without its prior, for D != 0 and block_len + D >= 0: the
// initial lp of the column (offset = L - 1 - j), then fast_lse_cols over
// the walk's entries, walked twice.  The max's own term adds exp(0) = 1
// without calling exp.
template <class S, class Pre>
__device__ __forceinline__ double align_lse(
    const int D, const int k, const double log_prior, const int j,
    const int L, const int blk_len, const int period,
    const int32_t* __restrict__ ups, const uint8_t* __restrict__ blk,
    const S& sg, const Pre& pre, const double* __restrict__ il,
    const double thresh) {
  const int offset = L - 1 - j;
  const int base_len = min(blk_len + D, j + 1);
  double lp;
  int lim;
  const int32_t* up;
  if (D > 0) {
    up = ups;
    lp = log_prior + pre.in(offset, k);
    lp = lp + (base_len > D ? pre.m(offset + D) : 0.0);
    lim = -min(max(0, base_len - D), blk_len);
  } else {
    up = ups + (size_t)k * blk_len;
    const int od = offset + D;
    if (od < 0) {
      lp = log_prior;
      for (int q = 0; q < base_len; q++)
        lp = lp + sg.at(offset + q, blk[q - D]);
    } else {
      lp = log_prior + (pre.m(od) - pre.del(od, k));
    }
    lim = -base_len;
  }
  // fast_lse_cols: the max of the entries, then their sum in order
  double m = -INFINITY;
  auto term = [&](double df) { return df == 0.0 ? 1.0 : exp(df); };
  auto vmax = [&](double e) { m = e > m ? e : m; };
  walk_entries(D, offset, lp, lim, blk_len, period, up, blk, sg, il, vmax);
  if (!isfinite(m)) return m;
  double total = 0.0;
  auto vsum = [&](double e) {
    const double df = e - m;
    if (df > thresh) total = total + term(df);
  };
  walk_entries(D, offset, lp, lim, blk_len, period, up, blk, sg, il, vsum);
  return m + log(total);
}

struct Desc {
  int side, blk_len, period, d_first, n_dl, n_del, n_ins, nDc, nIc;
  const uint8_t* blk;
  const int32_t* ups;
};

__device__ __forceinline__ Desc load_desc(const int32_t* __restrict__ tdesc,
                                          int t,
                                          const uint8_t* __restrict__ blk_bytes,
                                          const int32_t* __restrict__ upstream,
                                          int pre_n) {
  const int* dsc = tdesc + (size_t)t * TD_N;
  Desc d;
  d.side = dsc[TD_SIDE];
  d.blk_len = dsc[TD_BLEN];
  d.period = dsc[TD_PERIOD];
  d.d_first = dsc[TD_DFIRST];
  d.n_dl = dsc[TD_NDL];
  d.n_del = dsc[TD_NDEL];
  d.n_ins = dsc[TD_NINS];
  d.nDc = max(d.n_del, 1);
  d.nIc = max(d.n_ins, 1);
  if (1 + d.nDc + d.nIc > pre_n) __trap();   // the host sizes pre_n for this
  d.blk = blk_bytes + dsc[TD_BLKOFF];
  d.ups = upstream + dsc[TD_UPOFF];
  return d;
}

// ---------------------------------------------------------------------------
// The warp kernel.
// ---------------------------------------------------------------------------

// What every column of one artifact size of the block's table shares.
struct SizeConst {
  double prior, log_prior;
  int D, k;
};

// The warp kernel's dynamic shared memory, in this order: the sizes'
// constants (n_d), int_log (n_log doubles), on chip the region (G segments
// of (pre_n + 2) * Lp doubles), the table's upstream arrays (at most
// (pre_n - 2) of at most n_log - 2 ints: block_len + 2 <= n_log and
// 1 + n_del + n_ins <= pre_n), its block bytes, and on chip the segments'
// base bytes.
struct WarpSmem {
  long size_c, il, region, ups, blk, codes, total;
  __host__ __device__ WarpSmem(int Lp, int n_d, int pre_n, int n_log, int G,
                               bool on_chip) {
    size_c = 0;
    il = size_c + n_d * (long)sizeof(SizeConst);
    region = il + n_log * 8L;
    ups = region + (on_chip ? (long)G * (pre_n + 2L) * Lp * 8 : 0);
    blk = ups + (pre_n - 2L) * (n_log - 2L) * 4;
    codes = blk + (n_log - 2L);
    total = codes + (on_chip ? (long)G * Lp : 0);
  }
};

template <typename OutT, bool ON_CHIP>
__global__ void __launch_bounds__(ART_THREADS)
mode_b_artifacts_warp_kernel(const uint8_t* __restrict__ seg_codes,
                             const uint8_t* __restrict__ seg_quals,
                             const int32_t* __restrict__ seg_len,
                             const double* __restrict__ lw64,
                             const double* __restrict__ lc64,
                             const int32_t* __restrict__ tdesc,
                             const uint8_t* __restrict__ blk_bytes,
                             const int32_t* __restrict__ upstream,
                             const double* __restrict__ priors,
                             const double* __restrict__ int_log, int P,
                             int Lp, int n_d, int pre_n, int n_log, int G,
                             int n_grp, double impossible, double thresh,
                             int blk0, double* __restrict__ ws,
                             OutT* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t art_bytes[];
  __shared__ int s_start[ART_MAX_SEGS + 1];   // valid columns before segment g
  const WarpSmem lay(Lp, n_d, pre_n, n_log, G, ON_CHIP);
  const int tid = threadIdx.x;
  const int gb = blk0 + blockIdx.x;           // t * n_grp + segment group
  const int t = gb / n_grp;
  const int p0 = (gb - t * n_grp) * G;
  const int ng = min(G, P - p0);
  const Desc ds = load_desc(tdesc, t, blk_bytes, upstream, pre_n);
  if (ds.blk_len + 2 > n_log) __trap();       // int_log holds block_len + 2
  SizeConst* s_size = (SizeConst*)(art_bytes + lay.size_c);
  double* il = (double*)(art_bytes + lay.il);
  int32_t* ups = (int32_t*)(art_bytes + lay.ups);
  uint8_t* blk = art_bytes + lay.blk;
  const int seg_doubles = (pre_n + 2) * Lp;   // lw, lc, match, dels, ins
  double* reg;
  uint8_t* codes;
  if constexpr (ON_CHIP) {
    reg = (double*)(art_bytes + lay.region);
    codes = art_bytes + lay.codes;
  } else {
    reg = ws + (size_t)blockIdx.x * (seg_doubles + (Lp + 7) / 8);
    codes = (uint8_t*)(reg + seg_doubles);
  }
  const size_t sp0 = (size_t)ds.side * P + p0;
  OutT* ob = out + ((size_t)t * P + p0) * n_d * Lp;

  if (tid == 0) {
    int s = 0;
    s_start[0] = 0;
    for (int g = 0; g < ng; g++) {
      s += min(max(seg_len[sp0 + g], 0), Lp);
      s_start[g + 1] = s;
    }
  }
  // the table: int_log, its upstream arrays and block bytes, the sizes'
  // constants
  for (int x = tid; x < n_log; x += ART_THREADS) il[x] = int_log[x];
  for (int x = tid; x < ds.nDc * ds.blk_len; x += ART_THREADS)
    ups[x] = ds.ups[x];
  for (int x = tid; x < ds.blk_len; x += ART_THREADS) blk[x] = ds.blk[x];
  for (int d = tid; d < ds.n_dl; d += ART_THREADS) {
    const int D = ds.d_first + d * ds.period;
    SizeConst c;
    c.D = D;
    c.prior = priors[(size_t)t * n_d + d];
    c.k = D != 0 ? size_index(D, ds.period) : 0;
    c.log_prior = D != 0 && ds.blk_len + D >= 0
                      ? size_log_prior(D, ds.blk_len, int_log) : 0.0;
    s_size[d] = c;
  }
  // 1. stage the segments: base byte, lw and lc of every position
  for (int x = tid; x < ng * Lp; x += ART_THREADS) {
    const int g = x / Lp, r = x - g * Lp;
    const uint8_t q = seg_quals[sp0 * Lp + x];
    codes[x] = seg_codes[sp0 * Lp + x];
    double* sg = reg + g * seg_doubles;
    sg[r] = lw64[q];
    sg[Lp + r] = lc64[q];
  }
  __syncthreads();

  const int V = s_start[ng];
  // 2. longtr_tpu's load_read_batch: one valid offset a thread
  for (int v = tid; v < V; v += ART_THREADS) {
    int g = 0;
    while (v >= s_start[g + 1]) g++;
    const int o = v - s_start[g], L = s_start[g + 1] - s_start[g];
    double* sg = reg + g * seg_doubles;
    const Staged st{codes + g * Lp, sg, sg + Lp};
    double* match = sg + 2 * Lp;
    double* dels = match + Lp;
    double* ins = dels + ds.nDc * Lp;
    auto set_del = [&](int k, double x) { dels[k * Lp + o] = x; };
    auto set_ins = [&](int k, double x) { ins[k * Lp + o] = x; };
    match[o] = prefixes(o, L, ds.blk_len, ds.period, ds.n_del, ds.nDc,
                        ds.n_ins, blk, st, set_del, set_ins);
  }
  // -inf past each segment's end and past n_dl (no lane walks them): a
  // warp a (segment, D) row
  const int lane = tid & 31;
  for (int row = tid >> 5; row < ng * n_d; row += ART_THREADS / 32) {
    const int g = row / n_d, d = row - g * n_d;
    const int L = d >= ds.n_dl ? 0 : s_start[g + 1] - s_start[g];
    OutT* orow = ob + (size_t)row * Lp;
    for (int j = L + lane; j < Lp; j += 32) orow[j] = (OutT)(-INFINITY);
  }
  __syncthreads();
  if (V == 0) return;

  // 3. longtr_tpu's align_all_batch + fast_lse_cols, D-major over the
  // valid columns:
  // item (d, v) = d * V + v, a thread's next item ART_THREADS further
  int d = tid / V, v = tid - d * V;
  for (; d < ds.n_dl; v += ART_THREADS) {
    int g = 0;
    while (v >= s_start[g + 1]) g++;
    const int j = v - s_start[g], L = s_start[g + 1] - s_start[g];
    const SizeConst c = s_size[d];
    const double* sg = reg + g * seg_doubles;
    const PreByRow pre{sg + 2 * Lp, sg + 3 * Lp, sg + (3 + ds.nDc) * Lp, Lp};
    double val;
    if (ds.blk_len + c.D < 0) {
      val = impossible;                     // base_len < 0
    } else if (c.D == 0) {
      val = c.prior + pre.m(L - 1 - j);
    } else {
      const Staged st{codes + g * Lp, sg, sg + Lp};
      val = c.prior + align_lse(c.D, c.k, c.log_prior, j, L, ds.blk_len,
                                ds.period, ups, blk, st, pre, il, thresh);
    }
    ob[((size_t)g * n_d + d) * Lp + j] = (OutT)val;
    while (v + ART_THREADS >= V && d < ds.n_dl) {
      v -= V;
      d++;
    }
  }
}

// Static shared memory of the warp kernel (s_start).
constexpr long WARP_STATIC_SMEM = (ART_MAX_SEGS + 1) * (long)sizeof(int);

// Opt a kernel with `fixed` bytes of static shared memory in to `smem`
// dynamic bytes where the two exceed the default 48 KB.
template <typename K>
int set_smem(K kernel, long smem, long fixed) {
  if (smem + fixed <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename OutT, bool ON_CHIP>
int launch_warp(const uint8_t* seg_codes, const uint8_t* seg_quals,
                const int32_t* seg_len, const double* lw64, const double* lc64,
                const int32_t* tdesc, const uint8_t* blk_bytes,
                const int32_t* upstream, const double* priors,
                const double* il, int P, int Lp, int n_d, int pre_n,
                int n_log, int G, int n_grp, double impossible, double thresh,
                int blk0, int nblk, double* ws, void* out, cudaStream_t st) {
  auto kernel = mode_b_artifacts_warp_kernel<OutT, ON_CHIP>;
  const long smem = WarpSmem(Lp, n_d, pre_n, n_log, G, ON_CHIP).total;
  const int e = set_smem(kernel, smem, WARP_STATIC_SMEM);
  if (e != 0) return e;
  kernel<<<nblk, ART_THREADS, smem, st>>>(
      seg_codes, seg_quals, seg_len, lw64, lc64, tdesc, blk_bytes, upstream,
      priors, il, P, Lp, n_d, pre_n, n_log, G, n_grp, impossible, thresh,
      blk0, ws, (OutT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Segments a block of the warp kernel may take.
int mode_b_artifacts_max_segments() { return ART_MAX_SEGS; }

// Shared memory (dynamic and static) of a warp-kernel launch of G segments
// a block whose region lives on chip; n_log is int_log's length.
long mode_b_artifacts_warp_smem_bytes(int Lp, int n_d, int pre_n, int n_log,
                                      int G) {
  return WarpSmem(Lp, n_d, pre_n, n_log, G, true).total + WARP_STATIC_SMEM;
}

// Doubles of one block's device workspace (one segment a block).
long mode_b_artifacts_warp_ws_doubles(int Lp, int pre_n) {
  return (pre_n + 2L) * Lp + (Lp + 7) / 8;
}

// All pointers are device pointers.  seg_codes, seg_quals (2, P, Lp)
// uint8; seg_len (2, P) int32; lw64, lc64 (256,) float64; tdesc (T, 9)
// int32; blk_bytes uint8; upstream int32; priors (T, n_d) float64; il
// (n_log,) float64; out (T * P, n_d, Lp) float32 (out64 0) or float64
// (out64 1).  The warp kernel: blocks blk0 .. blk0 + nblk - 1 of
// T * ceil(P / G), G segments each (1 <= G <= 16); ws is null (the region
// in shared memory) or an (nblk, mode_b_artifacts_warp_ws_doubles) float64
// device workspace (then G is 1).
int mode_b_artifacts_warp(const uint8_t* seg_codes, const uint8_t* seg_quals,
                          const int32_t* seg_len, const double* lw64,
                          const double* lc64, const int32_t* tdesc,
                          const uint8_t* blk_bytes, const int32_t* upstream,
                          const double* priors, const double* il, int P,
                          int Lp, int n_d, int pre_n, int n_log, int G,
                          double impossible, double thresh,
                          int blk0, int nblk, double* ws, int out64,
                          void* out, void* stream) {
  if (G < 1 || G > ART_MAX_SEGS || (ws != nullptr && G != 1) || P < 1 ||
      Lp < 1 || n_log < 2 || pre_n < 2)
    return (int)cudaErrorInvalidValue;
  const int n_grp = (P + G - 1) / G;
  cudaStream_t st = (cudaStream_t)stream;
#define ART_WARP(T_, C_)                                                     \
  launch_warp<T_, C_>(seg_codes, seg_quals, seg_len, lw64, lc64, tdesc,     \
                      blk_bytes, upstream, priors, il, P, Lp, n_d, pre_n,     \
                      n_log, G, n_grp, impossible, thresh, blk0, nblk, ws,    \
                      out, st)
#define ART_WARP_C(T_) (ws == nullptr ? ART_WARP(T_, true) : ART_WARP(T_, false))
  return out64 ? ART_WARP_C(double) : ART_WARP_C(float);
#undef ART_WARP_C
#undef ART_WARP
}

}  // extern "C"
