#!/usr/bin/env python3
"""Smoke test of the PyTorch port (longtr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each:

1. device  — the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from longtr_tpu_torch/csrc (into
   longtr_tpu_torch/_build/, at first use).
2. kernels — seeded batches through every variant of the resident kernel
   K1 that takes their width (warp: one warp a pair; block: one block of
   warps a pair), both kernels of K2
   (cluster: one thread-block cluster a pair, up to 65536 columns;
   workspace: the rows in device memory, any width), the plain torch scan
   on the card and the native host scorer (but for the three largest
   cases, B=128 x 8 kb, B=8 x 24 kb and B=4 x 40 kb, which are held to the
   plain scan alone); every pair of them must agree
   bit for bit (tolerance 0), at 192 bp, 8 kb, length skew, custom
   parameters, gates and band fails, B=8 x 24 kb, B=4 x 40 kb, and at each
   kernel's width edges (the cluster kernel's at every C step, C full
   CTAs of 8192 columns and one column more, and 65536/65537, where the
   router hands over to the workspace kernel).  Every kernel is timed at
   192 bp, ~3 kb, 8 kb, 12 kb, 24 kb and 40 kb where it takes the width
   (the workspace kernel up to 24 kb), and at B=8 x 8 kb, beside the
   plain scan and its bound, with its time a row; the cluster kernel also
   at C = 1 beside
   the block variant (its barrier's cost), and at B = 8 and 128 x 12, 24
   and 40 kb at cluster_shape's C beside the fastest other C of the full
   sweep recorded in PERF.md (the guard of cluster_shape's choice).  Mode
   B at bench.py's shape (512 pooled reads of a 35 bp | A x 18 | 35 bp
   locus with -2/-1/+1 alternates): the artifact kernel's float32 tables
   must equal the plain version's built on the CPU (tolerance 0; the
   float64 entries that differ before the cast are counted), there and on
   12 random repeat
   blocks; its and the warp row kernel's device time a call is read from
   torch.profiler beside the CUDA events; both row kernels (warp and
   block),
   reading those tables in place, must equal the plain torch rows on the
   card (tolerance 0), there, at the warp kernel's widest rows and one
   column more (1024, 1025) and on rows too wide for the block kernel's
   shared memory; the
   marginalized LLs the host f64 path within 1e-4.  Times each kernel and
   its plain version at the main path's shapes, and mode-B pairs/s split
   into prepare, dispatch and marginalize.
3. e2e     — the `longtr` CLI of the port, each run twice: on the card, and
   as the reference, with pair scoring given to the native host scorer and
   mode B to the plain versions (the artifact tables built on the CPU, the
   plain rows on the card).  Catalogs: 512 short STRs, with and without
   --stutter-align-len 25 (one locus in six is an A homopolymer, so mode B
   and the pair-HMM both run); 24 VNTRs of 500-3000 bp; and the dryrun
   catalog's --snp-vcf, --ref-vcf and mode-B + --haploid-chrs surfaces and
   its core surface with LONGTR_DEVICE_POSTERIOR=1.  The VCF bodies must
   be byte-identical, each run's kernels must have launched (counts reset
   just before it and read just after), and no pair and no mode-B element
   may have been scored off the card, but for mode-B elements outside the
   row tables' envelope, which the host scores by design.  The STR runs
   take K1's warp variant and the VNTR run its block variant; a second
   VNTR run lowers the width thresholds so that K2's cluster and workspace
   kernels take its batches, a third so that K2's cluster kernel takes
   them.  The mode-B runs take the artifact warp kernel and the warp
   row kernel; a second mode-B dryrun sends its rows to the block kernel.
   The device-posterior run takes the window posteriors kernel.  The
   mode-B runs print the Haplotype build and Mode B dispatch seconds of
   both runs (the reference builds its tables on the CPU in the latter).
   The window
   posteriors (J3) on real windows: the 512-STR catalog once more with
   LONGTR_DEVICE_POSTERIOR=1 must give the VCF body of the runs without
   it; on each window's recorded inputs the kernel must meet
   tests/test_posterior.py's tolerances against the plain version on the
   card, locus by locus, and give the same bits on a second launch; it
   prints the loci a window, the launches (one a window), each window's
   device time (torch.profiler), the first window's time, the plain
   version's and the bound, the time of the host float64 posteriors that
   the kernel replaces (timed in a run without the variable), and the
   Device posterior stage split into host packing, copies, kernel and
   read-back.
4. mesh    — a mesh of four shards on the one card (4 x cuda:0): the
   sharded pair-HMM at phase 2's 192 bp and 8 kb batches, through K1's
   variant for the width and through each of K2's two kernels, equals the
   single-device kernels (tolerance 0) and launched once a shard; the EM
   train kernel (J4) at a realistic locus (R = 2000 reads, A = 12
   alleles, S = 3), on a mesh of 1 and of 4 shards of the card (the branch
   that keeps each read's terms in shared memory, whose name and cluster
   barriers an iteration it prints), equals the
   plain loop on CPU shards and on the card in iterations and convergence,
   parameters and posterior probabilities within 1e-5 (its log-posterior
   and total differences printed beside the plain loop's own on the card),
   gives the same bits on a second launch, and launches exactly one kernel
   a train (torch.profiler); it is timed against its plain loop, the host
   EM and its bound; the window posteriors kernel (J3) at that locus meets
   tests/test_posterior.py's tolerances against the plain version on the
   card, gives the same bits on a second launch and on a 4-shard mesh of a
   window of unequal loci, and is timed beside its plain version and its
   bound; its two routes, forced, are timed on windows of one locus and of
   256 equal loci of n reads (A = 4 and 12, S = 3) and on the mixed
   window, where the step bound between them comes from (one
   torch.profiler trace; the two routes must agree within the posterior
   tolerances); the five mesh surfaces of the dryrun catalog
   (core, snp-vcf, mode-b+haploid, ref-vcf, em-training) through the CLI
   with the mesh are byte-identical to the meshless runs on the card, with
   the kernels (the window posteriors on every surface and, for
   em-training, one EM train launch a trained locus) counted on the card
   and no pair off it; `--workers 2` and a two-process `--distributed` run
   of the 512-STR catalog are byte-identical to phase 3's single run; and
   a `--jax-profile` run of the core surface writes a torch.profiler trace
   that holds pairhmm_resident kernel events.

A torch.profiler trace that holds none of the kernels its calls launched
is one the profiler lost: it is taken again and printed, and a second
such trace in one run fails the smoke.

The last lines are a JSON object of the kernels (each with its launches
on the main path, error, time, plain version's time and bound), the
card's nvidia-smi name and power limit, and the result line.  Exits
non-zero, printing no result, without a CUDA card, outside a checkout of
the repository, or when any phase fails.  Nothing here imports JAX or the
JAX package: the inputs come from longtr_tpu_torch.testing.

A bound is the least time the card could take for the work: the larger of
the operations over 67 TFLOP/s (float32 outside the tensor cores) and the
bytes over 3.35 TB/s (each input read once, each output written once), the
H100 SXM's published peaks at 700 W.  A pair-HMM cell is 21 float
operations (the plain scan's adds, products and maxes), counted over the
pairs that are neither gated nor band-failed at the start; a mode-B column
of a row by its kind (expf and logf one operation each).  The artifact
tables are float64 work, over 34 TFLOP/s (float64 outside the tensor
cores, the same data sheet), counted on the run's data by artifact_ops.
"""

import contextlib
import gc
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_OPS = 67e12     # float32 operations/s outside the tensor cores
PEAK_F64_OPS = 34e12     # float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12     # HBM3 bytes/s
NATIVE_MAX_CELLS = 2e9   # phase 2 cases the native host scorer also checks
# J4's log-posteriors against CPU shards: at most this many times the
# plain loop on the card's share of the rtol 1e-6 / atol 1e-4 bound
EM_LOGPOST_SLACK = 2.0
# phase 3's runs that score mode B on the card
MODE_B_RUNS = ("STR mode B", "dryrun mode-b+haploid",
               "dryrun mode-b+haploid block")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card():
    """`name, power.limit` of card 0 as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(ops, nbytes):
    """(ms, what bounds it) for `ops` float32 operations moving `nbytes`."""
    t_ops = ops / PEAK_F32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pairhmm_bound(arrs):
    """Bound of one mode-A batch (hap, hap_len, read, read_len, full_len):
    21 float operations a cell of every pair the DP runs on."""
    import numpy as np
    H, hl, R, rl, fl = arrs
    live = (fl > 60) & (np.abs(hl.astype(np.int64) - rl) <= 600)
    cells = float((hl[live].astype(np.int64)
                   * np.minimum(rl[live], R.shape[1])).sum())
    nbytes = sum(a.nbytes for a in arrs) + 7 * 4 + 4 * len(H)
    return bound(21 * cells, nbytes)


def mode_b_bound(g, n_d):
    """Bound of one mode_b_cols call on its tables `g` (TABLE_KEYS order):
    per column, a flank row 18 operations, a row after a stutter row 1, a
    stutter row 5 a stutter term plus a log and an add, row 0 one."""
    codes, kind = g[0], g[7]
    L = codes.shape[1]
    per_kind = {0: 18, 1: 1, 2: 5 * n_d + 2, 3: 0}
    k = kind[:, 1:].cpu().numpy()
    ops = L * (kind.shape[0] + sum(int((k == kk).sum()) * v
                                   for kk, v in per_kind.items()))
    nbytes = sum(x.numel() * x.element_size() for x in g) + 4 * kind.numel()
    return bound(float(ops), nbytes)


def artifact_ops(inp):
    """float64 operations the artifact tables of `inp` (a prepared batch's
    ARTIFACT_KEYS arrays) need, counted on this data: per offset of a
    segment the block's and the insertions' prefix adds; per valid column
    and artifact size the initial lp (2, or one add a base where a
    deletion runs past the segment's start), the descent's lp updates (2
    each) and int_log adds (1 each) up to the column's exit, the tail (1),
    the LSE (a max, a subtract, a compare, an exp and an add an entry; a log
    and an add) and the prior (1).  The descent is the same for every
    column of a (table, D), so it is walked once and cut at each exit."""
    import numpy as np
    total = 0.0
    for row in inp["tdesc"].tolist():
        side, bl, per, d_first, n_dl, n_del, n_ins, _bo, uo = row
        Ls = inp["seg_len"][side].astype(np.int64)
        total += float(Ls.sum()) * (bl + per * n_ins)
        if not Ls.max():
            continue
        j = np.arange(int(Ls.max()))
        valid = j[None, :] < Ls[:, None]
        ups = inp["upstream"][uo:uo + max(n_del, 1) * bl]
        for di in range(n_dl):
            D = d_first + di * per
            if bl + D < 0:
                continue
            if D == 0:
                total += float(Ls.sum())
                continue
            up = ups[:bl] if D > 0 else ups[(-D // per - 1) * bl:
                                            (-D // per) * bl]
            # the shared descent: (i at the step, ops, i after)
            steps, i = [], 0
            while i > -bl:
                if D > 0 and not (-i + per < bl):
                    steps.append((i, 0, i - 1))
                    i -= 1
                    continue
                um = int(up[bl - 1 + i])
                if um == 0:
                    u = 2 * len(range(i - per, i - D - 1, -per)) if D > 0 \
                        else 2
                    steps.append((i, u, i - 1))
                    i -= 1
                else:
                    steps.append((i, 1, i - um))
                    i -= um
            t_base = bl if D > 0 else bl + D
            # by exit -lim = 0 .. bl: steps taken, their ops, the tail
            n_st = np.zeros(bl + 1)
            ops_st = np.zeros(bl + 1)
            for k in range(bl + 1):
                taken = [st for st in steps if st[0] > -k]
                i_exit = taken[-1][2] if taken else 0
                n_st[k] = len(taken) + (i_exit > -t_base)
                ops_st[k] = sum(st[1] for st in taken) + (i_exit > -t_base)
            base_len = np.minimum(bl + D, j + 1)
            neg = (Ls[:, None] - 1 - j[None, :] + D) < 0
            if D > 0:
                k = np.minimum(np.maximum(0, base_len - D), bl)
                init = np.full(neg.shape, 2.0)
            else:
                k = base_len
                init = np.where(neg, base_len[None, :], 2.0)
            n_e = 1 + n_st[k]
            per_col = init + ops_st[k][None, :] + 5 * n_e + 3
            total += float((per_col * valid).sum())
    return total


def kernel_lines():
    """`file:line` of the two Pallas kernel bodies the CUDA kernels replace."""
    rel = "longtr_tpu/ops/pairhmm_pallas.py"
    with open(os.path.join(ROOT, rel)) as fh:
        lines = fh.read().splitlines()
    found = {}
    for i, ln in enumerate(lines, 1):
        for name in ("_kernel", "_kernel_chunked"):
            if ln.startswith(f"def {name}("):
                found[name] = f"{rel}:{i}"
    if len(found) != 2:
        fail(f"Pallas kernels not found in {rel}")
    return found


def def_line(rel, name):
    """`file:line` of `def name(` in the JAX package's file `rel`."""
    with open(os.path.join(ROOT, rel)) as fh:
        for i, ln in enumerate(fh, 1):
            if ln.lstrip().startswith(f"def {name}("):
                return f"{rel}:{i}"
    fail(f"{name} not found in {rel}")


def bench_mode_b_locus(device):
    """bench.py's mode-B shape (bench.py:177-241) with the port's aligner:
    512 distinct pooled reads of a 35 bp | A x 18 | 35 bp locus with
    -2/-1/+1 alternates.  Returns (aligner, reads, seeds)."""
    import numpy as np
    from longtr_tpu_torch.haplotype.blocks import (HapBlock, Haplotype,
                                                   RepeatBlock)
    from longtr_tpu_torch.models.stutter import StutterModel
    from longtr_tpu_torch.pipeline.alignment import Alignment
    from longtr_tpu_torch.pipeline.mode_b import ModeBAligner, calc_seed_base
    rng = np.random.default_rng(2)
    bases = list("ACGT")
    lf = "".join(rng.choice(bases, 35).tolist())
    rf = "".join(rng.choice(bases, 35).tolist())
    rep = "A" * 18
    model = StutterModel(0.9, 0.05, 0.05, 0.9, 0.01, 0.01, "A")
    rs = 1000 + len(lf)
    rb = RepeatBlock(rs, rs + len(rep), rep, 1, model)
    for d in (-2, -1, 1):
        rb.add_alternate("A" * (18 + d))
    hap = Haplotype([HapBlock(1000, rs, lf), rb,
                     HapBlock(rs + len(rep), rs + len(rep) + len(rf), rf)])
    aligner = ModeBAligner(hap, device=device)
    pools = []
    for k in range(512):
        fl = list(lf + "A" * (18 + int(rng.integers(-2, 2))) + rf)
        for _ in range(int(rng.integers(1, 4))):
            fl[int(rng.integers(0, len(fl)))] = str(rng.choice(bases))
        seq = "".join(fl)
        pools.append(Alignment(1000, 1000 + len(lf) + len(rep) + len(rf) - 1,
                               False, False, f"p{k}", "I" * len(seq), seq,
                               alignment=seq, cigar=[("=", len(seq))]))
    seeds = [calc_seed_base(a, aligner.repeat_starts, aligner.repeat_ends,
                            1000, rs + len(rep) + len(rf)) for a in pools]
    keep = [i for i, s in enumerate(seeds) if s >= 0]
    return aligner, [pools[i] for i in keep], [int(seeds[i]) for i in keep]


def artifacts_vs_plain(inp, n_d, dev, mbc, label):
    """The artifact kernel's float32 tables against the plain version's
    float64 tables run on the CPU, cast, at tolerance 0; returns (the
    kernel's float32 tables on the card, float64 entries that differ
    before the cast, entries, max |float64 difference|, the plain tables'
    seconds on the CPU, max |float32 difference|)."""
    import numpy as np
    import torch
    from longtr_tpu_torch.ops.mode_b_artifacts import mode_b_artifacts_plain
    from test_torch_cuda import ARTIFACT_KEYS
    cpu = [torch.from_numpy(np.ascontiguousarray(inp[k]))
           for k in ARTIFACT_KEYS]
    g = [x.to(dev) for x in cpu]
    t = time.perf_counter()
    host = mode_b_artifacts_plain(*cpu, n_d=n_d, dtype=torch.float64).numpy()
    host_s = time.perf_counter() - t
    name = "mode_b_artifacts"
    got32 = mbc.mode_b_artifacts(*g, n_d=n_d)
    got64 = mbc.mode_b_artifacts(*g, n_d=n_d, dtype=torch.float64)
    torch.cuda.synchronize()
    c32, c64 = got32.cpu().numpy(), got64.cpu().numpy()
    if c32.shape != host.shape or not np.array_equal(c32,
                                                     host.astype(np.float32)):
        bad = np.argwhere(c32 != host.astype(np.float32))[:4].tolist()
        fail(f"{name} disagrees with the plain tables on {label}: "
             f"{int((c32 != host.astype(np.float32)).sum())} entries, first "
             f"{bad}")
    fin = np.isfinite(host)
    if not np.array_equal(fin, np.isfinite(c64)) \
            or not np.array_equal(c64[~fin], host[~fin]):
        fail(f"{name}: non-finite entries differ on {label}")
    err = float(np.abs(c64[fin] - host[fin]).max()) if fin.any() else 0.0
    err32 = float(np.abs(c32[fin].astype(np.float64)
                         - host[fin].astype(np.float32)).max()) \
        if fin.any() else 0.0
    return got32, int((c64 != host).sum()), host.size, err, host_s, err32


# Traces the profiler lost in this run.  Each is taken again and printed;
# a second in one run fails the smoke, so that a worsening loss shows.
LOST_TRACES = []


def lost_trace(what):
    LOST_TRACES.append(what)
    say("profile", f"torch.profiler lost a trace: {what}")
    if len(LOST_TRACES) > 1:
        fail(f"torch.profiler lost {len(LOST_TRACES)} traces in this run: "
             f"{LOST_TRACES}")


def profiled_us(fn, name, reps=20):
    """Device microseconds a call of the kernels whose name holds `name`,
    from torch.profiler's key_averages over `reps` calls of `fn`.  fn
    launches such a kernel (the callers count its launches apart), so a
    trace without one is one the profiler lost: it is taken again
    (lost_trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "device_time_total", 0) or \
                    getattr(ev, "cuda_time_total", 0)
                count += ev.count
        if count:
            return (total / count if total else None), count / reps
        lost_trace(f"no {name} kernel in {reps} calls")


def ms_or_none(us):
    return None if us is None else us / 1e3


def fmt_ms(ms):
    return "not measured (no device time in the trace)" if ms is None \
        else f"{ms:.5f} ms"


def mode_b_kernel_phase(dev, smi, mbc, mbd, dev_ms):
    """Phase 2 for mode B: the artifact kernel against the plain tables
    built on the CPU at bench.py's shape and on random blocks (tolerance 0 in
    float32, float64 differences counted); both row kernels against the
    plain rows on the card at that shape, at the warp kernel's edge and
    above the shared-memory width; the LLs against the host f64 path;
    times, bounds and pairs/s."""
    import numpy as np
    import torch
    from longtr_tpu_torch.ops.mode_b_artifacts import mode_b_artifacts_plain
    from longtr_tpu_torch.pipeline.mode_b import ModeBAligner
    from longtr_tpu_torch.utils.timers import record_spans
    from test_torch_cuda import (ARTIFACT_KEYS, TABLE_KEYS, artifact_case,
                                 synthetic_tables)

    aligner, alns, seeds = bench_mode_b_locus(dev)
    t = time.perf_counter()
    prep = aligner.score_reads_batch_prepare(alns, seeds)
    prep_s = time.perf_counter() - t
    n_d, P = prep["n_d"], prep["P"]
    # (a) the artifact tables: bench.py's shape, then the edges
    Lp = prep["seg_codes"].shape[2]
    plan = mbc.artifact_plan(Lp, n_d, P, len(prep["int_log"]), dev)
    A, n64, n_all, err64, host_s, art_err = artifacts_vs_plain(
        prep, n_d, dev, mbc, "bench.py's shape")
    art_shape = (f"T={prep['tdesc'].shape[0]} P={P} n_d={n_d} L={Lp}")
    e64 = e_all = 0
    e_err = 0.0
    for trial in range(12):
        al, tables, ss, L_max, nd = artifact_case(
            trial, lambda hap, params=None: ModeBAligner(hap, params,
                                                         device=dev))
        inp = al.artifact_inputs(tables, ss, L_max, nd)
        _g, d64, d_all, d_err, _s, d_err32 = artifacts_vs_plain(
            inp, nd, dev, mbc, f"random block {trial}")
        e64, e_all = e64 + d64, e_all + d_all
        e_err, art_err = max(e_err, d_err), max(art_err, d_err32)
    say("kernels", f"mode_b_artifacts (warp kernel: {plan[0]} segments a "
        f"block, region on chip {plan[1]}) at bench.py's shape "
        f"({art_shape}) and on 12 random blocks (homopolymers and not, "
        "deletions past the block, empty and one-base segments, padding): "
        "float32 tables == the plain tables built on the CPU (tolerance 0); "
        "float64 "
        f"entries that differ before the cast: {n64} of {n_all} at "
        f"bench.py's shape (max {err64:.3g}), {e64} of {e_all} on the "
        f"random blocks (max {e_err:.3g})")
    # (b) the row DP on the kernel's tables, read in place
    g = [A if k == "A_tab" else torch.from_numpy(prep[k]).to(dev)
         for k in TABLE_KEYS]
    shape = (f"B={g[0].shape[0]} R={g[6].shape[1]} L={g[0].shape[1]} "
             f"S={g[10].shape[1]} NT={g[9].shape[0]} n_d={n_d}")
    if not mbc.takes_warp(g[0].shape[1], n_d):
        fail(f"mode_b_cols: bench.py's shape {shape} does not take the warp "
             "kernel")
    before = dict(mbc.launches)
    got = mbc.mode_b_cols(*g, n_d=n_d)
    if mbc.launches["mode_b_cols"] != before["mode_b_cols"] + 1:
        fail("mode_b_cols: bench.py's shape did not launch the warp kernel")
    got_block = mbc.mode_b_cols(*g, n_d=n_d, variant="block")
    plain = mbd.mode_b_cols_plain(*g, n_d=n_d)
    torch.cuda.synchronize()
    max_err = {"mode_b_cols": float((got.double() - plain.double()).abs()
                                    .nan_to_num().max()),
               "mode_b_cols_block": float((got_block.double()
                                           - plain.double()).abs()
                                          .nan_to_num().max())}
    for name, out in (("warp", got), ("block", got_block)):
        if not torch.equal(out, plain):
            bad = torch.nonzero(out != plain)[:4].tolist()
            fail(f"mode_b_cols ({name}) disagrees with the plain rows at "
                 f"{shape}: first {bad}")
    # the warp kernel's widest rows and one column more, then rows too
    # wide for the block kernel's shared memory (the workspace)
    for L, want_route in ((1024, "mode_b_cols"), (1025, "mode_b_cols_block")):
        ge = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
            synthetic_tables(np.random.default_rng(L), 8, L, 32, 2, 13)[k]
            for k in TABLE_KEYS)]
        want = mbd.mode_b_cols_plain(*ge, n_d=13)
        before = dict(mbc.launches)
        outs = [mbc.mode_b_cols(*ge, n_d=13),
                mbc.mode_b_cols(*ge, n_d=13, variant="block")]
        if mbc.launches[want_route] == before[want_route]:
            fail(f"mode_b_cols: width {L} did not take {want_route}")
        if not all(torch.equal(o, want) for o in outs):
            fail(f"mode_b_cols disagrees with the plain rows at width {L}")
    wide = synthetic_tables(np.random.default_rng(9), 4, 20000, 32, 2, 13)
    gw = [torch.from_numpy(np.ascontiguousarray(wide[k])).to(dev)
          for k in TABLE_KEYS]
    wide_shape = (4, 32, 20000, 2, 13)
    if mbc.fits_on_chip(20000, dev):
        fail("mode_b_cols: a width of 20000 should not fit on chip")
    if not torch.equal(mbc.mode_b_cols(*gw, n_d=13),
                       mbd.mode_b_cols_plain(*gw, n_d=13)):
        fail(f"mode_b_cols disagrees with the plain rows at {wide_shape} "
             "(workspace)")
    # (c) marginalized LLs: the card's f32 rows against the host f64 path
    # on the first 64 reads (the host path takes ~100 ms a read)
    lls = aligner.score_reads_batch_finish(prep)
    t = time.perf_counter()
    host = np.stack([aligner.score_read(a, s)
                     for a, s in zip(alns[:64], seeds[:64])])
    host_ll_s = (time.perf_counter() - t) / 64 * len(alns)
    ll_err = float(np.abs(lls[:64] - host).max())
    if not np.allclose(lls[:64], host, rtol=1e-4, atol=1e-4):
        fail(f"mode-B LLs on the card differ from the host f64 path by "
             f"{ll_err}")
    # (d) times and bounds: each kernel's device time a call from the
    # profiler beside the CUDA events of a loop of wrapper calls, and the
    # artifact wrapper's host time a call
    ga = [torch.from_numpy(prep[k]).to(dev) for k in ARTIFACT_KEYS]

    def art_call():
        return mbc.mode_b_artifacts(*ga, n_d=n_d)

    art_ms = dev_ms(art_call, 20)
    art_prof = profiled_us(art_call, "mode_b_artifacts_warp_kernel")

    def host_us(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / reps * 1e6

    wrap_us = host_us(art_call)
    art_plain_ms = dev_ms(lambda: mode_b_artifacts_plain(*ga, n_d=n_d), 2)
    art_bytes = (sum(x.numel() * x.element_size() for x in ga)
                 + A.numel() * A.element_size())
    art_ops = artifact_ops(prep)
    art_bound = max((art_ops / PEAK_F64_OPS * 1e3, "operations"),
                    (art_bytes / PEAK_BYTES * 1e3, "bytes"))
    ms = {"mode_b_cols": dev_ms(lambda: mbc.mode_b_cols(*g, n_d=n_d), 20),
          "mode_b_cols_block": dev_ms(lambda: mbc.mode_b_cols(
              *g, n_d=n_d, variant="block"), 20)}
    cols_prof = profiled_us(lambda: mbc.mode_b_cols(*g, n_d=n_d),
                            "mode_b_cols_warp_kernel")
    plain_ms = dev_ms(lambda: mbd.mode_b_cols_plain(*g, n_d=n_d), 3)
    bound_ms, bound_by = mode_b_bound(g, n_d)
    # pairs/s as bench.py:234 defines it: (prepare + finish) per rep
    reps, phase = 3, {"prepare_s": 0.0}
    spans = record_spans(True)
    t = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        p = aligner.score_reads_batch_prepare(alns, seeds)
        phase["prepare_s"] += time.perf_counter() - t0
        aligner.score_reads_batch_finish(p)
    rep_s = (time.perf_counter() - t) / reps
    record_spans(False)
    for key, name in (("dispatch_s", "Mode B device"),
                      ("marginalize_s", "Mode B marginalize")):
        phase[key] = sum(b - a for n, a, b, *_ in spans if n == name)
    pairs = len(alns) * aligner.hap.num_combs()
    copied = sum(prep[k].nbytes for k in TABLE_KEYS if k != "A_tab") \
        + sum(prep[k].nbytes for k in ARTIFACT_KEYS)
    say("kernels", f"mode_b_cols at bench.py's shape ({shape}), on the "
        "artifact kernel's tables in place: warp and block kernels == plain "
        f"rows on the card (bit-identical); widths 1024 (warp) and 1025 "
        "(block) == plain; rows of width 20000 (workspace) == plain; LLs "
        f"within {ll_err:.3g} of the host f64 path on 64 reads")
    art_prof_ms = ms_or_none(art_prof[0])
    cols_prof_ms = ms_or_none(cols_prof[0])
    say("kernels", f"mode_b_artifacts on {smi} ({art_shape}): "
        f"{art_ms:.5f} ms a call (CUDA events, 20 calls), device time a "
        f"call {fmt_ms(art_prof_ms)} (torch.profiler, {art_prof[1]:g} "
        f"launches a call); the wrapper's host time {wrap_us / 1e3:.5f} ms "
        f"a call; plain version on the card {art_plain_ms:.3f} ms; bound "
        f"{art_bound[0]:.5f} ms ({art_bound[1]}; {art_bytes} bytes, "
        f"{art_ops:.4g} float64 operations at {PEAK_F64_OPS / 1e12:g} "
        f"TFLOP/s): {art_bound[0] / art_ms:.3%} of it by events; the plain "
        f"version on the CPU {host_s:.3f} s (wall)")
    say("kernels", f"mode_b_cols on {smi}: warp kernel "
        f"{ms['mode_b_cols']:.4f} ms (CUDA events), device time a call "
        f"{fmt_ms(cols_prof_ms)} (torch.profiler, {cols_prof[1]:g} launches "
        f"a call), block kernel {ms['mode_b_cols_block']:.4f} ms, plain "
        f"rows {plain_ms:.3f} ms (CUDA events), bound {bound_ms:.5f} ms "
        f"({bound_by}; warp {bound_ms / ms['mode_b_cols']:.3%}, block "
        f"{bound_ms / ms['mode_b_cols_block']:.3%} of it); host f64 "
        f"score_read {host_ll_s:.3f} s for all {len(alns)} reads (wall, "
        f"timed on 64); first prepare {prep_s:.3f} s")
    say("kernels", f"mode-B pairs/s (bench.py's definition): "
        f"{pairs / rep_s:.5g} ({rep_s:.4f} s a rep: prepare "
        f"{phase['prepare_s'] / reps:.4f}, dispatch (copy, both kernels, "
        f"copy back) {phase['dispatch_s'] / reps:.4f}, marginalize "
        f"{phase['marginalize_s'] / reps:.4f}); {copied} bytes copied to "
        f"the card a dispatch, {A.numel() * A.element_size()} bytes of "
        "tables built there")
    entry = {"plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "shape": shape}
    return {"mode_b_cols": dict(entry, ms=ms["mode_b_cols"],
                                profiler_ms=cols_prof_ms,
                                max_abs_err=max_err["mode_b_cols"]),
            "mode_b_cols_block": dict(entry, ms=ms["mode_b_cols_block"],
                                      max_abs_err=max_err[
                                          "mode_b_cols_block"]),
            "mode_b_artifacts": {"ms": art_ms, "plain_ms": art_plain_ms,
                                 "bound_ms": art_bound[0],
                                 "bound_by": art_bound[1],
                                 "profiler_ms": art_prof_ms,
                                 "max_abs_err": art_err, "shape": art_shape},
            "wide_shape": wide_shape}


def posterior_and_em_bounds(R, A, S, n_iter):
    """The bounds of the two device programs at a locus of R reads, A
    alleles and S samples: J3's (ms, what bounds it, bytes) for one
    locus, J4's for a train of n_iter iterations.

    J3, the window posteriors: reads the (R, A) log-likelihoods, the two
    (R,) phase weights, the (R,) int64 labels and read mask and the (A, A)
    prior, writes the (S, A, A) posteriors and (S,) totals; 6 operations a
    (read, allele, allele) term (two adds, a logaddexp of three and the sum
    by sample).  J4, the EM train loop: reads the six (R, A) diff tables
    (int32 rep, eff and cat, bool in_frame, float32 w_in and w_out), the
    (R,) weights, labels and mask and the (A,) initial priors once (0.5 MB
    at R=2000 stays on chip between iterations), writes the packed result
    (8 + S + S * A * A floats) once; 21 operations a (read, allele,
    allele) term over its two E-step halves (the first as J3, the second a
    logaddexp and two logsumexps of the phase terms) and 12 a (read,
    allele) term for the PMF, each iteration."""
    j3_bytes = (R * A * 4 + R * (4 + 4 + 8 + 1) + A * A * 4
                + S * (A * A + 1) * 4)
    j4_bytes = (R * A * (4 + 4 + 4 + 1 + 4 + 4) + R * (4 + 4 + 8 + 1)
                + A * 4 + (8 + S + S * A * A) * 4)
    j4_ops = n_iter * (21.0 * R * A * A + 12.0 * R * A)
    return ((*bound(6.0 * R * A * A, j3_bytes), j3_bytes),
            (*bound(j4_ops, j4_bytes), j4_bytes))


def window_bound(counts, A, S):
    """J3's (ms, what bounds it, bytes) over a window whose loci hold
    `counts` reads each, padded to A alleles and S samples: the sum of
    posterior_and_em_bounds's J3 bytes and 6 operations a term over each
    locus's own reads."""
    nbytes = 0
    for n in counts:
        nbytes += posterior_and_em_bounds(int(n), A, S, 0)[0][2]
    return (*bound(6.0 * float(sum(counts)) * A * A, nbytes), nbytes)


def ev_ms(fn, reps):
    """Milliseconds a call of fn on the card: CUDA events around `reps`
    calls after one more."""
    import torch
    fn()
    torch.cuda.synchronize()
    s_ev, e_ev = (torch.cuda.Event(enable_timing=True) for _ in "se")
    s_ev.record()
    for _ in range(reps):
        fn()
    e_ev.record()
    torch.cuda.synchronize()
    return s_ev.elapsed_time(e_ev) / reps


def em_errors(got, want):
    """(parameters, posterior probabilities, log-posteriors, the
    log-posteriors' largest share of rtol 1e-6 / atol 1e-4, totals) max
    absolute differences between two trains."""
    import numpy as np
    lg = np.abs(got[3] - want[3])
    fin = np.isfinite(lg)
    return (float(np.abs(got[1] - want[1]).max()),
            float(np.abs(np.exp(got[3]) - np.exp(want[3])).max()),
            float(lg[fin].max()),
            float((lg[fin] / (1e-4 + 1e-6 * np.abs(want[3][fin]))).max()),
            float(np.abs(got[4] - want[4]).max()))


def profiled_kernels(fn):
    """(fn's result, the CUDA kernel events of one call of fn, copies and
    fills left out) from torch.profiler.  fn launches at least one kernel
    (its launch counts are checked apart), so a trace without a single
    kernel event is one the profiler lost (seen late in a long process,
    with and without its copies): the call is profiled again
    (lost_trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in on_card
                if not e.name.startswith(("Memcpy", "Memset"))]
        if kern:
            return out, kern
        lost_trace(f"{len(on_card)} device events, no kernel: "
                   f"{sorted({e.name for e in on_card})}")


def run_cli_processes(argvs, timeout):
    """Run `python -m longtr_tpu_torch.cli` once per argv, all at once, each
    in its own process group; kill every group still running at the end.
    Returns [(returncode, stderr, seconds)]."""
    import signal
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "longtr_tpu_torch.cli",
                               *a], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, start_new_session=True)
             for a in argvs]
    try:
        outs = [pr.communicate(timeout=timeout) for pr in procs]
    except subprocess.TimeoutExpired:
        fail(f"CLI processes did not finish within {timeout} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                os.killpg(pr.pid, signal.SIGKILL)
                pr.wait()
    dt = time.perf_counter() - t
    return [(pr.returncode, err.decode(), dt)
            for pr, (_o, err) in zip(procs, outs)]


def em_kernel_phase(dev, smi, mesh):
    """Phase 4's kernel checks: the EM train (J4), one launch of
    em_train_kernel a train on a mesh of 1 and of 4 shards of the card,
    against the plain loop on CPU shards and on the card, its launches
    counted by torch.profiler; then the window posteriors (J3) against the
    plain version on the card and across mesh sizes.  Returns both
    kernels' numbers for the kernels line."""
    import numpy as np
    import torch
    from longtr_tpu_torch.config import Config
    from longtr_tpu_torch.parallel import mesh as pm
    from longtr_tpu_torch.ops import em_cuda
    from longtr_tpu_torch.ops import posterior as post
    from _torch_cases import (assert_posteriors_close, plain_em_train,
                              posterior_window, realistic_em_locus)

    cfg = Config()
    conv = (cfg.max_em_iter, cfg.abs_ll_converge, cfg.frac_ll_converge)
    locus = realistic_em_locus()
    em = locus()
    R, A, S = len(em.sample_label), em.num_alleles, em.num_samples
    if (A, R, S) != (12, 2000, 3):
        fail(f"EM locus has A={A}, R={R}, S={S}")
    tables = em.mesh_inputs()
    args = (*tables, *conv)
    em_err = 0.0
    for n in (1, 4):
        card_mesh = pm.Mesh([dev] * n)
        em_cuda.reset_launches()
        on_card = pm.em_train_sharded(card_mesh, *args)
        again = pm.em_train_sharded(card_mesh, *args)
        if em_cuda.launches != {"window_posteriors": 0, "em_train": 2}:
            fail(f"device EM on {n} shard(s): launches {em_cuda.launches}")
        if (on_card[0], on_card[2]) != (again[0], again[2]) or not all(
                np.array_equal(a, b) for a, b in zip(on_card[1:], again[1:])):
            fail(f"device EM on {n} shard(s): two launches differ")
        on_cpu = pm.em_train_sharded(pm.Mesh(["cpu"] * n), *args)
        plain_card = plain_em_train(card_mesh, tables, *conv)
        for ref_name, ref in (("CPU shards", on_cpu),
                              ("the plain loop on the card", plain_card)):
            e = em_errors(on_card, ref)
            if (on_card[0], on_card[2]) != (ref[0], ref[2]) \
                    or e[0] > 1e-5 or e[1] > 1e-5:
                fail(f"device EM on {n} shard(s) vs {ref_name}: (converged, "
                     f"n_iter) {on_card[0], on_card[2]} vs {ref[0], ref[2]}, "
                     f"params {e[0]}, posterior probabilities {e[1]}")
        e_cpu = em_errors(on_card, on_cpu)
        e_plain = em_errors(plain_card, on_cpu)
        e_kp = em_errors(on_card, plain_card)
        # Log-posteriors near -5000 sum in float32, where one step is
        # 4.9e-4: a second order of the same sums (the plain loop on the
        # card) may itself miss the rtol 1e-6 / atol 1e-4 bound against CPU
        # shards.  The kernel may miss it by at most EM_LOGPOST_SLACK times
        # as much as that second order does, and by no more than the bound
        # where the second order meets it.
        limit = EM_LOGPOST_SLACK * max(1.0, e_plain[3])
        if e_cpu[3] > limit:
            fail(f"device EM on {n} shard(s) vs CPU shards: log-posteriors "
                 f"{e_cpu[3]:.3g} x the rtol 1e-6 / atol 1e-4 bound, more "
                 f"than {limit:.3g} ({EM_LOGPOST_SLACK} x max(1, "
                 f"{e_plain[3]:.3g}), the plain loop on the card's)")
        em_err = max(em_err, e_kp[2])
        padded = pm.em_tables(*tables[:9], n)
        branch = em_cuda.em_branch(
            A, S, n, em_cuda.em_layout(padded[5], padded[9], n, S), dev)
        say("mesh", f"em_train_sharded at R=2000 A=12 S=3 on {n} shard(s) "
            f"of the card: branch {branch} ({em_cuda.BARRIERS[branch]} "
            "cluster barriers an iteration); one em_train_kernel launch a "
            "train, two launches "
            f"bit-identical; (converged, n_iter) = ({on_card[0]}, "
            f"{on_card[2]}) as on CPU shards and the plain loop on the card; "
            f"against CPU shards parameters within {e_cpu[0]:.3g}, posterior "
            f"probabilities within {e_cpu[1]:.3g}, log-posteriors within "
            f"{e_cpu[2]:.4g} ({e_cpu[3]:.3g} x the rtol 1e-6 / atol 1e-4 "
            f"bound), totals within {e_cpu[4]:.4g}; the plain loop on the "
            f"card against CPU shards: log-posteriors {e_plain[2]:.4g} "
            f"({e_plain[3]:.3g} x; the kernel's limit {limit:.3g} x), totals "
            f"{e_plain[4]:.4g}; the kernel "
            f"against the plain loop on the card: parameters "
            f"{e_kp[0]:.3g}, log-posteriors {e_kp[2]:.4g}, totals "
            f"{e_kp[4]:.4g}")

    # the launches of one train, counted by the profiler
    one, kern = profiled_kernels(
        lambda: pm.em_train_sharded(pm.Mesh([dev]), *args))
    if len(kern) != 1 or "em_train_kernel" not in kern[0].name:
        fail(f"one device train launched {[e.name for e in kern]}")
    plain_one, plain_kern = profiled_kernels(
        lambda: plain_em_train(pm.Mesh([dev]), tables, *conv))
    n_plain = len(plain_kern)
    say("mesh", f"em_train_sharded on 1 shard of the card: 1 CUDA kernel "
        f"launch for {one[2]} iterations (torch.profiler: {kern[0].name}); "
        f"the plain loop on the card: {n_plain} kernel launches for "
        f"{plain_one[2]} iterations, {n_plain / plain_one[2]:.1f} an "
        "iteration")

    # times: the kernel on device-resident tables (CUDA events and the
    # profiler's device time), the plain loop on the card, the host EM and
    # em_train_sharded's wall (copies in, the launch, the one read back)
    padded = pm.em_tables(*tables[:9], 1)
    g4 = [torch.from_numpy(x).to(dev) for x in (
        *padded, np.asarray(tables[9], np.float32))]
    layout = em_cuda.em_layout(padded[5], padded[9], 1, S)

    def em_call():
        return em_cuda.em_train(*g4, n_shards=1, num_samples=S,
                                haploid=False, max_iter=conv[0],
                                min_abs=conv[1], min_frac=conv[2],
                                layout=layout)

    j4_ms = ev_ms(em_call, 10)
    j4_prof = profiled_us(em_call, "em_train_kernel", reps=10)
    j4_plain_ms = ev_ms(
        lambda: plain_em_train(pm.Mesh([dev]), tables, *conv), 3)

    def train_s(mesh_):
        times = []
        for _ in range(3):
            e = locus()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if not e.train(*conv, mesh=mesh_):
                fail("EM on the realistic locus did not converge")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return sorted(times)[1]

    t_host = train_s(None)
    t_card4 = train_s(mesh)
    t_card1 = train_s(pm.Mesh([dev]))
    t_host2 = train_s(None)
    (j3_bound, j3_by, j3_bytes), (j4_bound, j4_by, j4_bytes) = \
        posterior_and_em_bounds(R, A, S, one[2])
    say("mesh", f"EM train at R=2000 A=12 S=3 on {smi}, {one[2]} "
        f"iterations: em_train_kernel {j4_ms:.4f} ms a train (CUDA events, "
        "device-resident tables), device time "
        f"{fmt_ms(ms_or_none(j4_prof[0]))}"
        f" (torch.profiler); the plain loop on the card {j4_plain_ms:.3f} ms; "
        f"bound {j4_bound * 1e3:.4f} us a train ({j4_by}; {j4_bytes} bytes "
        f"a train), {j4_bound / j4_ms:.4%} of it; wall, median of 3: "
        f"host EMStutterGenotyper.train() {t_host * 1e3:.2f} ms and "
        f"{t_host2 * 1e3:.2f} ms (before and after), em_train_sharded on 4 "
        f"shards of the card {t_card4 * 1e3:.3f} ms, on 1 shard "
        f"{t_card1 * 1e3:.3f} ms")

    # J3 at the realistic locus (one locus a window) against the plain
    # version on the card; a window of unequal loci on 1 and 4 shards
    rng = np.random.default_rng(11)
    window1 = [dict(log_aln_probs=rng.normal(-6.0, 3.0, (R, A)),
                    log_p1=np.log(rng.uniform(0.05, 0.95, R)),
                    log_p2=np.log(rng.uniform(0.05, 0.95, R)),
                    sample_label=np.asarray(em.sample_label), num_samples=S,
                    haploid=False)]
    arrays, S_max = post.pad_window(window1)
    g3 = [torch.from_numpy(x).to(dev) for x in arrays]

    def j3_call():
        return em_cuda.window_posteriors(*g3, S_max, np.array([R], np.int32))

    em_cuda.reset_launches()
    P, tot = j3_call()
    P2, tot2 = j3_call()
    want_P, want_tot, _ = post.calc_log_sample_posteriors(
        *g3[:4], S_max, g3[5], read_mask=g3[4])
    torch.cuda.synchronize()
    if em_cuda.launches["window_posteriors"] != 2:
        fail(f"window posteriors: launches {em_cuda.launches}")
    if not (torch.equal(P, P2) and torch.equal(tot, tot2)):
        fail("window posteriors: two launches differ")
    try:
        assert_posteriors_close(P[0].cpu(), tot[0].cpu(), want_P[0].cpu(),
                                want_tot[0].cpu())
    except AssertionError as e:
        fail(f"window posteriors vs the plain version on the card: {e}")
    keep = want_P > -50
    j3_err = float((P - want_P).abs()[keep].max())
    tot_err = float((tot - want_tot).abs().max())
    j3_ms = ev_ms(j3_call, 20)
    j3_prof = profiled_us(j3_call, "window_posteriors_kernel")
    j3_plain_ms = ev_ms(lambda: post.calc_log_sample_posteriors(
        *g3[:4], S_max, g3[5], read_mask=g3[4]), 20)
    window = posterior_window()
    em_cuda.reset_launches()
    single = post.batched_posteriors(window, dev)
    four = post.batched_posteriors(window, mesh=pm.Mesh([dev] * 4))
    step = -(-len(window) // 4)
    if em_cuda.launches["window_posteriors"] != \
            1 + len(range(0, len(window), step)):
        fail(f"batched_posteriors launches {em_cuda.launches}")
    if not all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(single, four)):
        fail("batched_posteriors: 4 shards differ from one device")
    say("mesh", f"window_posteriors at R=2000 A=12 S=3 (one locus a window)"
        f" on {smi}: two launches bit-identical; against the plain version "
        f"on the card log-posteriors within {j3_err:.4g} where it is above "
        f"-50, totals within {tot_err:.4g} (tolerances atol 5e-3, rtol 1e-5"
        f" / atol 1e-2, MAP equal); {j3_ms:.4f} ms a call (CUDA events), "
        f"device time {fmt_ms(ms_or_none(j3_prof[0]))} (torch.profiler), "
        f"plain version {j3_plain_ms:.4f} ms; bound {j3_bound * 1e3:.4f} us "
        f"({j3_by}; {j3_bytes} bytes), "
        f"{j3_bound / (ms_or_none(j3_prof[0]) or j3_ms):.4%} of its device "
        "time; a "
        f"window of {len(window)} unequal loci on 4 shards of the card == "
        f"one device (bit-identical), one launch a shard")
    sweep = j3_route_sweep(dev, smi)
    results = {
        "window_posteriors": {
            "ms": ms_or_none(j3_prof[0]) or j3_ms, "events_ms": j3_ms,
            "plain_ms": j3_plain_ms, "bound_ms": j3_bound, "bound_by": j3_by,
            "profiler_ms": ms_or_none(j3_prof[0]),
            "share": j3_bound / (ms_or_none(j3_prof[0]) or j3_ms),
            "max_abs_err": j3_err, "route_sweep": sweep,
            "shape": f"R={R} A={A} S={S}, one locus"},
        "em_train": {
            "ms": j4_ms, "plain_ms": j4_plain_ms, "bound_ms": j4_bound,
            "bound_by": j4_by, "profiler_ms": ms_or_none(j4_prof[0]),
            "max_abs_err": em_err, "branch": branch,
            "barriers_per_iteration": em_cuda.BARRIERS[branch],
            "shape": f"R={R} A={A} S={S}, {one[2]} iterations"}}
    return results


def j3_route_sweep(dev, smi, reps=5):
    """J3's two routes, each forced through em_cuda.WINDOW_SMALL_STEPS, on
    windows of one locus and of 256 equal loci of n reads (A = 4 and 12,
    S = 3) and on tests/_torch_cases.mixed_window (its 2000-read locus
    among 255 small ones): device ms a launch, `reps` launches a window
    and route, all in one torch.profiler trace (each (window, route) a
    record_function span of its own).  The routes must meet
    the posterior tolerances against each other.  Returns the rows and,
    for each (A, loci), the least n at which the large route is the
    faster: em_cuda.WINDOW_SMALL_STEPS lies between these crossings."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from longtr_tpu_torch.ops import em_cuda
    from longtr_tpu_torch.ops import posterior as post
    from _torch_cases import assert_posteriors_close, mixed_window, random_case
    windows = []
    for A, ns in ((4, (250, 500, 1000, 2000)), (12, (125, 250, 500, 1000))):
        for L in (1, 256):
            for n in ns:
                loci = [random_case(np.random.default_rng(n), R=n, A=A,
                                    S=3)] * L
                windows.append(((A, L, n), loci))
    windows.append((("mixed", 256, 2000), mixed_window()))
    steps_now = em_cuda.WINDOW_SMALL_STEPS
    calls = []

    def launch(steps, g, S, counts):
        em_cuda.WINDOW_SMALL_STEPS = steps
        try:
            return em_cuda.window_posteriors(*g, S, counts)
        finally:
            em_cuda.WINDOW_SMALL_STEPS = steps_now

    for key, loci in windows:
        arrays, S = post.pad_window(loci)
        g = [torch.from_numpy(x).to(dev) for x in arrays]
        counts = np.array([l["log_aln_probs"].shape[0] for l in loci],
                          np.int32)
        got = {}
        for route, steps in (("small", 10 ** 12), ("large", 0)):
            got[route] = launch(steps, g, S, counts)
            calls.append((key, route, steps, g, S, counts))
        i = int(np.argmax(counts))      # the largest locus
        A, S_i = loci[i]["log_aln_probs"].shape[1], loci[i]["num_samples"]
        (sP, st), (lP, lt) = got["small"], got["large"]
        try:
            assert_posteriors_close(
                sP[i, :S_i, :A, :A].cpu(), st[i, :S_i].cpu(),
                lP[i, :S_i, :A, :A].cpu(), lt[i, :S_i].cpu())
        except AssertionError as e:
            fail(f"window_posteriors routes differ at {key}: {e}")

    def launch_all():
        gc.disable()                # no collection pause within a span
        try:
            for i, (_key, _route, steps, g, S, counts) in enumerate(calls):
                with record_function(f"j3 route sweep {i}"):
                    for _ in range(reps):
                        launch(steps, g, S, counts)
                    torch.cuda.synchronize()
                time.sleep(0.02)    # 20 ms idle between the spans
        finally:
            gc.enable()

    # each kernel belongs to the span of the calls that launched it (the
    # spans lie 20 ms apart); the profiler may drop a kernel event now and
    # then, so a span's time is the mean of those it holds, and a trace
    # with a span that holds none is one it lost
    launch_all()
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            launch_all()
        evs = prof.events()
        spans = {e.name: e.time_range for e in evs
                 if e.name.startswith("j3 route sweep ")}
        kern = [e for e in evs
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "window_posteriors_kernel" in e.name]
        groups = []
        for i in range(len(calls)):
            tr = spans.get(f"j3 route sweep {i}")
            groups.append([] if tr is None else [
                e for e in kern if tr.start - 5000 <= e.time_range.start
                <= tr.end + 5000])
        if all(groups):
            break
        lost_trace(f"route sweep: {sum(not g for g in groups)} of "
                   f"{len(calls)} spans hold no kernel")
    if max(map(len, groups)) > reps:
        fail(f"window_posteriors route sweep: a span holds more than "
             f"{reps} kernels")
    ms = {}
    for grp, (key, route, *_rest) in zip(groups, calls):
        ms.setdefault(key, {})[route] = sum(
            e.time_range.elapsed_us() for e in grp) / len(grp) / 1e3
    crossings = {}
    for (A, L, n), t in ms.items():
        if A != "mixed" and t["large"] < t["small"]:
            crossings.setdefault(f"A={A} L={L}", n)
    rows = [{"A": A, "L": L, "n": n, "small_ms": t["small"],
             "large_ms": t["large"]} for (A, L, n), t in ms.items()]
    say("mesh", f"window_posteriors routes on {smi}, device ms a launch "
        f"(torch.profiler, {reps} a window; S=3), small / large: " + "; ".join(
            f"A={r['A']} L={r['L']} n={r['n']} {r['small_ms']:.5f} / "
            f"{r['large_ms']:.5f}" for r in rows)
        + f"; the large route the faster from n = {crossings} (none: "
        f"at no n swept); WINDOW_SMALL_STEPS = {steps_now}; kernel events "
        f"{sum(map(len, groups))} of {reps * len(calls)} launches")
    return {"rows": rows, "large_faster_from_n": crossings}


def j3_window_phase(smi, run, body, str_fx, str_single, tmp, dev):
    """The window posteriors (J3) on real windows: the 512-STR catalog once
    with LONGTR_DEVICE_POSTERIOR=1, its VCF body byte-identical to the run
    without it (phase 3's on the card, and a second one here that times
    the host float64 posteriors the kernel replaces: the first
    _calc_posteriors of each genotype_finalize that has no device
    posterior).  On each window's recorded inputs the kernel meets
    tests/test_posterior.py's tolerances against the plain version on the
    card, locus by locus, and two launches give the same bits.  Returns
    the loci a window, the launches, the first window's times (CUDA
    events, torch.profiler, the plain version), bound and error, every
    window's device time, the host time, and the Device posterior stage
    split into host packing (posterior_request and pad_window, timed in
    the run), copies, kernel and read-back (timed again on the run's
    windows), for the kernels line."""
    import numpy as np
    import torch
    from longtr_tpu_torch.ops import em_cuda
    from longtr_tpu_torch.ops import posterior as post
    from longtr_tpu_torch.pipeline.seq_genotyper import SeqStutterGenotyper
    from _torch_cases import assert_posteriors_close
    sg = SeqStutterGenotyper
    host = [0, 0.0]
    finalize, calc = sg.genotype_finalize, sg._calc_posteriors

    def timed_finalize(self, pool_scores=None, initial_posterior=None):
        self._smoke_host_first = initial_posterior is None
        return finalize(self, pool_scores, initial_posterior)

    def timed_calc(self):
        if not getattr(self, "_smoke_host_first", False):
            return calc(self)
        self._smoke_host_first = False
        t = time.perf_counter()
        calc(self)
        host[0] += 1
        host[1] += time.perf_counter() - t

    sg.genotype_finalize, sg._calc_posteriors = timed_finalize, timed_calc
    try:
        host_out, host_dt, _m = run("STR host posterior", str_fx, [], None,
                                    tmp)
    finally:
        sg.genotype_finalize, sg._calc_posteriors = finalize, calc
    windows, requests = [], []
    packing = {"posterior_request": 0.0, "pad_window": 0.0}
    real, pad, request = (em_cuda.window_posteriors, post.pad_window,
                          sg.posterior_request)

    def recording(*args, **kw):
        windows.append((args, kw))
        return real(*args, **kw)

    def timed_pad(loci):
        requests.append(loci)
        t = time.perf_counter()
        out = pad(loci)
        packing["pad_window"] += time.perf_counter() - t
        return out

    def timed_request(self, *args, **kw):
        t = time.perf_counter()
        out = request(self, *args, **kw)
        packing["posterior_request"] += time.perf_counter() - t
        return out

    em_cuda.window_posteriors, post.pad_window = recording, timed_pad
    sg.posterior_request = timed_request
    os.environ["LONGTR_DEVICE_POSTERIOR"] = "1"
    em_cuda.reset_launches()         # the counts to 0 just before the run
    try:
        dev_out, dev_dt, m = run("STR device posterior", str_fx, [], None,
                                 tmp)
    finally:
        em_cuda.window_posteriors, post.pad_window = real, pad
        sg.posterior_request = request
        del os.environ["LONGTR_DEVICE_POSTERIOR"]
    launches = em_cuda.launches["window_posteriors"]
    want = body(str_single)
    if body(host_out) != want or body(dev_out) != want:
        fail("STR device posterior: VCF body differs from the run without "
             "LONGTR_DEVICE_POSTERIOR")
    if launches != len(windows) or not launches \
            or len(requests) != len(windows):
        fail(f"STR device posterior: {launches} window_posteriors launches "
             f"for {len(windows)} windows")
    loci = [int(w[0][0].shape[0]) for w in windows]
    shapes = [tuple(int(x) for x in w[0][0].shape) + (int(w[0][6]),)
              for w in windows]
    # the kernel against the plain version on the card, locus by locus
    err = 0.0
    for (args, kw), reqs in zip(windows, requests):
        got = real(*args, **kw)
        again = real(*args, **kw)
        plain = post.calc_log_sample_posteriors(*args[:4], args[6], args[5],
                                                read_mask=args[4])
        torch.cuda.synchronize()
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            fail("STR device posterior: two launches on a window differ")
        for i, r in enumerate(reqs):
            A, S = r["log_aln_probs"].shape[1], r["num_samples"]
            try:
                assert_posteriors_close(
                    got[0][i, :S, :A, :A].cpu(), got[1][i, :S].cpu(),
                    plain[0][i, :S, :A, :A].cpu(), plain[1][i, :S].cpu())
            except AssertionError as e:
                fail(f"STR device posterior: locus {i} of a window against "
                     f"the plain version on the card: {e}")
        keep = plain[0] > -50
        err = max(err, float((got[0] - plain[0]).abs()[keep].max()))
    prof = [profiled_us(lambda w=w: real(*w[0], **w[1]),
                        "window_posteriors_kernel", reps=10)[0]
            for w in windows]
    args, kw = windows[0]
    j3_ms = ev_ms(lambda: real(*args, **kw), 20)
    plain_ms = ev_ms(lambda: post.calc_log_sample_posteriors(
        *args[:4], args[6], args[5], read_mask=args[4]), 20)
    L, R, A = args[0].shape
    S = int(args[6])
    j3_bound, j3_by, j3_bytes = window_bound(kw["counts"], A, S)
    padded_bytes = window_bound([R] * L, A, S)[2]
    # the Device posterior stage split: host packing in the run; copies,
    # kernel (the wrapper, its counts' copy, the launch) and read-back
    # timed again on the run's windows, the median of 5
    split = {"copies": 0.0, "kernel": 0.0, "read_back": 0.0}
    for reqs in requests:
        arrays, S_max = pad(reqs)
        counts = np.array([r["log_aln_probs"].shape[0] for r in reqs],
                          np.int32)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = [torch.from_numpy(x).to(dev) for x in arrays]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            P, tot = real(*g, S_max, counts)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            P.cpu().numpy(), tot.cpu().numpy()
            times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        for k, v in zip(split, np.median(times[1:], axis=0)):
            split[k] += float(v)
    dev_s = m["stage_seconds"].get("Device posterior", 0.0)
    split_ms = {k: v * 1e3 for k, v in {**packing, **split}.items()}
    say("e2e", f"STR device posterior on {smi}: {m['loci_processed']} loci, "
        f"{launches} window_posteriors launches, one a window of {loci} "
        f"loci ((L, R_max, A_max, S_max) {shapes}); against the plain "
        f"version on the card, locus by locus, log-posteriors within "
        f"{err:.4g} where it is above -50 (tolerances atol 5e-3, rtol 1e-5"
        f" / atol 1e-2, MAP equal), two launches bit-identical; device time "
        f"a window {[fmt_ms(ms_or_none(u)) for u in prof]} "
        f"(torch.profiler); the first window {j3_ms:.5f} ms a call (CUDA "
        f"events), the plain version {plain_ms:.4f} ms; bound "
        f"{j3_bound * 1e3:.4f} us ({j3_by}; {j3_bytes} bytes of the loci's "
        f"own reads, {padded_bytes} bytes padded to R_max), "
        f"{j3_bound / (ms_or_none(prof[0]) or j3_ms):.4%} of its device "
        f"time; the host float64 posteriors it "
        f"replaces {host[1] * 1e3:.3f} ms over {host[0]} loci "
        f"({host[1] * 1e3 / max(1, len(windows)):.3f} ms a window); VCF "
        f"body byte-identical to both runs without it ({dev_dt:.2f} s, "
        f"host {host_dt:.2f} s)")
    say("e2e", f"STR device posterior stage {dev_s * 1e3:.3f} ms over "
        f"{len(windows)} windows: host packing posterior_request "
        f"{split_ms['posterior_request']:.3f} ms and pad_window "
        f"{split_ms['pad_window']:.3f} ms (in the run); copies "
        f"{split_ms['copies']:.3f} ms, kernel (the wrapper, its counts' "
        f"copy, launch, sync) {split_ms['kernel']:.3f} ms, read-back "
        f"{split_ms['read_back']:.3f} ms (the run's windows again, median "
        "of 5)")
    # the kernel's time is the profiler's device time: at ~0.01 ms a
    # window the events of back-to-back calls time the wrapper's host work
    ms = ms_or_none(prof[0]) or j3_ms
    return {"ms": ms, "events_ms": j3_ms, "plain_ms": plain_ms,
            "bound_ms": j3_bound, "bound_by": j3_by,
            "profiler_ms": ms_or_none(prof[0]), "max_abs_err": err,
            "shape": f"real window {shapes[0]}", "share": j3_bound / ms,
            "launches": launches,
            "window_loci": loci,
            "window_profiler_ms": [ms_or_none(u) for u in prof],
            "host_posterior_ms": host[1] * 1e3,
            "host_posterior_loci": host[0],
            "device_posterior_stage_ms": dev_s * 1e3,
            "device_posterior_split_ms": split_ms}


def mesh_phase(tmp, dev, smi, cases, run, body, dr, str_fx, str_single):
    """Phase 4: the mesh (4 x the card), the EM train and window
    posteriors kernels, --workers, --distributed and --jax-profile.
    Returns the two kernels' numbers for the kernels line."""
    import glob
    import socket

    import numpy as np
    import torch
    from longtr_tpu_torch.ops import em_cuda
    from longtr_tpu_torch.ops import mode_b_cuda as mbc
    from longtr_tpu_torch.ops import mode_b_device as mbd
    from longtr_tpu_torch.ops import pairhmm as ph
    from longtr_tpu_torch.ops import pairhmm_cuda as pc
    from longtr_tpu_torch.parallel import mesh as pm
    from longtr_tpu_torch.pipeline.seq_genotyper import _gather
    mesh = pm.Mesh([dev] * 4)
    say("mesh", f"{mesh} on {smi}")

    # (a) the sharded pair-HMM through K1's variant for the width and K2's
    # two kernels (the router's thresholds lowered to send them the batch)
    tr = ph.AlignmentParams().as_array()
    for label, arrs, _params in cases[:2]:
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        want = pc.pairhmm_batch(*g).cpu().numpy().astype(np.float64)
        for k2 in (pc.pairhmm_streamed_cluster, pc.pairhmm_streamed):
            if not np.array_equal(want, k2(*g).cpu().numpy()):
                fail(f"{label}: {k2.__name__} disagrees with K1")
        k1 = ("pairhmm_resident_warp" if arrs[2].shape[1] <= pc.WARP_MAX_WIDTH
              else "pairhmm_resident_block")
        k2_route = {"BLOCK_MAX_WIDTH": 0}
        for kname, routing in ((k1, {}),
                               ("pairhmm_streamed_cluster", k2_route),
                               ("pairhmm_streamed",
                                {**k2_route, "CLUSTER_MAX_WIDTH": 0})):
            saved = {k: getattr(pc, k) for k in routing}
            for k, v in routing.items():
                setattr(pc, k, v)
            before = dict(pc.launches)
            try:
                shards = pm.pairhmm_batch_sharded(
                    *arrs, ph.AlignmentParams(), mesh=mesh)
            finally:
                for k, v in saved.items():
                    setattr(pc, k, v)
            moved = {k: pc.launches[k] - before[k] for k in pc.launches}
            got = _gather([shards])[0]
            if moved[kname] != mesh.size or sum(moved.values()) != mesh.size:
                fail(f"{label}: sharded {kname} launches {moved}, expected "
                     f"{mesh.size} of {kname}")
            if not np.array_equal(got, want):
                bad = np.flatnonzero(got != want)
                fail(f"{label}: sharded {kname} differs from the "
                     f"single-device kernels at {len(bad)} pairs")
            say("mesh", f"{label}: pairhmm_batch_sharded through {kname}, "
                f"{[len(s) for s in shards]} pairs a shard, one launch a "
                "shard == the single-device kernels (bit-identical)")

    # (b) the EM train (J4) and window posteriors (J3) kernels
    results = em_kernel_phase(dev, smi, mesh)

    # (c) the five mesh surfaces of the dryrun catalog
    dry = (dr["fasta"], dr["bed"], dr["bams"])
    surfaces = [("core", []), ("snp-vcf", ["--snp-vcf", dr["snp_vcf"]]),
                ("mode-b+haploid", ["--stutter-align-len", "25",
                                    "--haploid-chrs", "chrH"]),
                ("ref-vcf", ["--ref-vcf", dr["panel"]]),
                ("em-training", ["--no-def-stutter-model"])]
    plain_core = None
    for name, extra in surfaces:
        plain, dt_plain, _m = run(f"dryrun {name} plain", dry, extra, None,
                                  tmp)
        if name == "core":
            plain_core = plain
        # every count to 0 just before the mesh run, read just after
        pc.reset_launches()
        mbc.reset_launches()
        em_cuda.reset_launches()
        for c in (ph.pairs_scored, mbd.mode_b_elements_scored, pm.em_trains):
            for k in c:
                c[k] = 0
        meshed, dt_mesh, m = run(f"dryrun {name} mesh", dry, extra, None, tmp,
                                 mesh=mesh)
        launches = {**pc.launches, **mbc.launches, **em_cuda.launches}
        scored, trains = dict(ph.pairs_scored), dict(pm.em_trains)
        mode_b_scored = dict(mbd.mode_b_elements_scored)
        got, want = body(meshed), body(plain)
        n_rec = sum(1 for ln in want if not ln.startswith("#"))
        if got != want or n_rec == 0:
            fail(f"dryrun {name}: the mesh run's VCF body differs from the "
                 f"meshless run on the card ({n_rec} records)")
        if not launches["pairhmm_resident_warp"]:
            fail(f"dryrun {name} mesh: pairhmm_resident_warp was not "
                 "launched")
        if scored["cpu"] or scored["host_f64"] or not scored["cuda"]:
            fail(f"dryrun {name} mesh: pairs scored off the card: {scored}")
        if name == "mode-b+haploid" and (not launches["mode_b_cols"]
                                         or not launches["mode_b_artifacts"]
                                         or mode_b_scored["cpu"]):
            fail(f"dryrun {name} mesh: mode B off the card: {launches} "
                 f"{mode_b_scored}")
        if not launches["window_posteriors"]:
            fail(f"dryrun {name} mesh: window_posteriors was not launched")
        if name == "em-training":
            if (not trains["cuda"] or trains["cpu"]
                    or launches["em_train"] != trains["cuda"]):
                fail(f"dryrun {name} mesh: the device EM did not run on the "
                     f"card, one launch a train: {trains} {launches}")
            results["em_train"]["launches"] = launches["em_train"]
        say("mesh", f"dryrun {name}: {n_rec} records byte-identical to the "
            f"meshless run | mesh {dt_mesh:.2f} s, meshless {dt_plain:.2f} "
            f"s | launches {launches}; pair rows {scored}; device EM trains "
            f"{trains}; {m['num_em_converge']} EM converged")

    # (d) --workers 2 and a two-process --distributed run of the STR catalog
    base = ["--bams", ",".join(str_fx[2]), "--fasta", str_fx[0],
            "--regions", str_fx[1], "--use-unpaired", "--min-reads", "5",
            "--quiet"]
    single = body(str_single)
    out_w = os.path.join(tmp, "str_workers.vcf.gz")
    [(rc, err, dt)] = run_cli_processes(
        [base + ["--tr-vcf", out_w, "--workers", "2"]], timeout=300)
    if rc != 0:
        fail(f"--workers 2 exited {rc}: {err[-2000:]}")
    if err.count("Device: cuda:0") != 2:
        fail("--workers 2: the workers did not both run on cuda:0")
    if body(out_w) != single:
        fail("--workers 2: VCF body differs from the single run")
    say("mesh", f"--workers 2 on the 512-STR catalog: byte-identical to "
        f"phase 3's single run on the card ({dt:.2f} s wall, both workers "
        "on cuda:0)")
    out_d = os.path.join(tmp, "str_distributed.vcf.gz")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    res = run_cli_processes(
        [base + ["--tr-vcf", out_d, "--distributed", "--coordinator",
                 f"localhost:{port}", "--num-processes", "2",
                 "--process-id", str(i)] for i in range(2)], timeout=300)
    for i, (rc, err, dt) in enumerate(res):
        if rc != 0:
            fail(f"--distributed rank {i} exited {rc}: {err[-2000:]}")
        if "Device: cuda:0" not in err:
            fail(f"--distributed rank {i} did not run on cuda:0")
    if body(out_d) != single:
        fail("--distributed: VCF body differs from the single run")
    if glob.glob(os.path.join(tmp, "*.shard*")):
        fail("shard files left behind")
    say("mesh", f"--distributed, 2 processes (gloo, localhost) on the "
        f"512-STR catalog: byte-identical to the single run ({dt:.2f} s "
        "wall, both ranks on cuda:0)")

    # (e) --jax-profile: a torch.profiler trace of the core surface
    prof = os.path.join(tmp, "profile")
    out_p, dt_p, _m = run("dryrun core profile", dry, ["--jax-profile", prof],
                          None, tmp)
    if body(out_p) != body(plain_core):
        fail("--jax-profile: VCF body differs from the run without it")
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--jax-profile wrote {traces}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    resident = [e for e in kernels if "pairhmm_resident" in e.get("name", "")]
    if not resident:
        fail(f"--jax-profile: no pairhmm_resident kernel event among "
             f"{len(kernels)} kernel events")
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in timed)
            - min(e["ts"] for e in timed))
    busy = sum(e["dur"] for e in kernels)
    say("mesh", f"--jax-profile on the dryrun core surface ({dt_p:.2f} s "
        f"wall, profiled): {os.path.basename(traces[0])} holds "
        f"{len(events)} events, {len(kernels)} kernel events, "
        f"{len(resident)} of pairhmm_resident "
        f"({sum(e['dur'] for e in resident):.0f} us); kernel time "
        f"{busy:.0f} us of a {span:.0f} us trace on {smi}")
    return results


def main():
    if not os.path.isdir(os.path.join(ROOT, "longtr_tpu_torch")):
        fail("run from a checkout of the repository (longtr_tpu_torch/ "
             "is missing beside this script)")
    sys.modules["jax"] = None          # the port must not need it
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = card()
    with tempfile.TemporaryDirectory(prefix="longtr_smoke_") as tmp:
        return smoke(tmp, torch.device("cuda:0"), smi)


def smoke(tmp, dev, smi):
    import numpy as np
    import torch

    # ---- 1. device -------------------------------------------------------
    from longtr_tpu_torch import native
    from longtr_tpu_torch.ops import _build, pairhmm_cuda as pc
    from longtr_tpu_torch.ops import em_cuda
    from longtr_tpu_torch.ops import mode_b_cuda as mbc
    from longtr_tpu_torch.ops import mode_b_device as mbd
    from longtr_tpu_torch.ops import pairhmm as ph
    say("device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} card(s)")
    t0 = time.time()
    _build.load_library()
    say("device", f"kernels built in {time.time() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s) -> "
        f"{os.path.relpath(_build.build_info['path'], ROOT)}")
    for ln in _build.build_info["report"].splitlines():
        if "registers" in ln or "spill" in ln:
            say("device", "ptxas: " + ln.strip())
    if native.get_lib() is None:
        fail("the native host scorer (longtr_tpu_torch/native) did not "
             "build")
    say("device", f"opt-in shared memory a block "
        f"{pc.max_smem_optin(dev)} bytes")

    t_phase = time.perf_counter()
    # ---- 2. kernels ------------------------------------------------------
    bases = np.frombuffer(b"ACGT", np.uint8)

    def mutate(rng, codes, sub, ind):
        keep = rng.random(len(codes)) >= ind / 2
        out = codes[keep].copy()
        flip = rng.random(len(out)) < sub
        out[flip] = bases[rng.integers(0, 4, flip.sum())]
        ins = np.flatnonzero(rng.random(len(out)) < ind / 2)
        return np.insert(out, ins, bases[rng.integers(0, 4, len(ins))])

    def pack(haps, reads, fl=None):
        N = max(len(h) for h in haps)
        M = max(len(r) for r in reads)
        H = np.zeros((len(haps), N), np.uint8)
        R = np.zeros((len(reads), M), np.uint8)
        for i, (h, r) in enumerate(zip(haps, reads)):
            H[i, :len(h)] = h
            R[i, :len(r)] = r
        hl = np.array([len(h) for h in haps], np.int32)
        rl = np.array([len(r) for r in reads], np.int32)
        return [H, hl, R, rl, hl + 60 if fl is None else np.array(fl, np.int32)]

    def batch_192(rng, B):
        haps = [bases[rng.integers(0, 4, int(rng.integers(150, 192)))]
                for _ in range(B)]
        return pack(haps, [mutate(rng, h, 0.008, 0.004)[:192] for h in haps])

    def batch_long(rng, B, L):
        haps = [bases[rng.integers(0, 4, L)] for _ in range(B)]
        return pack(haps, [mutate(rng, h, 0.001, 0.0005)[:L] for h in haps])

    def batch_skew(rng):
        haps, reads = [], []
        for k in range(64):
            h = bases[rng.integers(0, 4, 1024 - int(rng.integers(0, 40)))]
            skew = int(rng.integers(250, 550)) * (1 if k % 2 else -1)
            cut = len(h) // 2
            r = (np.concatenate([h[:cut], h[cut + skew:]]) if skew > 0 else
                 np.concatenate([h[:cut], bases[rng.integers(0, 4, -skew)],
                                 h[cut:]]))
            haps.append(h)
            reads.append(mutate(rng, r, 0.01, 0.0))
        return pack(haps, reads)

    def batch_gates(rng):
        haps, reads, fl = [], [], []
        for k in range(64):
            h = bases[rng.integers(0, 4, int(rng.integers(1, 400)))]
            kind = k % 6
            if kind == 0:
                r = bases[rng.integers(0, 4, len(h))]           # band fail
            elif kind == 1:
                r = h[:1]                                        # m == 1
            elif kind == 2:
                h = h[:1]                                        # n == 1
                r = bases[rng.integers(0, 4, int(rng.integers(1, 50)))]
            elif kind == 3:
                r = bases[rng.integers(0, 4, len(h) + 601)]    # |n-m| > 600
            else:
                r = mutate(rng, h, 0.02, 0.01)
            haps.append(h)
            reads.append(r)
            fl.append(60 if kind == 5 else len(h) + 60)          # short hap
        return pack(haps, reads, fl)

    def batch_width(rng, B, W, full):
        """B pairs padded to read width W: `full` of them nearly W long,
        the rest about 200 bp."""
        haps = [bases[rng.integers(0, 4, int(rng.integers(W - 40, W + 1))
                                   if k < full else 200)] for k in range(B)]
        H, hl, R, rl, fl = pack(haps, [mutate(rng, h, 0.008, 0.004)[:W]
                                       for h in haps])
        Rw = np.zeros((B, W), np.uint8)
        Rw[:, :R.shape[1]] = R
        return [H, hl, Rw, rl, fl]

    custom = ph.AlignmentParams.from_list(
        [-2.0, -0.3, -1.5, -0.25, -0.0001, -8.0, -9.0])
    rng = np.random.default_rng(20261016)
    # The last two cases are wider than K1 takes: pairhmm_batch must route
    # them to K2's cluster kernel (the JAX package's envelope reaches 40960
    # columns; above it the JAX package sends a pair to the host).
    cases = [("B=2048 @192bp", batch_192(rng, 2048), ph.AlignmentParams()),
             ("B=128 @8kb", batch_long(rng, 128, 8192), ph.AlignmentParams()),
             ("length skew 250-550bp", batch_skew(rng), ph.AlignmentParams()),
             ("custom params @192bp", batch_192(rng, 256), custom),
             ("gates + band fails", batch_gates(rng), ph.AlignmentParams()),
             ("B=8 @24kb", batch_long(rng, 8, 24576), ph.AlignmentParams()),
             ("B=4 @40kb", batch_long(rng, 4, 40960), ph.AlignmentParams())]
    # K1's width edges: each register variant's K steps (32*K, 32*K+1),
    # warp -> block, the block variant's 8 -> 16 columns a thread, block ->
    # K2's cluster kernel
    edges = [(w, batch_width(rng, 16, w, 16))
             for w in (64, 65, 128, 129, 192, 193, 256, 257, 384, 385, 512,
                       513, 768, 769, 1024, 1025)]
    edges += [(w, batch_width(rng, 8, w, 2)) for w in (4096, 4097, 8192, 8193)]
    # the cluster kernel's C steps: C CTAs of 8192 columns hold C * 8192
    # (run there with C forced, 512 threads of 16 columns a CTA), one more
    # column needs another CTA, and 65537 goes to the workspace kernel
    edges += [(w, batch_width(rng, 4, w, 0)) for c in range(2, 9)
              for w in (c * pc.CTA_MAX_WIDTH, c * pc.CTA_MAX_WIDTH + 1)]
    cases += [(f"width edge {w}", arrs, ph.AlignmentParams())
              for w, arrs in edges]
    variants = {"pairhmm_resident_warp": pc.pairhmm_resident_warp,
                "pairhmm_resident_block": pc.pairhmm_resident_block,
                "pairhmm_streamed_cluster": pc.pairhmm_streamed_cluster,
                "pairhmm_streamed": pc.pairhmm_streamed}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def takes(kname, M):
        return {"pairhmm_resident_warp": M <= pc.WARP_MAX_WIDTH,
                "pairhmm_resident_block": M <= pc.BLOCK_MAX_WIDTH,
                "pairhmm_streamed_cluster": M <= pc.CLUSTER_MAX_WIDTH,
                "pairhmm_streamed": True}[kname]

    def routed(M):
        if M <= pc.BLOCK_MAX_WIDTH:
            return ("pairhmm_resident_warp" if M <= pc.WARP_MAX_WIDTH
                    else "pairhmm_resident_block")
        if M <= pc.CLUSTER_MAX_WIDTH:
            return "pairhmm_streamed_cluster"
        return "pairhmm_streamed"

    def cluster_dims(M, B):
        """(C, K, W) of cluster_shape's launch: C CTAs of W columns, K = 16
        columns a thread."""
        C, K = pc.cluster_shape(M, B, sms), 16
        threads = -(-(-(-M // C)) // K)
        return C, K, -(-threads // 32) * 32 * K

    def dev_ms(fn, reps, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    max_err = {k: 0.0 for k in variants}
    plain_out, plain_ms = {}, {}
    outcomes = set()
    pc.reset_launches()
    # the native scorer's host threads (ctypes releases the GIL) work
    # through the cases in order while the card checks them.  The three
    # largest (B=128 x 8 kb, B=8 x 24 kb, B=4 x 40 kb: ~2e10 cells, minutes
    # of the host) are held to the plain scan on the card alone, which the
    # native scorer holds on every other case.
    from concurrent.futures import ThreadPoolExecutor
    host = ThreadPoolExecutor(1)

    def native_cells(arrs):
        return float((arrs[1].astype(np.int64) * arrs[3]).sum())

    natives = [host.submit(native.pairhmm_batch_native, *arrs,
                           params.as_array())
               if native_cells(arrs) <= NATIVE_MAX_CELLS else None
               for _l, arrs, params in cases]
    try:
        for (label, arrs, params), fut in zip(cases, natives):
            tr = params.as_array()
            B, M = arrs[0].shape[0], arrs[2].shape[1]
            g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
            # the plain scan, timed once (one call a case)
            s_ev, e_ev = (torch.cuda.Event(enable_timing=True) for _ in "se")
            s_ev.record()
            plain_out[label] = ph.pairhmm_scan(*g)
            e_ev.record()
            plain = plain_out[label].cpu().numpy()
            plain_ms[label] = s_ev.elapsed_time(e_ev)
            # the workspace kernel above 20000 columns only in the timing
            # below (1.5 s a call at 24 kb)
            outs = {k: fn(*g).cpu().numpy() for k, fn in variants.items()
                    if takes(k, M)
                    and (k != "pairhmm_streamed" or M <= 20000)}
            if M % pc.CTA_MAX_WIDTH == 0 and M <= pc.CLUSTER_MAX_WIDTH:
                # C full CTAs of 512 threads
                C = M // pc.CTA_MAX_WIDTH
                full = pc.pairhmm_streamed_cluster(*g, cluster=C)
                outs[f"pairhmm_streamed_cluster C={C}"] = full.cpu().numpy()
            before = dict(pc.launches)
            outs["pairhmm_batch"] = pc.pairhmm_batch(*g).cpu().numpy()
            moved = [k for k in pc.launches if pc.launches[k] != before[k]]
            if moved != [routed(M)]:
                fail(f"pairhmm_batch sent {label} (width {M}) to {moved}, "
                     f"expected {routed(M)}")
            torch.cuda.synchronize()
            nat = plain if fut is None else fut.result()
            if nat is None:
                fail("native scorer unavailable")
            for kname, out in outs.items():
                base = kname.split()[0]
                if base in max_err:
                    err = float(np.max(np.abs(out.astype(np.float64)
                                              - plain.astype(np.float64))))
                    max_err[base] = max(max_err[base], err)
                if not (np.array_equal(out, plain)
                        and np.array_equal(out, nat)):
                    bad = np.flatnonzero((out != plain) | (out != nat))
                    fail(f"{kname} disagrees on {label}: {len(bad)} pairs, "
                         f"first {bad[:4]}: {out[bad[:4]]} vs plain "
                         f"{plain[bad[:4]]} vs native {nat[bad[:4]]}")
            if not np.array_equal(plain, nat):
                fail(f"plain scan on the card disagrees with native on "
                     f"{label}")
            outcomes |= {"gate" if v == ph.IMPOSSIBLE else
                         "band fail" if v == ph.BAND_FAIL_SCORE else "aligned"
                         for v in nat}
            ran = " == ".join(k.replace("pairhmm_", "") for k in outs
                              if k.split()[0] in variants) or \
                "streamed (through the router)"
            dims = (" (cluster C, K, W = %d, %d, %d)" % cluster_dims(M, B)
                    if takes("pairhmm_streamed_cluster", M) else "")
            held = "native" if fut is not None else "(not native: held " \
                "to the plain scan)"
            say("kernels", f"{label}: B={B} N={arrs[0].shape[1]} M={M} "
                f"{ran} == plain == {held} (bit-identical; pairhmm_batch took "
                f"{routed(M).replace('pairhmm_', '')}; "
                f"{int((nat == ph.BAND_FAIL_SCORE).sum())} band fails, "
                f"{int((nat == ph.IMPOSSIBLE).sum())} gated){dims}")
    finally:
        host.shutdown(cancel_futures=True)
    if outcomes != {"gate", "band fail", "aligned"}:
        fail(f"kernel cases reached only {sorted(outcomes)}")
    if not all(pc.launches.values()):
        fail(f"phase 2 left a variant unlaunched: {pc.launches}")
    say("kernels",
        f"phase 2 checks took {time.perf_counter() - t_phase:.1f} s")
    t_part = time.perf_counter()

    def host1_cells_per_s(arrs, tr):
        os.environ["LONGTR_NATIVE_THREADS"] = "1"
        try:
            native.pairhmm_batch_native(*arrs, tr)
            t = time.perf_counter()
            native.pairhmm_batch_native(*arrs, tr)
            dt = time.perf_counter() - t
        finally:
            del os.environ["LONGTR_NATIVE_THREADS"]
        return float((arrs[1].astype(np.int64) * arrs[3]).sum()) / dt

    # Times at the main path's shapes: short STRs, VNTR widths (K1), and
    # the long VNTRs of K2 (12, 24 and 40 kb); every kernel that takes the
    # width (the workspace kernel up to 24 kb), the cluster kernel also at
    # C = 1 beside the block variant (the cost of its barrier), the plain
    # scan (from the case above at 24 and 40 kb; not at 12 kb, where a call
    # takes ~10 s) and the bound.  At 12 kb the kernels are held to the
    # cluster kernel, elsewhere to the plain scan.  Last, a small batch at
    # the block variant's widest (B=8 x 8 kb: 8 SMs busy in the block
    # variant, 64 in the cluster kernel), held to the block variant.
    timing = {}
    tr = ph.AlignmentParams().as_array()
    case_arrs = {c[0]: c[1] for c in cases}
    shapes = [(cases[0][0], cases[0][1], 20, 3),
              ("B=128 @3kb", batch_long(rng, 128, 3072), 3, 1),
              (cases[1][0], cases[1][1], 3, None),
              ("B=128 @12kb", batch_long(rng, 128, 12288), 2, 0),
              ("B=8 @24kb", case_arrs["B=8 @24kb"], 2, None),
              ("B=4 @40kb", case_arrs["B=4 @40kb"], 2, None),
              ("B=8 @8kb", batch_long(rng, 8, 8192), 3, 0)]
    for label, arrs, reps, plain_reps in shapes:
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        B, M = arrs[0].shape[0], arrs[2].shape[1]
        rows = int(arrs[1].max())
        cells = float((arrs[1].astype(np.int64) * arrs[3]).sum())
        want = (plain_out[label] if label in plain_out else
                None if plain_reps == 0 else ph.pairhmm_scan(*g))
        runs = {k: fn for k, fn in variants.items() if takes(k, M)
                and (k != "pairhmm_streamed" or M <= 24576)}
        if M == 8192:
            runs["pairhmm_streamed_cluster C=1"] = \
                lambda *a: pc.pairhmm_streamed_cluster(*a, cluster=1)
        t = {}
        for k, fn in runs.items():
            got = fn(*g)
            if want is None:
                want = got
            elif not torch.equal(got, want):
                fail(f"{k} disagrees on {label}")
            slow = k == "pairhmm_streamed" and M > 8192
            t[k] = dev_ms(lambda: fn(*g), 1 if slow else reps, warm=not slow)
        t["plain"] = (plain_ms[label] if plain_reps is None else None
                      if plain_reps == 0 else
                      dev_ms(lambda: ph.pairhmm_scan(*g), plain_reps))
        t["bound"], t["bound_by"] = pairhmm_bound(arrs)
        t["rows"], t["cells"] = rows, cells
        t["cluster_dims"] = cluster_dims(M, B)
        timing[label] = t
        nat_s = ""
        if M <= 8192:
            sub = [a[:1] if M > 1024 else a[:256] for a in arrs]
            nat_s = (f" | native 1-thread host "
                     f"{host1_cells_per_s(sub, tr):.4g} cells/s")
        plain_s = ("not timed" if t["plain"] is None
                   else f"{t['plain']:.3f} ms")
        say("kernels", f"{label} ({cells:.4g} cells, {rows} rows) on {smi}: "
            + " | ".join(f"{k.replace('pairhmm_', '')} {t[k]:.4f} ms = "
                         f"{cells / t[k] * 1e3:.4g} cells/s, "
                         f"{t['bound'] / t[k]:.2%} of bound, "
                         f"{t[k] * 1e3 / rows:.4f} us/row" for k in runs)
            + f" | cluster C, K, W = {t['cluster_dims']} | plain {plain_s} "
            f"| bound {t['bound']:.5f} ms ({t['bound_by']}){nat_s}")

    say("kernels", f"timing took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # The guard of cluster_shape's choice of C (CTAs a pair): at each shape
    # its C beside the fastest other C of the full sweep over C = 2..8 and
    # 16 and K = 8 and 16 (PERF.md, K2's C and W), held to each other and
    # timed.
    for (B, L), other in (((8, 12288), 6), ((128, 12288), 8),
                          ((8, 24576), 7), ((128, 24576), 6),
                          ((8, 40960), 7), ((128, 40960), 8)):
        arrs = batch_long(rng, B, L)
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        rows = int(arrs[1].max())
        chosen = pc.cluster_shape(L, B, sms)
        res, ref = {}, None
        for C in (chosen, other):
            out = pc.pairhmm_streamed_cluster(*g, cluster=C)
            if ref is None:
                ref = out
            elif not torch.equal(out, ref):
                fail(f"cluster C={C} disagrees at B={B} L={L}")
            res[C] = dev_ms(lambda: pc.pairhmm_streamed_cluster(
                *g, cluster=C), 2, warm=False)
        best = min(res, key=res.get)
        say("kernels", f"cluster C B={B} @{L // 1024}kb ({rows} rows) on "
            f"{smi}: " + " | ".join(f"C={c} {ms:.3f} ms "
                                    f"{ms * 1e3 / rows:.4f} us/row"
                                    for c, ms in res.items())
            + f" | cluster_shape C={chosen}, "
            f"{res[chosen] / res[best]:.3f} of the faster's time")

    say("kernels", f"the C guard took {time.perf_counter() - t_part:.1f} s")
    mb = mode_b_kernel_phase(dev, smi, mbc, mbd, dev_ms)
    say("kernels", f"phase 2 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 3. e2e ----------------------------------------------------------
    from longtr_tpu_torch import cli
    from longtr_tpu_torch.haplotype import poa
    from longtr_tpu_torch.testing.catalogs import build_catalog, dryrun_catalog

    def native_scorer(hap, hl, read, rl, fl, params):
        out = native.pairhmm_batch_native(hap, hl, read, rl, fl,
                                          params.as_array())
        if out is None:
            fail("native scorer unavailable")
        return out

    @contextlib.contextmanager
    def plain_mode_b():
        """Mode B on the plain versions for the duration: the artifact
        tables built on CPU copies of their inputs and handed back on the
        card, the rows by the plain torch version on the card.  The names
        patched are the ones the pipeline calls."""
        from longtr_tpu_torch.ops.mode_b_artifacts import \
            mode_b_artifacts_plain
        from longtr_tpu_torch.pipeline import mode_b as pmb

        def artifacts(*args, n_d, dtype=torch.float32):
            return mode_b_artifacts_plain(*[a.cpu() for a in args], n_d=n_d,
                                          dtype=dtype).to(args[0].device)

        def cols(*args, n_d, **_kw):
            return mbd.mode_b_cols_plain(*args, n_d=n_d)

        saved = pmb.mode_b_artifacts, mbc.mode_b_cols
        pmb.mode_b_artifacts, mbc.mode_b_cols = artifacts, cols
        try:
            yield
        finally:
            pmb.mode_b_artifacts, mbc.mode_b_cols = saved

    def body(path):
        with gzip.open(path, "rt") as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.startswith("##command")]

    def run(tag, fx, extra, scorer, out_dir, mesh=None):
        name = tag.replace(" ", "_").replace("+", "_")
        out = os.path.join(out_dir, f"{name}.vcf.gz")
        metrics = os.path.join(out_dir, f"{name}.json")
        argv = ["--bams", ",".join(fx[2]), "--fasta", fx[0], "--regions",
                fx[1], "--tr-vcf", out, "--use-unpaired", "--min-reads", "5",
                "--quiet", "--metrics-out", metrics, *extra]
        poa._memo.clear()        # no assembly reuse across runs
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv, device=dev, pair_scorer=scorer, mesh=mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if rc != 0:
            fail(f"{tag}: longtr exited {rc}")
        with open(metrics) as fh:
            m = json.load(fh)
        return out, dt, m

    def catalog(sub, n, **kw):
        d = os.path.join(tmp, sub)
        os.makedirs(d)
        return build_catalog(d, n, seed=1, **kw)

    t = time.perf_counter()
    d = os.path.join(tmp, "dryrun_in")
    os.makedirs(d)
    dr = dryrun_catalog(d)
    dry = (dr["fasta"], dr["bed"], dr["bams"])
    str_fx = catalog("str_in", 512)
    vntr_fx = catalog("vntr_in", 24, vntr=True)
    # (tag, catalog, options, environment, routing): the card's runs of
    # each are compared with a reference run of the same options, its pairs
    # scored by the native host scorer and its mode B on the plain versions
    # (plain_mode_b).  The device-posterior run's reference is the default
    # host-f64 posterior.  The VNTR catalog's batches are 1-2 kb and 2-4 kb
    # wide, both K1's block variant; its second run lowers the thresholds
    # (`routing`: (module, attribute, value)) so that the 1-2 kb batch takes
    # K2's cluster kernel and the 2-4 kb batch the workspace kernel, its third
    # so that both take the cluster kernel.  The second mode-B dryrun sends its
    # rows to the block kernel.
    catalogs = [("STR", str_fx, [], {}, []),
                ("VNTR", vntr_fx, ["--max-tr-len", "10000"], {}, []),
                ("VNTR streamed", vntr_fx, ["--max-tr-len", "10000"], {},
                 [(pc, "BLOCK_MAX_WIDTH", 1024),
                  (pc, "CLUSTER_MAX_WIDTH", 2048)]),
                ("VNTR cluster", vntr_fx, ["--max-tr-len", "10000"], {},
                 [(pc, "BLOCK_MAX_WIDTH", 1024)]),
                ("STR mode B", str_fx, ["--stutter-align-len", "25"], {}, []),
                ("dryrun snp-vcf", dry, ["--snp-vcf", dr["snp_vcf"]], {}, []),
                ("dryrun ref-vcf", dry, ["--ref-vcf", dr["panel"]], {}, []),
                ("dryrun mode-b+haploid", dry, ["--stutter-align-len", "25",
                                                "--haploid-chrs", "chrH"], {},
                 []),
                ("dryrun mode-b+haploid block", dry,
                 ["--stutter-align-len", "25", "--haploid-chrs", "chrH"], {},
                 [(mbc, "WARP_MAX_WIDTH", 0)]),
                ("dryrun core device-posterior", dry, [],
                 {"LONGTR_DEVICE_POSTERIOR": "1"}, [])]
    say("e2e", f"catalogs built in {time.perf_counter() - t:.1f} s "
        "(512 short-STR loci, one in six an A homopolymer of 10-25 copies; "
        "24 VNTR loci, 500-3000 bp repeats; 3 samples at 20x; the "
        f"{dr['n_loci']}-locus dryrun catalog at 18x)")
    refs = {}
    for tag, fx, extra, _env, routing in catalogs:
        if routing:     # the same run as the one before it, rerouted
            refs[tag] = refs[prev]
            continue
        with plain_mode_b():
            refs[tag] = run(tag + " reference", fx, extra, native_scorer,
                            tmp)
        prev = tag
    shapes = []
    real_mode_b = mbc.mode_b_cols

    def recording(*args, n_d, **kw):
        shapes.append((args[0].shape[0], args[6].shape[1], args[0].shape[1],
                       args[10].shape[1], n_d))
        return real_mode_b(*args, n_d=n_d, **kw)

    mbc.mode_b_cols = recording      # records shapes; counts stay the wrapper's
    results, counts = {}, {}
    for tag, fx, extra, env, routing in catalogs:
        saved = [(mod, k, getattr(mod, k)) for mod, k, _v in routing]
        for mod, k, v in routing:
            setattr(mod, k, v)
        os.environ.update(env)
        # every count to 0 just before the path, read just after
        pc.reset_launches()
        mbc.reset_launches()
        em_cuda.reset_launches()
        for c in (ph.pairs_scored, mbd.mode_b_elements_scored):
            for k in c:
                c[k] = 0
        try:
            results[tag] = run(tag + " cuda", fx, extra, None, tmp)
        finally:
            for mod, k, v in saved:
                setattr(mod, k, v)
            for k in env:
                del os.environ[k]
        counts[tag] = ({**pc.launches, **mbc.launches, **em_cuda.launches},
                       dict(ph.pairs_scored),
                       dict(mbd.mode_b_elements_scored))
    mbc.mode_b_cols = real_mode_b
    for tag, fx, extra, env, routing in catalogs:
        out, dt, m = results[tag]
        ref_out, ref_dt, _ = refs[tag]
        got, want = body(out), body(ref_out)
        n_rec = sum(1 for ln in want if not ln.startswith("#"))
        if got != want:
            diff = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
                if len(got) == len(want) else "length"
            fail(f"{tag}: VCF body differs from the reference run "
                 f"(first difference at line {diff})")
        if n_rec == 0:
            fail(f"{tag}: no VCF records")
        loci = m["loci_processed"]
        stages = sorted(m["stage_seconds"].items(), key=lambda kv: -kv[1])
        launches, scored, mode_b_scored = counts[tag]
        say("e2e", f"{tag}: {n_rec} records byte-identical to the "
            f"reference run | card {loci / dt:.4g} loci/s ({dt:.2f} s), "
            f"reference {loci / ref_dt:.4g} loci/s ({ref_dt:.2f} s) "
            f"on {smi} | {m['num_dispatches']} batches, {m['num_syncs']} syncs")
        say("e2e", f"{tag} stage seconds: "
            + "  ".join(f"{k}={v:.3f}" for k, v in stages))
        say("e2e", f"{tag}: kernel launches {launches}; pair rows scored "
            f"{scored}; mode-B elements scored {mode_b_scored} (host_f64 = "
            "configs outside the row tables' envelope)")
        need = {"VNTR": ["pairhmm_resident_block"],
                "VNTR streamed": ["pairhmm_streamed_cluster",
                                  "pairhmm_streamed"],
                "VNTR cluster": ["pairhmm_streamed_cluster"],
                "STR mode B": ["pairhmm_resident_warp", "mode_b_artifacts",
                               "mode_b_cols"],
                "dryrun mode-b+haploid": ["pairhmm_resident_warp",
                                          "mode_b_artifacts", "mode_b_cols"],
                "dryrun mode-b+haploid block": ["mode_b_artifacts",
                                                "mode_b_cols_block"],
                "dryrun core device-posterior": ["pairhmm_resident_warp",
                                                 "window_posteriors"]
                }.get(tag, ["pairhmm_resident_warp"])
        for k in need:
            if launches[k] == 0:
                fail(f"{tag}: {k} was not launched")
        if scored["cpu"] or scored["host_f64"] or not scored["cuda"]:
            fail(f"{tag}: pairs scored off the card: {scored}")
        if mode_b_scored["cpu"] or (tag in MODE_B_RUNS
                                    and not mode_b_scored["cuda"]):
            fail(f"{tag}: mode-B elements scored off the card: "
                 f"{mode_b_scored}")
    widest = max(shapes, key=lambda x: x[0] * x[1] * x[2] * x[3] * x[4])
    say("e2e", f"mode_b_cols: {len(shapes)} e2e launches; widest (B, R_max, "
        f"L_max, S_max, n_d) = {widest}; the widest rows of phase 2: "
        f"{mb['wide_shape']}")
    for tag in ("STR mode B", "dryrun mode-b+haploid"):
        st = results[tag][2]["stage_seconds"]
        rst = refs[tag][2]["stage_seconds"]
        say("e2e", f"{tag}, mode-B stage seconds (wall, Haplotype build "
            "summed over the build threads): card (tables and rows on the "
            f"card) Haplotype build {st.get('Haplotype build', 0.0):.3f}, "
            f"Mode B dispatch {st.get('Mode B dispatch', 0.0):.3f}; reference "
            "(plain tables on the CPU, plain rows on the card) Haplotype "
            f"build {rst.get('Haplotype build', 0.0):.3f}, Mode B dispatch "
            f"{rst.get('Mode B dispatch', 0.0):.3f}")

    j3_window = j3_window_phase(smi, run, body, str_fx, results["STR"][0],
                                tmp, dev)
    say("e2e", f"phase 3 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # ---- 4. mesh ---------------------------------------------------------
    em = mesh_phase(tmp, dev, smi, cases, run, body, dr, str_fx,
                    results["STR"][0])
    say("mesh", f"phase 4 took {time.perf_counter() - t_phase:.1f} s")
    if "jax" in {k.split(".")[0] for k, v in sys.modules.items() if v}:
        fail("JAX was imported")

    src = "longtr_tpu_torch/csrc/pairhmm.cu"
    lines = kernel_lines()
    # each kernel's time at its main-path shape, and its launches in the
    # main path's run that takes it: the STR run for the warp variant, the
    # VNTR runs for the block variant and K2's two kernels, the mode-B STR
    # run for mode_b_cols
    main = {"pairhmm_resident_warp": (cases[0][0], "STR", "_kernel"),
            "pairhmm_resident_block": (cases[1][0], "VNTR", "_kernel"),
            "pairhmm_streamed_cluster": ("B=8 @24kb", "VNTR cluster",
                                         "_kernel_chunked"),
            "pairhmm_streamed": (cases[1][0], "VNTR streamed",
                                 "_kernel_chunked")}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": lines[pallas],
                "launches": counts[run_tag][0][k],
                "max_abs_err": max_err[k],
                "ms": timing[shape][k],
                "plain_ms": timing[shape]["plain"],
                "bound_ms": timing[shape]["bound"],
                "bound_by": timing[shape]["bound_by"],
                "library_ms": None,
                "shape": shape}
               for k, (shape, run_tag, pallas) in main.items()]
    # mode B's kernels: the warp row kernel and the artifact warp kernel in
    # the mode-B STR run, the block row kernel in the rerouted mode-B
    # dryrun; the window posteriors in the device-posterior run; the EM
    # train in phase 4's em-training mesh surface
    h1 = def_line("longtr_tpu/pipeline/mode_b.py", "_artifact_table_batch")
    j2 = def_line("longtr_tpu/ops/mode_b_device.py", "mode_b_cols")
    j3 = def_line("longtr_tpu/ops/posterior.py", "batched_posteriors")
    j4 = def_line("longtr_tpu/parallel/mesh.py", "_em_train_local")
    h1_src = "longtr_tpu_torch/csrc/mode_b_artifacts.cu"
    j2_src = "longtr_tpu_torch/csrc/mode_b.cu"
    em_src = "longtr_tpu_torch/csrc/em.cu"
    # J3's numbers at the main path's real window; the one locus beside
    j3_window["one_locus"] = em["window_posteriors"]
    em["window_posteriors"] = j3_window
    mb.update(em)
    for name, run_tag, replaces, source in (
            ("mode_b_artifacts", "STR mode B", h1, h1_src),
            ("mode_b_cols", "STR mode B", j2, j2_src),
            ("mode_b_cols_block", "dryrun mode-b+haploid block", j2, j2_src),
            ("window_posteriors", None, j3, em_src),
            ("em_train", None, j4, em_src)):
        k = mb[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": counts[run_tag][0][name] if run_tag
                        else k["launches"],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None,
                        "shape": k["shape"],
                        **{x: k[x] for x in (
                            "profiler_ms", "branch", "barriers_per_iteration",
                            "events_ms", "share", "one_locus", "window_loci",
                            "window_profiler_ms", "host_posterior_ms",
                            "host_posterior_loci",
                            "device_posterior_stage_ms",
                            "device_posterior_split_ms") if x in k}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
