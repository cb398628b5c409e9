#!/usr/bin/env python3
"""Smoke test of the PyTorch port (longtr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each:

1. device  — the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from longtr_tpu_torch/csrc (into
   longtr_tpu_torch/_build/, at first use).
2. kernels — seeded batches through every variant of the resident kernel
   K1 that takes their width (warp: one warp a pair; block: one block of
   warps a pair; smem: the rows in shared memory), the streamed kernel
   K2, the plain torch scan on the card and the native host scorer; every
   pair of them must agree bit for bit (tolerance 0), at 192 bp, 8 kb,
   length skew, custom parameters, gates and band fails, and at each
   variant's width edges.  One batch is too wide for K1 and must be routed
   to K2.  Every K1 variant and K2 is timed at 192 bp, ~3 kb and 8 kb
   beside the plain scan and its bound.  The mode-B kernel at bench.py's shape (512 pooled reads
   of a 35 bp | A x 18 | 35 bp locus with -2/-1/+1 alternates) and on rows
   too wide for its shared memory must equal the plain torch rows on the
   card (tolerance 0), and its marginalized LLs the host f64 path within
   1e-4.  Times each kernel and its plain version at the main path's
   shapes.
3. e2e     — the `longtr` CLI of the port, each run twice: on the card, and
   with pair scoring given to the native host scorer and mode B to the
   plain rows on the card.  Catalogs: 512 short STRs, with and without
   --stutter-align-len 25 (one locus in six is an A homopolymer, so mode B
   and the pair-HMM both run); 24 VNTRs of 500-3000 bp; and the dryrun
   catalog's --snp-vcf, --ref-vcf and mode-B + --haploid-chrs surfaces and
   its core surface with LONGTR_DEVICE_POSTERIOR=1.  The VCF bodies must
   be byte-identical, each run's kernels must have launched (counts reset
   just before it and read just after), and no pair and no mode-B element
   may have been scored off the card, but for mode-B elements outside the
   row tables' envelope, which the host scores by design.  The STR runs
   take K1's warp variant and the VNTR run its block variant; a second
   VNTR run lowers the width thresholds so that the smem variant and K2
   take its batches.
4. mesh    — a mesh of four shards on the one card (4 x cuda:0): the
   sharded pair-HMM at phase 2's 192 bp and 8 kb batches, through K1's
   variant for the width and through K2, equals the single-device kernels (tolerance 0) and launched
   once a shard; the device EM train loop at a realistic locus (R = 2000
   reads, A = 12 alleles, S = 3) equals the same call on CPU shards
   (iterations, convergence, parameters within 1e-5) and is timed against
   the host EM; the five mesh surfaces of the dryrun catalog
   (core, snp-vcf, mode-b+haploid, ref-vcf, em-training) through the CLI
   with the mesh are byte-identical to the meshless runs on the card, with
   the kernels (and, for em-training, the device EM) counted on the card
   and no pair off it; `--workers 2` and a two-process `--distributed` run
   of the 512-STR catalog are byte-identical to phase 3's single run; and
   a `--jax-profile` run of the core surface writes a torch.profiler trace
   that holds pairhmm_resident kernel events.

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
of a row by its kind (expf and logf one operation each).
"""

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_OPS = 67e12     # float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12     # HBM3 bytes/s


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


def mode_b_line():
    """`file:line` of the jnp mode-B row scan the CUDA kernel replaces."""
    rel = "longtr_tpu/ops/mode_b_device.py"
    with open(os.path.join(ROOT, rel)) as fh:
        for i, ln in enumerate(fh, 1):
            if ln.startswith("def mode_b_cols("):
                return f"{rel}:{i}"
    fail(f"mode_b_cols not found in {rel}")


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


def mode_b_kernel_phase(dev, smi, mbc, mbd, dev_ms):
    """Phase 2 for mode B: the kernel against the plain rows on the card at
    bench.py's shape and above the shared-memory width; the LLs against
    the host f64 path; times and pairs/s."""
    import numpy as np
    import torch
    from test_torch_cuda import TABLE_KEYS, synthetic_tables

    aligner, alns, seeds = bench_mode_b_locus(dev)
    t = time.perf_counter()
    prep = aligner.score_reads_batch_prepare(alns, seeds)
    prep_s = time.perf_counter() - t
    g = [torch.from_numpy(prep[k]).to(dev) for k in TABLE_KEYS]
    n_d = prep["n_d"]
    shape = (f"B={g[0].shape[0]} R={g[6].shape[1]} L={g[0].shape[1]} "
             f"S={g[9].shape[1]} n_d={n_d}")
    if not mbc.fits_on_chip(g[0].shape[1], dev):
        fail(f"mode_b_cols: bench.py's shape {shape} does not fit on chip")
    got = mbc.mode_b_cols(*g, n_d=n_d)
    plain = mbd.mode_b_cols_plain(*g, n_d=n_d)
    torch.cuda.synchronize()
    max_err = float((got.double() - plain.double()).abs().nan_to_num().max())
    if not torch.equal(got, plain):
        bad = torch.nonzero(got != plain)[:4].tolist()
        fail(f"mode_b_cols disagrees with the plain rows at {shape}: "
             f"first {bad}")
    # rows too wide for the block's shared memory: the workspace
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
    # marginalized LLs: the card's f32 rows against the host f64 path on
    # the first 64 reads (the host path takes ~100 ms a read)
    timings = {}
    lls = aligner.score_reads_batch_finish(prep, timings)
    t = time.perf_counter()
    host = np.stack([aligner.score_read(a, s)
                     for a, s in zip(alns[:64], seeds[:64])])
    host_s = (time.perf_counter() - t) / 64 * len(alns)
    ll_err = float(np.abs(lls[:64] - host).max())
    if not np.allclose(lls[:64], host, rtol=1e-4, atol=1e-4):
        fail(f"mode-B LLs on the card differ from the host f64 path by "
             f"{ll_err}")
    ms = dev_ms(lambda: mbc.mode_b_cols(*g, n_d=n_d), 20)
    plain_ms = dev_ms(lambda: mbd.mode_b_cols_plain(*g, n_d=n_d), 3)
    bound_ms, bound_by = mode_b_bound(g, n_d)
    # pairs/s as bench.py:234 defines it: (prepare + finish) per rep
    reps, phase = 3, {"prepare_s": 0.0}
    t = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        p = aligner.score_reads_batch_prepare(alns, seeds)
        phase["prepare_s"] += time.perf_counter() - t0
        aligner.score_reads_batch_finish(p, phase)
    rep_s = (time.perf_counter() - t) / reps
    pairs = len(alns) * aligner.hap.num_combs()
    say("kernels", f"mode_b_cols at bench.py's shape ({shape}): == plain "
        f"rows on the card (bit-identical); LLs within {ll_err:.3g} of the "
        "host f64 path on 64 reads; rows of width 20000 (workspace) == "
        "plain")
    say("kernels", f"mode_b_cols on {smi}: kernel {ms:.4f} ms, plain rows "
        f"{plain_ms:.3f} ms (CUDA events), bound {bound_ms:.5f} ms "
        f"({bound_by}; {bound_ms / ms:.3%} of it); host f64 score_read "
        f"{host_s:.3f} s for all {len(alns)} reads (wall, timed on 64); "
        f"first prepare {prep_s:.3f} s")
    say("kernels", f"mode-B pairs/s (bench.py's definition): "
        f"{pairs / rep_s:.5g} ({rep_s:.4f} s a rep: prepare "
        f"{phase['prepare_s'] / reps:.4f}, dispatch "
        f"{phase['dispatch_s'] / reps:.4f}, marginalize "
        f"{phase['marginalize_s'] / reps:.4f})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape,
            "wide_shape": wide_shape}


def realistic_em_locus():
    """A factory of the EM trainer of one locus at a realistic size: 2000
    reads of 3 diploid samples over 12 distinct length differences of a
    dinucleotide repeat (in-frame and out-of-frame), drawn from a seed."""
    import numpy as np
    from longtr_tpu_torch.models.em import EMStutterGenotyper
    rng = np.random.default_rng(7)
    lengths = np.array([-8, -6, -4, -3, -2, -1, 0, 1, 2, 4, 6, 8])
    num_bps = []
    for (a, b), n in zip(((-4, 0), (0, 4), (2, 6)), (667, 667, 666)):
        w = np.exp(-np.abs(lengths - a)) + np.exp(-np.abs(lengths - b))
        num_bps.append(rng.choice(lengths, n, p=w / w.sum()).tolist())
    zeros = [[0.0] * len(x) for x in num_bps]
    names = ["S1", "S2", "S3"]
    return lambda: EMStutterGenotyper(False, "NN", num_bps, zeros, zeros,
                                      names)


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


def mesh_phase(tmp, dev, smi, cases, run, body, dr, str_fx, str_single):
    """Phase 4: the mesh (4 x the card), --workers, --distributed and
    --jax-profile."""
    import glob
    import socket

    import numpy as np
    import torch
    from longtr_tpu_torch.config import Config
    from longtr_tpu_torch.ops import mode_b_cuda as mbc
    from longtr_tpu_torch.ops import mode_b_device as mbd
    from longtr_tpu_torch.ops import pairhmm as ph
    from longtr_tpu_torch.ops import pairhmm_cuda as pc
    from longtr_tpu_torch.parallel import mesh as pm
    from longtr_tpu_torch.pipeline.seq_genotyper import _gather
    mesh = pm.Mesh([dev] * 4)
    say("mesh", f"{mesh} on {smi}")

    # (a) the sharded pair-HMM through K1's variant for the width and K2
    tr = ph.AlignmentParams().as_array()
    for label, arrs, _params in cases[:2]:
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        want = pc.pairhmm_resident(*g).cpu().numpy().astype(np.float64)
        if not np.array_equal(want, pc.pairhmm_streamed(*g).cpu().numpy()):
            fail(f"{label}: the two kernels disagree")
        k1 = ("pairhmm_resident_warp" if arrs[2].shape[1] <= pc.WARP_MAX_WIDTH
              else "pairhmm_resident_block")
        for kname, limit in ((k1, None), ("pairhmm_streamed", 0)):
            pc.resident_limit_bytes = limit
            before = dict(pc.launches)
            try:
                shards = pm.pairhmm_batch_sharded(
                    *arrs, ph.AlignmentParams(), mesh=mesh)
            finally:
                pc.resident_limit_bytes = None
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

    # (b) the device EM train loop against CPU shards and the host EM
    cfg = Config()
    conv = (cfg.max_em_iter, cfg.abs_ll_converge, cfg.frac_ll_converge)
    locus = realistic_em_locus()
    em = locus()
    if (em.num_alleles, len(em.sample_label), em.num_samples) != (12, 2000, 3):
        fail(f"EM locus has A={em.num_alleles}, R={len(em.sample_label)}, "
             f"S={em.num_samples}")
    args = (*em.mesh_inputs(), *conv)
    on_card = pm.em_train_sharded(mesh, *args)
    on_cpu = pm.em_train_sharded(pm.Mesh(["cpu"] * mesh.size), *args)
    param_err = float(np.abs(on_card[1] - on_cpu[1]).max())
    prob_err = float(np.abs(np.exp(on_card[3]) - np.exp(on_cpu[3])).max())
    log_err = np.abs(on_card[3] - on_cpu[3])
    rel_err = float((log_err / np.maximum(np.abs(on_cpu[3]), 1.0)).max())
    if (on_card[0], on_card[2]) != (on_cpu[0], on_cpu[2]):
        fail(f"device EM: card (converged, n_iter) {on_card[0], on_card[2]} "
             f"vs CPU shards {on_cpu[0], on_cpu[2]}")
    if param_err > 1e-5 or prob_err > 1e-5:
        fail(f"device EM: card vs CPU shards params {param_err}, "
             f"posterior probabilities {prob_err}")
    say("mesh", f"em_train_sharded at R=2000 A=12 S=3: card == CPU shards "
        f"(converged={on_card[0]}, {on_card[2]} iterations); params within "
        f"{param_err:.3g}, posterior probabilities within {prob_err:.3g}, "
        f"log-posteriors within {float(log_err.max()):.3g} "
        f"(relative {rel_err:.3g})")

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
    say("mesh", f"EM train at R=2000 A=12 S=3 on {smi} (wall, median of 3, "
        f"{on_card[2]} iterations on the mesh): host EMStutterGenotyper."
        f"train() {t_host * 1e3:.2f} ms and {t_host2 * 1e3:.2f} ms (before "
        f"and after); device loop, 4 shards on the card {t_card4 * 1e3:.2f} "
        f"ms, 1 shard {t_card1 * 1e3:.2f} ms")

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
        for c in (ph.pairs_scored, mbd.mode_b_elements_scored, pm.em_trains):
            for k in c:
                c[k] = 0
        meshed, dt_mesh, m = run(f"dryrun {name} mesh", dry, extra, None, tmp,
                                 mesh=mesh)
        launches = {**pc.launches, **mbc.launches}
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
                                         or mode_b_scored["cpu"]):
            fail(f"dryrun {name} mesh: mode B off the card: {launches} "
                 f"{mode_b_scored}")
        if name == "em-training" and (not trains["cuda"] or trains["cpu"]):
            fail(f"dryrun {name} mesh: the device EM did not run on the "
                 f"card: {trains}")
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
    say("device", f"resident kernel opt-in shared memory "
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
    # The last case is wider than K1's shared memory takes (about 17.8k
    # columns): pairhmm_batch must route it to the streamed kernel, where
    # the JAX package would have sent it to the host.
    cases = [("B=2048 @192bp", batch_192(rng, 2048), ph.AlignmentParams()),
             ("B=128 @8kb", batch_long(rng, 128, 8192), ph.AlignmentParams()),
             ("length skew 250-550bp", batch_skew(rng), ph.AlignmentParams()),
             ("custom params @192bp", batch_192(rng, 256), custom),
             ("gates + band fails", batch_gates(rng), ph.AlignmentParams()),
             ("B=8 @24kb", batch_long(rng, 8, 24576), ph.AlignmentParams())]
    # K1's width edges: each register variant's K steps (32*K, 32*K+1),
    # warp -> block, the block variant's 8 -> 16 columns a thread, block ->
    # smem, and the widest batch the smem variant takes and one more (short
    # pairs there: the edge is the batch's width)
    smem_max = max(w for w in range(16384, 24577, 64)
                   if pc.resident_smem_bytes(w) <= pc.max_smem_optin(dev))
    while pc.resident_smem_bytes(smem_max + 1) <= pc.max_smem_optin(dev):
        smem_max += 1
    edges = [(w, batch_width(rng, 16, w, 16))
             for w in (64, 65, 128, 129, 192, 193, 256, 257, 384, 385, 512,
                       513, 768, 769, 1024, 1025)]
    edges += [(w, batch_width(rng, 8, w, 2)) for w in (4096, 4097, 8192, 8193)]
    edges += [(w, batch_width(rng, 4, w, 0)) for w in (smem_max, smem_max + 1)]
    cases += [(f"width edge {w}", arrs, ph.AlignmentParams())
              for w, arrs in edges]
    variants = {"pairhmm_resident_warp": pc.pairhmm_resident_warp,
                "pairhmm_resident_block": pc.pairhmm_resident_block,
                "pairhmm_resident_smem": pc.pairhmm_resident_smem,
                "pairhmm_streamed": pc.pairhmm_streamed}

    def takes(kname, M):
        return {"pairhmm_resident_warp": M <= pc.WARP_MAX_WIDTH,
                "pairhmm_resident_block": M <= pc.BLOCK_MAX_WIDTH,
                "pairhmm_resident_smem": pc.resident_fits(M, dev),
                "pairhmm_streamed": True}[kname]

    def routed(M):
        if not pc.resident_fits(M, dev):
            return "pairhmm_streamed"
        if M <= pc.WARP_MAX_WIDTH:
            return "pairhmm_resident_warp"
        if M <= pc.BLOCK_MAX_WIDTH:
            return "pairhmm_resident_block"
        return "pairhmm_resident_smem"

    max_err = {k: 0.0 for k in variants}
    outcomes = set()
    pc.reset_launches()
    for label, arrs, params in cases:
        tr = params.as_array()
        M = arrs[2].shape[1]
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        nat = native.pairhmm_batch_native(*arrs, tr)
        if nat is None:
            fail("native scorer unavailable")
        plain = ph.pairhmm_scan(*g).cpu().numpy()
        # K2 at 24 kb only through the router (it takes 1.5 s a call)
        outs = {k: fn(*g).cpu().numpy() for k, fn in variants.items()
                if takes(k, M) and (k != "pairhmm_streamed" or M <= 20000)}
        before = dict(pc.launches)
        outs["pairhmm_batch"] = pc.pairhmm_batch(*g).cpu().numpy()
        moved = [k for k in pc.launches if pc.launches[k] != before[k]]
        if moved != [routed(M)]:
            fail(f"pairhmm_batch sent {label} (width {M}) to {moved}, "
                 f"expected {routed(M)}")
        torch.cuda.synchronize()
        for kname, out in outs.items():
            if kname in max_err:
                err = float(np.max(np.abs(out.astype(np.float64)
                                          - plain.astype(np.float64))))
                max_err[kname] = max(max_err[kname], err)
            if not (np.array_equal(out, plain) and np.array_equal(out, nat)):
                bad = np.flatnonzero((out != plain) | (out != nat))
                fail(f"{kname} disagrees on {label}: {len(bad)} pairs, "
                     f"first {bad[:4]}: {out[bad[:4]]} vs plain "
                     f"{plain[bad[:4]]} vs native {nat[bad[:4]]}")
        if not np.array_equal(plain, nat):
            fail(f"plain scan on the card disagrees with native on {label}")
        outcomes |= {"gate" if v == ph.IMPOSSIBLE else
                     "band fail" if v == ph.BAND_FAIL_SCORE else "aligned"
                     for v in nat}
        ran = " == ".join(k.replace("pairhmm_", "") for k in outs
                          if k in variants) or "streamed (through the router)"
        say("kernels", f"{label}: B={len(nat)} N={arrs[0].shape[1]} M={M} "
            f"{ran} == plain == native (bit-identical; pairhmm_batch took "
            f"{routed(M).replace('pairhmm_', '')}; "
            f"{int((nat == ph.BAND_FAIL_SCORE).sum())} band fails, "
            f"{int((nat == ph.IMPOSSIBLE).sum())} gated)")
    if outcomes != {"gate", "band fail", "aligned"}:
        fail(f"kernel cases reached only {sorted(outcomes)}")
    if not all(pc.launches.values()):
        fail(f"phase 2 left a variant unlaunched: {pc.launches}")

    def dev_ms(fn, reps):
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

    # Times at the three shapes of the main path: short STRs, a VNTR width
    # and the long-VNTR shape; every kernel that takes the width, the plain
    # scan and the bound
    timing = {}
    tr = ph.AlignmentParams().as_array()
    shapes = [(cases[0][0], cases[0][1], 20, 3),
              ("B=128 @3kb", batch_long(rng, 128, 3072), 3, 1),
              (cases[1][0], cases[1][1], 3, 1)]
    for label, arrs, reps, plain_reps in shapes:
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        M = arrs[2].shape[1]
        cells = float((arrs[1].astype(np.int64) * arrs[3]).sum())
        want = ph.pairhmm_scan(*g)
        t = {}
        for k, fn in variants.items():
            if takes(k, M):
                if not torch.equal(fn(*g), want):
                    fail(f"{k} disagrees with the plain scan on {label}")
                t[k] = dev_ms(lambda: fn(*g), reps)
        t["plain"] = dev_ms(lambda: ph.pairhmm_scan(*g), plain_reps)
        t["bound"], t["bound_by"] = pairhmm_bound(arrs)
        timing[label] = t
        sub = [a[:4] for a in arrs] if M > 1024 else [a[:256] for a in arrs]
        say("kernels", f"{label} ({cells:.4g} cells) on {smi}: "
            + " | ".join(f"{k.replace('pairhmm_', '')} {v:.4f} ms = "
                         f"{cells / v * 1e3:.4g} cells/s, "
                         f"{t['bound'] / v:.2%} of bound"
                         for k, v in t.items() if k in variants)
            + f" | plain {t['plain']:.3f} ms | bound {t['bound']:.5f} ms "
            f"({t['bound_by']}) | native 1-thread host "
            f"{host1_cells_per_s(sub, tr):.4g} cells/s")
    label, arrs, _params = cases[5]
    g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
    cells = float((arrs[1].astype(np.int64) * arrs[3]).sum())
    ms = dev_ms(lambda: pc.pairhmm_batch(*g), 2)
    say("kernels", f"{label} ({cells:.4g} cells) on {smi}: pairhmm_streamed "
        f"{ms:.3f} ms = {cells / ms * 1e3:.4g} cells/s, bound "
        f"{pairhmm_bound(arrs)[0]:.4f} ms (the only kernel that takes this "
        "width; plain scan not timed)")

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

    def body(path):
        with gzip.open(path, "rt") as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.startswith("##command")]

    def run(tag, fx, extra, scorer, out_dir, mode_b_scorer=None, mesh=None):
        name = tag.replace(" ", "_").replace("+", "_")
        out = os.path.join(out_dir, f"{name}.vcf.gz")
        metrics = os.path.join(out_dir, f"{name}.json")
        argv = ["--bams", ",".join(fx[2]), "--fasta", fx[0], "--regions",
                fx[1], "--tr-vcf", out, "--use-unpaired", "--min-reads", "5",
                "--quiet", "--metrics-out", metrics, *extra]
        poa._memo.clear()        # no assembly reuse across runs
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv, device=dev, pair_scorer=scorer,
                      mode_b_scorer=mode_b_scorer, mesh=mesh)
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
    # each are compared with a native-scored reference run of the same
    # options.  The device-posterior run's reference is the default
    # host-f64 posterior.  The VNTR catalog's batches are 1-2 kb and 2-4 kb
    # wide, both K1's block variant; its second run lowers the thresholds
    # (`routing`: pairhmm_cuda attributes) so that the 1-2 kb batch takes
    # the smem variant and the 2-4 kb batch the streamed kernel.
    catalogs = [("STR", str_fx, [], {}, {}),
                ("VNTR", vntr_fx, ["--max-tr-len", "10000"], {}, {}),
                ("VNTR smem+streamed", vntr_fx, ["--max-tr-len", "10000"], {},
                 {"BLOCK_MAX_WIDTH": 1024,
                  "resident_limit_bytes": pc.resident_smem_bytes(2048)}),
                ("STR mode B", str_fx, ["--stutter-align-len", "25"], {}, {}),
                ("dryrun snp-vcf", dry, ["--snp-vcf", dr["snp_vcf"]], {}, {}),
                ("dryrun ref-vcf", dry, ["--ref-vcf", dr["panel"]], {}, {}),
                ("dryrun mode-b+haploid", dry, ["--stutter-align-len", "25",
                                                "--haploid-chrs", "chrH"], {},
                 {}),
                ("dryrun core device-posterior", dry, [],
                 {"LONGTR_DEVICE_POSTERIOR": "1"}, {})]
    say("e2e", f"catalogs built in {time.perf_counter() - t:.1f} s "
        "(512 short-STR loci, one in six an A homopolymer of 10-25 copies; "
        "24 VNTR loci, 500-3000 bp repeats; 3 samples at 20x; the "
        f"{dr['n_loci']}-locus dryrun catalog at 18x)")
    refs = {}
    for tag, fx, extra, _env, routing in catalogs:
        if routing:     # the same run as the one before it, rerouted
            refs[tag] = refs[prev]
            continue
        refs[tag] = run(tag + " native", fx, extra, native_scorer, tmp,
                        mode_b_scorer=mbd.mode_b_cols_plain)
        prev = tag
    shapes = []
    real_mode_b = mbc.mode_b_cols

    def recording(*args, n_d, **kw):
        shapes.append((args[0].shape[0], args[6].shape[1], args[0].shape[1],
                       args[9].shape[1], n_d))
        return real_mode_b(*args, n_d=n_d, **kw)

    mbc.mode_b_cols = recording      # records shapes; counts stay the wrapper's
    results, counts = {}, {}
    for tag, fx, extra, env, routing in catalogs:
        saved = {k: getattr(pc, k) for k in routing}
        for k, v in routing.items():
            setattr(pc, k, v)
        os.environ.update(env)
        # every count to 0 just before the path, read just after
        pc.reset_launches()
        mbc.reset_launches()
        for c in (ph.pairs_scored, mbd.mode_b_elements_scored):
            for k in c:
                c[k] = 0
        try:
            results[tag] = run(tag + " cuda", fx, extra, None, tmp)
        finally:
            for k, v in saved.items():
                setattr(pc, k, v)
            for k in env:
                del os.environ[k]
        counts[tag] = ({**pc.launches, **mbc.launches}, dict(ph.pairs_scored),
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
            fail(f"{tag}: VCF body differs from the native-scored run "
                 f"(first difference at line {diff})")
        if n_rec == 0:
            fail(f"{tag}: no VCF records")
        loci = m["loci_processed"]
        stages = sorted(m["stage_seconds"].items(), key=lambda kv: -kv[1])
        launches, scored, mode_b_scored = counts[tag]
        say("e2e", f"{tag}: {n_rec} records byte-identical to the "
            f"native-scored run | card {loci / dt:.4g} loci/s ({dt:.2f} s), "
            f"native-scored {loci / ref_dt:.4g} loci/s ({ref_dt:.2f} s) "
            f"on {smi} | {m['num_dispatches']} batches, {m['num_syncs']} syncs")
        say("e2e", f"{tag} stage seconds: "
            + "  ".join(f"{k}={v:.3f}" for k, v in stages))
        say("e2e", f"{tag}: kernel launches {launches}; pair rows scored "
            f"{scored}; mode-B elements scored {mode_b_scored} (host_f64 = "
            "configs outside the row tables' envelope)")
        need = {"VNTR": ["pairhmm_resident_block"],
                "VNTR smem+streamed": ["pairhmm_resident_smem",
                                       "pairhmm_streamed"],
                "STR mode B": ["pairhmm_resident_warp", "mode_b_cols"],
                "dryrun mode-b+haploid": ["pairhmm_resident_warp",
                                          "mode_b_cols"]
                }.get(tag, ["pairhmm_resident_warp"])
        for k in need:
            if launches[k] == 0:
                fail(f"{tag}: {k} was not launched")
        if scored["cpu"] or scored["host_f64"] or not scored["cuda"]:
            fail(f"{tag}: pairs scored off the card: {scored}")
        if mode_b_scored["cpu"] or ("mode_b_cols" in need
                                    and not mode_b_scored["cuda"]):
            fail(f"{tag}: mode-B elements scored off the card: "
                 f"{mode_b_scored}")
    widest = max(shapes, key=lambda x: x[0] * x[1] * x[2] * x[3] * x[4])
    say("e2e", f"mode_b_cols: {len(shapes)} e2e launches; widest (B, R_max, "
        f"L_max, S_max, n_d) = {widest}; the widest rows of phase 2: "
        f"{mb['wide_shape']}")
    mb_stages = results["STR mode B"][2]["stage_seconds"]
    say("e2e", "STR mode B, mode-B stage seconds on the card: prepare (in "
        f"Haplotype build) {mb_stages.get('Haplotype build', 0.0):.3f}, "
        f"Mode B dispatch (row DP + marginalize) "
        f"{mb_stages.get('Mode B dispatch', 0.0):.3f}")

    say("e2e", f"phase 3 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    # ---- 4. mesh ---------------------------------------------------------
    mesh_phase(tmp, dev, smi, cases, run, body, dr, str_fx,
               results["STR"][0])
    say("mesh", f"phase 4 took {time.perf_counter() - t_phase:.1f} s")
    if "jax" in {k.split(".")[0] for k, v in sys.modules.items() if v}:
        fail("JAX was imported")

    src = "longtr_tpu_torch/csrc/pairhmm.cu"
    lines = kernel_lines()
    # each kernel's time at its main-path shape, and its launches in the
    # main path's run that takes it: the STR run for the warp variant, the
    # VNTR runs for the block and smem variants and K2, the mode-B STR run
    # for mode_b_cols
    main = {"pairhmm_resident_warp": (cases[0][0], "STR", "_kernel"),
            "pairhmm_resident_block": (cases[1][0], "VNTR", "_kernel"),
            "pairhmm_resident_smem": (cases[1][0], "VNTR smem+streamed",
                                      "_kernel"),
            "pairhmm_streamed": (cases[1][0], "VNTR smem+streamed",
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
    kernels.append({"name": "mode_b_cols", "route": "cuda",
                    "source": "longtr_tpu_torch/csrc/mode_b.cu",
                    "replaces": mode_b_line(),
                    "launches": counts["STR mode B"][0]["mode_b_cols"],
                    "max_abs_err": mb["max_abs_err"], "ms": mb["ms"],
                    "plain_ms": mb["plain_ms"], "bound_ms": mb["bound_ms"],
                    "bound_by": mb["bound_by"], "library_ms": None,
                    "shape": mb["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
