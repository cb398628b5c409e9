#!/usr/bin/env python3
"""Smoke test of the PyTorch port (longtr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each:

1. device  — the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from longtr_tpu_torch/csrc (into
   longtr_tpu_torch/_build/, at first use).
2. kernels — seeded batches through the resident kernel, the streamed
   kernel (forced), the plain torch scan on the card and the native host
   scorer; every pair of them must agree bit for bit (tolerance 0).  One
   batch is too wide for the resident kernel and must be routed to the
   streamed one.  Times each kernel and the plain scan at the main path's
   shapes.
3. e2e     — the `longtr` CLI of the port on two synthetic catalogs (512
   short STRs; 24 VNTRs of 500-3000 bp), each run twice: on the card, and
   with pair scoring given to the native host scorer.  The VCF bodies must
   be byte-identical, both kernels must have launched, and no pair may have
   been scored on the host in the card's runs.

The last lines are a JSON object of the kernels, the card's nvidia-smi
name and power limit, and the result line.  Exits non-zero, printing no
result, without a CUDA card, outside a checkout of the repository, or when
any phase fails.  Nothing here imports JAX.
"""

import gzip
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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
    from longtr_tpu import native
    from longtr_tpu_torch.ops import _build, pairhmm_cuda as pc
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
        fail("the native host scorer (longtr_tpu/native) did not build")
    say("device", f"resident kernel opt-in shared memory "
        f"{pc.max_smem_optin(dev)} bytes")

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

    custom = ph.AlignmentParams.from_list(
        [-2.0, -0.3, -1.5, -0.25, -0.0001, -8.0, -9.0])
    rng = np.random.default_rng(20261016)
    # The last case is wider than the resident kernel's shared memory takes
    # (about 17.8k columns): pairhmm_batch must route it to the streamed
    # kernel, where the JAX package would have sent it to the host.
    cases = [("B=2048 @192bp", batch_192(rng, 2048), ph.AlignmentParams()),
             ("B=128 @8kb", batch_long(rng, 128, 8192), ph.AlignmentParams()),
             ("length skew 250-550bp", batch_skew(rng), ph.AlignmentParams()),
             ("custom params @192bp", batch_192(rng, 256), custom),
             ("gates + band fails", batch_gates(rng), ph.AlignmentParams()),
             ("B=8 @24kb", batch_long(rng, 8, 24576), ph.AlignmentParams())]
    max_err = {"pairhmm_resident": 0.0, "pairhmm_streamed": 0.0}
    outcomes = set()
    for label, arrs, params in cases:
        tr = params.as_array()
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        nat = native.pairhmm_batch_native(*arrs, tr)
        if nat is None:
            fail("native scorer unavailable")
        plain = ph.pairhmm_scan(*g).cpu().numpy()
        outs = {}
        if pc.resident_fits(arrs[2].shape[1], dev):
            outs["pairhmm_resident"] = pc.pairhmm_resident(*g).cpu().numpy()
            outs["pairhmm_streamed"] = pc.pairhmm_streamed(*g).cpu().numpy()
        else:
            before = pc.launches["pairhmm_streamed"]
            outs["pairhmm_streamed"] = pc.pairhmm_batch(*g).cpu().numpy()
            if pc.launches["pairhmm_streamed"] == before:
                fail(f"pairhmm_batch did not route {label} to pairhmm_streamed")
        torch.cuda.synchronize()
        for kname, out in outs.items():
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
        ran = (" == ".join(k.split("_")[1] for k in outs) if len(outs) > 1
               else "streamed (routed by pairhmm_batch)")
        say("kernels", f"{label}: B={len(nat)} N={arrs[0].shape[1]} "
            f"M={arrs[2].shape[1]} {ran} == plain == native "
            f"(bit-identical; {int((nat == ph.BAND_FAIL_SCORE).sum())} band "
            f"fails, {int((nat == ph.IMPOSSIBLE).sum())} gated)")
    if outcomes != {"gate", "band fail", "aligned"}:
        fail(f"kernel cases reached only {sorted(outcomes)}")

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

    timing = {}
    tr = ph.AlignmentParams().as_array()
    for label, arrs, reps, plain_reps in ((cases[0][0], cases[0][1], 20, 3),
                                          (cases[1][0], cases[1][1], 3, 1)):
        g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
        cells = float((arrs[1].astype(np.int64) * arrs[3]).sum())
        t = {"pairhmm_resident": dev_ms(lambda: pc.pairhmm_resident(*g), reps),
             "pairhmm_streamed": dev_ms(lambda: pc.pairhmm_streamed(*g), reps),
             "plain": dev_ms(lambda: ph.pairhmm_scan(*g), plain_reps)}
        timing[label] = t
        sub = [a[:4] for a in arrs] if arrs[0].shape[1] > 1024 else \
            [a[:256] for a in arrs]
        say("kernels", f"{label} ({cells:.4g} cells) on {smi}: "
            + " | ".join(f"{k} {v:.3f} ms = {cells / v * 1e3:.4g} cells/s"
                         for k, v in t.items())
            + f" | native 1-thread host {host1_cells_per_s(sub, tr):.4g} "
            "cells/s")
    label, arrs, _params = cases[-1]
    g = [torch.from_numpy(a).to(dev) for a in (*arrs, tr)]
    cells = float((arrs[1].astype(np.int64) * arrs[3]).sum())
    ms = dev_ms(lambda: pc.pairhmm_batch(*g), 2)
    say("kernels", f"{label} ({cells:.4g} cells) on {smi}: pairhmm_streamed "
        f"{ms:.3f} ms = {cells / ms * 1e3:.4g} cells/s (the only kernel "
        "that takes this width; plain scan not timed)")

    # ---- 3. e2e ----------------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "loci_throughput", os.path.join(ROOT, "benchmarks",
                                        "loci_throughput.py"))
    lt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lt)
    from longtr_tpu.haplotype import poa
    from longtr_tpu_torch import cli

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

    def run(tag, fx, extra, scorer, out_dir):
        out = os.path.join(out_dir, f"{tag}.vcf.gz")
        metrics = os.path.join(out_dir, f"{tag}.json")
        argv = ["--bams", ",".join(fx[2]), "--fasta", fx[0], "--regions",
                fx[1], "--tr-vcf", out, "--use-unpaired", "--min-reads", "5",
                "--quiet", "--metrics-out", metrics, *extra]
        poa._memo.clear()        # no assembly reuse across runs
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv, device=dev, pair_scorer=scorer)
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
        return lt.build_catalog(d, n, seed=1, **kw)

    t = time.perf_counter()
    catalogs = [("STR", catalog("str_in", 512), []),
                ("VNTR", catalog("vntr_in", 24, vntr=True),
                 ["--max-tr-len", "10000"])]
    say("e2e", f"catalogs built in {time.perf_counter() - t:.1f} s "
        "(512 short-STR loci; 24 VNTR loci, 500-3000 bp repeats; 3 samples "
        "at 20x)")
    refs = {}
    for tag, fx, extra in catalogs:
        refs[tag] = run(f"{tag}_native", fx, extra, native_scorer, tmp)
    # The VNTR run lowers the resident kernel's shared-memory limit so that
    # read widths above 2048 take the streamed kernel; with the default
    # limit (the card's opt-in maximum, ~17k columns) every width of these
    # catalogs fits the resident kernel.
    vntr_limit = pc.resident_smem_bytes(2048)
    pc.reset_launches()
    for k in ph.pairs_scored:
        ph.pairs_scored[k] = 0
    results = {}
    for tag, fx, extra in catalogs:
        pc.resident_limit_bytes = vntr_limit if tag == "VNTR" else None
        try:
            results[tag] = run(f"{tag}_cuda", fx, extra, None, tmp)
        finally:
            pc.resident_limit_bytes = None
    launches = dict(pc.launches)
    scored = dict(ph.pairs_scored)
    for tag, fx, extra in catalogs:
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
        say("e2e", f"{tag}: {n_rec} records byte-identical to the "
            f"native-scored run | card {loci / dt:.4g} loci/s ({dt:.2f} s), "
            f"native-scored {loci / ref_dt:.4g} loci/s ({ref_dt:.2f} s) "
            f"on {smi} | {m['num_dispatches']} batches, {m['num_syncs']} syncs")
        say("e2e", f"{tag} stage seconds: "
            + "  ".join(f"{k}={v:.3f}" for k, v in stages))
    say("e2e", f"kernel launches {launches}; pair rows scored {scored}")
    for k, v in launches.items():
        if v == 0:
            fail(f"{k} was not launched by the e2e runs")
    if scored["cpu"] or scored["host_f64"] or not scored["cuda"]:
        fail(f"pairs scored off the card in the e2e runs: {scored}")
    if "jax" in {k.split(".")[0] for k, v in sys.modules.items() if v}:
        fail("JAX was imported")

    src = "longtr_tpu_torch/csrc/pairhmm.cu"
    lines = kernel_lines()
    main_shape = {"pairhmm_resident": cases[0][0],
                  "pairhmm_streamed": cases[1][0]}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": lines[pallas],
                "launches": launches[k], "max_abs_err": max_err[k],
                "ms": timing[main_shape[k]][k],
                "plain_ms": timing[main_shape[k]]["plain"],
                "shape": main_shape[k]}
               for k, pallas in (("pairhmm_resident", "_kernel"),
                                 ("pairhmm_streamed", "_kernel_chunked"))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
