"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from the interpreter's start): torch and the port
imported, the card opened, the cell's catalog generated from the seed
into ``TMPDIR``, the port's kernels loaded from its build directory in the
checkout (built there by the first run), and one warm pass over a few
loci spread over the catalog's sizes.

Window: passes back to back until ``--seconds`` have gone by, the running
pass let finish.  A pass is one in-process ``longtr_tpu_torch.cli.main``
over the whole catalog with the configuration's flags, writing its VCF and
``--metrics-out`` into ``TMPDIR``: what one BED-shard process does, less
the interpreter's start.  ``loci_per_s`` is every pass's loci over the
wall from the window's start to the last pass's end.

With ``--trace 1`` a second window of the same length follows under the
profiler.  After the windows the device's memory peak is read, the
profiler's trace reduced, and the check run (``pbench.check``) over what
every window's passes produced.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from pbench import catalog, cells, check, roofline
from pbench.probes import Probes
from pbench.readers import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "longtr_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell "
                                "of the port (longtr_tpu_torch).")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=lambda v: int(v) % 2 ** 64, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``longtr_tpu_torch`` is not ``longtr_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def warm_loci(loci, n: int) -> list:
    """n loci spread evenly over the catalog sorted by repeat length, the
    shortest and the longest among them."""
    order = sorted(loci, key=lambda l: (l.stop - l.start, l.name))
    idx = np.unique(np.linspace(0, len(order) - 1, n).round().astype(int))
    picked = {order[i].name for i in idx}
    return [l for l in loci if l.name in picked]


def chosen_loci(loci, n: int, seed: int) -> list:
    """The loci whose calls the check compares: n drawn from the seed, the
    longest repeat among them."""
    rng = np.random.default_rng([seed, 0x10C1])
    names = [l.name for l in loci]
    longest = max(loci, key=lambda l: (l.stop - l.start, l.name)).name
    rest = [x for x in names if x != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def _argv(cat, bed, vcf, metrics, log, flags):
    return (["--bams", ",".join(cat["bams"]), "--fasta", cat["fasta"],
             "--regions", bed, "--tr-vcf", vcf, "--metrics-out", metrics,
             "--log", log] + list(flags))


def _launches() -> int:
    from longtr_tpu_torch.ops import em_cuda, mode_b_cuda, pairhmm_cuda
    return sum(sum(m.launches.values())
               for m in (pairhmm_cuda, mode_b_cuda, em_cuda))


def _reset_launches() -> None:
    from longtr_tpu_torch.ops import em_cuda, mode_b_cuda, pairhmm_cuda
    for m in (pairhmm_cuda, mode_b_cuda, em_cuda):
        m.reset_launches()


def _window(cli, probes, argv_of, vcfs, mets, seconds, device, log, what):
    """Whole passes back to back until ``seconds`` have gone by: the
    window's loci, genotyped loci, summed stage seconds and counters, wall
    and launches."""
    import torch

    _reset_launches()
    first = len(vcfs)
    pass_s = []
    t_start = time.perf_counter()
    while True:
        probes.pass_index = len(vcfs)
        argv = argv_of(len(vcfs))
        t_pass = time.perf_counter()
        rc = probes.span("pass", lambda: cli.main(argv, device=device))
        pass_s.append(time.perf_counter() - t_pass)
        if rc != 0:
            raise RuntimeError(f"pass {len(vcfs) - 1} exited with {rc}")
        if time.perf_counter() - t_start >= seconds:
            break
    t_end = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stage, counters = {}, {}
    for path in mets[first:]:
        m = cells.load_json(path)
        for k, v in m["stage_seconds"].items():
            stage[k] = stage.get(k, 0.0) + v
        for k, v in m.items():
            if isinstance(v, int) and not isinstance(v, bool):
                counters[k] = counters.get(k, 0) + v
    loci, ok = counters["loci_processed"], counters["num_genotype_success"]
    log(f"[{what}] {len(pass_s)} passes, {loci} loci in "
        f"{t_end - t_start:.4f} s; passes "
        + " ".join(f"{t:.3f}" for t in pass_s))
    return dict(loci=loci, ok=ok, stage=stage, counters=counters,
                t_start=t_start, t_end=t_end, launches=_launches())


def run_cell(cell, harness, seed, seconds, trace, device, t0, log=print,
             setup_hook=None):
    """The result object of one run (None where the profiler lost the
    trace).  ``setup_hook(device)``, if given, runs before the probes are
    installed and returns a function that undoes it: the control and the
    fault tests put their scorers in the program's place there.  A
    configuration whose flags the check has no reference for stops the run
    before set-up (ValueError).

    Every run measures one untraced window: its wall gives ``loci_per_s``
    and its passes' stage seconds and launches the per-layer stage
    metrics.  A traced run then measures a second window of the same
    length under the profiler, for the device's metrics and the spans."""
    import torch

    from longtr_tpu_torch import cli

    sem = check.semantics(cell.config["flags"])
    scorers = {route: cells.scorer(harness, module)
               for route, module in cell.checks.get("scorers", {}).items()}
    cuda = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        marks.append(("card", time.perf_counter()))
        from longtr_tpu_torch.ops import _build
        _build.load_library()
        marks.append(("kernels", time.perf_counter()))
    work = tempfile.mkdtemp(prefix="port_bench.", dir=tempfile.gettempdir())
    probes = undo = None
    try:
        cat = catalog.build(work, cell.traffic, cell.config["reads"], seed)
        marks.append(("catalog", time.perf_counter()))
        warm_bed = catalog.write_bed(
            os.path.join(work, "warm.bed"),
            warm_loci(cat["loci"], cell.traffic["warm_loci"]))
        sample = cell.checks["sample"]
        probes = Probes(seed, chosen_loci(cat["loci"], sample["loci"], seed),
                        sample)
        if setup_hook is not None:
            undo = setup_hook(device)
        probes.install()
        flags = cell.config["flags"]
        logf = os.path.join(work, "pass.log")
        rc = cli.main(_argv(cat, warm_bed, os.path.join(work, "warm.vcf.gz"),
                            os.path.join(work, "warm.json"), logf, flags),
                      device=device)
        if rc != 0:
            raise RuntimeError(f"the warm pass exited with {rc}")
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        marks.append(("warm pass", time.perf_counter()))
        last = t0
        parts = []
        for what, t in marks:
            parts.append(f"{what} {t - last:.3f}")
            last = t
        log(f"[setup] {setup_s:.3f} s: " + ", ".join(parts))

        vcfs, mets = [], []

        def argv_of(i):
            vcfs.append(os.path.join(work, f"pass{i}.vcf.gz"))
            mets.append(os.path.join(work, f"pass{i}.json"))
            return _argv(cat, cat["bed"], vcfs[-1], mets[-1], logf, flags)

        probes.capturing = True
        win = _window(cli, probes, argv_of, vcfs, mets, seconds, device, log,
                      "window")
        summary = None
        if trace:
            from pbench import trace as tr
            dtrace = tr.DeviceTrace(device)
            dtrace.start()
            probes.tracing = True
            twin = _window(cli, probes, argv_of, vcfs, mets, seconds, device,
                           log, "traced window")
            probes.tracing = False
            ops = dtrace.stop()
            if not ops:
                log("[trace] the profiler lost the window's trace; "
                    "taking it again")
                return None
            summary = tr.summarize(ops, probes.spans, twin["t_start"],
                                   twin["t_end"])
        probes.capturing = False
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        t_check = time.perf_counter()
        values, notes = check.run(probes, vcfs, cat, sample, sem, scorers,
                                  device, seed)
        for n in notes:
            log(f"[check] {n}")
        log(f"[check] {time.perf_counter() - t_check:.2f} s")
        limits = cell.checks["limits"]
        correct = all(v is not None and v <= limits[k]
                      for k, v in values.items())
        compared = {k: {"value": v, "limit": limits[k]}
                    for k, v in values.items()}

        device_info = {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak)}
        metrics = {}
        result = {"correct": bool(correct), "attempted": int(win["loci"]),
                  "failed": int(win["loci"] - win["ok"]), "metrics": metrics,
                  "device": device_info}
        if not trace:
            window_s = win["t_end"] - win["t_start"]
            for m in cell.end_to_end:
                value = {"loci_per_s": win["loci"] / window_s,
                         "setup_s": setup_s}[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            bounds = {"pairhmm": roofline.pairhmm_window(probes.pair_lengths)}
            w = Window(win["loci"], win["stage"], win["launches"], bounds,
                       summary, win["counters"])
            for m in cell.per_layer:
                v = cells.reader(harness, m["name"])(w)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["attempted"] += twin["loci"]
            result["failed"] += twin["loci"] - twin["ok"]
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in summary["device_ops"]],
                "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
            log(f"[roofline] bounds {bounds}; peaks 67 TFLOP/s f32, "
                f"3.35 TB/s; card {power_limit()}")
            result["_summary"] = dict(
                summary, stage_s=win["stage"], counters=win["counters"],
                loci=win["loci"],
                launches=win["launches"], bound_s=bounds,
                traced_stage_s=twin["stage"], traced_loci=twin["loci"],
                passes=len(vcfs))
        result["checks"] = compared
        return result
    finally:
        if probes is not None:
            probes.remove()
        if undo is not None:
            undo()
        shutil.rmtree(work, ignore_errors=True)


def main(argv, t0, harness, root) -> int:
    args = parse(argv)
    cell = cells.find(root, harness, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ERROR: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no run on the CPU)", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    say = lambda s: print(s, file=sys.stderr, flush=True)
    result = run_cell(cell, harness, args.seed, args.seconds, args.trace,
                      device, t0, log=say)
    if result is None:
        result = run_cell(cell, harness, args.seed, args.seconds, args.trace,
                          device, t0, log=say)
        if result is None:
            say("ERROR: the profiler lost the window's trace twice")
            return 4
    bad = forbidden_modules()
    if bad:
        say(f"ERROR: JAX or the JAX package was loaded: {bad}")
        return 3
    summary = result.pop("_summary", None)
    if summary is not None:
        out_dir = os.path.join(root, "port_bench_runs")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{args.workload}.{args.seed}"
                               ".trace.json"), "w") as fh:
            json.dump(summary, fh, indent=1, default=float)
    for k, v in result["checks"].items():
        say(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result))
    return 0
