"""LongTR-compatible command-line interface of the PyTorch port.

Port of :mod:`longtr_tpu.cli`: the same parser (``build_parser``) and
option mapping (``config_from_args``), which are free of JAX, and the same
run.  The device comes from :func:`longtr_tpu_torch.device.select_device`:
the first CUDA card when there is one, else the CPU; with more than one
card the pair-HMM, the EM stutter training and the window posteriors run
on a mesh of all of them (:mod:`longtr_tpu_torch.parallel.mesh`).

``--workers N`` runs N shard processes of this CLI and merges their
outputs; ``--distributed`` runs one block shard in each of several
processes that meet at a ``torch.distributed`` (gloo) barrier before rank
0 merges; ``--jax-profile DIR`` writes a ``torch.profiler`` trace.  The
shard paths and the merge are :mod:`longtr_tpu.cli`'s, which load no JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys

import torch

from longtr_tpu.cli import (_SHARDED_OUTPUT_FLAGS, _merge_shard_outputs,
                            _shard_path, build_parser, config_from_args)
from longtr_tpu.version import __version__
from longtr_tpu_torch.device import select_device

# The directory that holds the package, for the worker processes' path.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None, pair_scorer=None, mode_b_scorer=None,
         mesh=None):
    """Run ``longtr``.  ``device`` (default: auto), ``mesh`` (a
    :class:`~longtr_tpu_torch.parallel.mesh.Mesh`; default: every card
    when ``device`` is auto and there is more than one), ``pair_scorer`` (a
    replacement for the pair-HMM) and ``mode_b_scorer`` (a replacement for
    ``mode_b_cols``), used by chip_smoke.py and the tests, are for programs
    that call this in-process; they are not options."""
    try:
        return _main(argv, device, pair_scorer, mode_b_scorer, mesh)
    except (OSError, ValueError, EOFError) as e:
        # printErrorAndDie analog (error.h:6): clean message, nonzero exit.
        # Set LONGTR_TRACEBACK=1 to see the full traceback when debugging.
        if os.environ.get("LONGTR_TRACEBACK"):
            raise
        sys.exit(f"ERROR: {e}")
    except Exception as e:
        import struct
        import zlib
        if isinstance(e, (zlib.error, struct.error)):
            if os.environ.get("LONGTR_TRACEBACK"):
                raise
            sys.exit(f"ERROR: corrupt or truncated input: {e}")
        raise


def _shard_argv(argv, shard: int, drop_bare=(), drop_valued=()):
    """``argv`` for shard ``shard`` of a fan-out: without the fan-out's own
    options (``drop_bare`` flags, ``drop_valued`` options with their
    value), and with each output option pointed at its shard path.  The
    ``--flag=value`` form of an output option is rewritten too, else every
    shard would write the same path."""
    out = []
    it = iter(argv)
    for a in it:
        key = a.split("=", 1)[0]
        if a in drop_bare:
            continue
        if key in drop_valued:
            if "=" not in a:
                next(it, None)
            continue
        if key in _SHARDED_OUTPUT_FLAGS:
            value = a.split("=", 1)[1] if "=" in a else next(it)
            out += [key, _shard_path(value, shard)]
            continue
        out.append(a)
    return out


def _shards_of(n):
    return lambda path: [_shard_path(path, i) for i in range(n)]


def _run_workers(argv, args):
    """Run N single-shard CLI processes on this host and merge their
    outputs (port of ``longtr_tpu.cli._run_workers``).

    Each worker is a fresh interpreter running ``python -m
    longtr_tpu_torch.cli`` (no fork of a process whose CUDA is up); the
    interleaved shards merge to the single run's output byte for byte."""
    n = args.workers
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []
    try:
        for i in range(n):
            wargv = _shard_argv(argv, i, drop_valued={"--workers"})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "longtr_tpu_torch.cli", *wargv,
                 "--shard", f"{i}/{n}"], env=env))
        failed = [i for i, pr in enumerate(procs) if pr.wait() != 0]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    if failed:
        sys.exit(f"ERROR: worker shard(s) {failed} failed")
    return _merge_shard_outputs(args, _shards_of(n))


def _run_distributed(argv, args):
    """One process of a multi-process run (port of
    ``longtr_tpu.cli._run_distributed`` onto ``torch.distributed``).

    The process joins a gloo process group (``tcp://COORDINATOR`` with
    ``--num-processes`` and ``--process-id``; without ``--coordinator``,
    ``env://``, the variables torchrun sets), takes the block shard of its
    rank on card ``rank % cards`` (or the CPU), writes its shard outputs,
    and meets the others at a barrier; then rank 0 merges.  A process group
    that does not start ends the run with an error: nothing runs
    unsharded."""
    import datetime

    import torch.distributed as dist
    if args.coordinator:
        kw = dict(init_method=f"tcp://{args.coordinator}",
                  world_size=args.num_processes, rank=args.process_id)
    else:
        kw = dict(init_method="env://")
    try:
        dist.init_process_group("gloo", timeout=datetime.timedelta(
            seconds=600), **kw)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"ERROR: --distributed: the torch.distributed process "
                 f"group did not start: {e}")
    try:
        rank, n = dist.get_rank(), dist.get_world_size()
        wargv = _shard_argv(
            argv, rank, drop_bare={"--distributed"},
            drop_valued={"--coordinator", "--num-processes", "--process-id"})
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards) if cards else "cpu"
        rc = _main(wargv + ["--shard", f"{rank}/{n}", "--shard-mode", "block"],
                   device=device)
        if rc:
            return rc
        # every process must have written its shard before rank 0 merges
        dist.barrier()
        if rank != 0:
            return 0
        return _merge_shard_outputs(args, _shards_of(n))
    finally:
        dist.destroy_process_group()


def _main(argv=None, device=None, pair_scorer=None, mode_b_scorer=None,
          mesh=None):
    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(argv)
    if args.distributed:
        return _run_distributed(argv, args)
    if args.workers > 1 and not args.shard:
        return _run_workers(argv, args)
    if mesh is None and device is None and torch.cuda.device_count() > 1:
        from longtr_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    device = select_device(device)
    if args.ref_fidelity:
        from longtr_tpu.utils import mathops
        mathops.set_ref_fidelity(True)
    full_command = "LongTR-TPU-" + __version__ + " " + " ".join(argv)

    if args.metrics_out:
        d = os.path.dirname(args.metrics_out) or "."
        if not os.path.isdir(d):
            sys.exit(f"ERROR: Directory for --metrics-out does not exist: {d}")
    if not args.bams and not args.bam_files:
        sys.exit("ERROR: You must specify either the --bams or --bam-files option")
    if args.bams and args.bam_files:
        sys.exit("ERROR: You can only specify one of --bams or --bam-files")
    if not args.skip_genotyping and not args.tr_vcf:
        sys.exit("ERROR: --tr-vcf option required")
    if args.tr_vcf and not args.tr_vcf.endswith(".gz"):
        sys.exit("ERROR: Path for TR VCF output file must end in .gz")

    bam_files = (args.bams.split(",") if args.bams else
                 [ln.strip() for ln in open(args.bam_files) if ln.strip()])

    if args.log:
        log_fh = open(args.log, "w")
    elif not sys.stderr.isatty():
        # batch mode: a raw per-locus print to a piped stderr costs ~0.8ms
        # in syscalls; buffer and flush at exit (content unchanged)
        try:
            log_fh = io.TextIOWrapper(
                io.BufferedWriter(
                    io.FileIO(sys.stderr.fileno(), "w", closefd=False),
                    1 << 16),
                line_buffering=False, write_through=False)
        except (OSError, ValueError, io.UnsupportedOperation):
            log_fh = sys.stderr
    else:
        log_fh = sys.stderr

    def full_logger(*msgs):
        if not args.silent:
            print(*msgs, file=log_fh)

    def sel_logger(*msgs):
        if not (args.quiet or args.silent):
            print(*msgs, file=log_fh)

    from longtr_tpu.io.bam import BamMultiReader
    reader = BamMultiReader(bam_files, args.fasta)
    full_logger(f"Detected {len(bam_files)} BAM/CRAM files")
    full_logger(f"Device: {device}")
    if mesh is not None:
        full_logger(f"Mesh: {mesh}")

    # Read-group → sample/library maps (hipstr_main.cpp:461-516)
    rg_to_sample = {}
    rg_to_library = {}
    rg_samples = set()
    use_bam_rgs = not args.bam_samps
    if args.bam_samps:
        samps = args.bam_samps.split(",")
        libs = (args.bam_libs.split(",") if args.bam_libs else
                (samps if args.lib_from_samp else None))
        if libs is None:
            sys.exit("ERROR: --bam-libs option required when --bam-samps specified")
        if len(samps) != len(bam_files) or len(libs) != len(bam_files):
            sys.exit("ERROR: Number of BAM files and samples/libraries must match")
        for path, s, l in zip(bam_files, samps, libs):
            rg_to_sample[path] = s
            rg_to_library[path] = l
            rg_samples.add(s)
    else:
        for i, path in enumerate(bam_files):
            rgs = reader.read_groups(i)
            if not rgs:
                sys.exit("ERROR: BAM files lack read groups and --bam-samps "
                         "was not specified")
            for rg in rgs:
                if not rg.id or not rg.sample:
                    sys.exit("ERROR: @RG lacks ID or SM tag")
                lib = rg.sample if args.lib_from_samp else rg.library
                if not args.lib_from_samp and not rg.library:
                    sys.exit("ERROR: @RG lacks LB tag")
                rg_to_sample[path + rg.id] = rg.sample
                rg_to_library[path + rg.id] = lib
                rg_samples.add(rg.sample)

    cfg = config_from_args(args)
    from longtr_tpu_torch.pipeline.processor import GenotyperPipeline
    pipeline = GenotyperPipeline(cfg, use_bam_rgs, full_logger, sel_logger,
                                 device=device, pair_scorer=pair_scorer,
                                 mode_b_scorer=mode_b_scorer, mesh=mesh)
    if log_fh is not sys.stderr:
        pipeline.log_flush = log_fh.flush

    if args.viz_out:
        if not args.viz_out.endswith(".gz"):
            sys.exit("ERROR: Path for alignment visualization file must end "
                     "in .gz as it will be bgzipped")
        from longtr_tpu.io.bgzf import BgzfWriter
        pipeline.viz_out = BgzfWriter(args.viz_out)
    if args.pass_bam or args.filt_bam:
        # hipstr_main.cpp:518-535: both writers share the merged input header.
        from longtr_tpu.io.bam_write import BamWriter
        hdr = reader.readers[0].header
        if args.pass_bam:
            pipeline.pass_bam = BamWriter(args.pass_bam, hdr.text,
                                          hdr.ref_names, hdr.ref_lengths)
        if args.filt_bam:
            pipeline.filt_bam = BamWriter(args.filt_bam, hdr.text,
                                          hdr.ref_names, hdr.ref_lengths)
    if args.ref_vcf:
        from longtr_tpu.io.vcf import VCFReader
        pipeline.ref_vcf = VCFReader(args.ref_vcf)
    if args.snp_vcf and not args.phased_bam:
        from longtr_tpu.io.vcf import VCFReader
        pipeline.snp_vcf = VCFReader(args.snp_vcf)
    if args.fam:
        # Pedigree-based SNP filtering before physical phasing
        # (hipstr_main.cpp:581-594 + snp_bam_processor.h:89-105).
        if not args.snp_vcf:
            sys.exit("ERROR: --fam option only applies if --snp-vcf option "
                     "has been specified as well")
        from longtr_tpu.denovo.haplotype_tracker import HaplotypeTracker
        from longtr_tpu.denovo.pedigree import (
            extract_pedigree_nuclear_families)
        from longtr_tpu.io.vcf import VCFReader
        snp_samples = set(pipeline.snp_vcf.samples)
        families = extract_pedigree_nuclear_families(
            args.fam, snp_samples, full_logger)
        families = [f for f in families if not f.is_missing_sample(snp_samples)]
        if families:
            # Separate reader: the tracker's sliding window iterates
            # independently of the per-locus SNP-tree queries.
            pipeline.snp_tracker = HaplotypeTracker(
                families, VCFReader(args.snp_vcf))

    if not args.skip_genotyping:
        samples = cfg.sample_set & rg_samples if cfg.sample_set else rg_samples
        pipeline.set_output_vcf(args.tr_vcf, samples)

    shard = None
    if args.shard:
        sid, nsh = (int(x) for x in args.shard.split("/"))
        shard = (sid, nsh, args.shard_mode)
    if args.checkpoint:
        pipeline.set_checkpoint(args.checkpoint)
    profiler = None
    if args.jax_profile:
        # torch.profiler takes --jax-profile's place: host activities, and
        # the card's when the run has one; DIR/*.pt.trace.json on exit
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        devices = mesh.devices if mesh is not None else (device,)
        activities = [ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in devices):
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities, on_trace_ready=(
            tensorboard_trace_handler(args.jax_profile)))
        profiler.start()
    try:
        pipeline.process_regions(reader, args.regions, args.fasta,
                                 rg_to_sample, rg_to_library, full_command,
                                 max_regions=10_000_000, chrom=args.chrom,
                                 shard=shard)
        pipeline.finish()
    finally:
        if profiler is not None:
            profiler.stop()
        if log_fh is not sys.stderr and not args.log:
            log_fh.flush()
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(pipeline.metrics(), fh, indent=2)
    reader.close()
    if args.log:
        log_fh.close()
    elif log_fh is not sys.stderr:
        log_fh.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
