"""The per-locus processing loop.

Port of :mod:`longtr_tpu.pipeline.processor`.  The pipeline receives its
``torch.device`` (and, for more than one shard, a
:class:`~longtr_tpu_torch.parallel.mesh.Mesh`) from the CLI and builds the
pair scorer around them; mode B (``--stutter-align-len``) runs its row DP
on ``device``.  The EM stutter trainer runs on the host, or with a mesh
as one train loop on the mesh.  Posteriors are the host f64 path; with a
mesh or ``LONGTR_DEVICE_POSTERIOR=1`` the pruning decision of each window
comes from one batched call on the devices first.

Reference: the BamProcessor → SNPBamProcessor → GenotyperBamProcessor
template-method chain (bam_processor.cpp:536-628;
snp_bam_processor.cpp:35-124; genotyper_bam_processor.cpp:227-351), collapsed
into one driver:

per locus: FASTA chromosome load → padded BAM region seek → streaming read
filter → phasing factors → stutter model selection (default / file / EM) →
left-align → SeqStutterGenotyper (pair-HMM + posteriors) → VCF record.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch

from longtr_tpu_torch.config import Config
from longtr_tpu_torch.device import select_device
from longtr_tpu_torch.io.fasta import FastaReader
from longtr_tpu_torch.io.vcf import VCFWriter
from longtr_tpu_torch.models.stutter import StutterModel, default_stutter_model
from longtr_tpu_torch.pipeline.alignment import extract_cigar, left_align_reads
from longtr_tpu_torch.pipeline.filters import read_and_filter_reads
from longtr_tpu_torch.pipeline.phasing import phased_bam_factors, unphased_factors
from longtr_tpu_torch.regions import RegionGroup, order_regions, read_regions
from longtr_tpu_torch.utils.timers import ProcessTimer
from longtr_tpu_torch.models.em import EMStutterGenotyper
from longtr_tpu_torch.ops.pairhmm import AlignmentParams, pairhmm_batch_auto
from longtr_tpu_torch.pipeline.seq_genotyper import (SeqStutterGenotyper,
                                                     score_pairs_async)
from longtr_tpu_torch.pipeline.vcf_record import get_vcf_header, write_vcf_record


@dataclass
class RunStats:
    num_too_long: int = 0
    too_few_reads: int = 0
    too_many_reads: int = 0
    num_em_converge: int = 0
    num_em_fail: int = 0
    num_missing_models: int = 0
    num_genotype_success: int = 0
    num_genotype_fail: int = 0
    loci_processed: int = 0
    num_dispatches: int = 0      # pair-HMM batches handed to the scorer
    num_syncs: int = 0           # host syncs (one per completed window)
    bytes_dispatched: int = 0    # encoded pair bytes shipped to the device
    cells_launched: int = 0      # DP cells of the padded pair batches
    cells_real: int = 0          # DP cells of the pairs themselves
    # (record, locus) pairs of the read filter whose gates and trim read
    # a decode batch's columns, and those that took the fallback path
    reads_from_columns: int = 0
    reads_fallback: int = 0
    # mode B's work, summed over the genotypers (seq_genotyper.MODE_B_COUNTERS)
    mode_b_loci: int = 0
    mode_b_reads: int = 0
    mode_b_elements_real: int = 0
    mode_b_elements_launched: int = 0
    mode_b_host_reads: int = 0


class GenotyperPipeline:
    def __init__(self, config: Config, use_bam_rgs: bool = True,
                 full_logger=None, selective_logger=None,
                 device: torch.device | None = None,
                 pair_scorer=None, mesh=None,
                 timer: ProcessTimer | None = None):
        """``pair_scorer(hap, hap_lens, read, read_lens, full_lens, params)``
        scores padded pair batches; by default
        :func:`~longtr_tpu_torch.ops.pairhmm.pairhmm_batch_auto` on ``device``
        (default: :func:`~longtr_tpu_torch.device.select_device`'s), or over
        ``mesh`` when it has more than one shard.  A mesh also takes the EM
        stutter training and the window posteriors.  ``timer`` (default: a new
        one) receives the stage spans."""
        self.config = config
        self.device = select_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.scorer = pair_scorer or functools.partial(
            pairhmm_batch_auto, device=self.device, mesh=self.mesh)
        self.use_bam_rgs = use_bam_rgs
        self.full_log = full_logger or (lambda *a: None)
        self.sel_log = selective_logger or (lambda *a: None)
        self.log_flush = None        # optional; called per completed window
        self.vcf_writer = VCFWriter()
        self.samples_to_genotype = []
        self.stats = RunStats()
        self.timer = timer or ProcessTimer()
        self.def_stutter_model = (default_stutter_model()
                                  if config.use_default_stutter_model else None)
        self.stutter_models_in = (StutterModel.read_models(config.stutter_in)
                                  if config.stutter_in else None)
        self.stutter_out_fh = (open(config.stutter_out, "w")
                               if config.stutter_out else None)
        self.ref_vcf = None
        self.snp_vcf = None
        self.viz_out = None          # BgzfWriter for --viz-out
        self.pass_bam = None         # BamWriter for --pass-bam
        self.snp_tracker = None      # HaplotypeTracker for --fam SNP filtering
        self.filt_bam = None         # BamWriter for --filt-bam
        self._pending = []           # loci awaiting the fused device dispatch
        self._inflight = None        # dispatched window not yet completed
        self._builders = None        # lazy thread pool for haplotype builds
        self._checkpoint_fh = None
        self._checkpoint_done = set()

    def set_output_vcf(self, path: str, samples):
        self.vcf_writer.open(path)
        self.samples_to_genotype = sorted(samples)

    def set_checkpoint(self, path: str):
        """Locus-level checkpoint/resume (absent in the reference — a crash
        there loses the run; SURVEY.md §5).  Completed locus keys are
        appended and skipped on restart."""
        import os
        if os.path.exists(path):
            with open(path) as fh:
                self._checkpoint_done = {ln.strip() for ln in fh if ln.strip()}
            if self._checkpoint_done:
                self.full_log(f"Resuming: {len(self._checkpoint_done)} loci "
                              f"already completed in checkpoint")
        self._checkpoint_fh = open(path, "a")

    def _locus_key(self, region):
        return f"{region.chrom}:{region.start}-{region.stop}"

    def _checkpoint_mark(self, group):
        if self._checkpoint_fh is None:
            return
        for region in group.regions:
            self._checkpoint_fh.write(self._locus_key(region) + "\n")
        self._checkpoint_fh.flush()

    # ------------------------------------------------------------------
    def process_regions(self, reader, region_file: str, fasta_file: str,
                        rg_to_sample, rg_to_library, full_command: str,
                        max_regions: int = 10_000_000, chrom: str = "",
                        shard=None):
        timer = self.timer
        with timer.span("Pass open"):
            regions = order_regions(read_regions(region_file, max_regions,
                                                 chrom, self.full_log))
            if shard is not None:
                from longtr_tpu_torch.parallel.multihost import shard_regions
                regions = shard_regions(regions, shard[1], shard[0], shard[2])
            fasta = FastaReader(fasta_file)

            chroms = []
            for r in regions:
                if not chroms or chroms[-1] != r.chrom:
                    chroms.append(r.chrom)
            for c in chroms:
                if fasta.get_sequence_length(c) == -1:
                    raise RuntimeError(f"Chromosome {c} missing from FASTA")
                if reader.header.ref_id(c) == -1:
                    raise RuntimeError(f"Chromosome {c} missing from BAM "
                                       "header")

            if self.vcf_writer.is_open:
                header = get_vcf_header(fasta_file, full_command,
                                        fasta.contig_header_lines(),
                                        self.samples_to_genotype,
                                        self.config.output_flags())
                self.vcf_writer.write_header(header)

        cur_chrom = None
        chrom_seq = ""
        cfg = self.config
        for region in regions:
            if self._checkpoint_done and \
                    self._locus_key(region) in self._checkpoint_done:
                continue
            self.full_log(f"Processing region {region.chrom} {region.start} "
                          f"{region.stop}")
            if region.stop - region.start > cfg.max_str_length:
                self.stats.num_too_long += 1
                self.full_log("Skipping region: reference allele too long")
                continue
            if region.chrom != cur_chrom:
                cur_chrom = region.chrom
                chrom_seq = fasta.get_sequence(cur_chrom)
            if region.start < 50 or region.stop + 50 >= len(chrom_seq):
                self.full_log("Skipping region within 50bp of the contig end")
                continue

            with timer.span("BAM seek"):
                reader.set_region(
                    region.chrom,
                    0 if region.start < cfg.max_mate_dist else region.start - cfg.max_mate_dist,
                    region.stop + cfg.max_mate_dist)

            group = RegionGroup.single(region)
            with timer.span("Read filtering"):
                rg_names, paired, mates, unpaired, counters = read_and_filter_reads(
                    reader, group, rg_to_sample, cfg, self.use_bam_rgs,
                    self.sel_log, pass_writer=self.pass_bam,
                    filt_writer=self.filt_bam)
            self.stats.reads_from_columns += counters.reads_from_columns
            self.stats.reads_fallback += counters.reads_fallback

            if cfg.sample_set:
                keep = [i for i, n in enumerate(rg_names) if n in cfg.sample_set]
                rg_names = [rg_names[i] for i in keep]
                paired = [paired[i] for i in keep]
                mates = [mates[i] for i in keep]
                unpaired = [unpaired[i] for i in keep]

            if cfg.remove_pcr_dups:
                from longtr_tpu_torch.pipeline.pcr_duplicates import remove_pcr_duplicates
                remove_pcr_duplicates(self.use_bam_rgs, rg_to_library,
                                      paired, mates, unpaired, self.sel_log)

            with timer.span("SNP info extraction"):
                if cfg.phased_bam:
                    alignments, log_p1s, log_p2s = phased_bam_factors(
                        paired, mates, unpaired, rg_names,
                        cfg.from_hap_ll, cfg.other_hap_ll, self.sel_log)
                elif self.snp_vcf is not None:
                    from longtr_tpu_torch.pipeline.snp_phasing import snp_vcf_factors
                    if self.snp_tracker is not None:
                        # snp_bam_processor.cpp:54-57: slide the pedigree SNP
                        # haplotype window to the current locus.
                        self.snp_tracker.advance(group.chrom, group.start, set())
                    alignments, log_p1s, log_p2s = snp_vcf_factors(
                        self.snp_vcf, paired, mates, unpaired, rg_names, group,
                        cfg, self.sel_log, tracker=self.snp_tracker)
                else:
                    alignments, log_p1s, log_p2s = unphased_factors(paired, unpaired)

            before = timer.snapshot()
            self._analyze_locus(alignments, log_p1s, log_p2s, rg_names, group,
                                chrom_seq, counters)
            self.stats.loci_processed += 1
            # Per-locus timing block (genotyper_bam_processor.cpp:316-338).
            # Genotyping itself is fused across the locus window here, so its
            # per-locus share is reported at flush time instead.
            deltas = {k: v - before.get(k, 0.0)
                      for k, v in timer.snapshot().items()
                      if v - before.get(k, 0.0) > 0}
            lines = ["Locus timing:"]
            for k in ("Stutter estimation", "Trimming alignment",
                      "Haplotype generation"):
                if k in deltas:
                    lines.append(f" {k:<20}= {deltas[k]:.6f} seconds")
            self.sel_log("\n".join(lines))
        self._flush_pending()

    # ------------------------------------------------------------------
    def _learn_stutter_model(self, alignments, log_p1s, log_p2s, haploid,
                             rg_names, region):
        """genotyper_bam_processor.cpp:170-225."""
        cfg = self.config
        str_bp_lengths = [[] for _ in alignments]
        str_p1s = [[] for _ in alignments]
        str_p2s = [[] for _ in alignments]
        inf_reads = 0
        MAX_INF_READS = 10000
        for i, reads in enumerate(alignments):
            for j, rec in enumerate(reads):
                ok, bp_diff = extract_cigar(rec.cigar, rec.pos,
                                            region.start - region.period,
                                            region.stop + region.period)
                if ok:
                    if bp_diff < -(region.stop - region.start + 1):
                        continue
                    inf_reads += 1
                    str_bp_lengths[i].append(bp_diff)
                    str_p1s[i].append(log_p1s[i][j] if log_p1s else 0.0)
                    str_p2s[i].append(log_p2s[i][j] if log_p2s else 0.0)
            if inf_reads > MAX_INF_READS:
                break
        if inf_reads < cfg.min_total_reads:
            self.full_log(f"Skipping locus: too few informative reads for "
                          f"stutter training ({inf_reads})")
            self.stats.too_few_reads += 1
            return None
        em = EMStutterGenotyper(haploid, region.motif, str_bp_lengths,
                                str_p1s, str_p2s, rg_names)
        if em.train(cfg.max_em_iter, cfg.abs_ll_converge, cfg.frac_ll_converge,
                    mesh=self.mesh):
            self.stats.num_em_converge += 1
            model = em.stutter_model.copy()
            if self.stutter_out_fh:
                self.stutter_out_fh.write(
                    model.write_model_line(region.chrom, region.start,
                                           region.stop) + "\n")
            self.sel_log(f"Learned stutter model {model}")
            return model
        self.stats.num_em_fail += 1
        self.full_log(f"Stutter model training failed for "
                      f"{region.chrom}:{region.start}-{region.stop}")
        return None

    def _analyze_locus(self, alignments, log_p1s, log_p2s, rg_names, group,
                       chrom_seq, counters):
        """genotyper_bam_processor.cpp:227-351."""
        cfg = self.config
        total_reads = sum(len(a) for a in alignments)
        if total_reads < cfg.min_total_reads:
            self.full_log(f"Skipping locus with too few reads: "
                          f"TOTAL={total_reads}, MIN={cfg.min_total_reads}")
            self.stats.too_few_reads += 1
            return
        if counters.too_many_reads:
            self.full_log("Skipping locus with too many reads")
            self.stats.too_many_reads += 1
            return

        haploid = group.chrom in cfg.haploid_chroms
        stutter_models = []
        stutter_success = True
        timer = self.timer
        with timer.span("Stutter estimation"):
            for region in group.regions:
                model = None
                if self.def_stutter_model is not None:
                    model = self.def_stutter_model.with_period(region.period)
                elif self.stutter_models_in is not None:
                    model = self.stutter_models_in.get(
                        (region.chrom, region.start, region.stop))
                    if model is None:
                        self.full_log(
                            f"WARNING: No stutter model found for "
                            f"{region.chrom}:{region.start}-{region.stop}")
                        self.stats.num_missing_models += 1
                else:
                    model = self._learn_stutter_model(
                        alignments, log_p1s, log_p2s, haploid, rg_names,
                        region)
                stutter_models.append(model)
                stutter_success &= model is not None

        if not (self.vcf_writer.is_open and stutter_success):
            return

        with timer.span("Trimming alignment"):
            left_alns, filt_p1s, filt_p2s, n_p1s, n_p2s = left_align_reads(
                group, chrom_seq, alignments, log_p1s, log_p2s,
                logger=self.sel_log)

        def _build():
            # pure given its inputs: log lines buffer and replay in locus
            # order at dispatch, so parallel builds keep output identical
            from longtr_tpu_torch.utils.workers import locus_worker_scope
            logbuf = []
            with timer.span("Haplotype build"), locus_worker_scope():
                return _build_inner(logbuf)

        def _build_inner(logbuf):
            gt = SeqStutterGenotyper(
                group, haploid, left_alns, filt_p1s, filt_p2s, n_p1s, n_p2s,
                rg_names, chrom_seq, stutter_models, ref_vcf=self.ref_vcf,
                logger=logbuf.append, skip_assembly=cfg.skip_assembly,
                indel_flank_len=cfg.indel_flank_len,
                switch_old_align_len=cfg.switch_old_align_len,
                alignment_params=cfg.alignment_params, scorer=self.scorer,
                device=self.device)
            ok, pairs = gt.genotype_prepare(cfg.max_total_haplotypes)
            gt.chrom_seq = chrom_seq   # shared ref, used by the viz writer
            return gt, pairs, ok, logbuf

        # Haplotype generation (clustering + POA + NW; native, GIL-free)
        # dominates host time on long-TR catalogs and is independent
        # across loci: overlap the window's builds on a thread pool.
        # Mode B's device work is deferred to _dispatch_pending (main
        # thread) so its table building parallelizes too; ref_vcf mode
        # shares a stateful VCF reader — keep that serial.
        # ...but for SHORT loci the pool loses: per-locus build work is
        # tens of microseconds and the submit/lock/GIL round trip costs
        # more than it hides (measured: 144 -> 192 loci/s on a 300-locus
        # short-STR catalog when building inline).  Span <= 150bp is
        # firmly in that regime; longer loci keep the pool.
        span = max((r.stop - r.start for r in group.regions), default=0)
        with timer.span("Genotyping"):
            if self.ref_vcf is None and span > 150 \
                    and os.environ.get("LONGTR_SERIAL_BUILD") != "1":
                self._pending.append((self._build_pool().submit(_build),
                                      group))
            else:
                with timer.span("Build inline"):
                    built = _build()
                self._pending.append((built, group))
        if len(self._pending) >= max(1, cfg.locus_batch):
            self._dispatch_pending()

    def _build_pool(self):
        if self._builders is None:
            from concurrent.futures import ThreadPoolExecutor

            from longtr_tpu_torch.utils.workers import available_cores
            self._builders = ThreadPoolExecutor(
                max_workers=min(4, available_cores()),
                thread_name_prefix="longtr-hapgen")
        return self._builders

    def _flush_pending(self):
        """Synchronous flush: dispatch the pending window and complete it
        (plus any window still in flight)."""
        self._dispatch_pending()
        self._complete_inflight()

    def _dispatch_pending(self):
        """Enqueue the pending window's fused pair-HMM work on the device
        WITHOUT waiting (the reference aligns per read per haplotype per
        locus — HapAligner.cpp:545-581; here a window of loci shares one
        launch per length class).  Completing the previous window first
        keeps at most one window in flight, so host IO/decode of window k+1
        overlaps device scoring of window k (double buffering)."""
        if not self._pending:
            return
        self._complete_inflight()
        timer = self.timer
        # resolve the window's (possibly parallel) builds in locus order,
        # replaying each locus's buffered log lines
        resolved = []
        for item, group in self._pending:
            with timer.span("Build wait"):
                gt, pairs, ok, logbuf = (item.result()
                                         if hasattr(item, "result")
                                         else item)
                for msg in logbuf:
                    self.sel_log(msg)
            # later phases (genotype_finalize's pruning messages) must log
            # live again, not into the already-replayed buffer
            gt.logger = self.sel_log
            fin = getattr(gt, "_mode_b_finish", None)
            if fin is not None:
                # mode B: the deferred device row DP + marginalization
                with timer.span("Mode B dispatch"):
                    gt._pool_scores = fin()
                gt._mode_b_finish = None
            resolved.append((gt, pairs, ok, group))
        self._pending = resolved
        # "Haplotype build" = the builds' summed wall on the threads that
        # ran them (can exceed wall); "Build wait" = the main thread's wall
        # blocked on the pool's builds here.  A short locus builds inline
        # on the main thread ("Build inline", in _analyze_locus), so
        # "Genotyping" and "Haplotype build" both hold inline builds.
        with timer.span("Genotyping"):
            all_pairs = []
            slices = []
            for gt, pairs, ok, _group in self._pending:
                if ok and pairs is not None:
                    slices.append((len(all_pairs), len(pairs)))
                    all_pairs.extend(pairs)
                else:
                    slices.append(None)
            handle = None
            if all_pairs:
                params = (AlignmentParams.from_list(self.config.alignment_params)
                          if self.config.alignment_params
                          else AlignmentParams())
                with timer.span("Device dispatch"):
                    handle = score_pairs_async(all_pairs, params, self.scorer)
                s = self.stats
                s.num_dispatches += handle.n_dispatches
                s.bytes_dispatched += handle.n_bytes
                s.cells_launched += handle.n_cells_launched
                s.cells_real += handle.n_cells_real
            self._inflight = (list(self._pending), slices, handle)
            self._pending.clear()

    def _complete_inflight(self):
        """Materialize the in-flight window's scores (the host sync), run
        posteriors, finalize calls and write VCF records."""
        if self._inflight is None:
            return
        window, slices, handle = self._inflight
        self._inflight = None
        with self.timer.span("Genotyping"):
            self._finalize_window(window, slices, handle)
        if self.log_flush is not None:
            # bound buffered-stderr loss to one window: a killed run keeps
            # its "which locus was in flight" evidence
            self.log_flush()

    def _finalize_window(self, window, slices, handle):
        """The body of :meth:`_complete_inflight`, inside its Genotyping
        span."""
        timer = self.timer
        if handle is not None:
            with timer.span("Device sync wait"):
                scores = handle.result()
                self.stats.num_syncs += 1
        cfg = self.config
        for (gt, pairs, ok, _group), sl in zip(window, slices):
            if ok and sl is not None:
                lo, n = sl
                gt._pool_scores = scores[lo: lo + n].reshape(gt._request_shape)
        # With a mesh or LONGTR_DEVICE_POSTERIOR=1: the pruning-decision
        # posteriors of the whole window in one batched call on the device,
        # or one on each shard of the mesh (each locus's reduction stays on
        # one device, so the results do not depend on the mesh size).  Final
        # VCF numbers are always recomputed host-side in f64 (genotyper.cpp
        # parity) inside genotype_finalize.
        initial = {}
        if (self.mesh is not None
                or os.environ.get("LONGTR_DEVICE_POSTERIOR") == "1"):
            from longtr_tpu_torch.ops.posterior import batched_posteriors
            live = [(i, gt) for i, (gt, _p, ok, _g) in enumerate(window) if ok]
            if live:
                with timer.span("Device posterior"):
                    results = batched_posteriors(
                        [gt.posterior_request() for _i, gt in live],
                        self.device, mesh=self.mesh)
                    initial = {i: res for (i, _gt), res in zip(live, results)}
        for idx, (gt, pairs, ok, group) in enumerate(window):
            if not ok:
                self.stats.num_genotype_fail += 1
                continue
            with timer.span("Call finalize"):
                called = gt.genotype_finalize(initial_posterior=initial.get(idx))
            if called:
                self.stats.num_genotype_success += 1
                with timer.span("VCF write"):
                    write_vcf_record(gt, self.samples_to_genotype,
                                     cfg.output_flags(), self.vcf_writer,
                                     self.sel_log)
                    if self.viz_out is not None:
                        from longtr_tpu_torch.pipeline.viz import write_viz_record
                        for region in group.regions:
                            write_viz_record(self.viz_out, region,
                                             gt.sample_names,
                                             list(gt.sample_label), gt.alns,
                                             chrom_seq=gt.chrom_seq)
            else:
                self.stats.num_genotype_fail += 1
            self._checkpoint_mark(group)
        for gt, *_rest in window:
            for name, n in gt.mode_b_counts.items():
                setattr(self.stats, name, getattr(self.stats, name) + n)

    def metrics(self) -> dict:
        """Structured run metrics (counters + stage timings in seconds)."""
        s = self.stats
        return {
            "loci_processed": s.loci_processed,
            "num_too_long": s.num_too_long,
            "too_few_reads": s.too_few_reads,
            "too_many_reads": s.too_many_reads,
            "num_em_converge": s.num_em_converge,
            "num_em_fail": s.num_em_fail,
            "num_missing_models": s.num_missing_models,
            "num_genotype_success": s.num_genotype_success,
            "num_genotype_fail": s.num_genotype_fail,
            "num_dispatches": s.num_dispatches,
            "bytes_dispatched": s.bytes_dispatched,
            "num_syncs": s.num_syncs,
            "cells_launched": s.cells_launched,
            "cells_real": s.cells_real,
            "reads_from_columns": s.reads_from_columns,
            "reads_fallback": s.reads_fallback,
            "mode_b_loci": s.mode_b_loci,
            "mode_b_reads": s.mode_b_reads,
            "mode_b_elements_real": s.mode_b_elements_real,
            "mode_b_elements_launched": s.mode_b_elements_launched,
            "mode_b_host_reads": s.mode_b_host_reads,
            "stage_seconds": self.timer.snapshot(),
        }

    # ------------------------------------------------------------------
    def finish(self):
        self._flush_pending()
        with self.timer.span("Pass close"):
            if self.vcf_writer.is_open:
                self.vcf_writer.close()
            if self.stutter_out_fh:
                self.stutter_out_fh.close()
            if self.viz_out is not None:
                self.viz_out.close()
            if self.pass_bam is not None:
                self.pass_bam.close()
            if self.filt_bam is not None:
                self.filt_bam.close()
            if self._checkpoint_fh is not None:
                self._checkpoint_fh.close()
        s = self.stats
        self.full_log(
            "\n------LongTR-TPU Execution Summary------\n"
            f"Skipped {s.num_too_long} loci above the length threshold\n"
            f"Skipped {s.too_many_reads} loci with too many reads\n"
            f"Skipped {s.too_few_reads} loci with too few reads\n"
            f"Genotyping succeeded for {s.num_genotype_success}/"
            f"{s.num_genotype_success + s.num_genotype_fail} loci\n"
            + self.timer.summary())
