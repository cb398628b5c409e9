"""Sequence-based STR genotyper — the per-locus engine.

Port of :mod:`longtr_tpu.pipeline.seq_genotyper`.  Pair scoring goes
through a *scorer* callable that the pipeline builds around its device
(:func:`longtr_tpu_torch.ops.pairhmm.pairhmm_batch_auto`); on a card the
scores stay there until :meth:`ScoreHandle.result`, the one sync of a
window.  Mode B (``--stutter-align-len``) scores through
:mod:`longtr_tpu_torch.pipeline.mode_b` on the same device.

Reference: src/seq_stutter_genotyper.{h,cpp} (SeqStutterGenotyper).  Flow per
locus (seq_stutter_genotyper.cpp:599-665):

1. pool identical read sequences (ReadPooler; read_pooler.{h,cpp}) and give
   pools per-position median base qualities,
2. build candidate haplotypes (build_haplotype, :416-482),
3. align every pool against every haplotype — here one batched pair-HMM
   launch instead of the reference's per-read gray-code loop
   (calc_hap_aln_probs, :508-563),
4. combine mate-pair LLs (:542-559), compute diplotype posteriors in f64,
5. iteratively drop alleles with no MAP calls and recompute (:636-660),
6. (flank reassembly — structurally present; with the default
   ``skip_assembly`` the reference's loop collects nothing
   (:76-97) and the non-default path depends on mode-B traceback that is
   gutted upstream (HapAligner.cpp:601-810), so this is a no-op here too).

The haplotype/read trimming geometry for alignment reproduces
``HapAligner::trim_alignment`` (HapAligner.cpp:346-465) and the fixed
``REF_FLANK_LEN - INDEL_FLANK_LEN`` haplotype clip (HapAligner.cpp:245-246).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from longtr_tpu_torch.haplotype.blocks import Haplotype
from longtr_tpu_torch.haplotype.generator import HaplotypeGenerator, REF_FLANK_LEN
from longtr_tpu_torch.ops import pairhmm
from longtr_tpu_torch.ops.posterior import genotype_log_priors


class ReadPooler:
    """Dedupe identical read sequences (read_pooler.{h,cpp})."""

    def __init__(self):
        self.pooled_alns = []       # representative Alignment per pool
        self.quals_by_pool = []
        self._seq_to_pool = {}
        self.pooled = False

    @property
    def num_pools(self):
        return len(self.pooled_alns)

    def add_alignment(self, aln) -> int:
        assert not self.pooled
        idx = self._seq_to_pool.get(aln.sequence)
        if idx is None:
            idx = len(self.pooled_alns)
            self._seq_to_pool[aln.sequence] = idx
            import copy
            rep = copy.copy(aln)
            rep.name = "READPOOL"
            rep.base_qualities = ""
            self.pooled_alns.append(rep)
            self.quals_by_pool.append([aln.base_qualities])
        else:
            self.quals_by_pool[idx].append(aln.base_qualities)
        return idx

    def pool(self):
        """Per-position upper-median base quality (base_quality.cpp:11-28)."""
        for i, rep in enumerate(self.pooled_alns):
            quals = self.quals_by_pool[i]
            if not quals or not quals[0]:
                rep.base_qualities = ""
                continue
            if len(quals) == 1:
                # the common case (unique read sequence): the upper median
                # of one string is itself
                rep.base_qualities = quals[0]
                continue
            arr = np.array([np.frombuffer(q.encode(), dtype=np.uint8)
                            for q in quals])
            arr = np.sort(arr, axis=0)
            rep.base_qualities = arr[len(quals) // 2].tobytes().decode()
        self.pooled = True


def trim_read_for_hapalign(aln, repeat_start: int, repeat_end: int,
                           indel_flank_len: int) -> str:
    """Trim a read to repeat±INDEL_FLANK_LEN (HapAligner.cpp:346-465).

    Run-level arithmetic — equivalent to the reference's base-at-a-time
    CIGAR walk (property-tested in tests/test_trim_oracle.py); matters
    because real HiFi reads are 10-25kb and this runs per read per locus.
    """
    padding = indel_flank_len
    min_read_start = repeat_start - padding
    max_read_stop = repeat_end + padding
    start_pos = aln.start + 1
    end_pos = aln.stop + 1
    ltrim = rtrim = 0
    cigar = [list(c) for c in aln.cigar]

    # phase 1: consume front until start_pos > min_read_start
    ci = 0
    while start_pos <= min_read_start and ci < len(cigar):
        op, n = cigar[ci]
        if op in "M=X":
            take = min(n, min_read_start - start_pos + 1)
            ltrim += take
            start_pos += take
        elif op == "D":
            take = min(n, min_read_start - start_pos + 1)
            start_pos += take
        elif op in "IS":
            take = n
            ltrim += n
        elif op == "H":
            take = n
        else:
            raise ValueError("Invalid CIGAR in trim_read_for_hapalign")
        if take == n:
            ci += 1
        else:
            cigar[ci][1] = n - take
    cigar = cigar[ci:]

    # phase 2: walk the padding window; deletions give trimmed bases back
    mid = start_pos
    ci = 0
    hi_bound = min_read_start + padding
    while mid > min_read_start and mid <= hi_bound and ci < len(cigar):
        op, n = cigar[ci]
        if op in "M=X":
            take = min(n, hi_bound - mid + 1)
            mid += take
        elif op == "D":
            take = min(n, hi_bound - mid + 1)
            ltrim -= take
            mid += take
        elif op in "ISH":
            take = n
        else:
            raise ValueError("Invalid CIGAR in trim_read_for_hapalign")
        if take == n:
            ci += 1
        else:
            cigar[ci][1] = n - take
    cigar = cigar[ci:]

    # phase 3: consume back until end_pos <= max_read_stop
    ci = len(cigar)
    while end_pos > max_read_stop and ci > 0:
        op, n = cigar[ci - 1]
        if op in "M=X":
            take = min(n, end_pos - max_read_stop)
            rtrim += take
            end_pos -= take
        elif op == "D":
            take = min(n, end_pos - max_read_stop)
            end_pos -= take
        elif op in "IS":
            take = n
            rtrim += n
        elif op == "H":
            take = n
        else:
            raise ValueError("Invalid CIGAR in trim_read_for_hapalign")
        if take == n:
            ci -= 1
        else:
            cigar[ci - 1][1] = n - take
    cigar = cigar[:ci]

    # phase 4: back padding window
    mid = end_pos
    ci = len(cigar)
    lo_bound = max_read_stop - padding
    while mid > lo_bound and mid <= max_read_stop and ci > 0:
        op, n = cigar[ci - 1]
        if op in "M=X":
            take = min(n, mid - lo_bound)
            mid -= take
        elif op == "D":
            take = min(n, mid - lo_bound)
            rtrim -= take
            mid -= take
        elif op in "ISH":
            take = n
        else:
            raise ValueError("Invalid CIGAR in trim_read_for_hapalign")
        if take == n:
            ci -= 1
        else:
            cigar[ci - 1][1] = n - take

    ltrim = max(ltrim, 0)
    rtrim = max(rtrim, 0)
    seq = aln.sequence
    assert ltrim + rtrim <= len(seq)
    return seq[ltrim: len(seq) - rtrim]


def _bucket(n: int, step: int = 64) -> int:
    """Round a sequence length up to a bucket of 64.

    Sized for XLA recompiles in the JAX package; a hand kernel has none to
    bound, so this and BATCH_LADDER are kept only until they are measured
    again on the card."""
    return ((n + step - 1) // step) * step


# Batch-size ladder, carried over from the JAX package (bottom rung = the
# Pallas batch tile).  Batches larger than the top rung are chunked.
BATCH_LADDER = (128, 256, 2048, 8192, 65536)


def _gather(chunks) -> list:
    """Host float64 arrays of chunk scores.

    A chunk is a host array, a tensor, or a list of them (the shards of
    ``pairhmm_batch_sharded``, in order), which may lie on several
    devices.  The tensors still on a device are copied to the host with
    one device-to-host copy per device."""
    parts = [c if isinstance(c, list) else [c] for c in chunks]
    by_dev = {}
    for p in parts:
        for s in p:
            if isinstance(s, torch.Tensor) and s.device.type != "cpu":
                by_dev.setdefault(s.device, []).append(s)
    host = {}
    for on_dev in by_dev.values():
        flat = torch.cat(on_dev).cpu().numpy()
        for s, v in zip(on_dev, np.split(
                flat, np.cumsum([len(s) for s in on_dev])[:-1])):
            host[id(s)] = v
    out = []
    for p in parts:
        vals = [host[id(s)] if id(s) in host else
                s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
                for s in p]
        out.append(np.concatenate(vals).astype(np.float64, copy=False))
    return out


class ScoreHandle:
    """Pair-HMM work enqueued on the device, not yet synced.

    Kernels on a card return at enqueue, so between
    :func:`score_pairs_async` and :meth:`result` the card computes while the
    host prepares the next locus window (the double-buffered flush in
    pipeline/processor.py).
    """

    __slots__ = ("_pending", "_out", "n_dispatches", "n_bytes")

    def __init__(self, pending, out, n_bytes=0):
        self._pending = pending
        self._out = out
        self.n_dispatches = len(pending)
        self.n_bytes = n_bytes

    def result(self) -> np.ndarray:
        """Materialize all chunk scores (the only host sync; one copy per
        device the chunks lie on)."""
        if self._pending is not None:
            vals = _gather([scores for _sel, scores in self._pending])
            for (sel, _s), v in zip(self._pending, vals):
                self._out[sel] = v[: len(sel)]
            self._pending = None
        return self._out


def score_pairs_async(pairs, params=None, scorer=None) -> ScoreHandle:
    """Enqueue scoring for a flat list of (hap_seq, read_seq, full_hap_len)
    triplets WITHOUT waiting for results.

    Encodes, pads (length-bucketed + batch ladder) and hands each padded
    batch to ``scorer(hap, hap_lens, read, read_lens, full_lens, params)``
    (by default :func:`~longtr_tpu_torch.ops.pairhmm.pairhmm_batch_auto` on
    the CPU).
    This is the single funnel every locus's alignment work goes through, so
    the cross-locus scheduler can fuse many loci into one call and overlap
    device compute with the next window's host work.
    """
    if not pairs:
        return ScoreHandle([], np.zeros(0))
    params = params or pairhmm.AlignmentParams()
    scorer = scorer or pairhmm.pairhmm_batch_auto
    B = len(pairs)
    out = np.empty(B, dtype=np.float64)
    # Group pairs into geometric length classes so one long-TR locus in the
    # fused window doesn't pad every short pair to its DP size (a 3kb VNTR
    # mixed into a window of 20bp STRs is a ~1000x cell blowup otherwise).
    classes = {}
    for idx, (h, r, _fl) in enumerate(pairs):
        key = max(64, 1 << (max(len(h), len(r), 1) - 1).bit_length())
        classes.setdefault(key, []).append(idx)
    # dispatch every chunk before materializing any result so the device
    # queue pipelines across chunks (one host sync at the end, not per chunk)
    pending = []
    n_bytes = 0
    for key in sorted(classes):
        idxs = classes[key]
        n_max = _bucket(max(max(len(pairs[i][0]) for i in idxs), 1))
        m_max = _bucket(max(max(len(pairs[i][1]) for i in idxs), 1))
        lo = 0
        for take, Bpad in _plan_chunks(len(idxs)):
            sel = idxs[lo: lo + take]
            lo += take
            hap_codes = np.zeros((Bpad, n_max), dtype=np.uint8)
            read_codes = np.zeros((Bpad, m_max), dtype=np.uint8)
            hap_lens = np.ones(Bpad, dtype=np.int32)
            read_lens = np.ones(Bpad, dtype=np.int32)
            full_lens = np.ones(Bpad, dtype=np.int32)
            for i, k in enumerate(sel):
                h, r, fl = pairs[k]
                hap_codes[i, : len(h)] = np.frombuffer(h.encode(),
                                                       dtype=np.uint8)
                read_codes[i, : len(r)] = np.frombuffer(r.encode(),
                                                        dtype=np.uint8)
                hap_lens[i] = len(h)
                read_lens[i] = len(r)
                full_lens[i] = fl
            n_bytes += hap_codes.nbytes + read_codes.nbytes + 12 * Bpad
            scores = scorer(hap_codes, hap_lens, read_codes, read_lens,
                            full_lens, params)
            pending.append((sel, scores))
    return ScoreHandle(pending, out, n_bytes)


def score_pairs(pairs, params=None, scorer=None):
    """Synchronous wrapper: enqueue + materialize in one call."""
    return score_pairs_async(pairs, params, scorer).result()


def _plan_chunks(B: int):
    """Split B pairs into ladder-sized chunks, minimizing padding.

    Returns [(take, padded_size), ...].  A rung whose padding exceeds 1.5x
    the remainder is replaced by completely filling the next rung down, so
    e.g. 21218 dispatches as 2x8192 + 2x2048 + 2x256 + 226->256 (1.001x
    padded) instead of one 65536 batch (3.1x).
    """
    plan = []
    rem = B
    top = BATCH_LADDER[-1]
    while rem > 0:
        if rem >= top:
            plan.append((top, top))
            rem -= top
            continue
        cover = next(r for r in BATCH_LADDER if r >= rem)
        fillable = [r for r in BATCH_LADDER if r <= rem]
        if fillable and cover > 1.5 * rem:
            take = fillable[-1]
            plan.append((take, take))
            rem -= take
        else:
            plan.append((rem, cover))
            rem = 0
    return plan


class HapAligner:
    """Scores pooled reads × haplotypes with the batched pair-HMM."""

    def __init__(self, haplotype: Haplotype, indel_flank_len: int,
                 alignment_params=None, scorer=None):
        self.haplotype = haplotype
        self.scorer = scorer or pairhmm.pairhmm_batch_auto
        self.indel_flank_len = indel_flank_len
        self.params = (pairhmm.AlignmentParams.from_list(alignment_params)
                       if alignment_params else pairhmm.AlignmentParams())
        rb = [b for b in haplotype.blocks if b.repeat_info is not None]
        self.repeat_start = rb[0].start
        self.repeat_end = rb[0].end
        clip = REF_FLANK_LEN - indel_flank_len
        self.hap_seqs = haplotype.all_seqs()
        self.full_lens = [len(s) for s in self.hap_seqs]
        self.trimmed = [s[clip: len(s) - clip] if len(s) > 2 * clip else ""
                        for s in self.hap_seqs]

    def _fallback_seq(self) -> str:
        first = self.haplotype.blocks[0].get_seq(0)
        last = self.haplotype.blocks[-1].get_seq(0)
        return first[-5:] + last[:5]

    def pair_request(self, pooled_alns, hap_subset=None):
        """Raw (hap_seq, read_seq, full_len) triplets for pools × haps.

        Used by the cross-locus batch scheduler to fuse many loci into one
        launch.
        """
        haps = list(hap_subset if hap_subset is not None
                    else range(len(self.trimmed)))
        reads = []
        for aln in pooled_alns:
            seq = trim_read_for_hapalign(aln, self.repeat_start,
                                         self.repeat_end, self.indel_flank_len)
            if len(seq) == 0:
                seq = self._fallback_seq()
            reads.append(seq)
        pairs = []
        for r in reads:
            for h in haps:
                pairs.append((self.trimmed[h], r, self.full_lens[h]))
        return pairs, len(reads), len(haps)

    def score_pools(self, pooled_alns, hap_subset=None) -> np.ndarray:
        """Returns (num_pools, num_haps) float64 log scores."""
        haps = hap_subset if hap_subset is not None else range(len(self.trimmed))
        haps = list(haps)
        reads = []
        for aln in pooled_alns:
            seq = trim_read_for_hapalign(aln, self.repeat_start,
                                         self.repeat_end, self.indel_flank_len)
            if len(seq) == 0:
                seq = self._fallback_seq()
            reads.append(seq)
        n_max = _bucket(max(max((len(self.trimmed[h]) for h in haps), default=1), 1))
        m_max = _bucket(max(max((len(r) for r in reads), default=1), 1))
        P, H = len(reads), len(haps)
        hap_codes = np.zeros((H, n_max), dtype=np.uint8)
        hap_lens = np.zeros(H, dtype=np.int32)
        full_lens = np.zeros(H, dtype=np.int32)
        for k, h in enumerate(haps):
            hap_codes[k] = pairhmm.encode_seq(self.trimmed[h], n_max)
            hap_lens[k] = len(self.trimmed[h])
            full_lens[k] = self.full_lens[h]
        read_codes = np.zeros((P, m_max), dtype=np.uint8)
        read_lens = np.zeros(P, dtype=np.int32)
        for k, r in enumerate(reads):
            read_codes[k] = pairhmm.encode_seq(r, m_max)
            read_lens[k] = len(r)
        # batch = outer product pools × haps; chunk through the batch ladder
        bi = np.repeat(np.arange(P), H)
        bj = np.tile(np.arange(H), P)
        B = len(bi)
        out = np.empty(B, dtype=np.float64)
        pending = []
        lo = 0
        for take, Bpad in _plan_chunks(B):
            hi = lo + take
            ci, cj = bi[lo:hi], bj[lo:hi]
            if Bpad != take:
                pad = Bpad - take
                ci = np.concatenate([ci, np.zeros(pad, dtype=ci.dtype)])
                cj = np.concatenate([cj, np.zeros(pad, dtype=cj.dtype)])
            scores = self.scorer(
                hap_codes[cj], hap_lens[cj], read_codes[ci], read_lens[ci],
                full_lens[cj], self.params)
            pending.append((lo, hi, scores))
            lo = hi
        vals = _gather([scores for _lo, _hi, scores in pending])
        for (lo, hi, _s), v in zip(pending, vals):
            out[lo:hi] = v[: hi - lo]
        return out.reshape(P, H)


class SeqStutterGenotyper:
    def __init__(self, region_group, haploid: bool, alns, log_p1s, log_p2s,
                 n_p1s, n_p2s, sample_names, chrom_seq: str, stutter_models,
                 ref_vcf=None, logger=None, skip_assembly: bool = True,
                 indel_flank_len: int = 5, switch_old_align_len: int = 0,
                 alignment_params=None, scorer=None, device=None,
                 mode_b_scorer=None):
        self.region_group = region_group
        self.scorer = scorer
        self.device = device              # where mode B runs its row DP
        self.mode_b_scorer = mode_b_scorer
        self.haploid = haploid
        self.alns = alns
        self.sample_names = list(sample_names)
        self.sample_indices = {s: i for i, s in enumerate(sample_names)}
        self.chrom_seq = chrom_seq
        self.ref_vcf = ref_vcf
        self.logger = logger or (lambda *a: None)
        self.skip_assembly = skip_assembly
        self.indel_flank_len = indel_flank_len
        self.switch_old_align_len = switch_old_align_len
        self.alignment_params = alignment_params
        self.n_p1s, self.n_p2s = n_p1s, n_p2s

        # Flatten phasing factors / sample labels (Genotyper ctor semantics)
        self.log_p1 = np.array([p for sample in log_p1s for p in sample])
        self.log_p2 = np.array([p for sample in log_p2s for p in sample])
        self.sample_label = np.array(
            [i for i, sample in enumerate(log_p1s) for _ in sample],
            dtype=np.int32)
        self.num_reads = len(self.alns)
        self.num_samples = len(sample_names)
        assert self.num_reads == len(self.log_p1)

        # Pool reads; detect second mates (init, seq_stutter_genotyper.cpp:484-506)
        self.pooler = ReadPooler()
        self.pool_index = np.zeros(self.num_reads, dtype=np.int32)
        self.second_mate = np.zeros(self.num_reads, dtype=bool)
        prev_name = None
        for i, aln in enumerate(alns):
            self.pool_index[i] = self.pooler.add_alignment(aln)
            self.second_mate[i] = (aln.name == prev_name)
            prev_name = aln.name
        self.read_weights = np.where(self.second_mate, 0, 1)

        self.call_sample = [""] * self.num_samples
        self.haplotype = None
        self.num_alleles = 0
        self.log_aln_probs = None        # (num_reads, A)
        self.posteriors = None           # (S, A, A)
        self.sample_total_lls = None
        self.initialized = self._build_haplotype(stutter_models)

    # ------------------------------------------------------------------
    def _build_haplotype(self, stutter_models) -> bool:
        """build_haplotype (seq_stutter_genotyper.cpp:416-482)."""
        if self.num_reads == 0:
            return False
        min_start = min(a.start for a in self.alns)
        max_stop = max(a.stop for a in self.alns)
        gen = HaplotypeGenerator(min_start, max_stop, self.indel_flank_len)
        regions = self.region_group.regions
        for ridx, region in enumerate(regions):
            by_sample = [[] for _ in range(self.num_samples)]
            for i, aln in enumerate(self.alns):
                if aln.use_for_hap_generation(ridx):
                    by_sample[self.sample_label[i]].append(aln)
            vcf_alleles = []
            if self.ref_vcf is not None:
                from longtr_tpu_torch.io.vcf_input import read_vcf_alleles
                ok, pos, vcf_alleles = read_vcf_alleles(self.ref_vcf, region)
                if not ok:
                    self.logger("Haplotype construction failed: alleles not in ref VCF")
                    return False
                if not gen.add_vcf_haplotype_block(pos, self.chrom_seq,
                                                   vcf_alleles,
                                                   stutter_models[ridx]):
                    self.logger("Haplotype construction failed: " + gen.failure_msg)
                    return False
            else:
                if not gen.add_haplotype_block(region, self.chrom_seq, by_sample,
                                               vcf_alleles, stutter_models[ridx]):
                    self.logger("Haplotype construction failed: " + gen.failure_msg)
                    return False
        if not gen.fuse_haplotype_blocks(self.chrom_seq):
            self.logger("Haplotype construction failed: " + gen.failure_msg)
            return False
        self.haplotype = gen.get_haplotype()
        self.num_alleles = self.haplotype.num_combs()
        self.haplotype.print_block_structure(35, 100, self.logger)
        return True

    # ------------------------------------------------------------------
    def _use_mode_b(self) -> bool:
        """Legacy stutter HMM gate (HapAligner.cpp:552-555): period == 1 and
        --stutter-align-len set."""
        if not self.switch_old_align_len:
            return False
        rb = [b for b in self.haplotype.blocks if b.repeat_info is not None]
        return bool(rb) and rb[0].period == 1

    def _mode_b_scores(self, deferred: bool = False):
        """Mode-B scoring of all pools (HapAligner::process_reads short path).

        Reads without a valid seed get an all-zero LL row
        (HapAligner.cpp:570-574); their seed position is recorded as -1.

        With ``deferred=True``, the host phase (seed calc + all table
        building) runs now — safe inside a locus build worker — and the
        device row DP + marginalization is stored as
        ``self._mode_b_finish`` for the scheduler to call on the main
        thread; returns None in that case.  ``--ref-fidelity``,
        ``LONGTR_MODE_B_HOST=1`` and configs outside the row tables'
        envelope score on the host in f64 instead.
        """
        from longtr_tpu_torch.utils import mathops
        from longtr_tpu_torch.ops.mode_b_device import mode_b_elements_scored
        from longtr_tpu_torch.pipeline.mode_b import (ModeBAligner,
                                                      calc_seed_base)
        aligner = ModeBAligner(self.haplotype, self.alignment_params,
                               device=self.device, cols_fn=self.mode_b_scorer)
        hap_start = self.haplotype.blocks[0].start
        hap_end = self.haplotype.blocks[-1].end
        A = self.haplotype.num_combs()
        pools = self.pooler.pooled_alns
        scores = np.zeros((len(pools), A))
        self.pool_seed_positions = np.full(len(pools), -1, dtype=np.int64)
        for p, aln in enumerate(pools):
            seed = calc_seed_base(aln, aligner.repeat_starts,
                                  aligner.repeat_ends, hap_start, hap_end)
            self.pool_seed_positions[p] = seed
        valid = np.flatnonzero(self.pool_seed_positions >= 0)
        self.seed_positions = self.pool_seed_positions[self.pool_index]
        prep = None
        if len(valid) and not mathops.ref_fidelity() \
                and os.environ.get("LONGTR_MODE_B_HOST", "") != "1":
            # One device call for all (read, config) pairs; the f64 host
            # path remains the reference-fidelity / envelope scorer.
            prep = aligner.score_reads_batch_prepare(
                [pools[p] for p in valid],
                [int(self.pool_seed_positions[p]) for p in valid])
        if prep is not None:
            if deferred:
                def _finish():
                    scores[valid] = aligner.score_reads_batch_finish(prep)
                    return scores
                self._mode_b_finish = _finish
                return None
            scores[valid] = aligner.score_reads_batch_finish(prep)
        else:
            mode_b_elements_scored["host_f64"] += len(valid) * A * 2
            for p in valid:
                scores[p] = aligner.score_read(
                    pools[p], int(self.pool_seed_positions[p]))
        return scores

    def _calc_posteriors(self):
        """Posterior on host in float64 (genotyper.cpp:45-83 uses doubles).

        The per-locus tensors are tiny (R×A²); host numpy avoids a device
        round-trip.
        """
        from longtr_tpu_torch.utils import mathops
        from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF
        prior = genotype_log_priors(self.num_alleles, self.haploid)
        # The reference clamps the LL array IN PLACE as it reads it
        # (genotyper.cpp:57-58; SURVEY §7.5) — downstream per-read stats
        # (strand pick, MALLREADS) must see the clamped values too, else a
        # -700 band-abort sentinel flips their comparisons.
        np.maximum(self.log_aln_probs, -600.0, out=self.log_aln_probs)
        LL = self.log_aln_probs
        a = LL + self.log_p1[:, None] + LOG_ONE_HALF
        b = LL + self.log_p2[:, None] + LOG_ONE_HALF
        if mathops.ref_fidelity():
            # the reference's literal log(exp+exp) (genotyper.cpp:60) —
            # bit-identical to the compiled kernel (safe: clamp keeps the
            # exponent above double underflow)
            T = np.log(np.exp(a[:, :, None]) + np.exp(b[:, None, :]))
        else:
            T = np.logaddexp(a[:, :, None], b[:, None, :])
        P = np.tile(prior[None], (self.num_samples, 1, 1))
        np.add.at(P, self.sample_label, T)
        flat = P.reshape(self.num_samples, -1)
        m = flat.max(axis=1)
        totals = m + np.log(np.exp(flat - m[:, None]).sum(axis=1))
        P -= totals[:, None, None]
        self.posteriors = P
        self.sample_total_lls = totals
        return float(totals.sum())

    def get_optimal_haplotypes(self):
        S, A = self.num_samples, self.num_alleles
        flat = np.argmax(self.posteriors.reshape(S, -1), axis=1)
        return [(int(i // A), int(i % A)) for i in flat]

    # ------------------------------------------------------------------
    def _get_unused_alleles(self, check_called=True):
        """Alleles with no MAP calls (:250-308). Returns per-block index lists."""
        haps = self.get_optimal_haplotypes()
        aligned_read = np.zeros(self.num_samples, dtype=bool)
        aligned_read[self.sample_label] = True
        out = []
        n_blocks = n_alleles = 0
        for bi in range(self.haplotype.num_blocks()):
            out.append([])
            block = self.haplotype.get_block(bi)
            if block.num_options() == 1:
                continue
            h2a = self.haplotype.haps_to_alleles(bi)
            called = [False] * block.num_options()
            for s, (a, b) in enumerate(haps):
                if aligned_read[s] and self.call_sample[s] == "":
                    called[h2a[a]] = True
                    called[h2a[b]] = True
            affected = False
            for ai in range(1, block.num_options()):
                if check_called and not called[ai]:
                    out[-1].append(ai)
                    affected = True
                    n_alleles += 1
            if affected:
                n_blocks += 1
        return out, n_blocks, n_alleles

    def _remove_alleles(self, allele_indices):
        """Rebuild blocks without the given alleles; remap LLs (:310-409).

        Scores for retained haplotypes are copied (our kernel is a pure
        function of (read, hap) so copy == recompute); only novel haplotype
        sequences would need realignment.
        """
        old_seqs = {seq: i for i, seq in enumerate(self.haplotype.all_seqs())}
        new_blocks = [blk.remove_alleles(allele_indices[i])
                      for i, blk in enumerate(self.haplotype.blocks)]
        new_hap = Haplotype(new_blocks)
        new_A = new_hap.num_combs()
        mapping = np.full(new_A, -1, dtype=np.int64)
        realign = []
        for j, seq in enumerate(new_hap.all_seqs()):
            old = old_seqs.get(seq)
            if old is None:
                realign.append(j)
            else:
                mapping[j] = old
        new_LL = np.full((self.num_reads, new_A), -100000.0)
        keep = mapping >= 0
        new_LL[:, keep] = self.log_aln_probs[:, mapping[keep]]
        self.haplotype = new_hap
        self.num_alleles = new_A
        self.log_aln_probs = new_LL
        if realign:
            if self._use_mode_b():
                sub = self._mode_b_scores()[:, realign]
            else:
                aligner = HapAligner(self.haplotype, self.indel_flank_len,
                                     self.alignment_params, self.scorer)
                sub = aligner.score_pools(self.pooler.pooled_alns,
                                          hap_subset=realign)
            LLsub = sub[self.pool_index]
            for i in np.flatnonzero(self.second_mate):
                tot = LLsub[i - 1] + LLsub[i]
                LLsub[i - 1] = tot
                LLsub[i] = tot
            self.log_aln_probs[:, realign] = LLsub
        self._calc_posteriors()

    # ------------------------------------------------------------------
    def genotype_prepare(self, max_total_haplotypes=1000):
        """Pre-alignment phase: gates + pooling + pair-batch request.

        Returns (ok, request) where ``request`` is (pairs, P, H) destined for
        the pair scorer, or None in mode B, whose device work the scheduler
        runs through ``self._mode_b_finish``.  The cross-locus scheduler
        fuses requests from many loci into one launch before calling
        :meth:`genotype_finalize`.
        """
        if not self.initialized:
            return False, None
        if self.haplotype.num_combs() > max_total_haplotypes:
            self.logger(f"Aborting genotyping: too many candidate haplotypes "
                        f"({self.haplotype.num_combs()} > {max_total_haplotypes})")
            return False, None
        if not self.skip_assembly:
            from longtr_tpu_torch.haplotype.debruijn import calc_kmer_length
            for bi in (0, self.haplotype.num_blocks() - 1):
                ref_seq = self.haplotype.get_block(bi).get_seq(0)
                max_k = min(15, len(ref_seq) - 1 if ref_seq else -1)
                if calc_kmer_length(ref_seq, 10, max_k) is None:
                    self.logger("Aborting genotyping: flank too repetitive")
                    return False, None
        self.pooler.pool()
        if self._use_mode_b():
            # host phase only; the scheduler calls self._mode_b_finish
            # (device row DP + marginalization) on the main thread
            r = self._mode_b_scores(deferred=True)
            if r is not None:
                self._pool_scores = r
            return True, None
        self._aligner = HapAligner(self.haplotype, self.indel_flank_len,
                                   self.alignment_params, self.scorer)
        pairs, P, H = self._aligner.pair_request(self.pooler.pooled_alns)
        self._request_shape = (P, H)
        return True, pairs

    def posterior_request(self, pool_scores=None):
        """Finish LL fan-out and expose the posterior inputs for the batched
        device call (ops.posterior.batched_posteriors)."""
        if pool_scores is not None:
            self._pool_scores = np.asarray(pool_scores).reshape(
                self._request_shape)
        LL = self._pool_scores[self.pool_index]
        for i in np.flatnonzero(self.second_mate):
            tot = LL[i - 1] + LL[i]
            LL[i - 1] = tot
            LL[i] = tot
        self.log_aln_probs = LL
        return {"log_aln_probs": self.log_aln_probs, "log_p1": self.log_p1,
                "log_p2": self.log_p2, "sample_label": self.sample_label,
                "num_samples": self.num_samples, "haploid": self.haploid}

    def genotype_finalize(self, pool_scores=None,
                          initial_posterior=None) -> bool:
        """Post-alignment phase: LL fan-out, posteriors, allele pruning.

        ``initial_posterior``: optional (P (S,A,A), totals (S,)) computed by
        the batched device call; used for the allele-pruning decision.
        The FINAL posterior numbers are always recomputed host-side in
        float64 (genotyper.cpp:45-83 parity).
        """
        if self.log_aln_probs is None or pool_scores is not None:
            self.posterior_request(pool_scores)
        if initial_posterior is not None:
            P, totals = initial_posterior
            self.posteriors = np.asarray(P, dtype=np.float64)
            self.sample_total_lls = np.asarray(totals, dtype=np.float64)
        else:
            self._calc_posteriors()
        pruned = False
        if self.ref_vcf is None:
            unused, n_blocks, n_alleles = self._get_unused_alleles()
            if n_alleles:
                self.logger(f"Recomputing posteriors after removing {n_alleles} "
                            f"uncalled alleles across {n_blocks} blocks")
                self._remove_alleles(unused)   # ends with host-f64 posteriors
                pruned = True
        if initial_posterior is not None and not pruned:
            self._calc_posteriors()            # final f64 refinement
        # Flank reassembly: no-op under the default configuration (see module
        # docstring); retained as a hook for the assembly workstream.
        return True

    def genotype(self, max_total_haplotypes=1000, max_flank_haplotypes=4,
                 min_flank_freq=0.01) -> bool:
        """Main entry (seq_stutter_genotyper.cpp:599-665)."""
        ok, pairs = self.genotype_prepare(max_total_haplotypes)
        if not ok:
            return False
        # Mode-B prepare defers the device work for the cross-locus
        # scheduler; a direct genotype() call must run it here.
        fin = getattr(self, "_mode_b_finish", None)
        if fin is not None:
            self._pool_scores = fin()
            self._mode_b_finish = None
        if pairs is not None:
            self.logger("Aligning reads to each candidate haplotype")
            self._pool_scores = score_pairs(
                pairs, self._aligner.params,
                self.scorer).reshape(self._request_shape)
        return self.genotype_finalize()
