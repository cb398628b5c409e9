"""Candidate-allele discovery and haplotype-block construction.

Reference: src/SeqAlignment/HaplotypeGenerator.{h,cpp}.  Pipeline per region:

1. ``extract_sequence``: pull each spanning read's bases across
   [region-LEFT_PAD, region+RIGHT_PAD] from its expanded CIGAR
   (HaplotypeGenerator.cpp:84-165),
2. support thresholds: keep alleles with >=2 reads & >=20% of some sample,
   or >5% of samples/reads (HaplotypeGenerator.h:60-73, .cpp:295-373),
3. long-read rescue: if >25% of a sample's reads match no candidate,
   greedy edit-distance clustering refined by POA consensus, clusters
   covering >=80% of ignored reads contribute ``inexact`` alleles
   (HaplotypeGenerator.cpp:376-472),
4. ``trim``: clip shared prefix/suffix down to ~3 repeat units
   (HaplotypeGenerator.cpp:14-82),
5. ``fuse_haplotype_blocks``: interleave ref-only flank blocks capped at
   REF_FLANK_LEN=35 (HaplotypeGenerator.cpp:580-607).
"""

from __future__ import annotations

import numpy as np

from longtr_tpu_torch.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
from longtr_tpu_torch.haplotype.cluster import greedy_clustering, merge_clusters
from longtr_tpu_torch.haplotype.poa import poa_consensus
from longtr_tpu_torch.utils.stringops import order_by_length_and_sequence

# HaplotypeGenerator.h:60-73
MIN_FRAC_READS = 0.05
MIN_FRAC_SAMPLES = 0.05
MIN_FRAC_STRONG_SAMPLE = 0.2
MIN_READS_STRONG_SAMPLE = 2
MIN_STRONG_SAMPLES = 1
MIN_BLOCK_SPACING = 10
REF_FLANK_LEN = 35

CLUSTER_THRESHOLDS = [20, 50, 80, 100, 150, 200, 300, 400, 500, 600, 700]


class HapGenerationError(Exception):
    pass


def extract_sequence(aln, region_start: int, region_end: int):
    """Read bases across [region_start, region_end) from expanded CIGAR.

    Returns (ok, seq). Transcription of HaplotypeGenerator.cpp:84-165.
    """
    if aln.deleted:
        return True, ""
    if aln.start >= region_start or aln.stop <= region_end:
        return False, ""
    align_index = 0
    pos = aln.start
    chunks = []
    cigar = aln.cigar
    ci = 0
    char_index = 0
    while ci < len(cigar):
        op, num = cigar[ci]
        if char_index == num:
            ci += 1
            char_index = 0
            continue
        if pos > region_end:
            return True, "".join(chunks).upper()
        if pos == region_end:
            if op == "I":
                chunks.append(aln.alignment[align_index: align_index + num])
                align_index += num
                ci += 1
                char_index = 0
                continue
            return True, "".join(chunks).upper()
        if pos >= region_start:
            num_bases = min(region_end - pos, num - char_index)
            if op == "I":
                num_bases = num
                chunks.append(aln.alignment[align_index: align_index + num_bases])
            elif op in "=XM":
                chunks.append(aln.alignment[align_index: align_index + num_bases])
                pos += num_bases
            elif op == "D":
                pos += num_bases
            else:
                raise ValueError("Invalid CIGAR char in extract_sequence: " + op)
            align_index += num_bases
            char_index += num_bases
        else:
            if op == "I":
                num_bases = num - char_index
            else:
                num_bases = min(region_start - pos, num - char_index)
                pos += num_bases
            align_index += num_bases
            char_index += num_bases
    raise RuntimeError("Logical error in extract_sequence")


def trim_sequences(ideal_min_length: int, region_start: int, region_end: int,
                   sequences, left_pad: int, right_pad: int):
    """Clip shared prefix/suffix (HaplotypeGenerator.cpp:14-82).

    ``sequences`` is a list of (seq, inexact) with the ref first; returns
    (new_start, new_end, new_sequences).
    """
    min_len = min(len(s) for s, _ in sequences)
    if min_len <= ideal_min_length:
        return region_start, region_end, sequences

    # shared-prefix/suffix scan (value-identical to the scalar char walk of
    # HaplotypeGenerator.cpp:24-37): max_left/right = length of the prefix/
    # suffix common to ALL sequences, capped at min_len - ideal_min_length
    cap = min_len - ideal_min_length
    if cap * len(sequences) < 4096:
        # short-STR loci: the scalar walk beats numpy's per-array overhead
        max_left = 0
        while max_left < cap:
            ch = sequences[0][0][max_left]
            if any(s[max_left] != ch for s, _ in sequences[1:]):
                break
            max_left += 1
        max_right = 0
        while max_right < cap:
            ch = sequences[0][0][len(sequences[0][0]) - 1 - max_right]
            if any(s[len(s) - 1 - max_right] != ch for s, _ in sequences[1:]):
                break
            max_right += 1
        return _trim_finish(ideal_min_length, region_start, region_end,
                            sequences, left_pad, right_pad, min_len,
                            max_left, max_right)
    ref_b = sequences[0][0].encode()
    ref_pre = np.frombuffer(ref_b[:cap], dtype=np.uint8)
    ref_suf = np.frombuffer(ref_b[len(ref_b) - cap:], dtype=np.uint8)[::-1]
    max_left = max_right = cap
    for s, _ in sequences[1:]:
        if max_left == 0 and max_right == 0:
            break
        sb = s.encode()
        if max_left:
            neq = ref_pre[:max_left] != np.frombuffer(sb[:max_left],
                                                      dtype=np.uint8)
            hit = int(np.argmax(neq))
            if neq[hit]:
                max_left = hit
        if max_right:
            neq = ref_suf[:max_right] != np.frombuffer(
                sb[len(sb) - max_right:], dtype=np.uint8)[::-1]
            hit = int(np.argmax(neq))
            if neq[hit]:
                max_right = hit

    return _trim_finish(ideal_min_length, region_start, region_end,
                        sequences, left_pad, right_pad, min_len,
                        max_left, max_right)


def _trim_finish(ideal_min_length, region_start, region_end, sequences,
                 left_pad, right_pad, min_len, max_left, max_right):
    """Pad clamping + final clip (HaplotypeGenerator.cpp:39-82)."""
    max_left = min(left_pad, max_left)
    max_right = min(right_pad, max_right)
    max_left = max(0, min(min_len - right_pad, max_left))
    max_right = max(0, min(min_len - left_pad, max_right))

    if min_len - 2 * min(max_left, max_right) <= ideal_min_length:
        left = right = min(max_left, max_right)
        while min_len - left - right < ideal_min_length:
            if left > right:
                left -= 1
            else:
                right -= 1
    else:
        if max_left > max_right:
            right = max_right
            left = min(max_left, min_len - ideal_min_length - max_right)
        else:
            left = max_left
            right = min(max_right, min_len - ideal_min_length - max_left)

    new_seqs = [(s[left: len(s) - right], inx) for s, inx in sequences]
    return region_start + left, region_end - right, new_seqs


def gen_candidate_seqs(ref_seq: str, ideal_min_length: int, alignments_by_sample,
                       vcf_alleles, region_start: int, region_end: int,
                       left_pad: int, right_pad: int):
    """Candidate allele list (HaplotypeGenerator.cpp:295-482).

    Returns (new_start, new_end, [(seq, inexact), ...]) with ref first.
    """
    sample_counts = {}
    read_counts = {}
    must_inc = {}
    tot_reads = 0
    tot_samples = 0
    per_sample_seqs = []   # cache: per sample list of extracted seqs

    for reads in alignments_by_sample:
        samp_reads = 0
        counts = {}
        extracted = []
        for aln in reads:
            ok, subseq = extract_sequence(aln, region_start, region_end)
            if ok:
                read_counts[subseq] = read_counts.get(subseq, 0) + 1
                counts[subseq] = counts.get(subseq, 0) + 1
                tot_reads += 1
                samp_reads += 1
                extracted.append(subseq)
        per_sample_seqs.append(extracted)
        for seq, cnt in counts.items():
            if cnt >= MIN_READS_STRONG_SAMPLE and cnt >= MIN_FRAC_STRONG_SAMPLE * samp_reads:
                must_inc[seq] = must_inc.get(seq, 0) + 1
            sample_counts[seq] = sample_counts.get(seq, 0) + cnt / samp_reads
        if samp_reads > 0:
            tot_samples += 1

    sequences = []   # (seq, inexact)
    ref_index = -1
    for i, va in enumerate(vcf_alleles):
        sequences.append((va, False))
        sample_counts.pop(va, None)
        read_counts.pop(va, None)
        must_inc.pop(va, None)
        if va == ref_seq:
            ref_index = i

    for seq, nsamp in sorted(must_inc.items()):
        if nsamp >= MIN_STRONG_SAMPLES:
            sample_counts.pop(seq, None)
            read_counts.pop(seq, None)
            sequences.append((seq, False))
            if seq == ref_seq:
                ref_index = len(sequences) - 1

    for seq, scount in sorted(sample_counts.items()):
        if (scount > MIN_FRAC_SAMPLES * tot_samples * 2
                or read_counts.get(seq, 0) > MIN_FRAC_READS * tot_reads * 2):
            sequences.append((seq, False))
            if ref_index == -1 and seq == ref_seq:
                ref_index = len(sequences) - 1

    if ref_index == -1:
        sequences.insert(0, (ref_seq, False))
    else:
        sequences[ref_index] = sequences[0]
        sequences[0] = (ref_seq, False)

    # Long-read rescue: cluster + POA for samples with many unexplained reads
    def _rescue_sample(item):
        """Threshold-ladder clustering for one sample; returns the ordered
        centroid candidates of the first threshold that explains >=80% of
        the sample's unexplained reads (empty if none does)."""
        not_added, tot_ignored = item
        # the reference collects the skipped sequences from a std::map, so
        # unique[0] — the one element exempt from the (len, seq) sort — is
        # the LEXICOGRAPHICALLY smallest, not the first-encountered read
        # (HaplotypeGenerator.cpp:398-404)
        unique = sorted(not_added.keys())
        if len(unique) > 1:
            unique = [unique[0]] + order_by_length_and_sequence(unique[1:])
        for t in CLUSTER_THRESHOLDS:
            clusters = greedy_clustering(unique, t)
            if clusters is None:
                continue
            not_converged = True
            while not_converged:
                updated = {}
                new_centroids = []
                # reference iterates the cluster std::map lexicographically
                # (HaplotypeGenerator.cpp:425-437); new_centroids[0] — the
                # element exempt from the (len, seq) sort — must be the
                # consensus of the lexicographically smallest centroid
                member_lists = [v for _, v in sorted(clusters.items())]
                from longtr_tpu_torch.utils.workers import in_locus_worker
                if len(member_lists) > 1 and not in_locus_worker():
                    # independent per-cluster POA; the native DP releases
                    # the GIL, so clusters run on all cores.  Results are
                    # folded back in the original cluster order, so the
                    # output is identical to the sequential loop.
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(
                            max_workers=min(4, len(member_lists))) as pool:
                        consensuses = list(pool.map(poa_consensus,
                                                    member_lists))
                else:
                    consensuses = [poa_consensus(m) for m in member_lists]
                for members, consensus in zip(member_lists, consensuses):
                    if consensus not in updated:
                        new_centroids.append(consensus)
                        updated[consensus] = list(members)
                    else:
                        updated[consensus].extend(members)
                if len(new_centroids) > 1:
                    new_centroids = [new_centroids[0]] + \
                        order_by_length_and_sequence(new_centroids[1:])
                not_converged = merge_clusters(new_centroids, updated, t)
                clusters = updated
            new_seqs_added = 0
            potential = []
            for centroid, members in sorted(clusters.items()):
                cluster_support = sum(not_added.get(s, 0) for s in members)
                if cluster_support > min(int(tot_ignored * 0.10), 10):
                    new_seqs_added += cluster_support
                    potential.append(centroid)
            if new_seqs_added >= int(0.80 * tot_ignored):
                return potential
        return []

    cand_set = {s for s, _ in sequences}
    not_added_all = []
    for extracted in per_sample_seqs:
        not_added = {}
        samp_reads = 0
        samp_ignored = 0
        for subseq in extracted:
            samp_reads += 1
            if subseq not in cand_set:
                not_added[subseq] = not_added.get(subseq, 0) + 1
                samp_ignored += 1
        if samp_ignored > samp_reads * 0.25:
            not_added_all.append((not_added, samp_ignored))

    # Phase 1 — per-sample cluster+POA, parallel across samples (each
    # sample's clustering depends only on its own not_added reads; the
    # cand_set membership filter moves to the sequential merge below so
    # earlier samples' additions are seen exactly as in the serial loop).
    # sample-level parallelism stays on inside locus workers (the window
    # often has one dominant VNTR locus whose wall time this splits);
    # only the innermost cluster-POA/edit-batch layers serialize there.
    # The thread-local worker flag must be re-entered in pool threads.
    from longtr_tpu_torch.utils.workers import (available_cores, in_locus_worker,
                                          locus_worker_scope, spare_workers)
    _flag = in_locus_worker()

    # size the per-sample fan-out to the cores this locus can actually
    # claim right now: a lone heavy VNTR locus gets them all, a window of
    # uniformly heavy loci stays one-thread-per-locus
    my_cores = spare_workers() if _flag else available_cores()
    width = min(4, len(not_added_all), my_cores if _flag else 4)
    # the sample threads' inner layers (cluster edit-distance batches,
    # per-cluster POA) must DIVIDE this locus's cores, not each claim all
    # of them — W sample threads x all-cores inner pools thrashes the host
    inner_budget = max(1, my_cores // width) if width > 1 else None

    def _run_rescue(item):
        if _flag or inner_budget is not None:
            with locus_worker_scope(nested=True, budget=inner_budget):
                return _rescue_sample(item)
        return _rescue_sample(item)

    if width > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=width) as pool:
            rescued = list(pool.map(_run_rescue, not_added_all))
    else:
        rescued = [_run_rescue(x) for x in not_added_all]
    # Phase 2 — merge in original sample order (parity with the reference's
    # sequential loop, HaplotypeGenerator.cpp rescue path)
    for candidates in rescued:
        for centroid in candidates:
            if centroid not in cand_set:
                sequences.append((centroid, True))
                cand_set.add(centroid)

    # Sort alts by length then sequence (reference keeps ref first);
    # same total order as stringops.order_by_length_and_sequence
    head, tail = sequences[0], sequences[1:]
    tail.sort(key=lambda p: (len(p[0]), p[0]))
    sequences = [head] + tail

    return trim_sequences(ideal_min_length, region_start, region_end,
                          sequences, left_pad, right_pad)


class HaplotypeGenerator:
    """Builds the fused block haplotype for a locus."""

    def __init__(self, min_aln_start: int, max_aln_stop: int, indel_flank_len: int):
        self.min_aln_start = min_aln_start
        self.max_aln_stop = max_aln_stop
        self.left_pad = indel_flank_len
        self.right_pad = indel_flank_len
        self.hap_blocks = []
        self.failure_msg = ""

    def _fail(self, msg):
        self.failure_msg = msg
        return False

    def add_haplotype_block(self, region, chrom_seq: str, alignments_by_sample,
                            vcf_alleles, stutter_model) -> bool:
        """HaplotypeGenerator.cpp:527-578."""
        if region.start < REF_FLANK_LEN + self.left_pad or \
                region.stop + REF_FLANK_LEN + self.right_pad > len(chrom_seq):
            return self._fail("Haplotype blocks are too near to the chromosome ends")

        region_start = region.start - self.left_pad
        region_end = region.stop + self.right_pad
        ref_seq = chrom_seq[region_start: region_end].upper()

        starts = [a.start for reads in alignments_by_sample for a in reads]
        stops = [a.stop for reads in alignments_by_sample for a in reads]
        if not starts:
            return self._fail("No spanning alignments")
        if min(starts) + 5 >= region_start or max(stops) - 5 <= region_end:
            return self._fail("No spanning alignments")

        padded_vcf = []
        if vcf_alleles:
            lflank = chrom_seq[region_start: region.start].upper()
            rflank = chrom_seq[region.stop: region_end].upper()
            padded_vcf = [lflank + a.upper() + rflank for a in vcf_alleles]
            assert padded_vcf[0] == ref_seq

        ideal_min_length = 3 * region.period
        new_start, new_end, sequences = gen_candidate_seqs(
            ref_seq, ideal_min_length, alignments_by_sample, padded_vcf,
            region_start, region_end, self.left_pad, self.right_pad)

        if self.hap_blocks and new_start < self.hap_blocks[-1].end + MIN_BLOCK_SPACING:
            return self._fail("Haplotype blocks are too near to one another")

        block = RepeatBlock(new_start, new_end, sequences[0][0],
                            stutter_model.period, stutter_model)
        for seq, inexact in sequences[1:]:
            block.add_alternate(seq, inexact)
        self.hap_blocks.append(block)
        return True

    def add_vcf_haplotype_block(self, pos: int, chrom_seq: str, vcf_alleles,
                                stutter_model) -> bool:
        """Ref-VCF mode (HaplotypeGenerator.cpp:497-525)."""
        region_start = pos
        region_end = region_start + len(vcf_alleles[0])
        assert vcf_alleles[0].upper() == chrom_seq[region_start: region_end].upper()
        if region_start < REF_FLANK_LEN or region_end + REF_FLANK_LEN >= len(chrom_seq):
            return self._fail("Haplotype blocks are too near to the chromosome ends")
        if self.hap_blocks and region_start < self.hap_blocks[-1].end + MIN_BLOCK_SPACING:
            return self._fail("Haplotype blocks are too near to one another")
        block = RepeatBlock(region_start, region_end, vcf_alleles[0].upper(),
                            stutter_model.period, stutter_model)
        for a in vcf_alleles[1:]:
            block.add_alternate(a.upper(), False)
        self.hap_blocks.append(block)
        return True

    def fuse_haplotype_blocks(self, chrom_seq: str) -> bool:
        """Interleave ref-only flanks (HaplotypeGenerator.cpp:580-607)."""
        assert self.hap_blocks
        first, last = self.hap_blocks[0], self.hap_blocks[-1]
        min_start = min(first.start - 10,
                        max(first.start - REF_FLANK_LEN, self.min_aln_start))
        max_stop = max(last.end + 10,
                       min(last.end + REF_FLANK_LEN, self.max_aln_stop))
        fused = []
        start = min_start
        for blk in self.hap_blocks:
            fused.append(HapBlock(start, blk.start,
                                  chrom_seq[start: blk.start].upper()))
            fused.append(blk)
            start = blk.end
        fused.append(HapBlock(start, max_stop, chrom_seq[start: max_stop].upper()))
        self.hap_blocks = fused
        return True

    def get_haplotype(self) -> Haplotype:
        return Haplotype(self.hap_blocks)
