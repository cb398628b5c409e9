"""Phased-SNP-VCF phasing factors.

Reference: src/snp_tree.{h,cpp} + src/snp_phasing_quality.{h,cpp} +
SNPBamProcessor::process_reads (snp_bam_processor.cpp:52-92).

Per sample: a position-query structure over its phased heterozygous SNPs in
the locus window (excluding SNPs within SKIP_PADDING=15bp of the TR and,
with a pedigree, sites failing Mendelian checks), then per read a
base-quality-weighted log P(read | hap1) / log P(read | hap2).  The
reference's interval tree is a balanced position tree; a sorted array with
bisect range queries is semantically identical.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from longtr_tpu_torch.utils.base_quality import log_prob_correct, log_prob_error


@dataclass(frozen=True)
class SNP:
    pos: int          # 0-based
    base_one: str
    base_two: str


class SNPTree:
    """Sorted het-SNP set with range queries (snp_tree.h:44-138 semantics)."""

    def __init__(self, snps):
        self.snps = sorted(snps, key=lambda s: s.pos)
        self._pos = [s.pos for s in self.snps]

    def find_contained(self, start: int, stop: int):
        """SNPs with start <= pos <= stop."""
        lo = bisect.bisect_left(self._pos, start)
        hi = bisect.bisect_right(self._pos, stop)
        return self.snps[lo:hi]


def is_biallelic_snp(variant) -> bool:
    return (len(variant.alleles) == 2 and len(variant.alleles[0]) == 1
            and len(variant.alleles[1]) == 1)


def in_any_region(variant, skip_regions, skip_padding: int) -> bool:
    for region in skip_regions:
        if (variant.pos + 1 >= region.start - skip_padding
                and variant.pos + 1 <= region.stop + skip_padding):
            return True
    return False


def create_snp_trees(chrom: str, start: int, end: int, skip_regions,
                     skip_padding: int, snp_vcf, tracker=None, logger=None):
    """Returns (ok, sample_indices, trees) (snp_tree.cpp:25-113).

    The reference queries tabix with the 1-BASED inclusive region
    "chrom:start-end" (vcf_reader.h:222-227), i.e. 0-based
    [start-1, end); our VCFReader.set_region takes 0-based [start, end),
    so the equivalent call passes start - 1 (clamped).
    """
    if not snp_vcf.set_region(chrom, max(0, start - 1), end):
        return False, {}, []
    samples = snp_vcf.get_samples()
    sample_indices = {s: i for i, s in enumerate(samples)}
    snps_by_sample = [[] for _ in samples]
    bad_sites_by_family = None
    if tracker is not None:
        bad_sites_by_family = [set() for _ in tracker.families]
    locus_count = 0
    while True:
        variant = snp_vcf.get_next_variant()
        if variant is None:
            break
        if not is_biallelic_snp(variant) or \
                in_any_region(variant, skip_regions, skip_padding):
            continue
        if tracker is not None:
            for fi, family in enumerate(tracker.families):
                if family.is_missing_genotype(variant) or \
                        not family.is_mendelian(variant):
                    bad_sites_by_family[fi].add(variant.pos + 1)
        locus_count += 1
        for i, name in enumerate(samples):
            gt = variant.genotype(name)
            if gt is None or gt[1] is None or not gt[2]:
                continue
            ga, gb, _ = gt
            if ga != gb:
                snps_by_sample[i].append(
                    SNP(variant.pos, variant.alleles[ga][0],
                        variant.alleles[gb][0]))
    if logger:
        logger(f"Region contained a total of {locus_count} valid SNPs")

    if tracker is not None:
        from longtr_tpu_torch.denovo.scanner import (MAX_BEST_SCORE,
                                               MIN_SECOND_BEST_SCORE)
        filt = unfilt = 0
        for fi, family in enumerate(tracker.families):
            mat, pat = [], []
            good = tracker.infer_haplotype_inheritance(
                family, MAX_BEST_SCORE, MIN_SECOND_BEST_SCORE, mat, pat,
                bad_sites_by_family[fi])
            for sname in family.samples:
                si = sample_indices.get(sname)
                if si is None:
                    continue
                filt += len(snps_by_sample[si])
                if not good:
                    snps_by_sample[si] = []
                else:
                    snps_by_sample[si] = [
                        s for s in snps_by_sample[si]
                        if s.pos + 1 not in bad_sites_by_family[fi]]
                filt -= len(snps_by_sample[si])
                unfilt += len(snps_by_sample[si])
        if logger:
            logger(f"Removed {filt} out of {filt + unfilt} het SNP calls due "
                   f"to pedigree uncertainties or inconsistencies")

    trees = [SNPTree(s) for s in snps_by_sample]
    return True, sample_indices, trees


def extract_bases_and_qualities(rec, snps):
    """Read base+qual at each overlapped SNP (snp_phasing_quality.cpp:4-61)."""
    bases, quals = [], []
    pos = rec.pos
    snp_index = cigar_index = base_index = 0
    cigar = rec.cigar
    while snp_index < len(snps) and cigar_index < len(cigar):
        op, num = cigar[cigar_index]
        if op in "M=X":
            if snps[snp_index].pos < pos + num:
                bases.append(rec.seq[snps[snp_index].pos - pos + base_index])
                quals.append(rec.qual[snps[snp_index].pos - pos + base_index])
                snp_index += 1
            else:
                pos += num
                base_index += num
                cigar_index += 1
        elif op == "D":
            if snps[snp_index].pos < pos + num:
                bases.append("-")
                quals.append("-")
                snp_index += 1
            else:
                pos += num
                cigar_index += 1
        elif op == "I":
            base_index += num
            cigar_index += 1
        elif op == "S":
            if snps[snp_index].pos < pos:
                bases.append("-")
                quals.append("-")
                snp_index += 1
            else:
                base_index += num
                cigar_index += 1
        elif op == "H":
            cigar_index += 1
        else:
            raise ValueError("Invalid CIGAR option encountered")
    assert len(bases) == len(snps) and snp_index == len(snps)
    return bases, quals


def add_log_phasing_probs(rec, tree: SNPTree, counts):
    """(log_p1, log_p2) contribution of one read (snp_phasing_quality.cpp:64-96)."""
    log_p1 = log_p2 = 0.0
    snps = tree.find_contained(rec.pos, rec.end_pos - 1)
    if snps:
        bases, quals = extract_bases_and_qualities(rec, snps)
        for snp, b, q in zip(snps, bases, quals):
            if b == "-":
                continue
            if b == snp.base_one:
                log_p1 += log_prob_correct(q)
                log_p2 += log_prob_error(q)
                counts["p1_match"] += 1
            elif b == snp.base_two:
                log_p1 += log_prob_error(q)
                log_p2 += log_prob_correct(q)
                counts["p2_match"] += 1
            else:
                log_p1 += log_prob_error(q)
                log_p2 += log_prob_error(q)
                counts["mismatch"] += 1
    return log_p1, log_p2


def snp_vcf_factors(snp_vcf, paired_by_rg, mates_by_rg, unpaired_by_rg,
                    rg_names, region_group, config, logger=None, tracker=None):
    """The SNP-VCF branch of SNPBamProcessor::process_reads
    (snp_bam_processor.cpp:52-103)."""
    start = region_group.start
    window_start = start - config.max_mate_dist if start > config.max_mate_dist else 1
    ok, sample_indices, trees = create_snp_trees(
        region_group.chrom, window_start, region_group.stop + config.max_mate_dist,
        region_group.regions, config.skip_padding, snp_vcf, tracker, logger)

    alignments = []
    log_p1s, log_p2s = [], []
    counts = {"p1_match": 0, "p2_match": 0, "mismatch": 0}
    for i, name in enumerate(rg_names):
        alns = list(paired_by_rg[i]) + list(unpaired_by_rg[i])
        alignments.append(alns)
        if ok and name in sample_indices:
            tree = trees[sample_indices[name]]
            p1s, p2s = [], []
            for j, rec in enumerate(paired_by_rg[i]):
                a1, b1 = add_log_phasing_probs(rec, tree, counts)
                a2, b2 = add_log_phasing_probs(mates_by_rg[i][j], tree, counts)
                p1s.append(a1 + a2)
                p2s.append(b1 + b2)
            for rec in unpaired_by_rg[i]:
                a, b = add_log_phasing_probs(rec, tree, counts)
                p1s.append(a)
                p2s.append(b)
        else:
            p1s = [0.0] * len(alns)
            p2s = [0.0] * len(alns)
        log_p1s.append(p1s)
        log_p2s.append(p2s)

    if logger:
        phased = sum(1 for s1, s2 in zip(log_p1s, log_p2s)
                     for a, b in zip(s1, s2) if a != b)
        total = sum(len(s) for s in log_p1s)
        logger(f"Phased SNPs add info for {phased} out of {total} reads")
    return alignments, log_p1s, log_p2s
