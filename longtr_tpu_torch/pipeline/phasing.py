"""Per-read phasing factors (log_p1/log_p2).

Reference: src/snp_bam_processor.cpp.  Three modes:

* ``--phased-bam``: HP tags (1/2) from haplotagged BAMs give each read
  FROM_HAP_LL=-1e-6 / OTHER_HAP_LL=-1000, with a per-sample guard: if >20% of
  reads are unphased or either haplotype has <=1 read, the whole sample's
  phasing is zeroed (snp_bam_processor.cpp:141-237).  NOTE the reference's
  guard flag ``not_enough_phased_reads`` is never reset between samples and
  the hap1/hap2/total counters accumulate across samples — once one sample
  trips the guard, all later samples are unphased too.  Reproduced.
* phased SNP VCF: per-sample het-SNP trees + base-quality-weighted factors
  (snp_bam_processor.cpp:52-92) — see longtr_tpu_torch.pipeline.snp_phasing.
* fallback: all zeros (no phasing information).
"""

from __future__ import annotations


def get_haplotype_tag(rec) -> int:
    hp = rec.get_tag("HP")
    if hp is None:
        return -1
    assert hp in (1, 2)
    return hp


def phased_bam_factors(paired_by_rg, mates_by_rg, unpaired_by_rg, rg_names,
                       from_hap_ll=-0.000001, other_hap_ll=-1000.0, logger=None):
    """HP-tag phasing (snp_bam_processor.cpp:141-237).

    Returns (alignments_by_rg, log_p1s, log_p2s).
    """
    alignments = []
    log_p1s, log_p2s = [], []
    total_reads = 0
    hap1_reads = 0
    hap2_reads = 0
    not_enough_phased = False
    phased_reads = 0
    for i in range(len(rg_names)):
        alns = list(paired_by_rg[i]) + list(unpaired_by_rg[i])
        alignments.append(alns)
        p1s, p2s = [], []

        pair_haps = []
        for j, rec in enumerate(paired_by_rg[i]):
            total_reads += 1
            h1 = get_haplotype_tag(rec)
            h2 = get_haplotype_tag(mates_by_rg[i][j])
            hap = h1 if h1 == h2 else -1
            pair_haps.append(hap)
            if hap == 1:
                hap1_reads += 1
            elif hap == 2:
                hap2_reads += 1
        unpaired_haps = []
        for rec in unpaired_by_rg[i]:
            total_reads += 1
            hap = get_haplotype_tag(rec)
            unpaired_haps.append(hap)
            if hap == 1:
                hap1_reads += 1
            elif hap == 2:
                hap2_reads += 1

        unphased_frac = (total_reads - hap1_reads - hap2_reads) / total_reads \
            if total_reads else 1.0
        if unphased_frac > 0.2 or hap2_reads <= 1 or hap1_reads <= 1:
            not_enough_phased = True
            if logger:
                logger(f"Skipping phasing information for sample {rg_names[i]} "
                       f"as there was many unphased reads.")

        for hap in pair_haps + unpaired_haps:
            if hap != -1 and not not_enough_phased:
                phased_reads += 1
                p1s.append(from_hap_ll if hap == 1 else other_hap_ll)
                p2s.append(from_hap_ll if hap == 2 else other_hap_ll)
            else:
                p1s.append(0.0)
                p2s.append(0.0)
        log_p1s.append(p1s)
        log_p2s.append(p2s)
    if logger:
        logger(f"Phased SNPs add info for {phased_reads} out of {total_reads} reads")
    return alignments, log_p1s, log_p2s


def unphased_factors(paired_by_rg, unpaired_by_rg):
    """All-zero factors (snp_bam_processor.cpp:93-103)."""
    alignments = []
    log_p1s, log_p2s = [], []
    for i in range(len(paired_by_rg)):
        alns = list(paired_by_rg[i]) + list(unpaired_by_rg[i])
        alignments.append(alns)
        log_p1s.append([0.0] * len(alns))
        log_p2s.append([0.0] * len(alns))
    return alignments, log_p1s, log_p2s
