"""Genotype/likelihood extraction from diplotype posteriors.

Reference: ``Genotyper::extract_genotypes_and_likelihoods``
(src/genotyper.cpp:132-256) plus calc_PLs / calc_gl_diff (102-130).

Port of :mod:`longtr_tpu.models.genotyper`; only the import of
``NEG_HALF_DBL_MAX`` differs.  The (S, A, A) posterior tensor comes from the
genotyper's host f64 path; this module marginalizes haplotypes to variants
and derives the VCF fields (GT, Q, PQ, GL, PL, GLDIFF, PHASEDGL) host-side in
float64 — these are O(S·A²) and string-bound, not worth a device trip.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from longtr_tpu_torch.ops.posterior import NEG_HALF_DBL_MAX
from longtr_tpu.utils.mathops import (LOG_E_BASE_10, TOLERANCE,
                                      fast_log_sum_exp2, int_log,
                                      log_sum_exp2)


def log_homozygous_prior(num_alleles: int, haploid: bool) -> float:
    if haploid:
        return -int_log(num_alleles)
    return int_log(2) - int_log(num_alleles) - int_log(num_alleles + 1)


def log_heterozygous_prior(num_alleles: int, haploid: bool) -> float:
    if haploid:
        return NEG_HALF_DBL_MAX  # -DBL_MAX/2 (genotyper.cpp:31)
    return -int_log(num_alleles) - int_log(num_alleles + 1)


def calc_pls(gls: np.ndarray) -> np.ndarray:
    """Phred-scaled likelihoods capped at 999 (genotyper.cpp:102-107)."""
    max_gl = gls.max()
    return np.minimum(999, (-10 * (gls - max_gl)).astype(int))


def calc_gl_diff(gls: np.ndarray, gt_a: int, gt_b: int, num_alleles: int,
                 haploid: bool) -> float:
    """genotyper.cpp:109-130."""
    if num_alleles == 1:
        return -1000.0
    max_gl = gls.max()
    others = gls[gls < max_gl]
    second_gl = others.max() if others.size else max_gl
    if haploid:
        gl_index = gt_a
    else:
        mn, mx = min(gt_a, gt_b), max(gt_a, gt_b)
        gl_index = mx * (mx + 1) // 2 + mn
    if abs(max_gl - gls[gl_index]) < TOLERANCE:
        return max_gl - second_gl
    return gls[gl_index] - max_gl


@dataclass
class GenotypeExtraction:
    best_haplotypes: list            # per-sample (hap_a, hap_b)
    best_gts: list                   # per-sample (variant_a, variant_b)
    log_phased_posteriors: np.ndarray
    log_unphased_posteriors: np.ndarray
    hap_log_phased_posteriors: np.ndarray
    hap_log_unphased_posteriors: np.ndarray
    gls: list = field(default_factory=list)          # per-sample np arrays
    gl_diffs: np.ndarray = None
    pls: list = field(default_factory=list)
    phased_gls: list = field(default_factory=list)


def extract_genotypes_and_likelihoods(
        posteriors: np.ndarray, sample_total_lls: np.ndarray,
        hap_to_allele, num_variants: int, haploid: bool,
        calc_gls: bool = True, want_pls: bool = False,
        calc_phased_gls: bool = False) -> GenotypeExtraction:
    """Transcription of genotyper.cpp:132-256 in vectorized numpy.

    posteriors: (S, A, A) normalized log posteriors (device output, any float)
    hap_to_allele: (A,) mapping haplotype index -> variant index
    """
    P = np.asarray(posteriors, dtype=np.float64)
    S, A, _ = P.shape
    h2a = np.asarray(hap_to_allele)
    V = num_variants

    # ML haplotype pair per sample (first max in scan order)
    flat_idx = np.argmax(P.reshape(S, -1), axis=1)
    best_haps = [(int(i // A), int(i % A)) for i in flat_idx]
    best_gts = [(int(h2a[a]), int(h2a[b])) for a, b in best_haps]

    # Marginalize haplotype pairs -> variant pairs with the reference's
    # STREAMING log-sum-exp in hap-pair scan order (genotyper.cpp:153-170,
    # mathops.cpp:73-86) — bit-identical, vectorized over samples.
    maxv = np.full((S, V * V), NEG_HALF_DBL_MAX)
    totv = np.zeros((S, V * V))
    for a1 in range(A):
        g_base = V * int(h2a[a1])
        for a2 in range(A):
            g = g_base + int(h2a[a2])
            lv = P[:, a1, a2]
            le = lv <= maxv[:, g]
            totv[le, g] += np.exp(lv[le] - maxv[le, g])
            gt = ~le
            totv[gt, g] = totv[gt, g] * np.exp(maxv[gt, g] - lv[gt]) + 1.0
            maxv[gt, g] = lv[gt]
    with np.errstate(divide="ignore"):
        T = (maxv + np.log(totv)).reshape(S, V, V)

    hap_phased = np.array([P[s, a, b] for s, (a, b) in enumerate(best_haps)])
    # genotyper.cpp:181 uses fast_log_sum_exp here (term-dropping; Mineiro
    # bit patterns in fidelity mode) — unlike :196 below which is exact.
    hap_unphased = np.array([
        P[s, a, b] if a == b else fast_log_sum_exp2(P[s, a, b], P[s, b, a])
        for s, (a, b) in enumerate(best_haps)])

    log_phased = np.array([T[s, ga, gb] for s, (ga, gb) in enumerate(best_gts)])
    # exact log_sum_exp in the reference (genotyper.cpp:196, mathops.cpp:53)
    log_unphased = np.array([
        T[s, ga, gb] if ga == gb else log_sum_exp2(T[s, ga, gb], T[s, gb, ga])
        for s, (ga, gb) in enumerate(best_gts)])

    out = GenotypeExtraction(best_haps, best_gts, log_phased, log_unphased,
                             hap_phased, hap_unphased)

    if calc_gls or calc_phased_gls or want_pls:
        hom_corr = log_homozygous_prior(A, haploid)
        het_corr = 0.0 if haploid else log_heterozygous_prior(A, haploid)
        if haploid:
            gl_nconfig = int_log(2) + int_log(A) - int_log(V)
            pgl_nconfig = int_log(A) - int_log(V)
        else:
            gl_nconfig = int_log(2) + 2 * (int_log(A) - int_log(V))
            pgl_nconfig = 2 * (int_log(A) - int_log(V))

        gls = [[] for _ in range(S)]
        pgls = [[] for _ in range(S)]
        for i1 in range(V):
            for i2 in range(V):
                gl_corr = (hom_corr if i1 == i2 else het_corr) + gl_nconfig
                pgl_corr = (hom_corr if i1 == i2 else het_corr) + pgl_nconfig
                for s in range(S):
                    if i2 <= i1 and (not haploid or i1 == i2):
                        # fast_log_sum_exp in the reference (genotyper.cpp:232)
                        v = (sample_total_lls[s] - gl_corr
                             + fast_log_sum_exp2(T[s, i1, i2], T[s, i2, i1]))
                        gls[s].append(v * LOG_E_BASE_10)
                    if calc_phased_gls and (not haploid or i1 == i2):
                        pgls[s].append((sample_total_lls[s] - pgl_corr
                                        + T[s, i1, i2]) * LOG_E_BASE_10)
        out.gls = [np.array(g) for g in gls]
        out.gl_diffs = np.array([
            calc_gl_diff(out.gls[s], best_gts[s][0], best_gts[s][1], A, haploid)
            for s in range(S)])
        if want_pls:
            out.pls = [calc_pls(g) for g in out.gls]
        if calc_phased_gls:
            out.phased_gls = [np.array(g) for g in pgls]
        if not calc_gls:
            out.gls = []
    return out
