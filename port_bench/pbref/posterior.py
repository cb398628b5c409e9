"""Genotype posteriors in float64 and the VCF's per-sample genotype fields.

Each read's phasing priors come from its HP tag (snp_bam_processor.cpp's
rules for a haplotagged BAM).  Reads' log-likelihoods against each candidate haplotype go in (clamped at
-600, each read weighted by its haplotype-1/haplotype-2 phasing factors);
out come the (S, A, A) log posteriors and, per sample, the called
haplotype pair, the allele pair, Q (unphased posterior), PQ (phased
posterior) and GLDIFF (genotyper.cpp:21-256 and mathops.cpp).
"""

from __future__ import annotations

import math

import numpy as np

LL_CLAMP = -600.0
LOG_ONE_HALF = math.log(0.5)
LOG_E_BASE_10 = 0.4342944819
TOLERANCE = 1e-10
LOG_THRESH = math.log(0.001)
NEG_HALF_DBL_MAX = -8.988465674311579e307


FROM_HAP_LL = -0.000001
OTHER_HAP_LL = -1000.0
MAX_UNPHASED_SHARE = 0.2


def phasing_priors(label, hp):
    """(log_p1, log_p2) of a locus's reads from their samples and HP tags
    (1, 2, or -1 for none).  A read of haplotype h gets FROM_HAP_LL for h
    and OTHER_HAP_LL for the other, unless its sample's phasing is
    dropped: taking the samples in the order their reads first come, with
    the reads, haplotype-1 and haplotype-2 reads counted over every sample
    so far, phasing is dropped for the sample where more than a fifth of
    the reads counted are untagged or either haplotype has at most one
    read, and for every later sample; a dropped or untagged read gets 0
    and 0 (snp_bam_processor.cpp:141-237)."""
    label, hp = np.asarray(label), np.asarray(hp)
    p1, p2 = np.zeros(len(hp)), np.zeros(len(hp))
    total = h1 = h2 = 0
    dropped = False
    for s in dict.fromkeys(label.tolist()):
        mine = label == s
        total += int(mine.sum())
        h1 += int((hp[mine] == 1).sum())
        h2 += int((hp[mine] == 2).sum())
        if (total - h1 - h2) / total > MAX_UNPHASED_SHARE or h1 <= 1 \
                or h2 <= 1:
            dropped = True
        if not dropped:
            tagged = mine & (hp > 0)
            p1[tagged] = np.where(hp[tagged] == 1, FROM_HAP_LL, OTHER_HAP_LL)
            p2[tagged] = np.where(hp[tagged] == 2, FROM_HAP_LL, OTHER_HAP_LL)
    return p1, p2


def int_log(val: int) -> float:
    return -1000.0 if val <= 0 else math.log(val)


def log_priors(A: int, haploid: bool) -> np.ndarray:
    if haploid:
        homo, het = -int_log(A), NEG_HALF_DBL_MAX
    else:
        homo = int_log(2) - int_log(A) - int_log(A + 1)
        het = -int_log(A) - int_log(A + 1)
    prior = np.full((A, A), het)
    np.fill_diagonal(prior, homo)
    return prior


def posteriors(LL, log_p1, log_p2, sample_label, num_samples, haploid):
    """((S, A, A) normalized log posteriors, (S,) total log-likelihoods)."""
    LL = np.maximum(np.asarray(LL, dtype=np.float64), LL_CLAMP)
    A = LL.shape[1]
    a = LL + np.asarray(log_p1)[:, None] + LOG_ONE_HALF
    b = LL + np.asarray(log_p2)[:, None] + LOG_ONE_HALF
    T = np.logaddexp(a[:, :, None], b[:, None, :])
    P = np.tile(log_priors(A, haploid)[None], (num_samples, 1, 1))
    np.add.at(P, np.asarray(sample_label), T)
    flat = P.reshape(num_samples, -1)
    m = flat.max(axis=1)
    totals = m + np.log(np.exp(flat - m[:, None]).sum(axis=1))
    return P - totals[:, None, None], totals


def _lse2(a, b):
    if a > b:
        return a + math.log(1.0 + math.exp(b - a))
    return b + math.log(1.0 + math.exp(a - b))


def _fast_lse2(x, y):
    hi, lo = (x, y) if x > y else (y, x)
    diff = lo - hi
    if diff < LOG_THRESH:
        return hi
    return hi + math.log1p(math.exp(diff))


def genotype_fields(P, totals, h2a, V, haploid):
    """Per sample: (allele pair, Q, PQ, GLDIFF) of the called genotype."""
    S, A, _ = P.shape
    h2a = np.asarray(h2a)
    flat = np.argmax(P.reshape(S, -1), axis=1)
    best_haps = [(int(i // A), int(i % A)) for i in flat]
    best_gts = [(int(h2a[a]), int(h2a[b])) for a, b in best_haps]
    maxv = np.full((S, V * V), NEG_HALF_DBL_MAX)
    totv = np.zeros((S, V * V))
    for a1 in range(A):
        for a2 in range(A):
            g = V * int(h2a[a1]) + int(h2a[a2])
            lv = P[:, a1, a2]
            le = lv <= maxv[:, g]
            totv[le, g] += np.exp(lv[le] - maxv[le, g])
            gt = ~le
            totv[gt, g] = totv[gt, g] * np.exp(maxv[gt, g] - lv[gt]) + 1.0
            maxv[gt, g] = lv[gt]
    with np.errstate(divide="ignore"):
        T = (maxv + np.log(totv)).reshape(S, V, V)
    hom = -int_log(A) if haploid else int_log(2) - int_log(A) - int_log(A + 1)
    het = 0.0 if haploid else -int_log(A) - int_log(A + 1)
    nconfig = (int_log(2) + int_log(A) - int_log(V) if haploid
               else int_log(2) + 2 * (int_log(A) - int_log(V)))
    out = []
    for s, (ga, gb) in enumerate(best_gts):
        pq = T[s, ga, gb]
        q = pq if ga == gb else _lse2(T[s, ga, gb], T[s, gb, ga])
        gls = []
        for i1 in range(V):
            for i2 in range(V):
                if i2 <= i1 and (not haploid or i1 == i2):
                    corr = (hom if i1 == i2 else het) + nconfig
                    gls.append((totals[s] - corr
                                + _fast_lse2(T[s, i1, i2], T[s, i2, i1]))
                               * LOG_E_BASE_10)
        gls = np.array(gls)
        out.append(((ga, gb), math.exp(q), math.exp(pq),
                    _gl_diff(gls, ga, gb, A, haploid)))
    return out


def _gl_diff(gls, gt_a, gt_b, A, haploid):
    if A == 1:
        return -1000.0
    max_gl = gls.max()
    others = gls[gls < max_gl]
    second = others.max() if others.size else max_gl
    if haploid:
        idx = gt_a
    else:
        mn, mx = min(gt_a, gt_b), max(gt_a, gt_b)
        idx = mx * (mx + 1) // 2 + mn
    if abs(max_gl - gls[idx]) < TOLERANCE:
        return max_gl - second
    return gls[idx] - max_gl
