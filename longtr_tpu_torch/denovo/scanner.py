"""De novo TR mutation scanning (the DenovoFinder binary's engine).

Reference: src/denovos/ — two modes:

* TrioDenovoScanner (trio_denovo_scanner.cpp): per-child test marginalizing
  parental unphased diplotypes weighted by GL, against a uniform mutation
  model; emits NOMUT/DENOVO/OTHER log10-likelihoods.
* DenovoScanner (denovo_scanner.cpp): family-joint test using PHASEDGL plus
  SNP-haplotype transmission from the HaplotypeTracker (window 500kb);
  emits CHILDREN/NOMUT/ANYMUT/DENOVO/OTHER per family.

REFERENCE QUIRK (PARITY.md ledger): the scanners accumulate LOG10-domain
values (GLs, log10 priors) with the NATURAL-base streaming log-sum-exp
(update_streaming_log_sum_exp / finish_streaming_log_sum_exp,
mathops.cpp:73-85, exp()/log()), so the emitted "log10-likelihoods" are
max + ln(sum(e^(x_i - max))) over log10 terms — a hybrid-base statistic,
not a true log10 marginal.  ANYMUT likewise flows through the Mineiro
fast_log_sum_exp chain.  We reproduce this exactly (execution-verified
against the compiled reference, tests/test_denovo_parity.py).

Two math paths per scanner:
* default — the configuration sums are vectorized with numpy in the same
  hybrid domain, WITHOUT the reference's <0.01%-contribution pruning
  (MIN_CONTRIBUTION): exact summation, FP-rounding-level equal.
* reference fidelity (LONGTR_REF_FIDELITY) — scalar transliteration of the
  reference loops: same iteration order, same streaming updates, same
  pruning gates, Mineiro bit patterns for ANYMUT; byte-identical records.
"""

from __future__ import annotations

import math

import numpy as np

from longtr_tpu_torch.io.bgzf import BgzfWriter
from longtr_tpu_torch.io.vcf_input import PhasedGL, UnphasedGL
from longtr_tpu_torch.utils import mathops

# DenovoScanner thresholds (denovo_scanner.h:17-18)
MIN_SECOND_BEST_SCORE = 100
MAX_BEST_SCORE = 10

LOG10_2 = math.log10(2)
_NEG_HALF_DBL_MAX = -1.7976931348623157e308 / 2  # -DBL_MAX/2


def _lse_hybrid(arr):
    """The reference's streaming LSE collapsed: max + ln(sum e^(x-max)) over
    log10-domain terms (mathops.cpp:73-85 quirk, see module docstring)."""
    arr = np.asarray(arr, dtype=np.float64).ravel()
    m = np.max(arr)
    if not np.isfinite(m):
        return float(m) if arr.size else -np.inf
    with np.errstate(divide="ignore"):
        return float(m + np.log(np.sum(np.exp(arr - m))))


def allele_freraw_priors(variant, families, num_alleles, use_pop: bool):
    """log10 allele frequencies (denovo_allele_priors.cpp)."""
    if not use_pop:
        return np.full(num_alleles, -math.log10(num_alleles))
    freqs = np.ones(num_alleles)
    total = float(num_alleles)
    for fam in families:
        for sample in (fam.mother, fam.father):
            gt = variant.genotype(sample)
            if gt is None:
                continue
            freqs[gt[0]] += 1
            freqs[gt[1]] += 1
            total += 2
    return np.log10(freqs / total)


def _variant_info_ints(variant):
    start = int(variant.get_info("START"))
    end = int(variant.get_info("END"))
    period = int(variant.get_info("PERIOD").split(",")[0])
    diffs = [int(x) for x in str(variant.get_info("BPDIFFS")).split(",")]
    return start, end, period, diffs


def _record_prefix(variant):
    alt = ",".join(variant.alleles[1:]) if len(variant.alleles) > 1 else "."
    start, end, period, diffs = _variant_info_ints(variant)
    info = ("BPDIFFS=" + ",".join(str(d) for d in diffs)
            + f";START={start};END={end};PERIOD={period}")
    return (f"{variant.chrom}\t{variant.pos + 1}\t{variant.vid}\t"
            f"{variant.alleles[0]}\t{alt}\t.\t.\t{info}")


def _fmt(v: float) -> str:
    """C++ fixed precision-3 ostream formatting (scanner ctors)."""
    return "%.3f" % v


class TrioDenovoScanner:
    """Per-trio scan without SNP transmission info."""

    def __init__(self, families, output_file, full_command, use_pop_priors):
        self.families = families
        self.use_pop_priors = use_pop_priors
        self.output_file = output_file
        self.out = BgzfWriter(output_file)
        self._write_header(full_command)

    def _write_header(self, full_command):
        lines = [
            "##fileformat=VCFv4.1",
            "##command=" + full_command,
            '##INFO=<ID=BPDIFFS,Number=A,Type=Integer,Description="Base pair difference of each alternate allele from the reference allele">',
            '##INFO=<ID=START,Number=1,Type=Integer,Description="Inclusive start coodinate for the repetitive portion of the reference allele">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="Inclusive end coordinate for the repetitive portion of the reference allele">',
            '##INFO=<ID=PERIOD,Number=1,Type=Integer,Description="Length of STR motif">',
            '##FORMAT=<ID=NOMUT,Number=1,Type=Float,Description="Log10-likelihood that no mutations occurred in the child">',
            '##FORMAT=<ID=DENOVO,Number=1,Type=Float,Description="Log10-likelihood that a single de novo mutation occurred in the child">',
            '##FORMAT=<ID=OTHER,Number=1,Type=Float,Description="Log10-likelihood that a single other mutation occurred in the child">',
        ]
        header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
        for fam in self.families:
            for child in fam.children:
                header += "\t" + child
        self.out.write("\n".join(lines) + "\n" + header + "\n")

    def finish(self):
        self.out.close()
        try:
            from longtr_tpu_torch.io.tabix import build_tbi
            build_tbi(self.output_file)
        except Exception:
            pass

    def scan(self, str_vcf, logger=None):
        while True:
            variant = str_vcf.get_next_variant()
            if variant is None:
                break
            A = variant.num_alleles()
            if A <= 1:
                continue
            if all(variant.genotype(s) is None for s in variant.sample_order):
                continue
            gls = UnphasedGL(variant)    # dies if GL absent, like upstream
            log_freqs = allele_freraw_priors(variant, self.families, A,
                                             self.use_pop_priors)
            log_mut_prior = -LOG10_2 - math.log10(A - 1)
            record = [_record_prefix(variant), "\tNOMUT:DENOVO:OTHER"]
            child_fn = (self._child_lls_fidelity if mathops.ref_fidelity()
                        else self._child_lls)
            for fam in self.families:
                scan = gls.has_sample(fam.mother) and gls.has_sample(fam.father)
                for child in fam.children:
                    if not scan or not gls.has_sample(child):
                        record.append("\t.")
                        continue
                    vals = child_fn(gls, fam, child, A, log_freqs,
                                    log_mut_prior)
                    record.append("\t" + ":".join(_fmt(v) for v in vals))
            self.out.write("".join(record) + "\n")

    def _child_lls(self, gls, fam, child, A, log_freqs, log_mut_prior):
        """Vectorized trio_denovo_scanner.cpp:107-186 (no pruning; hybrid
        LSE domain)."""
        small, big = np.triu_indices(A)    # unordered pairs {small <= big}
        K = len(small)

        def pair_ll(sample):
            idx = gls.sample_indices[sample]
            prior = log_freqs[small] + log_freqs[big] + \
                np.where(small == big, 0.0, LOG10_2)
            gl = np.array([gls.get_gl(idx, int(a), int(b))
                           for a, b in zip(small, big)], dtype=np.float64)
            return prior + gl

        mat_ll = pair_ll(fam.mother)      # (K,)
        pat_ll = pair_ll(fam.father)      # (K,)
        cidx = gls.sample_indices[child]
        GLc = np.empty((A, A))
        for a in range(A):
            for b in range(A):
                GLc[a, b] = gls.get_gl(cidx, min(a, b), max(a, b))

        config = mat_ll[:, None] + pat_ll[None, :] - math.log10(4)  # (K, K)
        onehot = np.zeros((K, A), dtype=bool)
        onehot[np.arange(K), small] = True
        onehot[np.arange(K), big] = True
        in_parents = onehot[:, None, :] | onehot[None, :, :]   # (K, K, A)

        no_mut_terms = []
        denovo_terms = []
        other_terms = []
        for a_sel in (big, small):         # maternal allele choice (K,)
            for b_sel in (big, small):     # paternal allele choice (K,)
                base = config + GLc[a_sel[:, None], b_sel[None, :]]
                no_mut_terms.append(base)
                # maternal mutations: replace a with m != a
                for m in range(A):
                    mut_m = config + GLc[m, b_sel][None, :] + log_mut_prior
                    valid = (a_sel != m)[:, None] & np.ones((1, K), dtype=bool)
                    is_denovo = ~in_parents[:, :, m]
                    denovo_terms.append(np.where(valid & is_denovo, mut_m, -np.inf))
                    other_terms.append(np.where(valid & ~is_denovo, mut_m, -np.inf))
                    # paternal mutations: replace b with m != b
                    mut_p = config + GLc[a_sel, m][:, None] + log_mut_prior
                    validp = np.ones((K, 1), dtype=bool) & (b_sel != m)[None, :]
                    denovo_terms.append(np.where(validp & is_denovo, mut_p, -np.inf))
                    other_terms.append(np.where(validp & ~is_denovo, mut_p, -np.inf))

        no_mut = _lse_hybrid(np.stack(no_mut_terms))
        denovo = _lse_hybrid(np.stack(denovo_terms))
        other = _lse_hybrid(np.stack(other_terms))
        return no_mut, denovo, other

    def _child_lls_fidelity(self, gls, fam, child, A, log_freqs,
                            log_mut_prior):
        """Scalar transliteration of trio_denovo_scanner.cpp:107-186:
        identical iteration order, streaming LSE updates, and the
        MIN_CONTRIBUTION pruning gates (:121-124, note the natural-log
        2*log(A+1) term in an otherwise log10 expression)."""
        upd = mathops.streaming_lse_update
        min_contrib = 4 + 3 * math.log10(A) + 2 * math.log(A + 1) + LOG10_2
        log14 = -math.log10(4)
        midx = gls.sample_indices[fam.mother]
        pidx = gls.sample_indices[fam.father]
        cidx = gls.sample_indices[child]
        nm_max, nm_tot = _NEG_HALF_DBL_MAX, 0.0
        dn_max, dn_tot = _NEG_HALF_DBL_MAX, 0.0
        ot_max, ot_tot = _NEG_HALF_DBL_MAX, 0.0
        for mat_i in range(A):
            for mat_j in range(mat_i + 1):
                mat_ll = (log_freqs[mat_j] + log_freqs[mat_i]
                          + (0.0 if mat_j == mat_i else LOG10_2)
                          + gls.get_gl(midx, mat_j, mat_i))
                for pat_i in range(A):
                    for pat_j in range(pat_i + 1):
                        pat_ll = (log_freqs[pat_j] + log_freqs[pat_i]
                                  + (0.0 if pat_j == pat_i else LOG10_2)
                                  + gls.get_gl(pidx, pat_j, pat_i))
                        config = mat_ll + pat_ll + log14
                        parental = (mat_i, mat_j, pat_i, pat_j)
                        for m_sel in range(2):
                            mat_a = mat_i if m_sel == 0 else mat_j
                            for p_sel in range(2):
                                pat_a = pat_i if p_sel == 0 else pat_j
                                nm = config + gls.get_gl(
                                    cidx, min(mat_a, pat_a), max(mat_a, pat_a))
                                nm_max, nm_tot = upd(nm, nm_max, nm_tot)
                                gate = min(dn_max, ot_max) - min_contrib
                                if (config + gls.get_max_gl_allele(cidx, pat_a)
                                        + log_mut_prior) > gate:
                                    for mut in range(A):
                                        if mut == mat_a:
                                            continue
                                        p = (config + gls.get_gl(
                                            cidx, min(mut, pat_a),
                                            max(mut, pat_a)) + log_mut_prior)
                                        if mut not in parental:
                                            dn_max, dn_tot = upd(p, dn_max, dn_tot)
                                        else:
                                            ot_max, ot_tot = upd(p, ot_max, ot_tot)
                                gate = min(dn_max, ot_max) - min_contrib
                                if (config + gls.get_max_gl_allele(cidx, mat_a)
                                        + log_mut_prior) > gate:
                                    for mut in range(A):
                                        if mut == pat_a:
                                            continue
                                        p = (config + gls.get_gl(
                                            cidx, min(mat_a, mut),
                                            max(mat_a, mut)) + log_mut_prior)
                                        if mut not in parental:
                                            dn_max, dn_tot = upd(p, dn_max, dn_tot)
                                        else:
                                            ot_max, ot_tot = upd(p, ot_max, ot_tot)
        fin = mathops.streaming_lse_finish
        return fin(nm_max, nm_tot), fin(dn_max, dn_tot), fin(ot_max, ot_tot)


class DenovoScanner:
    """Family-joint scan with SNP haplotype transmission (denovo_scanner.cpp)."""

    def __init__(self, families, output_file, full_command, use_pop_priors):
        self.families = families
        self.use_pop_priors = use_pop_priors
        self.window_size = 500_000
        self.output_file = output_file
        self.out = BgzfWriter(output_file)
        self._write_header(full_command)

    def _write_header(self, full_command):
        lines = [
            "##fileformat=VCFv4.1",
            "##command=" + full_command,
            '##INFO=<ID=BPDIFFS,Number=A,Type=Integer,Description="Base pair difference of each alternate allele from the reference allele">',
            '##INFO=<ID=START,Number=1,Type=Integer,Description="Inclusive start coodinate for the repetitive portion of the reference allele">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="Inclusive end coordinate for the repetitive portion of the reference allele">',
            '##INFO=<ID=PERIOD,Number=1,Type=Integer,Description="Length of STR motif">',
            '##FORMAT=<ID=CHILDREN,Number=.,Type=String,Description="Ordered list of children in family that were tested for mutations. Specifies order of values for AFF, DENOVO and OTHER FORMAT fields">',
            '##FORMAT=<ID=NOMUT,Number=1,Type=Float,Description="Log10-likelihood that no mutations occurred in any of the family members">',
            '##FORMAT=<ID=ANYMUT,Number=1,Type=Float,Description="Log10-likelihood that a mutation occurred in any of the family members">',
            '##FORMAT=<ID=DENOVO,Number=.,Type=Float,Description="Log10-likelihood that a single de novo mutation occurred in the family, and it occurred in the current child">',
            '##FORMAT=<ID=OTHER,Number=.,Type=Float,Description="Log10-likelihood that a single mutation occurred in the family, and it occurred in the current child. In contrast to DENOVO, the mutated allele is also present in a parental genotype">',
        ]
        header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
        for fam in self.families:
            header += "\t" + fam.family_id
        self.out.write("\n".join(lines) + "\n" + header + "\n")

    def finish(self):
        self.out.close()
        try:
            from longtr_tpu_torch.io.tabix import build_tbi
            build_tbi(self.output_file)
        except Exception:
            pass

    def scan(self, snp_vcf, str_vcf, sites_to_skip=(), logger=None):
        from longtr_tpu_torch.denovo.haplotype_tracker import HaplotypeTracker
        tracker = HaplotypeTracker(self.families, snp_vcf, self.window_size)
        while True:
            variant = str_vcf.get_next_variant()
            if variant is None:
                break
            A = variant.num_alleles()
            if A <= 1:
                continue
            if all(variant.genotype(s) is None for s in variant.sample_order):
                continue
            pgls = PhasedGL(variant)   # dies if PHASEDGL absent, like upstream
            tracker.advance(variant.chrom, variant.pos + 1, set(sites_to_skip))
            log_freqs = allele_freraw_priors(variant, self.families, A,
                                             self.use_pop_priors)
            log_mut_prior = -LOG10_2 - math.log10(A - 1)
            record = [_record_prefix(variant), "\tCHILDREN:NOMUT:ANYMUT:DENOVO:OTHER"]
            family_fn = (self._family_lls_fidelity if mathops.ref_fidelity()
                         else self._family_lls)
            for fam in self.families:
                mat_idx, pat_idx = [], []
                bad_sites = set()
                scan = tracker.infer_haplotype_inheritance(
                    fam, MAX_BEST_SCORE, MIN_SECOND_BEST_SCORE, mat_idx,
                    pat_idx, bad_sites)
                scan &= pgls.has_sample(fam.mother) and pgls.has_sample(fam.father)
                if scan:
                    scan = all(pgls.has_sample(c) for c in fam.children)
                if not scan:
                    record.append("\t.")
                    continue
                no_mut, denovos, others = family_fn(
                    pgls, fam, A, log_freqs, log_mut_prior, mat_idx, pat_idx)
                # ANYMUT flows through the reference's Mineiro fast-LSE
                # chain (denovo_scanner.cpp:101): vector LSE per category,
                # then the two-argument variant.
                anymut = mathops.fast_log_sum_exp2(
                    mathops.fast_log_sum_exp(list(denovos)),
                    mathops.fast_log_sum_exp(list(others)))
                fields = [",".join(fam.children), _fmt(no_mut),
                          _fmt(anymut),
                          ",".join(_fmt(v) for v in denovos),
                          ",".join(_fmt(v) for v in others)]
                record.append("\t" + ":".join(fields))
            self.out.write("".join(record) + "\n")

    def _family_lls(self, pgls, fam, A, log_freqs, log_mut_prior,
                    mat_idx, pat_idx):
        """Vectorized denovo_scanner.cpp:146-262 (no pruning; hybrid LSE
        domain)."""
        mi, mj = np.meshgrid(np.arange(A), np.arange(A), indexing="ij")
        mi, mj = mi.ravel(), mj.ravel()       # ordered pairs (A²,)
        K = A * A

        def phased_ll(sample):
            idx = pgls.sample_indices[sample]
            prior = log_freqs[mi] + log_freqs[mj]
            gl = np.array([pgls.get_gl(idx, int(a), int(b))
                           for a, b in zip(mi, mj)], dtype=np.float64)
            return prior + gl

        mat_ll = phased_ll(fam.mother)
        pat_ll = phased_ll(fam.father)
        config = mat_ll[:, None] + pat_ll[None, :]     # (K, K)

        child_GL = {}
        child_ci = {}
        child_cj = {}
        for ci_, child in enumerate(fam.children):
            idx = pgls.sample_indices[child]
            G = np.empty((A, A))
            for a in range(A):
                for b in range(A):
                    G[a, b] = pgls.get_gl(idx, a, b)
            child_GL[child] = G
            # inheritance pattern -> child's (hap1, hap2) alleles as arrays
            # over the (mat pair, pat pair) grid
            m_idx, p_idx = mat_idx[ci_], pat_idx[ci_]
            mat_allele = mi if m_idx in (0, 2) else mj        # function of axis 0
            pat_allele = mi if p_idx in (0, 2) else mj        # function of axis 1
            if m_idx in (0, 1):
                ci_arr = mat_allele[:, None] * np.ones((1, K), dtype=int)
                cj_arr = np.ones((K, 1), dtype=int) * pat_allele[None, :]
            else:
                cj_arr = mat_allele[:, None] * np.ones((1, K), dtype=int)
                ci_arr = np.ones((K, 1), dtype=int) * pat_allele[None, :]
            child_ci[child] = ci_arr
            child_cj[child] = cj_arr

        no_mut_config = config.copy()
        for child in fam.children:
            no_mut_config += child_GL[child][child_ci[child], child_cj[child]]
        no_mut = _lse_hybrid(no_mut_config)

        in_parents = np.zeros((K, K, A), dtype=bool)
        eye = np.eye(A, dtype=bool)
        in_parents |= eye[mi][:, None, :]
        in_parents |= eye[mj][:, None, :]
        in_parents |= eye[mi][None, :, :]
        in_parents |= eye[mj][None, :, :]

        denovos, others = [], []
        for child in fam.children:
            G = child_GL[child]
            ci_arr, cj_arr = child_ci[child], child_cj[child]
            base = no_mut_config - G[ci_arr, cj_arr]
            d_terms, o_terms = [], []
            for m in range(A):
                # mutation on haplotype 1: (m, cj)
                t1 = base + G[m, cj_arr] + log_mut_prior
                v1 = ci_arr != m
                # mutation on haplotype 2: (ci, m)
                t2 = base + G[ci_arr, m] + log_mut_prior
                v2 = cj_arr != m
                dn = ~in_parents[:, :, m]
                d_terms.append(np.where(v1 & dn, t1, -np.inf))
                d_terms.append(np.where(v2 & dn, t2, -np.inf))
                o_terms.append(np.where(v1 & ~dn, t1, -np.inf))
                o_terms.append(np.where(v2 & ~dn, t2, -np.inf))
            denovos.append(_lse_hybrid(np.stack(d_terms)))
            others.append(_lse_hybrid(np.stack(o_terms)))
        return no_mut, np.array(denovos), np.array(others)

    def _family_lls_fidelity(self, pgls, fam, A, log_freqs, log_mut_prior,
                             mat_idx, pat_idx):
        """Scalar transliteration of denovo_scanner.cpp:146-262: identical
        iteration order, per-child streaming accumulators, and the
        MIN_CONTRIBUTION gate (:157, a C float)."""
        upd = mathops.streaming_lse_update
        n_children = len(fam.children)
        min_contrib = float(np.float32(4 + 5 * math.log10(A) + math.log10(2)
                                       + math.log10(n_children)))
        midx = pgls.sample_indices[fam.mother]
        pidx = pgls.sample_indices[fam.father]
        cidxs = [pgls.sample_indices[c] for c in fam.children]
        nm_max, nm_tot = _NEG_HALF_DBL_MAX, 0.0
        dn_max = [_NEG_HALF_DBL_MAX] * n_children
        dn_tot = [0.0] * n_children
        ot_max = [_NEG_HALF_DBL_MAX] * n_children
        ot_tot = [0.0] * n_children

        def child_alleles(cn, mat_i, mat_j, pat_i, pat_j):
            """denovo_scanner.cpp:190-199 inheritance-pattern decode."""
            child_i = child_j = None
            m = mat_idx[cn]
            if m == 0:
                child_i = mat_i
            elif m == 1:
                child_i = mat_j
            elif m == 2:
                child_j = mat_i
            else:
                child_j = mat_j
            p = pat_idx[cn]
            if p == 0:
                child_i = pat_i
            elif p == 1:
                child_i = pat_j
            elif p == 2:
                child_j = pat_i
            else:
                child_j = pat_j
            return child_i, child_j

        for mat_i in range(A):
            for mat_j in range(A):
                mat_ll = (log_freqs[mat_i] + log_freqs[mat_j]
                          + pgls.get_gl(midx, mat_i, mat_j))
                for pat_i in range(A):
                    for pat_j in range(A):
                        pat_ll = (log_freqs[pat_i] + log_freqs[pat_j]
                                  + pgls.get_gl(pidx, pat_i, pat_j))
                        nm_config = mat_ll + pat_ll
                        alleles = [child_alleles(cn, mat_i, mat_j,
                                                 pat_i, pat_j)
                                   for cn in range(n_children)]
                        for cn in range(n_children):
                            ci_, cj_ = alleles[cn]
                            nm_config += pgls.get_gl(cidxs[cn], ci_, cj_)
                        nm_max, nm_tot = upd(nm_config, nm_max, nm_tot)
                        parental = (mat_i, mat_j, pat_i, pat_j)
                        for cn in range(n_children):
                            ci_, cj_ = alleles[cn]
                            config = nm_config - pgls.get_gl(cidxs[cn], ci_, cj_)
                            gate = min(dn_max[cn], ot_max[cn]) - min_contrib
                            if (config + pgls.get_max_gl_allele_two(
                                    cidxs[cn], cj_) + log_mut_prior) > gate:
                                for mut in range(A):
                                    if mut == ci_:
                                        continue
                                    p = (config + pgls.get_gl(cidxs[cn], mut, cj_)
                                         + log_mut_prior)
                                    if mut not in parental:
                                        dn_max[cn], dn_tot[cn] = upd(
                                            p, dn_max[cn], dn_tot[cn])
                                    else:
                                        ot_max[cn], ot_tot[cn] = upd(
                                            p, ot_max[cn], ot_tot[cn])
                            gate = min(dn_max[cn], ot_max[cn]) - min_contrib
                            if (config + pgls.get_max_gl_allele_one(
                                    cidxs[cn], ci_) + log_mut_prior) > gate:
                                for mut in range(A):
                                    if mut == cj_:
                                        continue
                                    p = (config + pgls.get_gl(cidxs[cn], ci_, mut)
                                         + log_mut_prior)
                                    if mut not in parental:
                                        dn_max[cn], dn_tot[cn] = upd(
                                            p, dn_max[cn], dn_tot[cn])
                                    else:
                                        ot_max[cn], ot_tot[cn] = upd(
                                            p, ot_max[cn], ot_tot[cn])
        fin = mathops.streaming_lse_finish
        no_mut = fin(nm_max, nm_tot)
        denovos = np.array([fin(dn_max[c], dn_tot[c])
                            for c in range(n_children)])
        others = np.array([fin(ot_max[c], ot_tot[c])
                           for c in range(n_children)])
        return no_mut, denovos, others
