"""Sliding-window SNP haplotype tracking for families.

Reference: src/haplotype_tracker.{h,cpp} — per-sample diploid SNP haplotypes
over a 500kb sliding window, diploid edit distances between family members,
and inference of which parental haplotype each child inherited (used for
pedigree-consistency SNP filtering and DenovoFinder transmission tests).

The reference packs haplotypes into 63-bit words; numpy byte arrays give the
same distances with simpler windowing.
"""

from __future__ import annotations

from collections import deque

import numpy as np

DEFAULT_WINDOW_SIZE = 500_000  # snp_bam_processor.h:103 / denovo_scanner.h


class DiploidEditDistance:
    def __init__(self, d11, d12, d21, d22):
        self.d = [int(d11), int(d12), int(d21), int(d22)]

    def distance(self, a, b):
        return self.d[a * 2 + b]

    def min_distance(self):
        idx = min(range(4), key=lambda i: self.d[i])
        return self.d[idx], idx

    def second_min_distance(self):
        order = sorted(range(4), key=lambda i: (self.d[i], i))
        return self.d[order[1]], order[1]


class HaplotypeTracker:
    def __init__(self, families, snp_vcf, window_size=DEFAULT_WINDOW_SIZE):
        self.families = list(families)
        self.snp_vcf = snp_vcf
        self.window_size = window_size
        self.samples = []
        for fam in self.families:
            self.samples.extend(fam.samples)
        self.sample_indices = {s: i for i, s in enumerate(self.samples)}
        for s in self.samples:
            if s not in snp_vcf.get_samples():
                raise ValueError(f"No sample data available in VCF for {s}")
        self._hap1 = [deque() for _ in self.samples]
        self._hap2 = [deque() for _ in self.samples]
        self.positions = deque()
        self.chrom = ""
        self._prev_start = -1
        self._prev_end = -1

    def num_stored_snps(self):
        return len(self.positions)

    def _reset(self):
        for h in self._hap1:
            h.clear()
        for h in self._hap2:
            h.clear()
        self.positions.clear()

    def _add_snp(self, variant):
        self.positions.append(variant.pos + 1)
        for fam in self.families:
            use = not (fam.is_missing_genotype(variant)
                       or not fam.is_mendelian(variant))
            for s in fam.samples:
                idx = self.sample_indices[s]
                if use:
                    ga, gb, _ = variant.genotype(s)
                    self._hap1[idx].append(1 if ga == 1 else 0)
                    self._hap2[idx].append(1 if gb == 1 else 0)
                else:
                    self._hap1[idx].append(0)
                    self._hap2[idx].append(0)

    def advance(self, chrom: str, position: int, sites_to_skip=()):
        """haplotype_tracker.cpp:87-125.

        The reference queries tabix with the 1-BASED region string
        "chrom:start" (vcf_reader.h:222-227), which includes a SNP at
        POS == start; our VCFReader.set_region takes a 0-based start, so
        the equivalent call passes start - 1 (clamped).
        """
        start = position - self.window_size if position >= self.window_size else 0
        end = position + self.window_size
        if chrom != self.chrom:
            self.chrom = chrom
            self._reset()
            if not self.snp_vcf.set_region(chrom, max(0, start - 1)):
                # printErrorAndDie analog (haplotype_tracker.cpp:90-92): a
                # chromosome absent from the SNP VCF is FATAL upstream
                import sys
                sys.exit("ERROR: Failed to set the region to chromosome "
                         + chrom + " in the SNP VCF. Please check the SNP "
                         "VCF and rerun the analysis")
        else:
            if start < self._prev_start:
                raise ValueError("advance() requires loci sorted by position")
            if start > self._prev_end:
                self._reset()
                if not self.snp_vcf.set_region(chrom, max(0, start - 1)):
                    import sys
                    sys.exit("ERROR: Failed to set the region in the SNP "
                             "VCF. Please check the SNP VCF and rerun the "
                             "analysis")
        self._prev_start = start
        self._prev_end = end

        while (not self.positions or self.positions[-1] < end):
            variant = self.snp_vcf.get_next_variant()
            if variant is None:
                break
            key = f"{variant.chrom}:{variant.pos + 1}"
            if key in sites_to_skip:
                continue
            self._add_snp(variant)

        while self.positions and self.positions[0] < start:
            self.positions.popleft()
            for h in self._hap1:
                h.popleft()
            for h in self._hap2:
                h.popleft()

    def edit_distances(self, sample_1: str, sample_2: str) -> DiploidEditDistance:
        i1 = self.sample_indices[sample_1]
        i2 = self.sample_indices[sample_2]
        a1 = np.fromiter(self._hap1[i1], dtype=np.int8)
        a2 = np.fromiter(self._hap2[i1], dtype=np.int8)
        b1 = np.fromiter(self._hap1[i2], dtype=np.int8)
        b2 = np.fromiter(self._hap2[i2], dtype=np.int8)
        return DiploidEditDistance(
            (a1 != b1).sum(), (a1 != b2).sum(), (a2 != b1).sum(), (a2 != b2).sum())

    def _mismatched_positions(self, child: str, parent: str, child_idx: int,
                              parent_idx: int):
        ci = self.sample_indices[child]
        pi = self.sample_indices[parent]
        ch = self._hap1[ci] if child_idx == 0 else self._hap2[ci]
        ph = self._hap1[pi] if parent_idx == 0 else self._hap2[pi]
        ca = np.fromiter(ch, dtype=np.int8)
        pa = np.fromiter(ph, dtype=np.int8)
        return [self.positions[i] for i in np.flatnonzero(ca != pa)]

    def infer_haplotype_inheritance(self, family, max_best_score: int,
                                    min_second_best_score: int,
                                    maternal_indices: list,
                                    paternal_indices: list,
                                    bad_sites: set) -> bool:
        """haplotype_tracker.cpp:133-195."""
        assert not maternal_indices and not paternal_indices
        mismatches = set()
        for child in family.children:
            mat = self.edit_distances(child, family.mother)
            min_mat, min_mat_idx = mat.min_distance()
            second_mat, _ = mat.second_min_distance()
            if min_mat > max_best_score or second_mat < min_second_best_score:
                return False
            pat = self.edit_distances(child, family.father)
            min_pat, min_pat_idx = pat.min_distance()
            second_pat, _ = pat.second_min_distance()
            if min_pat > max_best_score or second_pat < min_second_best_score:
                return False
            if min_mat_idx in (0, 1):
                if min_pat_idx not in (2, 3):
                    return False
            elif min_pat_idx not in (0, 1):
                return False

            idx_a = 0 if min_mat_idx in (0, 1) else 1
            idx_b = 0 if min_mat_idx in (0, 2) else 1
            mismatches.update(self._mismatched_positions(
                child, family.mother, idx_a, idx_b))
            idx_a = 0 if min_pat_idx in (0, 1) else 1
            idx_b = 0 if min_pat_idx in (0, 2) else 1
            mismatches.update(self._mismatched_positions(
                child, family.father, idx_a, idx_b))

            maternal_indices.append(min_mat_idx)
            paternal_indices.append(min_pat_idx)
        bad_sites.update(mismatches)
        return True
