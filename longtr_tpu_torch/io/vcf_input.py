"""Reference-panel VCF input (``--ref-vcf`` mode).

Reference: src/vcf_input.{h,cpp} — match a BED region against VCF records via
their START/END INFO tags within a ±50bp window (vcf_input.cpp:16-50), plus
the UnphasedGL/PhasedGL caches used by DenovoFinder.
"""

from __future__ import annotations

import numpy as np

PAD = 50  # vcf_input.cpp:19


def read_vcf_alleles(ref_vcf, region):
    """Returns (ok, pos0, alleles) (vcf_input.cpp:21-50).

    The reference queries tabix with the 1-BASED inclusive region
    "chrom:pad_start-stop+pad" (vcf_reader.h:222-227), which includes a
    record at POS == pad_start; our VCFReader.set_region takes a 0-based
    start, so the equivalent call passes pad_start - 1 (clamped).
    """
    pad_start = 0 if region.start < PAD else region.start - PAD
    if not ref_vcf.set_region(region.chrom, max(0, pad_start - 1),
                              region.stop + PAD):
        return False, -1, []
    while True:
        variant = ref_vcf.get_next_variant()
        if variant is None:
            break
        start = variant.get_info("START")
        stop = variant.get_info("END")
        if start is None or stop is None:
            continue
        if int(start) == region.start + 1 and int(stop) == region.stop:
            return True, variant.pos, list(variant.alleles)
        if variant.pos + 1 > region.start + PAD:
            break
    return False, -1, []


class UnphasedGL:
    """Per-sample GL cache keyed lower-triangle (vcf_input.cpp:52-79).

    Mirrors the reference's htslib-level semantics: the ctor dies when the
    GL FORMAT field is absent (vcf_input.h:55-57) or carries no values
    (vcf_reader.h:139-140); values are C floats (float32), promoted to f64
    only at use; samples with missing genotypes are skipped.
    """

    def __init__(self, variant):
        if "GL" not in variant.fmt:
            raise ValueError("Required FORMAT field GL not present in VCF")
        self.num_alleles = variant.num_alleles()
        self.sample_indices = {}
        self.gls = []
        self.max_gls = []
        any_values = False
        for name in variant.sample_order:
            raw = variant.sample_field(name, "GL")
            if raw is not None and raw != ".":
                any_values = True
            gt = variant.genotype(name)
            if gt is None:
                continue
            if raw is None or raw == ".":
                raise ValueError(
                    "Failed to construct UnphasedGL instance from VCF record")
            vals = np.array([x for x in raw.split(",")], dtype=np.float32)
            self.sample_indices[name] = len(self.gls)
            self.gls.append(vals)
            max_allele = np.full(self.num_alleles, np.float32(-np.inf),
                                 dtype=np.float32)
            gl_index = 0
            for i in range(self.num_alleles):
                for j in range(i + 1):
                    max_allele[i] = max(max_allele[i], vals[gl_index])
                    max_allele[j] = max(max_allele[j], vals[gl_index])
                    gl_index += 1
            self.max_gls.append(max_allele)
        if not any_values:
            raise ValueError(
                "Failed to extract multiple FORMAT values from the VCF record")

    def has_sample(self, sample):
        return sample in self.sample_indices

    def get_gl(self, sample_index, gt_a, gt_b):
        # Python float (f64): C++ promotes the stored float to double at
        # every use site; numpy-2 promotion would otherwise keep f32.
        mn, mx = min(gt_a, gt_b), max(gt_a, gt_b)
        return float(self.gls[sample_index][mx * (mx + 1) // 2 + mn])

    def get_max_gl_allele(self, sample_index, allele):
        return float(self.max_gls[sample_index][allele])


class PhasedGL:
    """Per-sample PHASEDGL cache (vcf_input.cpp:81-110).

    Same htslib-level semantics as UnphasedGL: dies when the field is
    absent (vcf_input.h:88-90) or empty; float32 values.
    """

    def __init__(self, variant):
        if "PHASEDGL" not in variant.fmt:
            raise ValueError(
                "Required FORMAT field PHASEDGL not present in VCF")
        self.num_alleles = variant.num_alleles()
        self.sample_indices = {}
        self.gls = []
        self.max_gls_one = []
        self.max_gls_two = []
        any_values = False
        for name in variant.sample_order:
            raw = variant.sample_field(name, "PHASEDGL")
            if raw is not None and raw != ".":
                any_values = True
            gt = variant.genotype(name)
            if gt is None:
                continue
            if raw is None or raw == ".":
                raise ValueError(
                    "Failed to construct PhasedGL instance from VCF record")
            vals = np.array([x for x in raw.split(",")], dtype=np.float32)
            self.sample_indices[name] = len(self.gls)
            self.gls.append(vals)
            A = self.num_alleles
            mat = vals.reshape(A, A)
            self.max_gls_one.append(mat.max(axis=1))
            self.max_gls_two.append(mat.max(axis=0))
        if not any_values:
            raise ValueError(
                "Failed to extract multiple FORMAT values from the VCF record")

    def has_sample(self, sample):
        return sample in self.sample_indices

    def get_gl(self, sample_index, gt_a, gt_b):
        # Python float (f64), matching C++ float->double promotion at use.
        return float(self.gls[sample_index][gt_a * self.num_alleles + gt_b])

    def get_max_gl_allele_one(self, sample_index, allele):
        return float(self.max_gls_one[sample_index][allele])

    def get_max_gl_allele_two(self, sample_index, allele):
        return float(self.max_gls_two[sample_index][allele])
