"""PhasingChecker: family SNP-haplotype phasing quality at TR loci.

Reference: src/check_phasing.cpp — for each BED region, compute the diploid
edit distances between every child's and each parent's SNP haplotypes within
the 500kb tracker window, flag families whose inheritance pattern is
ambiguous (same thresholds as DenovoScanner), and write a bgzipped table.
"""

from __future__ import annotations

import argparse
import sys

from longtr_tpu_torch.version import __version__


def build_parser():
    p = argparse.ArgumentParser(
        prog="phasingchecker",
        description="Assess family SNP phasing quality at TR loci")
    p.add_argument("--fam", required=True)
    p.add_argument("--snp-vcf", required=True)
    p.add_argument("--regions", required=True)
    p.add_argument("--out", required=True, help="Output .gz path")
    p.add_argument("--version", action="version",
                   version=f"PhasingChecker-TPU {__version__}")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.out.endswith(".gz"):
        sys.exit("ERROR: Output file must end in .gz")

    from longtr_tpu_torch.denovo.haplotype_tracker import HaplotypeTracker
    from longtr_tpu_torch.denovo.pedigree import extract_pedigree_nuclear_families
    from longtr_tpu_torch.denovo.scanner import MAX_BEST_SCORE, MIN_SECOND_BEST_SCORE
    from longtr_tpu_torch.io.bgzf import BgzfWriter
    from longtr_tpu_torch.io.vcf import VCFReader
    from longtr_tpu_torch.regions import order_regions, read_regions

    def logger(*m):
        print(*m, file=sys.stderr)

    snp_vcf = VCFReader(args.snp_vcf)
    snp_samples = set(snp_vcf.get_samples())
    families = extract_pedigree_nuclear_families(args.fam, snp_samples, logger)
    regions = order_regions(read_regions(args.regions))
    tracker = HaplotypeTracker(families, snp_vcf, 500_000)

    out = BgzfWriter(args.out)
    header = "#CHROM\tPOS"
    for fam in families:
        for child in fam.children:
            header += "\t" + child
    out.write(header + "\n")

    prev_chrom = None
    for region in regions:
        if region.chrom != prev_chrom:
            logger(f"Processing chromosome {region.chrom}")
            prev_chrom = region.chrom
        line = [f"{region.chrom}\t{region.start}"]
        tracker.advance(region.chrom, region.start, set())
        for fam in families:
            all_pass = True
            for child in fam.children:
                mat = tracker.edit_distances(child, fam.mother)
                pat = tracker.edit_distances(child, fam.father)
                min_mat, min_mat_idx = mat.min_distance()
                second_mat, _ = mat.second_min_distance()
                if min_mat > MAX_BEST_SCORE or second_mat < MIN_SECOND_BEST_SCORE:
                    all_pass = False
                min_pat, min_pat_idx = pat.min_distance()
                second_pat, _ = pat.second_min_distance()
                if min_pat > MAX_BEST_SCORE or second_pat < MIN_SECOND_BEST_SCORE:
                    all_pass = False
                if min_mat_idx in (0, 1):
                    if min_pat_idx not in (2, 3):
                        all_pass = False
                elif min_pat_idx not in (0, 1):
                    all_pass = False
            for child in fam.children:
                mat = tracker.edit_distances(child, fam.mother)
                pat = tracker.edit_distances(child, fam.father)
                line.append(
                    "\t" + ("PASS" if all_pass else "FAIL")
                    + f":{mat.distance(0, 0)},{mat.distance(0, 1)}"
                    + f",{mat.distance(1, 0)},{mat.distance(1, 1)}"
                    + f":{pat.distance(0, 0)},{pat.distance(0, 1)}"
                    + f",{pat.distance(1, 0)},{pat.distance(1, 1)}")
        out.write("".join(line) + "\n")
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
