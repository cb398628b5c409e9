"""DenovoFinder command-line interface.

Reference: src/denovos/denovo_main.cpp — scans a LongTR VCF + FAM pedigree
for de novo TR mutations; with --snp-vcf runs the family-joint transmission
test, otherwise the per-trio test.
"""

from __future__ import annotations

import argparse
import sys

from longtr_tpu_torch.version import __version__


def build_parser():
    p = argparse.ArgumentParser(
        prog="denovofinder",
        description="Scan a LongTR VCF for de novo TR mutations")
    p.add_argument("--fam", required=True, help="FAM pedigree file")
    p.add_argument("--str-vcf", required=True, help="Bgzipped LongTR VCF")
    p.add_argument("--denovo-vcf", required=True, help="Bgzipped output VCF")
    p.add_argument("--snp-vcf", default="",
                   help="Phased SNP VCF enabling the family-joint test")
    p.add_argument("--uniform-prior", action="store_true")
    p.add_argument("--log", default="")
    p.add_argument("--chrom", default="")
    p.add_argument("--haploid-chrs", default="")
    p.add_argument("--skip-snps", default="",
                   help="File of CHROM:POS sites to omit")
    p.add_argument("--version", action="version",
                   version=f"DenovoFinder-TPU {__version__}")
    return p


def main(argv=None):
    try:
        return _main(argv)
    except (OSError, ValueError, EOFError) as e:
        import os
        if os.environ.get("LONGTR_TRACEBACK"):
            raise
        sys.exit(f"ERROR: {e}")
    except Exception as e:
        import struct
        import zlib
        if isinstance(e, (zlib.error, struct.error)):
            import os
            if os.environ.get("LONGTR_TRACEBACK"):
                raise
            sys.exit(f"ERROR: corrupt or truncated input: {e}")
        raise


def _main(argv=None):
    args = build_parser().parse_args(argv)
    full_command = "DenovoFinder-TPU-" + __version__ + " " + \
        " ".join(argv or sys.argv[1:])
    log_fh = open(args.log, "w") if args.log else sys.stderr

    def logger(*msgs):
        print(*msgs, file=log_fh)

    from longtr_tpu_torch.denovo.pedigree import extract_pedigree_nuclear_families
    from longtr_tpu_torch.io.vcf import VCFReader

    str_vcf = VCFReader(args.str_vcf)
    # samples-with-data mirrors denovo_main.cpp: STR samples in trio mode
    # (:245), SNP∩STR in joint mode (:225-230).  The reference proceeds even
    # with zero nuclear families (header-only columns), so no early exit.
    samples_with_data = set(str_vcf.get_samples())
    if args.snp_vcf:
        snp_vcf_for_samples = VCFReader(args.snp_vcf)
        samples_with_data &= set(snp_vcf_for_samples.get_samples())
    families = extract_pedigree_nuclear_families(args.fam, samples_with_data,
                                                 logger)

    sites_to_skip = set()
    if args.skip_snps:
        with open(args.skip_snps) as fh:
            sites_to_skip = {ln.strip() for ln in fh if ln.strip()}

    # Iterate all records (optionally restricted to one chromosome)
    chroms = [args.chrom] if args.chrom else str_vcf.chromosomes()

    class _Iter:
        def __init__(self, vcf, chrom_list):
            self.vcf = vcf
            self.chroms = list(chrom_list)
            self._advance()

        def _advance(self):
            if self.chroms:
                chrom = self.chroms.pop(0)
                if not self.vcf.set_region(chrom, 0) and args.chrom:
                    # printErrorAndDie analog (denovo_main.cpp --chrom path)
                    sys.exit("ERROR: Failed to set the region to chromosome "
                             + chrom + " in the STR VCF. Please check the "
                             "STR VCF and rerun the analysis")

        def get_next_variant(self):
            while True:
                v = self.vcf.get_next_variant()
                if v is not None:
                    return v
                if not self.chroms:
                    return None
                self._advance()

    it = _Iter(str_vcf, chroms)
    if args.snp_vcf:
        from longtr_tpu_torch.denovo.scanner import DenovoScanner
        snp_vcf = VCFReader(args.snp_vcf)
        scanner = DenovoScanner(families, args.denovo_vcf, full_command,
                                not args.uniform_prior)
        scanner.scan(snp_vcf, it, sites_to_skip, logger)
    else:
        from longtr_tpu_torch.denovo.scanner import TrioDenovoScanner
        scanner = TrioDenovoScanner(families, args.denovo_vcf, full_command,
                                    not args.uniform_prior)
        scanner.scan(it, logger)
    scanner.finish()
    if args.log:
        log_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
