"""Join DenovoFinder likelihoods back onto a genotype VCF.

Reference: src/denovos/annotate_vcf_with_denovo_lls.py (PyVCF based).
Same behavior, self-contained: records are matched positionally
(CHROM/POS/ID/REF/ALT must agree), DenovoFinder's FORMAT fields are appended
per shared sample, and GL/PL/PHASEDGL fields are dropped unless --keep-gls.
"""

from __future__ import annotations

import argparse
import sys

from longtr_tpu_torch.io.bgzf import bgzf_open_text


def _open(path):
    if path == "-":
        return sys.stdin
    return bgzf_open_text(path) if path.endswith(".gz") else open(path)


def main(argv=None, out=sys.stdout):
    p = argparse.ArgumentParser(prog="longtr-annotate-denovo")
    p.add_argument("--vcf", required=True, dest="VCF",
                   help="Genotype VCF (longtr output)")
    p.add_argument("--denovo-ll-vcf", required=True, dest="LLVCF",
                   help="DenovoFinder output VCF")
    p.add_argument("--keep-gls", action="store_true", default=False,
                   dest="keep_lls")
    args = p.parse_args(argv)

    gt_fh = _open(args.VCF)
    ll_fh = _open(args.LLVCF)

    # Load the LL VCF records + header formats
    ll_samples = []
    ll_formats = []
    ll_records = {}
    for line in ll_fh:
        line = line.rstrip("\n")
        if line.startswith("##FORMAT"):
            ll_formats.append(line)
            continue
        if line.startswith("#CHROM"):
            ll_samples = line.split("\t")[9:]
            continue
        if line.startswith("#"):
            continue
        c = line.split("\t")
        ll_records[(c[0], c[1])] = c

    drop = () if args.keep_lls else ("GL", "PL", "PHASEDGL")
    gt_samples = []
    for line in gt_fh:
        line = line.rstrip("\n")
        if line.startswith("##"):
            print(line, file=out)
            continue
        if line.startswith("#CHROM"):
            for fline in ll_formats:
                print(fline, file=out)
            gt_samples = line.split("\t")[9:]
            if not set(gt_samples) & set(ll_samples):
                sys.exit("ERROR: No samples are shared between the raw VCF "
                         "and the denovo VCF")
            print(line, file=out)
            continue
        cols = line.split("\t")
        ll = ll_records.get((cols[0], cols[1]))
        if ll is None:
            continue
        for idx, name in ((2, "IDs"), (3, "REF alleles"), (4, "alternate alleles")):
            if cols[idx] != ll[idx]:
                sys.exit(f"ERROR: Record {name} don't match")
        gt_fmt = cols[8].split(":")
        keep = [i for i, k in enumerate(gt_fmt) if k not in drop]
        ll_fmt = ll[8]
        cols[8] = ":".join([gt_fmt[i] for i in keep] + ll_fmt.split(":"))
        ll_by_sample = dict(zip(ll_samples, ll[9:]))
        n_ll_fields = len(ll_fmt.split(":"))
        new_cols = []
        for name, val in zip(gt_samples, cols[9:]):
            parts = val.split(":")
            parts = [parts[i] if i < len(parts) else "." for i in keep]
            extra = ll_by_sample.get(name, ".")
            if extra == ".":
                extra = ":".join(["."] * n_ll_fields)
            new_cols.append(":".join(parts) + ":" + extra)
        print("\t".join(cols[:9] + new_cols), file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
