"""Post-hoc call-level VCF filtering.

Reference: scripts/filter_vcf.py and scripts/filter_haploid_vcf.py (PyVCF
based).  Same option names and filter semantics, self-contained on our VCF
text layer: per-call DP/Q/PDP depth+ratio/DFLANKINDEL/DSTUTTER/AB/FS/
MALLREADS-spanning-depth filters, locus-level depth/indel/stutter gates,
unused-allele removal (only when no GL/PL/PHASEDGL fields are present) and
INFO recomputation (NFILT/DP/BPDIFFS/REFAC/AC/AN).

Haploid records (single GT index) are handled in the same pass, mirroring
filter_haploid_vcf.py's per-call logic.
"""

from __future__ import annotations

import argparse
import collections
import sys

from longtr_tpu_torch.io.bgzf import bgzf_open_text


def build_parser():
    p = argparse.ArgumentParser(prog="longtr-filter-vcf")
    p.add_argument("--vcf", dest="VCF", required=True)
    p.add_argument("--min-call-depth", type=int, default=0, dest="DEPTH")
    p.add_argument("--min-call-qual", type=float, default=0.0, dest="QUAL")
    p.add_argument("--min-call-allele-depth", type=float, default=0.0,
                   dest="ALLELE_DEPTH")
    p.add_argument("--min-call-depth-ratio", type=float, default=0.0,
                   dest="ALLELE_RATIO")
    p.add_argument("--max-call-flank-indel", type=float, default=1.0,
                   dest="FLANK_INDEL_FRAC")
    p.add_argument("--max-call-stutter", type=float, default=1.0,
                   dest="STUTTER_FRAC")
    p.add_argument("--min-call-allele-bias", type=float, default=-100.0,
                   dest="ALLELE_BIAS")
    p.add_argument("--min-call-strand-bias", type=float, default=-100.0,
                   dest="STRAND_BIAS")
    p.add_argument("--min-call-spanning-depth", type=int, default=0,
                   dest="SPAN_DEPTH")
    p.add_argument("--min-loc-depth", type=int, default=0, dest="MIN_LOC_DEPTH")
    p.add_argument("--max-loc-depth", type=int, default=1_000_000_000,
                   dest="MAX_LOC_DEPTH")
    p.add_argument("--max-loc-flank-indel", type=float, default=1.0,
                   dest="LOC_FLANK_INDEL_FRAC")
    p.add_argument("--max-loc-stutter", type=float, default=1.0,
                   dest="LOC_STUTTER")
    p.add_argument("--min-loc-calls", type=int, default=0, dest="MIN_CALLS")
    return p


def _fields(fmt, values):
    return dict(zip(fmt, values + ["."] * (len(fmt) - len(values))))


def filter_call(call, args, haploid):
    """Reference filter_call (filter_vcf.py:10-41)."""
    try:
        if int(call["DP"]) < args.DEPTH:
            return "Depth"
        if float(call["Q"]) < args.QUAL:
            return "Quality"
    except (KeyError, ValueError):
        return None
    if not haploid and "PDP" in call and call["PDP"] not in (".", None):
        d1, d2 = (float(x) for x in call["PDP"].split("|"))
        if d1 == 0 or d2 == 0 or min(d1, d2) < args.ALLELE_DEPTH:
            return "Allele depth"
        if min(d1 / d2, d2 / d1) < args.ALLELE_RATIO:
            return "Allele ratio"
    if args.FLANK_INDEL_FRAC < 1 and "DFLANKINDEL" in call:
        if float(call["DFLANKINDEL"]) / float(call["DP"]) > args.FLANK_INDEL_FRAC:
            return "Flank indels"
    if args.STUTTER_FRAC < 1 and "DSTUTTER" in call:
        if float(call["DSTUTTER"]) / float(call["DP"]) > args.STUTTER_FRAC:
            return "Stutter fraction"
    if args.ALLELE_BIAS > -100 and "AB" in call and \
            float(call["AB"]) < args.ALLELE_BIAS:
        return "Allele bias"
    if args.STRAND_BIAS > -100 and "FS" in call and \
            float(call["FS"]) < args.STRAND_BIAS:
        return "Strand bias"
    if args.SPAN_DEPTH > 0:
        mall = call.get("MALLREADS")
        if mall in (None, "."):
            return "Spanning depth"
        gbs = [int(x) for x in call["GB"].split("|")]
        span = dict((int(a), int(b)) for a, b in
                    (x.split("|") for x in mall.split(";")))
        if min(span.get(gb, 0) for gb in gbs) < args.SPAN_DEPTH:
            return "Spanning depth"
    return None


def _parse_info(text):
    out = {}
    order = []
    for item in text.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = v
        else:
            out[item] = None
        order.append(item.split("=", 1)[0])
    return out, order


def _fmt_info(info, order):
    parts = []
    for k in order:
        if k not in info:
            continue
        parts.append(k if info[k] is None else f"{k}={info[k]}")
    return ";".join(parts)


def main(argv=None, out=sys.stdout, log=sys.stderr):
    args = build_parser().parse_args(argv)
    fh = (sys.stdin if args.VCF == "-" else
          bgzf_open_text(args.VCF) if args.VCF.endswith(".gz") else
          open(args.VCF))
    total_counts = collections.defaultdict(int)
    samples = []
    for line in fh:
        line = line.rstrip("\n")
        if line.startswith("##"):
            print(line, file=out)
            continue
        if line.startswith("#CHROM"):
            samples = line.split("\t")[9:]
            print(line, file=out)
            continue
        cols = line.split("\t")
        info, info_order = _parse_info(cols[7])
        dp = int(info.get("DP", 0))
        if dp < args.MIN_LOC_DEPTH or dp > args.MAX_LOC_DEPTH:
            continue
        if args.LOC_FLANK_INDEL_FRAC < 1 and "DFLANKINDEL" in info and dp and \
                float(info["DFLANKINDEL"]) / dp > args.LOC_FLANK_INDEL_FRAC:
            continue
        if args.LOC_STUTTER < 1 and "DSTUTTER" in info and dp and \
                float(info["DSTUTTER"]) / dp > args.LOC_STUTTER:
            continue

        fmt = cols[8].split(":")
        can_remove = not any(k in fmt for k in ("GL", "PL", "PHASEDGL"))
        alleles = [cols[3]] + ([] if cols[4] == "." else cols[4].split(","))
        allele_counts = [0] * len(alleles)

        calls = []
        for val in cols[9:]:
            calls.append(val.split(":") if val != "." else None)

        haploid = False
        for c in calls:
            if c and not c[0].startswith("."):
                haploid = "|" not in c[0] and "/" not in c[0]
                break

        parsed = []
        for c in calls:
            if c is None or c[0].startswith("."):
                parsed.append(None)
                continue
            parsed.append(_fields(fmt, c))

        reasons = []
        for name, call in zip(samples, parsed):
            if call is None:
                reasons.append(None)
                continue
            reason = filter_call(call, args, haploid)
            reasons.append(reason)
            if reason is None:
                gts = [int(x) for x in
                       call["GT"].replace("|", "/").split("/")]
                for g in gts:
                    allele_counts[g] += 1
            else:
                total_counts[reason] += 1

        allele_index = {0: 0}
        k = 1
        for i in range(1, len(allele_counts)):
            if allele_counts[i] != 0 or not can_remove:
                allele_index[i] = k
                k += 1

        new_cols = []
        num_kept = num_filt = 0
        total_dp = total_dstutter = total_dflank = 0
        for call, reason, raw in zip(parsed, reasons, cols[9:]):
            if call is None:
                new_cols.append(raw)
                continue
            if reason is not None:
                num_filt += 1
                vals = []
                for key in fmt:
                    if key == "GT":
                        vals.append("." if haploid else "./.")
                    elif key == "FILTER":
                        vals.append(reason.replace(" ", "_").upper())
                    else:
                        vals.append(".")
                new_cols.append(":".join(vals))
            else:
                num_kept += 1
                sep = "|" if "|" in call["GT"] else "/"
                gts = [allele_index[int(x)] for x in
                       call["GT"].replace("|", "/").split("/")]
                vals = []
                for key in fmt:
                    if key == "GT":
                        vals.append(sep.join(str(g) for g in gts))
                    else:
                        vals.append(call.get(key, "."))
                new_cols.append(":".join(vals))
                total_dp += int(call.get("DP", 0))
                total_dstutter += int(call.get("DSTUTTER", 0) or 0)
                total_dflank += int(call.get("DFLANKINDEL", 0) or 0)

        if num_kept < args.MIN_CALLS:
            continue

        new_alleles = [alleles[0]] + [
            alleles[i] for i in range(1, len(alleles))
            if allele_counts[i] != 0 or not can_remove]
        cols[4] = ",".join(new_alleles[1:]) if len(new_alleles) > 1 else "."
        if "NFILT" in info:
            info["NFILT"] = str(int(info["NFILT"]) + num_filt)
        info["DP"] = str(total_dp)
        if "DSTUTTER" in info:
            info["DSTUTTER"] = str(total_dstutter)
        if "DFLANKINDEL" in info:
            info["DFLANKINDEL"] = str(total_dflank)
        if "BPDIFFS" in info:
            if len(new_alleles) == 1:
                del info["BPDIFFS"]
            else:
                info["BPDIFFS"] = ",".join(
                    str(len(a) - len(new_alleles[0])) for a in new_alleles[1:])
        if "REFAC" in info:
            info["REFAC"] = str(allele_counts[0])
        if "AC" in info:
            if len(new_alleles) == 1:
                del info["AC"]
            elif can_remove:
                info["AC"] = ",".join(str(c) for c in allele_counts[1:] if c != 0)
            else:
                info["AC"] = ",".join(str(c) for c in allele_counts[1:])
        if "AN" in info:
            info["AN"] = str(sum(allele_counts))
        cols[7] = _fmt_info(info, info_order)
        print("\t".join(cols[:9] + new_cols), file=out)

    if total_counts:
        for reason, count in sorted(total_counts.items()):
            print(f"Filtered {count} calls: {reason}", file=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
