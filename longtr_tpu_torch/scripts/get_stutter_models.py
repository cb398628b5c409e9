"""Extract stutter models from a HipSTR-generated VCF.

Reference: scripts/GetStutterModels (bash + vcftools) — pulls
INFRAME_PGEOM/DOWN/UP and OUTFRAME_PGEOM/DOWN/UP INFO fields into the
``--stutter-in`` text format, flooring the up/down probabilities at 0.01.
Note (SURVEY.md §2.9): LongTR itself no longer emits these INFO fields, so
this tool applies to HipSTR output.
"""

from __future__ import annotations

import argparse
import sys

from longtr_tpu_torch.io.bgzf import bgzf_open_text


def main(argv=None, out=sys.stdout):
    p = argparse.ArgumentParser(prog="getstuttermodels")
    p.add_argument("vcf", help="HipSTR VCF (.vcf or .vcf.gz)")
    args = p.parse_args(argv)
    fh = (bgzf_open_text(args.vcf) if args.vcf.endswith(".gz")
          else open(args.vcf))
    floor = lambda v: max(float(v), 0.01)
    with fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) for kv in cols[7].split(";")
                        if "=" in kv)
            needed = ("START", "END", "INFRAME_PGEOM", "INFRAME_DOWN",
                      "INFRAME_UP", "OUTFRAME_PGEOM", "OUTFRAME_DOWN",
                      "OUTFRAME_UP", "PERIOD")
            if not all(k in info for k in needed[:8]):
                continue
            period = int(info.get("PERIOD", "1").split(",")[0])
            print("\t".join([
                cols[0], info["START"], info["END"],
                info["INFRAME_PGEOM"],
                f"{floor(info['INFRAME_DOWN']):g}",
                f"{floor(info['INFRAME_UP']):g}",
                info["OUTFRAME_PGEOM"],
                f"{floor(info['OUTFRAME_DOWN']):g}",
                f"{floor(info['OUTFRAME_UP']):g}",
                "N" * period]), file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
