"""Alignment visualization: --viz-out writer + VizAln/VizAlnPdf rendering.

Reference: src/SeqAlignment/AlignmentViz.cpp + HTMLCreator.cpp define the
``--viz-out`` file format: a bgzipped, tabix-addressable, tab-separated
table whose lines are ``CHROM  START  STOP  SAMPLE  <html fragment>`` and
whose fragments are consumed by the reference's own runnable tooling
(VizAln = tabix | awk $2==START | cut -f1-4 --complement |
scripts/generate_aln_html.py).  We emit that format byte-compatibly —
tests/test_viz_ref_tooling.py feeds our file through the reference's
generate_aln_html.py — while our ``vizaln``/``vizalnpdf`` CLIs decode the
same fragments for standalone rendering (no tabix binary needed).

Layout semantics (AlignmentViz.cpp:16-141): reads are overlaid on a
common column space; SPACE (' ') pads outside a read's extent, NOT_APP
('*') pads columns created by insertions in *other* reads, '-' marks
deletions.  HTML encoding (HTMLCreator.cpp:45-117): leading spaces become
a numeric offset, interior spaces 'x', mismatch bases map A/C/G/T/N ->
H/I/J/K/L, bases inside insertion columns are lowercased.

Note the upstream *producer* of this file is non-functional in the
reference (the visualizeAlignments call is commented out,
seq_stutter_genotyper.cpp:1400, and its HapAligner::retrace feed is dead
— PARITY.md ledger); the format contract is therefore defined by the
runnable consumer scripts, which this module targets.  Our producer
renders the trimmed alignments the genotyper actually used.
"""

from __future__ import annotations

import argparse
import sys

SPACE_CHAR = " "       # outside a read's extent (HTMLCreator.h:11)
NOT_APP_CHAR = "*"     # insertion-column padding (HTMLCreator.h:10)
DELETION_CHAR = "-"    # deletion (HTMLCreator.h:9)

_SNP_CODE = {"A": "H", "C": "I", "G": "J", "T": "K", "N": "L"}
_SNP_DECODE = {v: k for k, v in _SNP_CODE.items()}


def max_insertion_sizes(alignments):
    """position -> max insertion length (AlignmentViz.cpp:16-45)."""
    out = {}
    for aln in alignments:
        pos = aln.start
        for op, num in aln.cigar:
            if op in "M=XD":
                pos += num
            elif op == "I":
                out[pos] = max(out.get(pos, 0), num)
    return out


def overlay_alignments(alignments):
    """Pad reads against the insertion profile (AlignmentViz.cpp:47-141).

    Returns (min_start, max_stop, insertions, list of overlay strings).
    Overlay alphabet: raw read bases, ' ' pad, '*' insertion pad, '-' del.
    """
    if not alignments:
        return 0, 0, {}, []
    min_start = min(a.start for a in alignments)
    max_stop = max(a.stop for a in alignments)
    ins = max_insertion_sizes(alignments)
    ins_positions = sorted(ins)

    results = []
    for aln in alignments:
        chunks = []
        pos = min_start
        ii = 0
        # left pad with SPACE over both regular and insertion columns; the
        # loop must EXIT with pos == aln.start (the reference pads with a
        # separate index and keeps `position` at the read start,
        # AlignmentViz.cpp:70-79) — advancing pos past the start shifted
        # every later insertion/deletion column check one base early
        while pos < aln.start:
            if ii < len(ins_positions) and pos == ins_positions[ii]:
                chunks.append(SPACE_CHAR * ins[ins_positions[ii]])
                ii += 1
            chunks.append(SPACE_CHAR)
            pos += 1
        # an insertion column exactly at the read start pads before it
        if ii < len(ins_positions) and pos == ins_positions[ii]:
            chunks.append(SPACE_CHAR * ins[ins_positions[ii]])
            ii += 1
        nuc = 0
        seq = aln.sequence
        cigar = list(aln.cigar)
        for ci, (op, num) in enumerate(cigar):
            if op in "M=X":
                for _ in range(num):
                    if ii < len(ins_positions) and pos == ins_positions[ii]:
                        chunks.append(NOT_APP_CHAR * ins[ins_positions[ii]])
                        ii += 1
                    chunks.append(seq[nuc])
                    nuc += 1
                    pos += 1
            elif op == "D":
                for _ in range(num):
                    if ii < len(ins_positions) and pos == ins_positions[ii]:
                        chunks.append(NOT_APP_CHAR * ins[ins_positions[ii]])
                        ii += 1
                    chunks.append(DELETION_CHAR)
                    pos += 1
            elif op == "I":
                width = ins.get(pos, num)
                chunks.append(seq[nuc: nuc + num])
                nuc += num
                # the reference pads the residual insertion width only when
                # another cigar op follows (AlignmentViz.cpp:115-118)
                if ci + 1 < len(cigar):
                    chunks.append(NOT_APP_CHAR * (width - num))
                if ii < len(ins_positions) and pos == ins_positions[ii]:
                    ii += 1
            elif op == "S":
                nuc += num
            # 'H': consumes nothing
        results.append("".join(chunks))
    return min_start, max_stop, ins, results


def arrange_reference_string(chrom_seq, ins, min_start, max_stop):
    """Reference row on the overlay columns: NOT_APP at every insertion
    column (AlignmentViz.cpp:142-160)."""
    chunks = []
    for pos in range(min_start, max_stop + 1):
        if pos in ins:
            chunks.append(NOT_APP_CHAR * ins[pos])
        chunks.append(chrom_seq[pos].upper() if pos < len(chrom_seq)
                      else "N")
    return "".join(chunks)


def encode_read_row(ref_str, row):
    """HTML-encode one overlay row vs the reference row
    (HTMLCreator.cpp:45-117): '<offset> ' + encoded bases."""
    j = 0
    while j < len(row) and row[j] == SPACE_CHAR:
        j += 1
    parts = [str(j), " "]
    for k in range(j, len(row)):
        c = row[k]
        r = ref_str[k] if k < len(ref_str) else SPACE_CHAR
        snp = (c.lower() != r.lower() and r != NOT_APP_CHAR
               and c != NOT_APP_CHAR and c != SPACE_CHAR
               and c != DELETION_CHAR)
        insert = (c != NOT_APP_CHAR and c != SPACE_CHAR
                  and r == NOT_APP_CHAR)
        if snp:
            parts.append(_SNP_CODE[c.upper()])
        elif insert:
            parts.append(c.lower())
        elif c == SPACE_CHAR:
            parts.append("x")
        else:
            parts.append(c)
    return "".join(parts)


def write_viz_record(out, region, sample_names, sample_label, alignments,
                     chrom_seq="", sample_info=None):
    """One locus block in the reference's viz-file format
    (writeReferenceString + writeAlignmentStrings, HTMLCreator.cpp:8-117,
    block framing visualizeAlignments, AlignmentViz.cpp:172-215)."""
    if not alignments:
        return
    locus_id = f"{region.chrom}\t{region.start + 1}\t{region.stop}"

    # sort samples by name, stable on original index (AlignmentViz.cpp:179)
    order = sorted(range(len(sample_names)), key=lambda i: sample_names[i])
    ordered, samples = [], []
    for si in order:
        for ai, aln in enumerate(alignments):
            if sample_label[ai] == si:
                ordered.append(aln)
                samples.append(sample_names[si])
    min_start, max_stop, ins, rows = overlay_alignments(ordered)
    ref_str = arrange_reference_string(chrom_seq, ins, min_start, max_stop)

    out.write(f"{locus_id}\tALL\t<div>\t<table class=\"reftable\">"
              f" <caption>{locus_id}</caption> \n")
    out.write(f"{locus_id}\tALL\t<tr style='font-weight: bold' "
              f"class=\"reference\">0 {ref_str}</tr>\n")
    for i, (sample, row) in enumerate(zip(samples, rows)):
        if i == 0 or samples[i - 1] != sample:
            info = (sample_info or {}).get(sample, "")
            label = f"{sample}: {info}"
            out.write(f"{locus_id}\t{sample}\t<tr> <td class=\"samplename\" "
                      f"style=\"text-align:left;\" colspan=\"{len(label)}\">"
                      f" <font color=\"red\">{label}</font> </td> </tr>\n")
        out.write(f"{locus_id}\t{sample}\t<tr>"
                  f"{encode_read_row(ref_str, row)}</tr>\n")
    out.write(f"{locus_id}\tALL\t\t</table> <br> </div>\n")


# ---------------------------------------------------------------------------
# decoding (our standalone vizaln/vizalnpdf renderers)

def decode_fragment(fragment):
    """Decode one '<tr>...' fragment into (sample_kind, [(char, kind)]).

    kinds: 'ref', 'base', 'mm' (SNP-highlighted), 'ins', 'del', 'pad',
    'space'.  Returns None for non-row fragments (div/table/samplename)."""
    if not fragment.startswith("<tr") or "samplename" in fragment:
        return None
    body = fragment[fragment.index(">") + 1:]
    if body.endswith("</tr>"):
        body = body[: -len("</tr>")]
    is_ref = 'class="reference"' in fragment
    off_s, _, bases = body.partition(" ")
    cells = [(" ", "space")] * int(off_s)
    for c in bases:
        if c == "x":
            cells.append((" ", "space"))
        elif c == NOT_APP_CHAR:
            cells.append(("*", "pad"))
        elif c == DELETION_CHAR:
            cells.append(("-", "del"))
        elif c in _SNP_DECODE:
            cells.append((_SNP_DECODE[c], "mm"))
        elif c.islower():
            cells.append((c.upper(), "ins"))
        else:
            cells.append((c, "ref" if is_ref else "base"))
    return ("REF" if is_ref else "read"), cells


def read_viz_rows(viz_file, chrom, start, sample=None):
    """Slice one locus out of a viz file -> list of (sample, cells)."""
    from longtr_tpu_torch.io.bgzf import bgzf_open_text
    rows = []
    with bgzf_open_text(viz_file) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 5 or f[0] != chrom or f[1] != str(start):
                continue
            if sample and f[3] not in ("ALL", sample):
                continue
            decoded = decode_fragment("\t".join(f[4:]))
            if decoded is None:
                continue
            kind, cells = decoded
            rows.append((f[3] if kind != "REF" else "REF", cells))
    return rows


_CSS = """
body { font-family: monospace; white-space: pre; font-size: 13px; }
.ref { color: #444; font-weight: bold; }
.base { color: #1669c1; }
.mm { color: #c11616; font-weight: bold; background-color: gold; }
.ins { color: #0a7d33; font-weight: bold; background-color: #fdd; }
.del { color: #999; }
.pad { color: #bbb; }
.sample { color: #000; font-weight: bold; margin-top: 8px; }
"""


def render_html(rows, out=sys.stdout):
    """rows: list of (sample, cells) from read_viz_rows."""
    print("<html><head><style>%s</style></head><body>" % _CSS, file=out)
    cur_sample = None
    for sample, cells in rows:
        if sample == "REF":
            text = "".join(c for c, _ in cells)
            print(f'<div class="ref">REF  {text}</div>', file=out)
            continue
        if sample != cur_sample:
            print(f'<div class="sample">{sample}</div>', file=out)
            cur_sample = sample
        spans = [f'<span class="{kind}">{c}</span>' if kind != "space"
                 else c for c, kind in cells]
        print('<div class="read">     %s</div>' % "".join(spans), file=out)
    print("</body></html>", file=out)


def render_pdf(rows, out_path: str):
    """PDF rendering (VizAlnPdf analog).

    The reference's html_alns_to_pdf.py needs svglib+reportlab; neither is
    in this image, so we render a monospaced text stack via matplotlib
    (always present alongside jax) — same read stack, printable output."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise SystemExit("PDF rendering requires matplotlib: " + str(e))
    height = max(2.0, 0.16 * len(rows) + 1)
    width = max(8.0, 0.085 * max((len(c) for _, c in rows), default=10))
    fig, ax = plt.subplots(figsize=(width, height))
    ax.axis("off")
    for i, (sample, cells) in enumerate(rows):
        text = "".join(c for c, _ in cells)
        color = "#444444" if sample == "REF" else "#1669c1"
        ax.text(0.01, 1 - (i + 1) / (len(rows) + 1),
                f"{sample[:10]:>10s}  {text}", fontsize=6,
                family="monospace", color=color, transform=ax.transAxes)
    fig.savefig(out_path, format="pdf", bbox_inches="tight")
    plt.close(fig)


def pdf_main(argv=None):
    p = argparse.ArgumentParser(
        prog="vizalnpdf",
        description="Render LongTR --viz-out alignments for one locus as PDF")
    p.add_argument("viz_file")
    p.add_argument("chrom")
    p.add_argument("start", type=int)
    p.add_argument("out", help="Output PDF path")
    p.add_argument("sample", nargs="?", default=None)
    args = p.parse_args(argv)
    rows = read_viz_rows(args.viz_file, args.chrom, args.start, args.sample)
    render_pdf(rows, args.out)
    print(f"Wrote {args.out}", file=sys.stderr)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="vizaln",
        description="Render LongTR --viz-out alignments for one locus as HTML")
    p.add_argument("viz_file", help="bgzipped --viz-out file")
    p.add_argument("chrom")
    p.add_argument("start", type=int)
    p.add_argument("sample", nargs="?", default=None)
    p.add_argument("--out", default="-", help="Output HTML path (- = stdout)")
    args = p.parse_args(argv)
    rows = read_viz_rows(args.viz_file, args.chrom, args.start, args.sample)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    render_html(rows, out)
    if out is not sys.stdout:
        out.close()
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
