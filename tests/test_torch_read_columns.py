"""The port's read layer reads a decoded BAM window's columns, on the CPU.

A record of a decoded BAM window carries its decode batch and row
(``BamRecord._src``): the read filter reads its gates (has an N, mean base
quality, hard-clipped at an edge) and the native trim its sequence,
qualities and CIGAR from the batch's columns, once a window instead of
once a locus.  Held here:

* every column against the Python expression it replaces, record by
  record of a decoded window (an empty record, hard clips, an N, HP tags
  of every type);
* the native trim fed from batch rows, from copied rows and from both at
  once against the pure-Python trim, alignment by alignment;
* on long reads that each span at least four loci 3 kb apart, in three
  BAMs with an N read, a low-quality read, a hard-clipped read and a
  low-MAPQ read: the VCF, each locus's FilterCounters and the
  --pass-bam/--filt-bam records (PF/FT tags included) equal to the
  fallback path's (LONGTR_NO_NATIVE=1, and CRAM input), and the VCF to
  longtr_tpu's, with the counters in --metrics-out saying which path each
  (record, locus) pair took.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from longtr_tpu.cli import main as jax_main
from longtr_tpu_torch import native
from longtr_tpu_torch.cli import main as port_main
from longtr_tpu_torch.io.bam import BamReader, BamRecord
from longtr_tpu_torch.io.bam_write import BamWriter, build_bai
from longtr_tpu_torch.io.bgzf import BgzfReader
from longtr_tpu_torch.io.cram import CramWriter
from longtr_tpu_torch.io.fasta import write_fasta
from longtr_tpu_torch.pipeline import alignment, processor
from longtr_tpu_torch.pipeline.filters import mean_phred
from longtr_tpu_torch.regions import Region, RegionGroup
from longtr_tpu_torch.testing.synth import Locus, make_genome, write_bed

CPU = torch.device("cpu")
SPACING = 3000
N_LOCI = 6
SPAN = 4          # loci a read covers
MOTIFS = ["AC", "AGAT", "CTG", "TTTA", "ACGGT", "A"]

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="the native library did not build")


def _qual(rng, n, lo=25, hi=60):
    return "".join(chr(33 + q) for q in rng.integers(lo, hi, n))


def _read(genome, loci, start, end, deltas):
    """Sequence and CIGAR of a haplotype read over [start, end) of the
    reference, each locus's repeat changed by ``deltas[l]`` motif copies
    (an insertion or a deletion at the repeat's end)."""
    ops, seq = [], []

    def add(op, n, bases=""):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += n
        else:
            ops.append([op, n])
        seq.append(bases)

    pos = start
    for loc in loci:
        if loc.stop <= start or loc.start >= end:
            continue
        add("M", loc.start - pos, genome[pos:loc.start])
        d = deltas[loc.name]
        m = len(loc.motif)
        rep = loc.stop - loc.start
        if d >= 0:
            add("M", rep, genome[loc.start:loc.stop])
            add("I", d * m, loc.motif * d)
        else:
            add("M", rep + d * m, genome[loc.start:loc.stop + d * m])
            add("D", -d * m)
        pos = loc.stop
    add("M", end - pos, genome[pos:end])
    return "".join(seq), [(op, n) for op, n in ops]


def _substitute(rng, seq, rate=0.002):
    chars = list(seq)
    for i in np.flatnonzero(rng.random(len(chars)) < rate):
        chars[i] = "ACGT"[("ACGT".index(chars[i]) + 1) % 4]
    return "".join(chars)


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    """Three samples of HP-tagged long reads over six loci 3 kb apart,
    each read spanning four of them."""
    tmp = tmp_path_factory.mktemp("long_reads")
    rng = np.random.default_rng(18)
    loci = [Locus("chr1", 3000 + SPACING * i, MOTIFS[i],
                  14 if MOTIFS[i] == "A" else 9, f"L{i}")
            for i in range(N_LOCI)]
    chrom_len = loci[-1].stop + 3000
    genome = make_genome(rng, loci, chrom_len)
    chrom = genome["chr1"]
    fasta = str(tmp / "g.fa")
    write_fasta(fasta, genome)
    bed = write_bed(str(tmp / "r.bed"), loci)
    header_sq = f"@SQ\tSN:chr1\tLN:{chrom_len}\n"
    bams = []
    for s in range(3):
        sample = f"S{s}"
        deltas = [{l.name: int(rng.integers(-2, 3)) for l in loci}
                  for _ in range(2)]
        recs = []
        for k in range(2 * 12 * (N_LOCI - SPAN + 1)):
            hap = 1 + k % 2
            first = (k // 2) % (N_LOCI - SPAN + 1)
            start = loci[first].start - int(rng.integers(300, 1200))
            end = loci[first + SPAN - 1].stop + int(rng.integers(300, 1200))
            seq, cigar = _read(chrom, loci, start, end, deltas[hap - 1])
            seq = _substitute(rng, seq)
            qual = _qual(rng, len(seq))
            mapq = 60
            if s == 1 and k == 3:
                seq = seq[:len(seq) // 2] + "N" + seq[len(seq) // 2 + 1:]
            elif s == 1 and k == 6:
                qual = _qual(rng, len(seq), 2, 12)
            elif s == 2 and k == 5:
                cigar = [("H", 40)] + cigar
            elif s == 2 and k == 8:
                mapq = 5
            recs.append(BamRecord(
                name=f"{sample}_r{k}", flag=16 * (k % 3 == 0), ref_id=0,
                pos=start, mapq=mapq, cigar=cigar, mate_ref_id=-1,
                mate_pos=-1, tlen=0, seq=seq, qual=qual,
                tags={"RG": f"rg_{sample}", "HP": hap}, ref_name="chr1",
                mate_ref_name="*"))
        recs.sort(key=lambda r: r.pos)
        path = str(tmp / f"{sample}.bam")
        w = BamWriter(path, "@HD\tVN:1.6\tSO:coordinate\n" + header_sq
                      + f"@RG\tID:rg_{sample}\tSM:{sample}\tLB:{sample}\n",
                      ["chr1"], [chrom_len])
        for rec in recs:
            w.save_alignment(rec)
        w.close()
        build_bai(path)
        bams.append(path)
    return dict(bams=bams, fasta=fasta, bed=bed, loci=loci, genome=chrom)


def _records(path, no_native, monkeypatch, chrom="chr1", start=0,
             end=1 << 30):
    """A region's records through the decode window (native) or the
    streaming decoder (LONGTR_NO_NATIVE=1)."""
    if no_native:
        monkeypatch.setenv("LONGTR_NO_NATIVE", "1")
    try:
        return BamReader(path).fetch(chrom, start, end)
    finally:
        monkeypatch.delenv("LONGTR_NO_NATIVE", raising=False)


def _hp_variants_bam(tmp_path):
    """Records of every edge the columns have: no sequence (empty
    qualities), hard clips at either edge, an N, HP tags of every type."""
    rng = np.random.default_rng(5)
    chrom = "".join(rng.choice(list("ACGT"), 4000))
    hp_values = [1, 2, 1.0, 2.0, 3, "1", [1], None]
    recs = []
    for k in range(40):
        pos = 100 + 60 * k
        n = 200 + 7 * k
        seq = chrom[pos:pos + n]
        cigar = [("M", n)]
        if k % 5 == 1:
            cigar = [("H", 12)] + cigar
        if k % 7 == 2:
            cigar = cigar + [("H", 9)]
        if k % 6 == 3:
            seq = seq[:50] + "N" + seq[51:]
        qual = _qual(rng, n, 0, 94)
        if k == 9:
            seq, qual = "", ""       # sequence and qualities absent
        tags = {"RG": "rg"}
        hp = hp_values[k % len(hp_values)]
        if hp is not None:
            tags["HP"] = hp
        recs.append(BamRecord(
            name=f"r{k}", flag=0, ref_id=0, pos=pos, mapq=60, cigar=cigar,
            mate_ref_id=-1, mate_pos=-1, tlen=0, seq=seq, qual=qual,
            tags=tags, ref_name="chr1", mate_ref_name="*"))
    path = str(tmp_path / "edges.bam")
    w = BamWriter(path, "@SQ\tSN:chr1\tLN:4000\n", ["chr1"], [4000])
    for rec in recs:
        w.save_alignment(rec)
    w.close()
    build_bai(path)
    return path


def _batch_of(recs):
    batches = {id(r._src[0]) for r in recs}
    assert len(batches) == 1, "one decode window serves one fetch"
    return recs[0]._src[0]


def test_decode_columns_equal_the_python_expressions(tmp_path, monkeypatch,
                                                     long_reads):
    """Every record of a decoded window: its gates, quality sum, CIGAR
    edges, length, CIGAR, sequence, qualities and HP tag equal the
    streaming decoder's record's."""
    paths = [_hp_variants_bam(tmp_path)] + long_reads["bams"]
    seen = {"empty": 0, "hard": 0, "N": 0, "hp_types": set()}
    for path in paths:
        got = _records(path, False, monkeypatch)
        want = _records(path, True, monkeypatch)
        assert [r.name for r in got] == [r.name for r in want] and got
        assert all("_src" not in r.__dict__ for r in want)
        batch = _batch_of(got)
        gates = batch.read_gates()
        for rec, py in zip(got, want):
            i = rec._src[1]
            has_n, mean_q, hard = gates[i]
            py_hard = py.starts_with_hard_clip() or py.ends_with_hard_clip()
            assert has_n == ("N" in py.seq)
            # the exact float: equal and of the same bits
            assert mean_q.hex() == mean_phred(py.qual).hex()
            assert hard == py_hard
            assert int(batch.qual_sums[i]) == sum(py.qual.encode())
            assert rec.starts_with_hard_clip() == py.starts_with_hard_clip()
            assert rec.ends_with_hard_clip() == py.ends_with_hard_clip()
            assert (rec.length, rec.n_cigar) == (len(py.seq), len(py.cigar))
            assert "seq" not in rec.__dict__, "length read the column"
            hp = rec.get_tag("HP")
            assert hp == py.get_tag("HP") and type(hp) is type(
                py.get_tag("HP"))
            assert (rec.cigar, rec.seq, rec.qual, rec.end_pos) == \
                (py.cigar, py.seq, py.qual, py.end_pos)
            seen["empty"] += py.qual == ""
            seen["hard"] += py_hard
            seen["N"] += has_n
            seen["hp_types"].add(type(hp).__name__)
    assert seen["empty"] == 1 and seen["hard"] > 2 and seen["N"] > 3
    assert seen["hp_types"] == {"int", "float", "str", "list", "NoneType"}


def _alignments(res):
    alns, p1, p2, n1, n2 = res
    return ([(a.start, a.stop, a.rev_strand, a.deleted, a.name,
              a.base_qualities, a.sequence, a.alignment, a.cigar,
              a.use_for_haps) for a in alns], p1, p2, n1, n2)


def test_trim_from_batch_rows_equals_python_trim(long_reads, monkeypatch):
    """At each locus, the native trim of records read from their batch
    rows, of records whose rows it copies, and of a mix of both equals
    the pure-Python trim_alignment + expand_cigar_vs_ref."""
    chrom = long_reads["genome"]
    recs = [_records(p, False, monkeypatch) for p in long_reads["bams"]]
    kept = 0
    for loc in long_reads["loci"]:
        group = RegionGroup.single(
            Region("chr1", loc.start, loc.stop, loc.motif))
        samples = [[r for r in rs if r.pos <= loc.start - 200
                    and r.end_pos >= loc.stop + 200] for rs in recs]
        p1 = [[0.0] * len(s) for s in samples]

        def run(copy):
            return alignment.left_align_reads(
                group, chrom, [[copy(r, j) for j, r in enumerate(s)]
                               for s in samples], p1, p1)

        def copied(r, j):
            """A clone that no longer names its batch row, as a CRAM
            record: its fields read before the row is dropped."""
            c = r.clone()
            c.seq, c.qual, c.cigar = c.seq, c.qual, c.cigar
            del c._src
            return c

        from_rows = run(lambda r, j: r.clone())
        assert _alignments(from_rows) == _alignments(run(copied))
        assert _alignments(from_rows) == _alignments(
            run(lambda r, j: copied(r, j) if j % 2 else r.clone()))
        monkeypatch.setenv("LONGTR_NO_NATIVE", "1")
        try:
            python = run(lambda r, j: r.clone())
        finally:
            monkeypatch.delenv("LONGTR_NO_NATIVE")
        assert _alignments(from_rows) == _alignments(python)
        kept += len(from_rows[0])
    assert kept > 100


def _bam_body(path):
    """A BAM's uncompressed bytes."""
    r = BgzfReader(path)
    out = []
    while chunk := r.read(1 << 20):
        out.append(chunk)
    return b"".join(out)


def _to_cram(bam, fasta_seq, out):
    r = BamReader(bam)
    w = CramWriter(out, r.header.text, r.header.ref_names,
                   r.header.ref_lengths)
    w.set_reference(0, fasta_seq)
    while (rec := r.get_next_alignment()) is not None:
        w.save_alignment(rec)
    w.close()
    return out


def _port_run(fx, tmp, tag, monkeypatch, bams=None, no_native=False):
    """One port run: VCF body, per-locus FilterCounters, --metrics-out,
    and the --pass-bam/--filt-bam bytes."""
    counters = []
    inner = processor.read_and_filter_reads

    def spy(*a, **k):
        out = inner(*a, **k)
        counters.append(out[-1])
        return out

    monkeypatch.setattr(processor, "read_and_filter_reads", spy)
    if no_native:
        monkeypatch.setenv("LONGTR_NO_NATIVE", "1")
    vcf, met = str(tmp / f"{tag}.vcf.gz"), str(tmp / f"{tag}.json")
    pass_bam, filt_bam = str(tmp / f"{tag}.pass.bam"), str(tmp / f"{tag}.filt.bam")
    try:
        assert port_main(_argv(fx, vcf, bams) + [
            "--metrics-out", met, "--pass-bam", pass_bam,
            "--filt-bam", filt_bam], device=CPU) == 0
    finally:
        monkeypatch.undo()
    with open(met) as fh:
        metrics = json.load(fh)
    return dict(vcf=_body(vcf), counters=counters, metrics=metrics,
                pass_bam=_bam_body(pass_bam), filt_bam=_bam_body(filt_bam),
                pass_path=pass_bam, filt_path=filt_bam)


def _argv(fx, out, bams=None):
    return ["--bams", ",".join(bams or fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--tr-vcf", out, "--min-reads", "5",
            "--max-tr-len", "10000", "--skip-assembly", "--phased-bam",
            "--quiet"]


def _body(path):
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("##command")]


def test_long_reads_same_outputs_on_both_paths(long_reads, tmp_path,
                                               monkeypatch):
    fx = long_reads
    cols = _port_run(fx, tmp_path, "columns", monkeypatch)
    fall = _port_run(fx, tmp_path, "fallback", monkeypatch, no_native=True)
    crams = [_to_cram(b, fx["genome"], str(tmp_path / (os.path.basename(b)
                                                       + ".cram")))
             for b in fx["bams"]]
    cram = _port_run(fx, tmp_path, "cram", monkeypatch, bams=crams)
    jax_vcf = str(tmp_path / "jax.vcf.gz")
    assert jax_main(_argv(fx, jax_vcf)) == 0

    calls = [ln for ln in cols["vcf"] if not ln.startswith("#")]
    assert len(calls) == N_LOCI
    assert cols["vcf"] == fall["vcf"] == cram["vcf"] == _body(jax_vcf)
    assert len(cols["counters"]) == N_LOCI
    assert cols["counters"] == fall["counters"] == cram["counters"]
    # the fixture's planted reads reach every gate
    total = {k: sum(getattr(c, k) for c in cols["counters"])
             for k in ("read_has_N", "low_qual_score", "hard_clip",
                       "low_mapq")}
    assert all(v > 0 for v in total.values()), total
    assert cols["pass_bam"] == fall["pass_bam"]
    assert cols["filt_bam"] == fall["filt_bam"]
    reasons = {r.tags.get("FT") for r in _all_records(cols["filt_path"])}
    assert {"HAS_N_BASES", "LOW_BASE_QUALS", "HARD_CLIPPED",
            "LOW_MAPQ"} <= reasons
    assert all("PF" in r.tags for r in _all_records(cols["pass_path"]))

    # which path each (record, locus) pair took
    pairs = sum(c.reads_from_columns + c.reads_fallback
                for c in cols["counters"])
    assert pairs > N_LOCI * 3 * 12
    for run in (cols, fall, cram):
        assert run["metrics"]["reads_from_columns"] + \
            run["metrics"]["reads_fallback"] == pairs
    assert cols["metrics"]["reads_fallback"] == 0
    assert fall["metrics"]["reads_from_columns"] == 0
    assert cram["metrics"]["reads_from_columns"] == 0
    assert [(c.reads_from_columns, c.reads_fallback)
            for c in cols["counters"]] == [
        (c.reads_fallback, c.reads_from_columns) for c in fall["counters"]]


def _all_records(path):
    r = BamReader(path)
    out = []
    while (rec := r.get_next_alignment()) is not None:
        out.append(rec)
    return out
