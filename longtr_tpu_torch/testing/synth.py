"""Synthetic-data fixtures: genome + STR loci + haplotagged HiFi-like reads.

Builds real FASTA/BED/BAM files so the full pipeline (including the I/O
layer) is exercised end-to-end with known genotype truth.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from longtr_tpu_torch.io.bam import BamRecord
from longtr_tpu_torch.io.bam_write import BamWriter, build_bai
from longtr_tpu_torch.io.fasta import write_fasta

BASES = np.array(list("ACGT"))


@dataclass
class Locus:
    chrom: str
    start: int          # 0-based start of repeat in reference
    motif: str
    ref_copies: int
    name: str = ""

    @property
    def stop(self):
        return self.start + len(self.motif) * self.ref_copies


def make_genome(rng, loci, chrom_len=4000):
    """Random genome with the given loci embedded. Returns {chrom: seq}."""
    genome = {}
    by_chrom = {}
    for loc in loci:
        by_chrom.setdefault(loc.chrom, []).append(loc)
    for chrom, ls in by_chrom.items():
        seq = list(rng.choice(BASES, size=chrom_len))
        for loc in ls:
            repeat = loc.motif * loc.ref_copies
            seq[loc.start: loc.start + len(repeat)] = list(repeat)
            # avoid accidental repeat extension at the borders
            if loc.start > 0 and seq[loc.start - 1] == loc.motif[-1]:
                seq[loc.start - 1] = "ACGT"[("ACGT".index(loc.motif[-1]) + 1) % 4]
            end = loc.start + len(repeat)
            if end < chrom_len and seq[end] == loc.motif[0]:
                seq[end] = "ACGT"[("ACGT".index(loc.motif[0]) + 1) % 4]
        genome[chrom] = "".join(seq)
    return genome


def sample_haplotype_read(genome, locus, copies, flank=300, chrom_len=None):
    """Read sequence + CIGAR for a read spanning the locus with ``copies``
    motif copies, aligned at pos = locus.start - flank."""
    chrom_seq = genome[locus.chrom]
    pos = max(locus.start - flank, 0)
    left = chrom_seq[pos: locus.start]
    right_end = min(locus.stop + flank, len(chrom_seq))
    right = chrom_seq[locus.stop: right_end]
    repeat = locus.motif * copies
    seq = left + repeat + right
    ref_rep = len(locus.motif) * locus.ref_copies
    alt_rep = len(repeat)
    cigar = []
    if alt_rep == ref_rep:
        cigar.append(("M", len(seq)))
    elif alt_rep > ref_rep:
        cigar.append(("M", len(left) + ref_rep))
        cigar.append(("I", alt_rep - ref_rep))
        cigar.append(("M", len(right)))
    else:
        cigar.append(("M", len(left) + alt_rep))
        cigar.append(("D", ref_rep - alt_rep))
        cigar.append(("M", len(right)))
    return pos, seq, cigar


def add_errors(rng, seq, cigar, sub_rate=0.002):
    """Substitution-only errors (keeps the CIGAR valid)."""
    hits = np.flatnonzero(rng.random(len(seq)) < sub_rate)
    if not len(hits):
        return seq, cigar
    chars = list(seq)
    for i in hits:
        chars[i] = str(rng.choice(BASES))
    return "".join(chars), cigar


def write_sample_bam(path, genome, loci, genotypes, sample, rng,
                     coverage=20, flank=300, sub_rate=0.0, haplotag=True,
                     indel_rate=0.0):
    """Write a coordinate-sorted BAM (+ .bai) for one sample.

    genotypes: {locus_name: (copies_hap1, copies_hap2)}
    """
    ref_names = sorted(genome.keys())
    ref_lengths = [len(genome[c]) for c in ref_names]
    rid = {c: i for i, c in enumerate(ref_names)}
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              + "".join(f"@SQ\tSN:{c}\tLN:{len(genome[c])}\n" for c in ref_names)
              + f"@RG\tID:rg_{sample}\tSM:{sample}\tLB:{sample}\n")
    records = []
    n = 0
    for loc in loci:
        g = genotypes[loc.name or loc.chrom + str(loc.start)]
        for k in range(coverage):
            hap = 1 + (k % 2)
            copies = g[hap - 1]
            pos, seq, cigar = sample_haplotype_read(genome, loc, copies, flank)
            if sub_rate:
                seq, cigar = add_errors(rng, seq, cigar, sub_rate)
            if indel_rate:
                seq, cigar = add_indel_errors(rng, seq, cigar, indel_rate)
            tags = {"RG": f"rg_{sample}"}
            if haplotag:
                tags["HP"] = hap
            rec = BamRecord(
                name=f"{sample}_read_{loc.name}_{n}", flag=16 * (k % 2),
                ref_id=rid[loc.chrom], pos=pos, mapq=60, cigar=cigar,
                mate_ref_id=-1, mate_pos=-1, tlen=0, seq=seq,
                qual="I" * len(seq), tags=tags, filename=path,
                ref_name=loc.chrom, mate_ref_name="*")
            records.append(rec)
            n += 1
    records.sort(key=lambda r: (r.ref_id, r.pos))
    w = BamWriter(path, header, ref_names, ref_lengths)
    for rec in records:
        w.save_alignment(rec)
    w.close()
    build_bai(path)
    return path


def write_bed(path, loci):
    with open(path, "w") as fh:
        for loc in loci:
            fh.write(f"{loc.chrom}\t{loc.start + 1}\t{loc.stop}\t{loc.motif}"
                     f"\t{loc.name}\n")
    return path


def standard_fixture(tmpdir, rng=None, sub_rate=0.0):
    """Three-sample trio-like fixture with several loci. Returns a dict."""
    rng = rng or np.random.default_rng(20240816)
    loci = [
        Locus("chr1", 1000, "AC", 10, "STR_AC"),
        Locus("chr1", 2000, "AGAT", 8, "STR_AGAT"),
        Locus("chr2", 1500, "TTTA", 9, "STR_TTTA"),
        Locus("chr3", 1200, "CTG", 12, "STR_CTG"),
    ]
    genome = make_genome(rng, loci)
    fasta = os.path.join(tmpdir, "genome.fa")
    write_fasta(fasta, {c: genome[c] for c in sorted(genome)})
    bed = os.path.join(tmpdir, "regions.bed")
    write_bed(bed, loci)
    genotypes = {
        "SAMP1": {"STR_AC": (10, 13), "STR_AGAT": (8, 8),
                  "STR_TTTA": (9, 7), "STR_CTG": (12, 14)},
        "SAMP2": {"STR_AC": (9, 10), "STR_AGAT": (6, 8),
                  "STR_TTTA": (9, 9), "STR_CTG": (12, 12)},
        "SAMP3": {"STR_AC": (13, 13), "STR_AGAT": (8, 10),
                  "STR_TTTA": (7, 9), "STR_CTG": (11, 14)},
    }
    bams = []
    for sample in sorted(genotypes):
        path = os.path.join(tmpdir, sample + ".bam")
        write_sample_bam(path, genome, loci, genotypes[sample], sample, rng,
                         coverage=20, sub_rate=sub_rate)
        bams.append(path)
    return dict(loci=loci, genome=genome, fasta=fasta, bed=bed,
                genotypes=genotypes, bams=bams)


def add_indel_errors(rng, seq, cigar, rate=0.01):
    """Sequencing-style indel errors with a consistent CIGAR.

    Each read base is deleted with probability rate/2 or gains a random
    inserted base before it with probability rate/2 (as an aligner would
    report: D consumes reference only, I consumes read only).
    """
    per_base = []
    for op, n in cigar:
        per_base.extend([op] * n)
    out_seq = []
    out_ops = []
    i = 0
    for op in per_base:
        if op in ("D", "N"):
            out_ops.append(op)
            continue
        ch = seq[i]
        i += 1
        r = rng.random()
        if r < rate / 2 and op == "M":
            out_ops.append("D")          # base dropped by the sequencer
        elif r < rate:
            out_ops.append("I")
            out_seq.append(str(rng.choice(BASES)))
            out_ops.append(op)
            out_seq.append(ch)
        else:
            out_ops.append(op)
            out_seq.append(ch)
    comp = []
    for op in out_ops:
        if comp and comp[-1][0] == op:
            comp[-1][1] += 1
        else:
            comp.append([op, 1])
    return "".join(out_seq), [(op, n) for op, n in comp]


def vcf_body(path):
    """Canonical VCF-comparison helper: every line except the run-specific
    ##command header.  Shared by the shard/merge identity tests and the
    scaling/scale benchmarks so they all enforce the same byte-identity."""
    from longtr_tpu_torch.io.bgzf import bgzf_open_text
    with bgzf_open_text(path) as fh:
        return [ln for ln in fh if not ln.startswith("##command")]
