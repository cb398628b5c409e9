"""Seeded input catalogs of the smoke test and the port's tests.

Copies of the JAX package's fixture builders, writing the same bytes for
the same seed: :func:`dryrun_catalog` is ``__graft_entry__._dryrun_catalog``
and :func:`build_catalog` is ``benchmarks/loci_throughput.build_catalog``.
"""

import os

import numpy as np

from longtr_tpu_torch.io.bgzf import BgzfWriter
from longtr_tpu_torch.io.fasta import write_fasta
from longtr_tpu_torch.testing.synth import (Locus, make_genome, write_bed,
                                            write_sample_bam)


def dryrun_catalog(tmp):
    """A 24-locus catalog covering every surface the mesh routes:
    diploid STRs (chr1/chr2), homopolymers for mode-B
    (--stutter-align-len), a haploid chromosome (--haploid-chrs), plus a
    phased SNP VCF (--snp-vcf) and a panel VCF (--ref-vcf)."""
    rng = np.random.default_rng(2025_05)
    motifs = ["AC", "AGAT", "CTG", "TTTA", "ACGGT"]
    loci = []
    for chrom, n in (("chr1", 10), ("chr2", 10), ("chrH", 4)):
        for k in range(n):
            if chrom != "chrH" and k in (4, 9):
                # homopolymers: the loci --stutter-align-len routes mode-B
                loci.append(Locus(chrom, 1000 + k * 1500, "T", 14,
                                  f"{chrom}_HOMO{k}"))
            else:
                m = motifs[k % len(motifs)]
                loci.append(Locus(chrom, 1000 + k * 1500, m,
                                  int(rng.integers(8, 16)), f"{chrom}_L{k}"))
    chrom_len = 1000 + 10 * 1500 + 1000
    genome = make_genome(rng, loci, chrom_len=chrom_len)
    fasta = os.path.join(tmp, "g.fa")
    write_fasta(fasta, {c: genome[c] for c in sorted(genome)})
    bed = os.path.join(tmp, "r.bed")
    write_bed(bed, loci)

    bams = []
    for s in ("SAMP1", "SAMP2", "SAMP3"):
        gts = {}
        for loc in loci:
            a = loc.ref_copies + int(rng.integers(-2, 3))
            # haploid chromosome: homozygous so -haploid calls are clean
            b = a if loc.chrom == "chrH" else max(
                2, loc.ref_copies + int(rng.integers(-2, 3)))
            gts[loc.name] = (max(a, 2), b)
        path = os.path.join(tmp, s + ".bam")
        write_sample_bam(path, genome, loci, gts, s, rng, coverage=18)
        bams.append(path)

    # phased het SNPs on every chromosome (hap1 = ALT)
    lines = ["##fileformat=VCFv4.1",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             "SAMP1\tSAMP2\tSAMP3"]
    for chrom in sorted(genome):
        seq = genome[chrom]
        pos = 300
        while pos < len(seq) - 300:
            pos += int(rng.integers(40, 120))
            if pos >= len(seq) - 300:
                break
            ref = seq[pos].upper()
            alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
            lines.append(f"{chrom}\t{pos + 1}\tsnp{chrom}_{pos}\t{ref}\t"
                         f"{alt}\t.\t.\t.\tGT\t1|0\t1|0\t1|0")
    snp_vcf = os.path.join(tmp, "snps.vcf.gz")
    w = BgzfWriter(snp_vcf)
    w.write("\n".join(lines) + "\n")
    w.close()

    # panel VCF: ref + /-1,+1,+2-copy alts per locus (for --ref-vcf)
    plines = ["##fileformat=VCFv4.1",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for loc in loci:
        seq = genome[loc.chrom]
        ref = seq[loc.start: loc.stop]
        alts = [loc.motif * c for c in (loc.ref_copies - 1,
                                        loc.ref_copies + 1,
                                        loc.ref_copies + 2)]
        plines.append(
            f"{loc.chrom}\t{loc.start + 1}\t{loc.name}\t{ref}\t"
            f"{','.join(alts)}\t.\t.\tSTART={loc.start + 1};"
            f"END={loc.stop};PERIOD={len(loc.motif)}")
    panel = os.path.join(tmp, "panel.vcf.gz")
    w = BgzfWriter(panel)
    w.write("\n".join(plines) + "\n")
    w.close()
    return dict(fasta=fasta, bed=bed, bams=bams, snp_vcf=snp_vcf,
                panel=panel, n_loci=len(loci))


def build_catalog(tmpdir, n_loci, coverage=20, n_samples=3, seed=1,
                  vntr=False, ont=False):
    rng = np.random.default_rng(seed)
    loci = []
    per_chrom = 8
    if vntr:
        # multi-kb VNTRs (500-3000bp repeats, 10-31bp motifs): the
        # device-dominant regime (BASELINE config 5 scale-up)
        vmotifs = ["ACGGTCATGG", "ACGGTCATGGACGGTCA",
                   "ACGGTCATGGACGGTCATGGACG",
                   "ACGGTCATGGACGGTCATGGACGGTCATGGA"]
        offset = 1000
        chrom_i = 1
        k = 0
        for i in range(n_loci):
            motif = vmotifs[i % len(vmotifs)]
            copies = int(rng.integers(500 // len(motif),
                                      3000 // len(motif)))
            loci.append(Locus(f"chr{chrom_i}", offset, motif, copies,
                              f"L{i}"))
            offset = loci[-1].stop + 900
            k += 1
            if k == per_chrom:
                k = 0
                chrom_i += 1
                offset = 1000
        chrom_len = max(l.stop for l in loci) + 1200
    else:
        motifs = ["AC", "AGAT", "CTG", "TTTA", "ACGGT", "A"]
        for i in range(n_loci):
            chrom = f"chr{i // per_chrom + 1}"
            offset = (i % per_chrom) * 1500 + 1000
            motif = motifs[i % len(motifs)]
            copies = int(rng.integers(8, 20)) if motif != "A" else int(rng.integers(10, 25))
            loci.append(Locus(chrom, offset, motif, copies, f"L{i}"))
        chrom_len = per_chrom * 1500 + 2000
    genome = make_genome(rng, loci, chrom_len=chrom_len)
    fasta = os.path.join(tmpdir, "g.fa")
    write_fasta(fasta, genome)
    bed = os.path.join(tmpdir, "r.bed")
    write_bed(bed, loci)
    bams = []
    truth = {}
    for s in range(n_samples):
        gts = {}
        for loc in loci:
            a = loc.ref_copies
            b = a + int(rng.integers(-3, 4))
            gts[loc.name] = (a, max(b, 2))
        path = os.path.join(tmpdir, f"S{s}.bam")
        write_sample_bam(path, genome, loci, gts, f"S{s}", rng,
                         coverage=coverage,
                         sub_rate=0.02 if ont else 0.002,
                         indel_rate=0.02 if ont else 0.0)
        bams.append(path)
        truth[f"S{s}"] = dict(gts)
    return fasta, bed, bams, loci, truth
