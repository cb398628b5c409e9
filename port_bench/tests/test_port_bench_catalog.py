"""The frozen traffic generator: its writers against the program's, and
what it draws."""

import filecmp
import gzip
import hashlib
import json
import os

import numpy as np
import pytest

from _paths import HARNESS
from pbench import catalog


def _load(name):
    with open(os.path.join(HARNESS, name)) as fh:
        return json.load(fh)


def _small(mix, n_loci=6, coverage=4):
    traffic = dict(_load(f"traffic/{mix}.json"), n_loci=n_loci)
    reads = dict(_load("configs/hifi_trio.json")["reads"], coverage=coverage)
    return traffic, reads


def _genome(path):
    genome, chrom = {}, None
    for line in open(path):
        if line.startswith(">"):
            chrom = line[1:].strip()
            genome[chrom] = []
        else:
            genome[chrom].append(line.strip())
    return {c: "".join(v) for c, v in genome.items()}


@pytest.mark.parametrize("mix", ["str_mix", "vntr"])
def test_the_writers_write_the_programs_bytes(tmp_path, mix):
    """The frozen BGZF, BAM, BAI and FASTA writers, given the permuted
    catalog's genome and reads, write what the program's writers do."""
    from longtr_tpu_torch.io.bam import BamRecord
    from longtr_tpu_torch.io.bam_write import BamWriter
    from longtr_tpu_torch.io.bam_write import build_bai as their_bai
    from longtr_tpu_torch.io.fasta import write_fasta as their_fasta
    traffic, reads = _small(mix, coverage=12)
    genome, _loci, alleles, (pad, content, order) = catalog.layout(
        traffic, 1, 2 ** 31 + 9)
    haps = [catalog.Haplotype(*catalog._haplotype(
        pad, content, order, [a[h] for a in alleles[0]]), reads)
        for h in range(2)]
    records = catalog.sample_records(haps, "S0", reads,
                                     np.random.default_rng(5))
    assert len(records) > 10
    header = catalog.sample_header(genome, "S0")
    lengths = [len(genome[catalog.CHROM])]
    ours, theirs = tmp_path / "ours.bam", tmp_path / "theirs.bam"
    catalog.write_bam(str(ours), header, [catalog.CHROM], lengths, records)
    catalog.build_bai(str(ours))
    w = BamWriter(str(theirs), header, [catalog.CHROM], lengths)
    for r in records:
        w.save_alignment(BamRecord(
            name=r.name, flag=r.flag, ref_id=r.ref_id, pos=r.pos, mapq=60,
            cigar=r.cigar, mate_ref_id=-1, mate_pos=-1, tlen=0, seq=r.seq,
            qual="I" * len(r.seq), tags=r.tags, filename=str(theirs),
            ref_name=catalog.CHROM, mate_ref_name="*"))
    w.close()
    their_bai(str(theirs))
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert filecmp.cmp(f"{ours}.bai", f"{theirs}.bai", shallow=False)
    catalog.write_fasta(str(tmp_path / "ours.fa"), genome)
    their_fasta(str(tmp_path / "theirs.fa"), genome)
    assert filecmp.cmp(tmp_path / "ours.fa", tmp_path / "theirs.fa",
                       shallow=False)


@pytest.mark.parametrize("mix", ["str_mix", "vntr"])
def test_reads_are_their_haplotype_with_hifi_errors(tmp_path, mix):
    """Every read, laid on the reference by its CIGAR and position, is
    its haplotype's bases with about the configured substitutions; the
    program's reader reads the BAM back, and reads span the loci at about
    the configured depth."""
    from longtr_tpu_torch.io.bam import BamReader
    traffic, reads = _small(mix, n_loci=12, coverage=10)
    cat = catalog.build(str(tmp_path), traffic, reads, 2 ** 31 + 3)
    ref = _genome(cat["fasta"])[catalog.CHROM]
    recs = list(BamReader(cat["bams"][0]).fetch(catalog.CHROM, 0, len(ref)))
    assert recs and {r.name for r in recs} <= set(cat["reads"])
    matched = mismatched = 0
    lengths = []
    for r in recs:
        assert r.cigar[0][0] == "M" and r.cigar[-1][0] == "M"
        assert r.get_tag("HP") == cat["reads"][r.name][1]
        i, j = 0, r.pos
        for op, n in r.cigar:
            if op == "M":
                a, b = np.frombuffer(r.seq[i:i + n].encode(), np.uint8), \
                    np.frombuffer(ref[j:j + n].encode(), np.uint8)
                mismatched += int((a != b).sum())
                matched += n
                i, j = i + n, j + n
            elif op == "I":
                i += n
            else:
                j += n
        assert i == len(r.seq)
        if 0 < r.pos and r.end_pos < len(ref) - 1:      # not clipped
            lengths.append(len(r.seq))
    assert mismatched / matched < 4 * reads["sub_rate"]
    assert len(lengths) > 5
    assert abs(np.median(lengths) / reads["length_mean"] - 1) < 0.15
    for loc in cat["loci"]:
        span = sum(r.pos <= loc.start and r.end_pos >= loc.stop for r in recs)
        assert span >= reads["coverage"] / 3, (loc, span)


def test_every_seed_gets_the_same_loci_in_another_order(tmp_path):
    traffic, reads = _small("vntr", n_loci=16, coverage=2)
    content, orders = [], []
    for seed in (1, 2 ** 31 + 5):
        d = tmp_path / str(seed)
        d.mkdir()
        cat = catalog.build(str(d), traffic, reads, seed)
        genome = _genome(cat["fasta"])
        pad = traffic["left_pad"]
        loci = [(l.motif, l.ref_copies,
                 genome[l.chrom][l.start - pad: l.stop + traffic["right_pad"]],
                 tuple(cat["truth"][s][l.name] for s in sorted(cat["truth"])))
                for l in cat["loci"]]
        content.append(sorted(loci))
        orders.append([x[2] for x in loci])
    assert content[0] == content[1]
    assert orders[0] != orders[1]


# sha256 of the three BAMs' decompressed bytes, one after another, that
# the generator wrote for _small("str_mix") at seed 2**31 + 77 before it
# took ``haplotags``; the decompressed bytes, so that the zlib build does
# not enter
STR_MIX_BAMS = \
    "c3ca1819adf8cb647fc753d011c9af5c5705fcd286757899b49b537a38e142b5"


def _bam_digest(cat):
    h = hashlib.sha256()
    for path in cat["bams"]:
        with gzip.open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_str_mix_reads_are_those_it_always_drew(tmp_path):
    traffic, reads = _small("str_mix")
    assert "haplotags" not in reads
    cat = catalog.build(str(tmp_path), traffic, reads, 2 ** 31 + 77)
    assert _bam_digest(cat) == STR_MIX_BAMS


def test_untagged_reads_are_the_same_reads_without_hp(tmp_path):
    from longtr_tpu_torch.io.bam import BamReader
    traffic, reads = _small("str_mix")
    cats = {}
    for tagged, r in ((True, reads), (False, dict(reads, haplotags=False))):
        d = tmp_path / str(tagged)
        d.mkdir()
        cats[tagged] = catalog.build(str(d), traffic, r, 2 ** 31 + 77)
    assert cats[True]["reads"].keys() == cats[False]["reads"].keys()
    for name, (s, hp) in cats[False]["reads"].items():
        assert (s, -1) == (cats[True]["reads"][name][0], hp)
    for a, b in zip(cats[True]["bams"], cats[False]["bams"]):
        tagged = list(BamReader(a).fetch(catalog.CHROM, 0, 10 ** 9))
        untagged = list(BamReader(b).fetch(catalog.CHROM, 0, 10 ** 9))
        assert [(r.name, r.pos, r.cigar, r.seq) for r in tagged] == \
            [(r.name, r.pos, r.cigar, r.seq) for r in untagged]
        assert all(r.get_tag("HP") in (1, 2) for r in tagged)
        assert all(r.get_tag("HP") is None for r in untagged)
