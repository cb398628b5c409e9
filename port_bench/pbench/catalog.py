"""The benchmark's one traffic generator: a seeded catalog of tandem-repeat
loci on one chromosome, and one indexed BAM of haplotagged long reads a
sample, drawn at a depth over each sample's two haplotypes.

The BGZF, BAM, BAI and FASTA writers are frozen copies of the port's
(``io/bgzf.py``, ``io/bam_write.py``, ``io/fasta.py``), importing nothing of
the program, so a later change to those files cannot move the yardstick;
``tests/test_port_bench_catalog.py`` holds them to the program's byte for
byte.

Every number comes from two files: a traffic mix (the loci: motifs,
repeat sizes, the genome around them) and a configuration's ``reads``
(samples, depth, read lengths, error rates).  Every seed gets the same
loci, each with the same flanking genome and alleles, in another order on
the chromosome; the seed also draws where the reads start, their lengths
and their errors.  So a seed changes which position holds which locus and
which reads cover it, not how much work a pass holds.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

# ---------------------------------------------------------------------------
# BGZF (io/bgzf.py)
# ---------------------------------------------------------------------------

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_HEADER = struct.Struct("<4BI2BH")


class BgzfWriter:
    MAX_BLOCK = 0xFF00

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._level = level
        self._buf = bytearray()

    def write(self, data) -> None:
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[: self.MAX_BLOCK])
            del self._buf[: self.MAX_BLOCK]

    def _flush_block(self, chunk) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(chunk)) + co.flush()
        crc = zlib.crc32(bytes(chunk)) & 0xFFFFFFFF
        bsize = len(cdata) + 12 + 6 + 8 - 1
        self._fh.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                       + struct.pack("<H", 6)
                       + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize)
                       + cdata + struct.pack("<II", crc,
                                             len(chunk) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()


class BgzfReader:
    """Sequential BGZF reader with virtual offsets (what the BAI needs)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._load_block(0)

    def close(self) -> None:
        self._fh.close()

    def _read_block_at(self, coffset: int):
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) == 0:
            return b"", 0
        *_magic, xlen = _HEADER.unpack(header)
        extra = self._fh.read(xlen)
        bsize = struct.unpack_from("<H", extra, 4)[0] + 1
        cdata = self._fh.read(bsize - 12 - xlen - 8)
        self._fh.read(8)
        return zlib.decompress(cdata, -15), bsize

    def _load_block(self, coffset: int) -> None:
        self._block_data, self._block_len_comp = self._read_block_at(coffset)
        self._block_start = coffset
        self._within = 0

    @property
    def virtual_offset(self) -> int:
        if self._within >= len(self._block_data) and self._block_len_comp:
            return (self._block_start + self._block_len_comp) << 16
        return (self._block_start << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block_data) - self._within
            if avail == 0:
                nxt = self._block_start + self._block_len_comp
                data, bsize = self._read_block_at(nxt)
                if bsize == 0:
                    break
                self._block_start = nxt
                self._block_data = data
                self._block_len_comp = bsize
                self._within = 0
                continue
            take = min(n, avail)
            out += self._block_data[self._within: self._within + take]
            self._within += take
            n -= take
        return bytes(out)


# ---------------------------------------------------------------------------
# BAM + BAI (io/bam_write.py)
# ---------------------------------------------------------------------------

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"
_QUAL_XLAT = bytes(min(max(i - 33, 0), 93) for i in range(256))
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _i, _ch in enumerate(SEQ_NT16):
    _NT16_LUT[ord(_ch)] = _i
_CIGAR_CODE = {ch: i for i, ch in enumerate(CIGAR_OPS)}


@dataclass
class Read:
    name: str
    flag: int
    ref_id: int
    pos: int
    cigar: list
    seq: str
    tags: dict


def encode_record(rec: Read) -> bytes:
    name = rec.name.encode() + b"\x00"
    parts = [struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(name), 60,
                         0, len(rec.cigar), rec.flag, len(rec.seq), -1, -1, 0)]
    parts.append(name)
    for op, n in rec.cigar:
        parts.append(struct.pack("<I", (n << 4) | _CIGAR_CODE[op]))
    codes = _NT16_LUT[np.frombuffer(rec.seq.upper().encode(), np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    parts.append(((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes())
    parts.append(("I" * len(rec.seq)).encode().translate(_QUAL_XLAT))
    for tag, val in rec.tags.items():
        if isinstance(val, str):
            parts.append(tag.encode() + b"Z" + val.encode() + b"\x00")
        else:
            parts.append(tag.encode() + b"i" + struct.pack("<i", val))
    body = b"".join(parts)
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, header_text: str, ref_names, ref_lengths,
              records) -> None:
    w = BgzfWriter(path)
    text = header_text.encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    w.write(struct.pack("<i", len(ref_names)))
    for name, length in zip(ref_names, ref_lengths):
        nb = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
    for rec in records:
        w.write(encode_record(rec))
    w.close()


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


def build_bai(bam_path: str) -> str:
    """A .bai (bins and linear index) for a coordinate-sorted BAM."""
    r = BgzfReader(bam_path)
    r.read(4)
    (l_text,) = struct.unpack("<i", r.read(4))
    r.read(l_text)
    (n_ref,) = struct.unpack("<i", r.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", r.read(4))
        r.read(l_name + 4)
    refs = [[{}, []] for _ in range(n_ref)]
    while True:
        v_start = r.virtual_offset
        hdr = r.read(4)
        if len(hdr) < 4:
            break
        (block_size,) = struct.unpack("<i", hdr)
        data = r.read(block_size)
        if len(data) < block_size:
            break
        v_end = r.virtual_offset
        ref_id, pos = struct.unpack_from("<ii", data, 0)
        if ref_id < 0:
            continue
        (n_cigar,) = struct.unpack_from("<H", data, 12)
        off = 32 + data[8]
        ref_len = 0
        for k in range(n_cigar):
            (v,) = struct.unpack_from("<I", data, off + 4 * k)
            if CIGAR_OPS[v & 0xF] in "MDN=X":
                ref_len += v >> 4
        end = pos + max(ref_len, 1)
        bins, intervals = refs[ref_id]
        bins.setdefault(_reg2bin(pos, end), []).append((v_start, v_end))
        for win in range(pos >> 14, ((end - 1) >> 14) + 1):
            while len(intervals) <= win:
                intervals.append(0)
            if intervals[win] == 0 or v_start < intervals[win]:
                intervals[win] = v_start
    r.close()
    out_path = bam_path + ".bai"
    with open(out_path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for bins, intervals in refs:
            fh.write(struct.pack("<i", len(bins)))
            for b, chunks in bins.items():
                merged = []
                for cb, ce in sorted(chunks):
                    if merged and cb <= merged[-1][1]:
                        merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
                    else:
                        merged.append((cb, ce))
                fh.write(struct.pack("<Ii", b, len(merged)))
                for cb, ce in merged:
                    fh.write(struct.pack("<QQ", cb, ce))
            filled = []
            prev = 0
            for v in intervals:
                prev = v if v else prev
                filled.append(prev)
            fh.write(struct.pack("<i", len(filled)))
            for v in filled:
                fh.write(struct.pack("<Q", v))
    return out_path


# ---------------------------------------------------------------------------
# Genome, loci and reads
# ---------------------------------------------------------------------------

CHROM = "chr1"


@dataclass
class Locus:
    chrom: str
    start: int          # 0-based start of the repeat
    motif: str
    ref_copies: int
    name: str

    @property
    def stop(self) -> int:
        return self.start + len(self.motif) * self.ref_copies


def _codes(s: str) -> np.ndarray:
    return np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                           np.frombuffer(s.encode(), np.uint8)).astype(np.uint8)


def _text(codes) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()


def _copy_range(traffic, motif) -> tuple:
    """[low, high) of a motif's copies in the reference."""
    if traffic["kind"] == "vntr":
        lo_bp, hi_bp = traffic["repeat_bp"]
        return lo_bp // len(motif), hi_bp // len(motif)
    return tuple(traffic["copies"].get(motif, traffic["copies"]["*"]))


def _content(traffic, samples):
    """Each locus content c from its own RNG (the mix's ``content_seed``
    and c): motif, reference copies, each sample's allele offset, and the
    flanking genome, whose borders never extend the repeat."""
    lo_d, hi_d = traffic["alt_delta"]
    out = []
    for c in range(traffic["n_loci"]):
        crng = np.random.default_rng([traffic["content_seed"], c])
        motif = traffic["motifs"][c % len(traffic["motifs"])]
        copies = int(crng.integers(*_copy_range(traffic, motif)))
        deltas = [int(d) for d in crng.integers(lo_d, hi_d, size=samples)]
        left = crng.integers(0, 4, traffic["left_pad"]).astype(np.uint8)
        right = crng.integers(0, 4, traffic["right_pad"]).astype(np.uint8)
        m = _codes(motif)
        if left[-1] == m[-1]:
            left[-1] = (m[-1] + 1) % 4
        if right[0] == m[0]:
            right[0] = (m[0] + 1) % 4
        out.append((motif, copies, deltas, left, right))
    return out


def _haplotype(pad, content, order, alleles):
    """(bases, reference position of each base or -1 where inserted,
    [(base, reference bases deleted after it)]) of one haplotype: the
    chromosome with locus p's repeat at ``alleles[p]`` copies.  An allele
    longer than the reference inserts its extra copies after the
    reference's; a shorter one deletes the reference's last copies."""
    bases, refpos, dels = [pad[0]], [np.arange(len(pad[0]))], []
    at_ref, at_hap = len(pad[0]), len(pad[0])
    for p, c in enumerate(order):
        motif, copies, _d, left, right = content[c]
        k, n = len(motif), alleles[p]
        rep = np.tile(_codes(motif), n)
        same = min(n, copies) * k
        bases += [left, rep, right]
        refpos.append(np.arange(at_ref, at_ref + len(left) + same))
        at_ref += len(left) + copies * k
        if n > copies:
            refpos.append(np.full((n - copies) * k, -1))
        elif n < copies:
            dels.append((at_hap + len(left) + same - 1, (copies - n) * k))
        refpos.append(np.arange(at_ref, at_ref + len(right)))
        at_ref += len(right)
        at_hap += len(left) + n * k + len(right)
    bases.append(pad[1])
    refpos.append(np.arange(at_ref, at_ref + len(pad[1])))
    return np.concatenate(bases), np.concatenate(refpos), dels


def _run_lengths(bases) -> np.ndarray:
    """The length of the homopolymer run each base lies in."""
    edge = np.flatnonzero(np.diff(bases)) + 1
    starts = np.concatenate([[0], edge])
    lens = np.diff(np.concatenate([starts, [len(bases)]]))
    return np.repeat(lens, lens)


class Haplotype:
    """One haplotype of a sample, with what drawing its reads needs: the
    bases (ASCII), each base's reference position (-1 where the allele
    inserts it), the reference bases deleted after a base, and each base's
    error thresholds (substitution; deletion; insertion, cumulative), the
    indel rates higher inside homopolymer runs."""

    def __init__(self, codes, refpos, dels, reads):
        self.text = _text(codes).encode()
        self.refpos = refpos
        self.aligned = np.flatnonzero(refpos >= 0)
        self.dels = dels                        # [(base, bases deleted)]
        ins = refpos < 0
        edge = np.flatnonzero(np.diff(ins.astype(np.int8))) + 1
        self.ins_starts = edge[ins[edge]]
        self.ins_ends = edge[~ins[edge]]
        run = _run_lengths(codes) >= reads["hp_min"]
        half = 0.5 * (reads["indel_rate"] + run * reads["hp_indel_rate"])
        self.t_sub = reads["sub_rate"]
        self.t_del = self.t_sub + half
        self.t_ins = self.t_sub + 2 * half
        self.run = run

    def read(self, rng, a, b):
        """(sequence, CIGAR, position) of the read of bases [a, b) with
        HiFi errors: substitutions, and insertions and deletions of one
        base, more often inside homopolymer runs, where an insertion
        repeats the run's base.  The first and last bases carry no error."""
        u = rng.random(b - a)
        u[0] = u[-1] = 1.0
        hit = np.flatnonzero(u < self.t_ins[a:b])
        at = hit + a
        kind = np.where(u[hit] < self.t_sub, 1,
                        np.where(u[hit] < self.t_del[at], 2, 3))
        alt = rng.integers(1, 4, len(hit))
        rand = rng.integers(0, 4, len(hit))
        # (position, order, what, value): an allele's inserted bases start
        # or end before base p (0), an error at base p (1), the allele's
        # deleted reference bases after base p (2)
        events = [(int(p), 0, "i0", 0) for p in self.ins_starts
                  if a < p < b]
        events += [(int(p), 0, "i1", 0) for p in self.ins_ends if a < p < b]
        events += [(int(j), 2, "d", n) for j, n in self.dels
                   if a <= j < b - 1]
        events += [(int(p), 1, int(k), (int(x), int(r)))
                   for p, k, x, r in zip(at, kind, alt, rand)]
        events.sort()
        text, cigar, seq = self.text, [], []

        def push(op, n):
            if n <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1][1] += n
            else:
                cigar.append([op, n])

        inserted, cur = False, a

        def emit(x, y):
            push("I" if inserted else "M", y - x)
            seq.append(text[x:y])

        for p, _o, what, val in events:
            if what in ("i0", "i1"):
                emit(cur, p)
                inserted, cur = what == "i0", p
            elif what == "d":
                emit(cur, p + 1)
                cur = p + 1
                push("D", val)
            else:
                emit(cur, p)
                base = text[p:p + 1]
                if what == 1:           # substitution
                    k = (b"ACGT".index(base) + val[0]) % 4
                    base = b"ACGT"[k:k + 1]
                if what == 2:           # deletion
                    if not inserted:
                        push("D", 1)
                else:
                    push("I" if inserted else "M", 1)
                    seq.append(base)
                    if what == 3:       # insertion after the base
                        push("I", 1)
                        seq.append(base if self.run[p]
                                   else b"ACGT"[val[1]:val[1] + 1])
                cur = p + 1
        emit(cur, b)
        return (b"".join(seq).decode(), [(op, int(n)) for op, n in cigar],
                int(self.refpos[a]))


def sample_records(haps, sample, reads, rng, rid=0):
    """The reads of one sample: on each haplotype, depth/2 x (length +
    mean read length) / mean read length reads, each of a length drawn
    from the configuration's distribution and starting anywhere it
    overlaps the chromosome (clipped at its ends, so that every position
    gets the same depth), trimmed to the bases the reference aligns at
    either end; HP-tagged with their haplotype unless the configuration's
    ``reads`` set ``haplotags`` false."""
    records = []
    mean, sd, lo = (reads["length_mean"], reads["length_sd"],
                    reads["length_min"])
    tagged = reads.get("haplotags", True)
    for h, hap in enumerate(haps, start=1):
        H = len(hap.refpos)
        n = int(round(reads["coverage"] / 2 * (H + mean) / mean))
        lengths = np.maximum(np.rint(rng.normal(mean, sd, n)), lo).astype(int)
        starts = (rng.random(n) * (H + lengths - 1)).astype(int) - lengths + 1
        idx = hap.aligned
        for i in range(n):
            a, b = max(starts[i], 0), min(starts[i] + lengths[i], H)
            a = idx[np.searchsorted(idx, a)]
            b = idx[np.searchsorted(idx, b) - 1] + 1
            if b - a < lo // 10:
                continue
            seq, cigar, pos = hap.read(rng, a, b)
            tags = {"RG": f"rg_{sample}", "HP": h} if tagged else \
                {"RG": f"rg_{sample}"}
            records.append(Read(f"{sample}_h{h}_{i}", 16 * (i % 2), rid, pos,
                                cigar, seq, tags))
    records.sort(key=lambda r: (r.ref_id, r.pos, r.name))
    return records


def sample_header(genome, sample) -> str:
    return ("@HD\tVN:1.6\tSO:coordinate\n"
            + "".join(f"@SQ\tSN:{c}\tLN:{len(genome[c])}\n" for c in genome)
            + f"@RG\tID:rg_{sample}\tSM:{sample}\tLB:{sample}\n")


def write_fasta(path: str, seqs: dict, line_len: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_len):
                fh.write(seq[i: i + line_len] + "\n")


def write_bed(path: str, loci) -> str:
    with open(path, "w") as fh:
        for loc in loci:
            fh.write(f"{loc.chrom}\t{loc.start + 1}\t{loc.stop}\t{loc.motif}"
                     f"\t{loc.name}\n")
    return path


def layout(traffic, samples, seed):
    """(genome, loci, each sample's (hap1, hap2) copies a locus, the
    contents' order) of a seed: the loci one after another on one
    chromosome between two end pads, in the seed's order."""
    content = _content(traffic, samples)
    order = np.random.default_rng(seed).permutation(len(content))
    prng = np.random.default_rng([traffic["content_seed"], len(content)])
    pad = [prng.integers(0, 4, traffic["end_pad"]).astype(np.uint8)
           for _ in range(2)]
    parts, loci, at = [pad[0]], [], len(pad[0])
    for p, c in enumerate(order):
        motif, copies, _d, left, right = content[c]
        rep = np.tile(_codes(motif), copies)
        parts += [left, rep, right]
        loci.append(Locus(CHROM, at + len(left), motif, copies, f"L{p}"))
        at += len(left) + len(rep) + len(right)
    parts.append(pad[1])
    genome = {CHROM: _text(np.concatenate(parts))}
    alleles = [[(content[c][1], max(content[c][1] + content[c][2][s], 2))
                for c in order] for s in range(samples)]
    return genome, loci, alleles, (pad, content, order)


def build(outdir: str, traffic: dict, reads: dict, seed: int) -> dict:
    """Write the catalog of ``traffic`` with the reads of a configuration's
    ``reads`` into ``outdir``.  Returns the paths, the sample names in the
    order of the BAMs, the loci, the true genotypes and each read's
    (sample index, HP tag or -1 where it has none) by read name."""
    S = reads["samples"]
    genome, loci, alleles, (pad, content, order) = layout(traffic, S, seed)
    fasta = os.path.join(outdir, "g.fa")
    write_fasta(fasta, genome)
    bed = write_bed(os.path.join(outdir, "r.bed"), loci)
    bams, truth, of_read = [], {}, {}
    for s in range(S):
        sample = f"S{s}"
        haps = [Haplotype(*_haplotype(pad, content, order,
                                      [a[h] for a in alleles[s]]), reads)
                for h in range(2)]
        records = sample_records(haps, sample, reads,
                                 np.random.default_rng([seed, 1, s]))
        path = os.path.join(outdir, f"{sample}.bam")
        write_bam(path, sample_header(genome, sample), [CHROM],
                  [len(genome[CHROM])], records)
        build_bai(path)
        bams.append(path)
        truth[sample] = {l.name: a for l, a in zip(loci, alleles[s])}
        of_read.update((r.name, (s, r.tags.get("HP", -1))) for r in records)
    return dict(fasta=fasta, bed=bed, bams=bams, loci=loci, truth=truth,
                samples=[f"S{s}" for s in range(S)], reads=of_read)
