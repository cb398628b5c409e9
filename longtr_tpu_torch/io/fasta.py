"""FASTA access with .fai indexing (reference: src/fasta_reader.{h,cpp}).

Whole-chromosome fetch matches the reference's per-locus strategy of loading
one chromosome at a time (bam_processor.cpp:574-577).  The ``##contig`` VCF
header lines come from here (genotyper.cpp:264-265).
"""

from __future__ import annotations

import os

from longtr_tpu_torch.io.bgzf import BgzfReader, is_bgzf


def build_fai(path: str):
    """Create a .fai index (name, length, offset, linebases, linewidth)."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            line_start = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = fh.tell()
                first_line = True
            else:
                seqlen = len(line.rstrip(b"\r\n"))
                if first_line and seqlen:
                    linebases = seqlen
                    linewidth = len(line)
                    first_line = False
                length += seqlen
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    return entries


class FastaReader:
    """Random-access FASTA reader; builds the .fai on demand."""

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise IOError("FASTA file does not exist: " + path)
        self.path = path
        self._bgzf = is_bgzf(path) if self._might_be_gz(path) else False
        fai = path + ".fai"
        if os.path.exists(fai):
            self.entries = []
            with open(fai) as fh:
                for line in fh:
                    f = line.split("\t")
                    self.entries.append((f[0], int(f[1]), int(f[2]), int(f[3]), int(f[4])))
        else:
            if self._bgzf:
                raise IOError("bgzipped FASTA requires a prebuilt .fai: " + path)
            self.entries = build_fai(path)
            try:
                with open(fai, "w") as fh:
                    for e in self.entries:
                        fh.write("\t".join(str(x) for x in e) + "\n")
            except OSError:
                pass
        self._index = {e[0]: e for e in self.entries}
        self._cache_name = None
        self._cache_seq = ""

    @staticmethod
    def _might_be_gz(path):
        with open(path, "rb") as fh:
            return fh.read(2) == b"\x1f\x8b"

    def has_chromosome(self, chrom: str) -> bool:
        return chrom in self._index

    def get_sequence_length(self, chrom: str) -> int:
        e = self._index.get(chrom)
        return e[1] if e else -1

    def get_sequence(self, chrom: str) -> str:
        """Whole-chromosome sequence (uppercased lazily by callers)."""
        if self._cache_name == chrom:
            return self._cache_seq
        e = self._index.get(chrom)
        if e is None:
            raise KeyError("Chromosome not in FASTA: " + chrom)
        name, length, offset, linebases, linewidth = e
        nlines = (length + linebases - 1) // linebases if linebases else 0
        nbytes = length + nlines * (linewidth - linebases)
        if self._bgzf:
            r = BgzfReader(self.path)
            # no virtual offsets in .fai — stream and slice
            data = r.read_all()[offset: offset + nbytes]
            r.close()
        else:
            with open(self.path, "rb") as fh:
                fh.seek(offset)
                data = fh.read(nbytes)
        seq = data.replace(b"\n", b"").replace(b"\r", b"").decode()
        self._cache_name, self._cache_seq = chrom, seq
        return seq

    def contig_header_lines(self):
        """##contig lines for the VCF header."""
        return [f"##contig=<ID={n},length={ln}>" for n, ln, *_ in self.entries]


def write_fasta(path: str, seqs: dict, line_len: int = 60):
    """Write a FASTA file (test fixtures)."""
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_len):
                fh.write(seq[i: i + line_len] + "\n")
