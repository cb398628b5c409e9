"""VCF output (sorted-heap bgzf writer) and a tabix-free VCF reader.

Writer reference: src/vcf_writer.{h,cpp} — records may arrive slightly out of
order (loci are processed sorted by region start but emitted positions can
shift by small pads), so a heap holds records and flushes those more than
MAX_RECORD_PAD=50 bp behind the newest (vcf_writer.h:30-44).

Reader reference: src/vcf_reader.{h,cpp} (htslib+tabix).  Ours loads the
bgzipped VCF and answers region queries from an in-memory per-chromosome
position index — the test/ref-panel VCFs here are locus-scale, so a .tbi
binning index is unnecessary; the API (set_region/get_next_variant) matches.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from longtr_tpu_torch.io.bgzf import BgzfWriter, bgzf_open_text


class VCFWriter:
    MAX_RECORD_PAD = 50

    def __init__(self):
        self._out = None
        self.chrom = ""
        self._heap = []      # (pos, seq, text)
        self._count = 0

    @property
    def is_open(self):
        return self._out is not None

    def open(self, path: str):
        if self._out is not None:
            raise RuntimeError("Cannot reopen an open VCFWriter")
        self._out = BgzfWriter(path)
        self._path = path

    def write_header(self, text: str):
        self._out.write(text)

    def add_vcf_record(self, chrom: str, pos: int, record_text: str):
        """Queue one record; flush safely-ordered ones (vcf_writer.cpp)."""
        if chrom != self.chrom:
            self._flush_all()
            self.chrom = chrom
        heapq.heappush(self._heap, (pos, self._count, record_text))
        self._count += 1
        while self._heap and self._heap[0][0] < pos - self.MAX_RECORD_PAD:
            _, _, text = heapq.heappop(self._heap)
            self._out.write(text + "\n")

    def _flush_all(self):
        while self._heap:
            _, _, text = heapq.heappop(self._heap)
            self._out.write(text + "\n")

    def close(self):
        if self._out is None:
            return
        self._flush_all()
        self._out.close()
        self._out = None
        # Auto-index the output so it is immediately queryable (our lazy
        # VCFReader and downstream tools use it; the reference leaves this
        # to a manual tabix run).
        try:
            from longtr_tpu_torch.io.tabix import build_tbi
            build_tbi(self._path)
        except Exception:
            pass


@dataclass
class Variant:
    chrom: str
    pos: int                  # 0-based
    vid: str
    alleles: list             # [ref, alt1, ...]
    qual: str
    filt: str
    info: dict
    fmt: list = field(default_factory=list)
    samples: dict = field(default_factory=dict)   # name -> list of fields
    sample_order: list = field(default_factory=list)

    @property
    def ref(self):
        return self.alleles[0]

    def num_alleles(self):
        return len(self.alleles)

    def get_info(self, key, default=None):
        return self.info.get(key, default)

    def sample_field(self, sample, key, default=None):
        if sample not in self.samples or key not in self.fmt:
            return default
        vals = self.samples[sample]
        i = self.fmt.index(key)
        return vals[i] if i < len(vals) else default

    def genotype(self, sample):
        """Returns (a1, a2, phased) or None for missing. Haploid -> a2 None."""
        gt = self.sample_field(sample, "GT")
        if gt is None or gt.startswith("."):
            return None
        phased = "|" in gt
        parts = gt.replace("|", "/").split("/")
        if len(parts) == 1:
            return (int(parts[0]), None, phased)
        if parts[0] == "." or parts[1] == ".":
            return None
        return (int(parts[0]), int(parts[1]), phased)


def _parse_info(text: str) -> dict:
    info = {}
    if text == ".":
        return info
    for item in text.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            info[k] = v
        else:
            info[item] = True
    return info


class VCFReader:
    """Loads a (bgzipped) VCF; supports per-chromosome region iteration."""

    def __init__(self, path: str):
        self.path = path
        self.samples = []
        self._by_chrom = {}          # chrom -> list[(pos, line)] (eager mode)
        self._region_iter = None
        self._tbi = None
        import os
        if path.endswith(".gz") and os.path.exists(path + ".tbi"):
            # Lazy tabix mode (vcf_reader.h:22-120): only the header is read
            # up front; set_region streams the indexed slice.  Essential for
            # whole-genome SNP VCFs that must not be loaded into memory.
            from longtr_tpu_torch.io.tabix import TbiIndex
            self._tbi = TbiIndex(path + ".tbi")
            fh = bgzf_open_text(path)
            with fh:
                for line in fh:
                    if line.startswith("##"):
                        continue
                    if line.startswith("#CHROM"):
                        self.samples = line.rstrip("\n").split("\t")[9:]
                    break
            return
        fh = bgzf_open_text(path) if path.endswith(".gz") else open(path)
        with fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("##"):
                    continue
                if line.startswith("#CHROM"):
                    cols = line.split("\t")
                    self.samples = cols[9:]
                    continue
                tab = line.index("\t")
                chrom = line[:tab]
                pos = int(line[tab + 1: line.index("\t", tab + 1)])
                self._by_chrom.setdefault(chrom, []).append((pos, line))
        for lst in self._by_chrom.values():
            lst.sort(key=lambda x: x[0])

    def get_samples(self):
        return self.samples

    def chromosomes(self):
        if self._tbi is not None:
            return list(self._tbi.names)
        return sorted(self._by_chrom)

    def has_chromosome(self, chrom):
        if self._tbi is not None:
            return self._tbi.ref_id(chrom) >= 0
        return chrom in self._by_chrom

    def _stream_region(self, chrom: str, start: int, end):
        """Generator over raw lines in the indexed slice (lazy mode)."""
        rid = self._tbi.ref_id(chrom)
        qend = (1 << 60) if end is None else end
        chunks = self._tbi.chunks_for(rid, start, qend)
        if not chunks:
            return
        from longtr_tpu_torch.io.bgzf import BgzfReader
        bz = BgzfReader(self.path)
        seen_target = False
        try:
            bz.seek_virtual(chunks[0][0])
            pending = b""
            lo = start + 1     # VCF positions are 1-based
            while True:
                chunk = bz.read(65536)
                if not chunk:
                    break
                data = pending + chunk
                pos0 = 0
                while True:
                    nl = data.find(b"\n", pos0)
                    if nl < 0:
                        break
                    line = data[pos0:nl]
                    pos0 = nl + 1
                    if not line or line.startswith(b"#"):
                        continue
                    tab = line.index(b"\t")
                    c = line[:tab].decode()
                    if c != chrom:
                        if seen_target:
                            return
                        continue
                    seen_target = True
                    p = int(line[tab + 1: line.index(b"\t", tab + 1)])
                    if p > qend:
                        return
                    if p >= lo:
                        yield line.decode()
                pending = data[pos0:]
        finally:
            bz.close()

    def _parse(self, line: str) -> Variant:
        f = line.split("\t")
        alleles = [f[3]] + ([] if f[4] == "." else f[4].split(","))
        fmt = f[8].split(":") if len(f) > 8 else []
        samples = {}
        for name, val in zip(self.samples, f[9:]):
            samples[name] = val.split(":")
        return Variant(f[0], int(f[1]) - 1, f[2], alleles, f[5], f[6],
                       _parse_info(f[7]), fmt, samples, list(self.samples))

    def set_region(self, chrom: str, start: int, end: int | None = None) -> bool:
        """Iterate variants with 0-based pos in [start, end)."""
        if self._tbi is not None:
            if self._tbi.ref_id(chrom) < 0:
                self._region_iter = iter(())
                return False
            self._region_iter = self._stream_region(chrom, start, end)
            return True
        lst = self._by_chrom.get(chrom)
        if lst is None:
            self._region_iter = iter(())
            return False
        lo = start + 1  # VCF positions are 1-based
        items = [ln for p, ln in lst
                 if p >= lo and (end is None or p <= end)]
        self._region_iter = iter(items)
        return True

    def get_next_variant(self) -> Variant | None:
        if self._region_iter is None:
            return None
        try:
            return self._parse(next(self._region_iter))
        except StopIteration:
            return None
