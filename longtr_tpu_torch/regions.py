"""TR region catalog (BED) parsing.

Reference: src/region.{h,cpp}.  ``read_regions`` accepts both the LongTR
4/5-column format (CHROM START STOP MOTIF [NAME], region.cpp:26-65) and the
legacy 7-column HipSTR format (CHROM START STOP PERIOD NREPEATS NAME MOTIF)
that the bundled test_data uses — fixing the documented format mismatch
(SURVEY.md §4): a numeric 4th column with 7 columns is auto-detected.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def is_valid_motif(motif: str) -> bool:
    # "," separates alternate motifs (region.cpp:17-24); the HipSTR
    # 7-column catalogs use "/" for the same thing (test_regions_hg38.bed)
    return all(ch.isalpha() or ch in ",/" for ch in motif)


@dataclass(frozen=True)
class Region:
    chrom: str
    start: int          # 0-based inclusive
    stop: int           # 0-based exclusive-ish (reference uses stop as last+1)
    motifs: str = ""
    name: str = ""

    @property
    def period(self) -> int:
        lens = {len(m) for m in self.motifs.split(",") if m}
        return lens.pop() if len(lens) == 1 else -1

    @property
    def motif(self) -> str:
        return self.motifs

    def period_str(self) -> str:
        return ",".join(str(len(m)) for m in self.motifs.split(",") if m)

    def key(self):
        return (self.chrom, self.start, self.stop)

    def str_repr(self) -> str:
        return f"{self.chrom}:{self.start}-{self.stop}"

    def sort_key(self):
        return (self.chrom, self.start, self.stop)


def read_regions(path: str, max_regions: int = 10_000_000, chrom_limit: str = "",
                 logger=None) -> list:
    regions = []
    num_lines = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if len(regions) >= max_regions:
                break
            num_lines += 1
            f = line.split()
            if len(f) < 4:
                raise ValueError("Improperly formatted region file; need >=4 "
                                 "columns CHROM START STOP MOTIF. Bad line: " + line)
            chrom, start, stop = f[0], int(f[1]), int(f[2])
            name = ""
            if len(f) >= 7 and not is_valid_motif(f[3]) and is_valid_motif(f[6]):
                # 7-column HipSTR format: PERIOD NREPEATS NAME MOTIF
                motif, name = f[6].replace("/", ","), f[5]
            else:
                motif = f[3].replace("/", ",")
                if not is_valid_motif(motif):
                    raise ValueError("Region MOTIF has invalid characters: " + line)
                if len(f) >= 5:
                    name = f[4]
            if start < 1:
                raise ValueError("Region START must be >= 1: " + line)
            if stop <= start:
                raise ValueError("Region STOP <= START: " + line)
            if chrom_limit and chrom != chrom_limit:
                continue
            regions.append(Region(chrom, start - 1, stop, motif, name))
    if logger:
        logger(f"Region file contains {num_lines} regions")
    if chrom_limit and not regions:
        raise ValueError(f"Region file {path} has no regions on chromosome {chrom_limit}")
    return regions


def order_regions(regions: list) -> list:
    return sorted(regions, key=lambda r: r.sort_key())


@dataclass
class RegionGroup:
    """A group of nearby regions processed together (region.h:108-146).

    Current reference behaviour: one region per group
    (bam_processor.cpp:595)."""

    regions: list = field(default_factory=list)

    @classmethod
    def single(cls, region: Region) -> "RegionGroup":
        return cls([region])

    @property
    def chrom(self):
        return self.regions[0].chrom

    @property
    def start(self):
        return min(r.start for r in self.regions)

    @property
    def stop(self):
        return max(r.stop for r in self.regions)

    @property
    def num_regions(self):
        return len(self.regions)
