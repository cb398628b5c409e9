"""Library-aware PCR duplicate removal.

Reference: src/pcr_duplicates.{h,cpp} — duplicates share (library, min read
start, max read start); the highest-quality copy survives, with the
mate-reversal special case preserved.  Off by default in LongTR
(hipstr_main.cpp:383 passes remove_pcr_dups=false).
"""

from __future__ import annotations

from longtr_tpu_torch.pipeline.filters import mean_phred


class _ReadPair:
    __slots__ = ("min_start", "max_start", "aln1", "aln2", "library", "name")

    def __init__(self, aln1, aln2, library):
        self.aln1 = aln1
        self.aln2 = aln2
        self.library = library
        self.name = aln1.name
        if aln2 is None:
            self.min_start = -1
            self.max_start = aln1.pos
        else:
            self.min_start = min(aln1.pos, aln2.pos)
            self.max_start = max(aln1.pos, aln2.pos)

    def single_ended(self):
        return self.min_start == -1

    def duplicate(self, other):
        return (self.library == other.library
                and self.min_start == other.min_start
                and self.max_start == other.max_start)

    def sort_key(self):
        return (self.library, self.min_start, self.max_start, self.name)


def remove_pcr_duplicates(use_bam_rgs, rg_to_library, paired_by_rg,
                          mates_by_rg, unpaired_by_rg, logger=None):
    """In-place duplicate removal (pcr_duplicates.cpp:18-95)."""
    def library_of(rec):
        if use_bam_rgs:
            return rg_to_library[rec.filename + rec.get_tag("RG", "")]
        return rg_to_library[rec.filename]

    dup_count = 0
    for i in range(len(paired_by_rg)):
        pairs = [_ReadPair(a, m, library_of(a))
                 for a, m in zip(paired_by_rg[i], mates_by_rg[i])]
        pairs += [_ReadPair(a, None, library_of(a)) for a in unpaired_by_rg[i]]
        pairs.sort(key=_ReadPair.sort_key)
        paired_by_rg[i].clear()
        mates_by_rg[i].clear()
        unpaired_by_rg[i].clear()
        if not pairs:
            continue

        include_rev = False
        best = 0

        def emit(best, include_rev):
            nonlocal dup_count
            rp = pairs[best]
            if rp.single_ended():
                unpaired_by_rg[i].append(rp.aln1)
            else:
                paired_by_rg[i].append(rp.aln1)
                mates_by_rg[i].append(rp.aln2)
                if include_rev:
                    dup_count -= 1
                    paired_by_rg[i].append(rp.aln2)
                    mates_by_rg[i].append(rp.aln1)

        for j in range(1, len(pairs)):
            if pairs[j].duplicate(pairs[best]):
                dup_count += 1
                if mean_phred(pairs[j].aln1.qual) > mean_phred(pairs[best].aln1.qual):
                    best = j
                    include_rev = pairs[best].name == pairs[j - 1].name
                elif j == best + 1:
                    include_rev |= pairs[best].name == pairs[j].name
            else:
                emit(best, include_rev)
                best = j
                include_rev = False
        emit(best, include_rev)
    if logger:
        logger(f"Removed {dup_count} sets of PCR duplicate reads")
