"""Left-aligned read representation + CIGAR expansion.

Reference: src/SeqAlignment/AlignmentData.h (the ``Alignment`` value type with
explicit =/X CIGARs and a '-'-for-deletion alignment string) and
``GenotyperBamProcessor::left_align_reads`` (genotyper_bam_processor.cpp:38-168)
which converts BAM records into these after trimming to region±FLANK_SIZE.

Also hosts ``extract_cigar`` (src/extract_indels.cpp — net bp diff of a read
vs the reference within a region, lobSTR-derived), used by EM stutter
training and the ALLREADS field.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from longtr_tpu_torch.io.bam import FLANK_SIZE


@dataclass
class Alignment:
    start: int
    stop: int                 # inclusive stop (reference: end_pos - 1)
    rev_strand: bool
    deleted: bool
    name: str
    base_qualities: str
    sequence: str
    alignment: str = ""       # bases with '-' for deletions
    cigar: list = field(default_factory=list)   # (op, num) with '=' and 'X'
    use_for_haps: list = field(default_factory=list)

    def use_for_hap_generation(self, region_index: int) -> bool:
        return bool(self.use_for_haps) and self.use_for_haps[region_index]

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for op, n in self.cigar)

    def check_cigar(self):
        num = sum(n for op, n in self.cigar if op not in "DH")
        assert num == len(self.sequence), \
            f"CIGAR check failed for {self.name}: {num} vs {len(self.sequence)}"


def expand_cigar_vs_ref(rec, chrom_seq: str):
    """Expand a BAM record's CIGAR into explicit =/X ops against the reference.

    Returns (Alignment, soft_clipped) — transcription of
    genotyper_bam_processor.cpp:72-140.  The input record should already be
    trimmed to the region window.
    """
    read_seq = rec.seq.upper()
    aln = Alignment(rec.pos, rec.end_pos - 1, rec.is_reverse, rec.deleted,
                    rec.name, rec.qual, read_seq)
    seq_index = 0
    ref_index = rec.pos
    soft_clipped = False
    out_cigar = []
    aln_chunks = []

    def push(op, num):
        # NO cross-element merging: the reference appends a fresh
        # CigarElement per source element and only coalesces =/X runs
        # WITHIN one M/=/X element (genotyper_bam_processor.cpp:80-130),
        # so adjacent same-type source elements stay separate.
        if num == 0:
            return
        out_cigar.append([op, num])

    for op, num in rec.cigar:
        if op == "H":
            continue
        if op == "S":
            push("S", num)
            seq_index += num
            soft_clipped = True
        elif op == "I":
            push("I", num)
            aln_chunks.append(read_seq[seq_index: seq_index + num])
            seq_index += num
        elif op == "D":
            push("D", num)
            aln_chunks.append("-" * num)
            ref_index += num
        elif op in "M=X":
            rseg = read_seq[seq_index:seq_index + num]
            fseg = chrom_seq[ref_index:ref_index + num].upper()
            aln_chunks.append(rseg)
            seq_index += num
            ref_index += num
            if rseg == fseg:
                push("=", num)
            else:
                # run-length encode the match mask without a per-base loop
                eq = np.frombuffer(rseg.encode(), np.uint8) == \
                    np.frombuffer(fseg.encode(), np.uint8)
                bounds = np.flatnonzero(eq[1:] != eq[:-1]) + 1
                start = 0
                for b in list(bounds) + [num]:
                    push("=" if eq[start] else "X", b - start)
                    start = b
        else:
            raise ValueError("Invalid CIGAR op in expand_cigar_vs_ref: " + op)

    aln.cigar = [(op, num) for op, num in out_cigar]
    aln.alignment = "".join(aln_chunks)
    return aln, soft_clipped


def left_align_reads(region_group, chrom_seq: str, samples_reads,
                     log_p1, log_p2, haplotype_tag="HP", logger=None):
    """Trim + expand reads for all samples (genotyper_bam_processor.cpp:38-168).

    Parameters
    ----------
    samples_reads : list[list[BamRecord]] — per-sample BAM records
    log_p1, log_p2 : list[list[float]] — per-read phasing factors

    Returns (left_alns, filt_log_p1, filt_log_p2, n_p1s, n_p2s) where
    ``left_alns`` is a flat list of Alignment and filt_log_p* parallel the
    per-sample structure of retained reads.
    """
    native_res = _native_left_align(region_group, chrom_seq, samples_reads)
    if native_res is not None:
        return _assemble_native_left_align(
            region_group, samples_reads, log_p1, log_p2, native_res,
            haplotype_tag, logger)

    left_alns = []
    filt_p1, filt_p2 = [], []
    n_p1s, n_p2s = [], []
    fail_count = 0
    total = 0
    for i, reads in enumerate(samples_reads):
        filt_p1.append([])
        filt_p2.append([])
        n_p1 = n_p2 = 0
        for j, rec in enumerate(reads):
            total += 1
            # Must fully overlap the repeat (genotyper_bam_processor.cpp:56-59)
            if rec.pos > region_group.start or rec.end_pos < region_group.stop:
                fail_count += 1
                continue
            rec.trim_alignment(
                region_group.start - FLANK_SIZE if region_group.start > FLANK_SIZE else 1,
                region_group.stop + FLANK_SIZE)
            if rec.length == 0:
                # Fully-deleted repeat -> <DEL> alignment
                # (genotyper_bam_processor.cpp:62-71)
                aln = Alignment(region_group.start, region_group.stop,
                                rec.is_reverse, True, rec.name, "", "", "")
                aln.use_for_haps = [True] * region_group.num_regions
                left_alns.append(aln)
                filt_p1[i].append(log_p1[i][j])
                filt_p2[i].append(log_p2[i][j])
                continue
            aln, soft_clipped = expand_cigar_vs_ref(rec, chrom_seq)
            if soft_clipped:
                fail_count += 1
                continue
            hp = rec.get_tag(haplotype_tag)
            if hp == 1:
                n_p1 += 1
            elif hp == 2:
                n_p2 += 1
            aln.check_cigar()
            aln.use_for_haps = list(getattr(rec, "pass_two", None)
                                    or [True] * region_group.num_regions)
            left_alns.append(aln)
            filt_p1[i].append(log_p1[i][j])
            filt_p2[i].append(log_p2[i][j])
        n_p1s.append(n_p1)
        n_p2s.append(n_p2)
    if logger and fail_count:
        logger(f"Failed to trim align {fail_count} out of {total} reads")
    return left_alns, filt_p1, filt_p2, n_p1s, n_p2s


def _native_left_align(region_group, chrom_seq, samples_reads):
    """One native trim+expand call for the whole locus, or None to fall
    back to the pure-Python path (LONGTR_NO_NATIVE, no library, or an
    input outside the native envelope)."""
    import os
    if os.environ.get("LONGTR_NO_NATIVE"):
        return None
    try:
        from longtr_tpu_torch import native
    except Exception:
        return None
    recs = [rec for reads in samples_reads for rec in reads]
    if not recs:
        return None
    min_read_start = (region_group.start - FLANK_SIZE
                      if region_group.start > FLANK_SIZE else 1)
    max_read_stop = region_group.stop + FLANK_SIZE
    window_lo = min(r.pos for r in recs)
    window_hi = max(r.end_pos for r in recs)
    window_lo = max(0, window_lo)
    window = chrom_seq[window_lo:max(window_hi, window_lo)].encode()
    return native.trim_expand_batch(
        window, window_lo, recs, min_read_start, max_read_stop,
        FLANK_SIZE, region_group.start, region_group.stop)


def _assemble_native_left_align(region_group, samples_reads, log_p1, log_p2,
                                native_res, haplotype_tag, logger):
    """Build the Alignment list from the native batch results, preserving
    the Python path's per-sample ordering, counters and filters exactly.
    Each kept read's trimmed sequence, qualities, CIGAR and alignment
    string are slices of the call's outputs."""
    (meta, ops, lens, cig_offs, aln_str, aln_offs, seqs, quals,
     seq_offs) = native_res
    left_alns = []
    filt_p1, filt_p2 = [], []
    n_p1s, n_p2s = [], []
    fail_count = 0
    total = 0
    k = 0
    for i, reads in enumerate(samples_reads):
        filt_p1.append([])
        filt_p2.append([])
        n_p1 = n_p2 = 0
        for j, rec in enumerate(reads):
            total += 1
            status, new_pos, new_end, _lt, _rt, _nc, _na, deleted = meta[k]
            k += 1
            if status == 4:
                raise ValueError(
                    "Invalid CIGAR op in trim/expand for " + rec.name)
            if status in (1, 2):       # overlap fail / soft-clip fail
                fail_count += 1
                continue
            if status == 3:            # fully-deleted repeat -> <DEL>
                aln = Alignment(region_group.start, region_group.stop,
                                rec.is_reverse, True, rec.name, "", "", "")
                aln.use_for_haps = [True] * region_group.num_regions
                left_alns.append(aln)
                filt_p1[i].append(log_p1[i][j])
                filt_p2[i].append(log_p2[i][j])
                continue
            slo, shi = seq_offs[k - 1], seq_offs[k]
            clo, chi = cig_offs[k - 1], cig_offs[k]
            aln = Alignment(
                new_pos, new_end - 1, rec.is_reverse, bool(deleted),
                rec.name, quals[slo:shi], seqs[slo:shi],
                aln_str[aln_offs[k - 1]:aln_offs[k]],
                list(zip(ops[clo:chi], lens[clo:chi])),
                list(getattr(rec, "pass_two", None)
                     or [True] * region_group.num_regions))
            hp = rec.get_tag(haplotype_tag)
            if hp == 1:
                n_p1 += 1
            elif hp == 2:
                n_p2 += 1
            aln.check_cigar()
            left_alns.append(aln)
            filt_p1[i].append(log_p1[i][j])
            filt_p2[i].append(log_p2[i][j])
        n_p1s.append(n_p1)
        n_p2s.append(n_p2)
    if logger and fail_count:
        logger(f"Failed to trim align {fail_count} out of {total} reads")
    return left_alns, filt_p1, filt_p2, n_p1s, n_p2s


def extract_cigar(cigar, cigar_start: int, region_start: int, region_end: int):
    """Net bp difference of a read vs the reference within a region.

    Transcription of src/extract_indels.cpp:18-91.  Returns (ok, bp_diff).
    """
    assert cigar_start >= 0 and region_end >= region_start
    ref_len = sum(n for op, n in cigar if op in "M=XD")
    if region_start < cigar_start:
        return False, 0
    if region_end >= cigar_start + ref_len:
        return False, 0

    pos = cigar_start
    start_index = 0
    last_match = 0
    i = 0
    while pos < region_start and i < len(cigar):
        op, n = cigar[i]
        if op in "M=XD":
            pos += n
        if op in "M=X":
            last_match = i
        i += 1
    start_index = last_match
    if start_index == 0 and cigar[0][0] not in "M=X":
        return False, 0

    end_index = len(cigar) - 1
    last_match = len(cigar) - 1
    pos = cigar_start + ref_len
    i = len(cigar) - 1
    while pos > region_end:
        op, n = cigar[i]
        if op in "M=XD":
            pos -= n
        if op in "M=X":
            last_match = i
        if i == 0:
            break
        i -= 1
    end_index = last_match
    if end_index == len(cigar) - 1 and cigar[end_index][0] not in "M=X":
        return False, 0

    bp_diff = 0
    for k in range(start_index, end_index + 1):
        op, n = cigar[k]
        if op == "D":
            bp_diff -= n
        elif op == "I":
            bp_diff += n
    return True, bp_diff
