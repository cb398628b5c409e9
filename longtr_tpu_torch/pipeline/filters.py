"""Streaming read filter for a locus.

Reference: ``BamProcessor::read_and_filter_reads`` (bam_processor.cpp:188-487):
drop unmapped/hard-clipped/N-containing/low-mean-qual/low-MAPQ/non-spanning
reads, analyze XA/SA alternate mappings for unique placement, pair mates by
trimmed name, and group survivors per read-group into per-sample lists.

The legacy HipSTR end-match/indel-proximity filters are commented out in the
reference (bam_processor.cpp:294-316) and omitted here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from longtr_tpu_torch.io.bam import build_cigar_string


def mean_phred(qualities: str) -> float:
    """sum_log_prob_correct — actually the mean phred (base_quality.h:77-84)."""
    if not qualities:
        return 0.0
    raw = qualities.encode()
    if len(raw) > 1024:
        # long-read path: C-speed sum (a 25kb HiFi qual string costs ~2ms
        # through builtins.sum, ~10us here)
        import numpy as np
        total = int(np.frombuffer(raw, np.uint8).sum(dtype=np.int64))
    else:
        total = sum(raw)
    return (total - 33 * len(raw)) / len(raw)


def spans_a_region(regions, rec) -> bool:
    """bam_processor.cpp:175-186."""
    for region in regions:
        if rec.pos > region.stop or rec.end_pos < region.start:
            continue
        if rec.pos > region.start:
            continue
        if rec.end_pos < region.stop:
            continue
        return True
    return False


def trim_alignment_name(rec) -> str:
    name = rec.name
    if len(name) > 2 and name[-2] == "/":
        return name[:-2]
    return name


def extract_mappings(rec):
    """Primary + XA/SA alternate mappings (bam_processor.cpp:59-94)."""
    if rec.ref_name == "*" or not rec.cigar:
        return []
    pairs = [(rec.ref_name, rec.pos)]
    aln_cigar_string = ""
    for tag in ("XA", "SA"):
        alt_info = rec.get_tag(tag)
        if not alt_info:
            continue
        for alt in alt_info.split(";"):
            if not alt:
                continue
            tokens = alt.split(",")
            pos = abs(int(tokens[1]))
            if tokens[0] != pairs[0][0] or abs(pos - pairs[0][1]) > 200:
                if tag == "XA" and tokens[0].endswith("_alt") and \
                        tokens[0].startswith(pairs[0][0] + "_"):
                    if not aln_cigar_string:
                        aln_cigar_string = build_cigar_string(rec.cigar)
                    if tokens[2] == aln_cigar_string:
                        continue
                pairs.append((tokens[0], pos))
    return pairs


def get_valid_pairings(aln_1, aln_2, max_mate_dist: int):
    """bam_processor.cpp:96-151. Returns (p1, p2) lists."""
    if aln_1.ref_name == "*" or aln_2.ref_name == "*":
        return [], []
    if not aln_2.has_tag("XA"):
        if aln_2.has_tag("AS") and aln_2.has_tag("XS"):
            if aln_2.get_tag("AS") - aln_2.get_tag("XS") < 10:
                return [], []
    elif not aln_1.has_tag("XA"):
        if aln_1.has_tag("AS") and aln_1.has_tag("XS"):
            if aln_1.get_tag("AS") - aln_1.get_tag("XS") < 10:
                return [], []
    pairs_1 = sorted(extract_mappings(aln_1))
    pairs_2 = sorted(extract_mappings(aln_2))
    p1, p2 = [], []
    min_j = 0
    for c1, x1 in pairs_1:
        for j in range(min_j, len(pairs_2)):
            c2, x2 = pairs_2[j]
            if c1 < c2:
                break
            if c1 > c2:
                min_j = j + 1
            elif abs(x1 - x2) < max_mate_dist:
                p1.append((c1, x1))
                p2.append((c2, x2))
    return p1, p2


@dataclass
class FilterCounters:
    read_count: int = 0
    not_spanning: int = 0
    unique_mapping: int = 0
    read_has_N: int = 0
    hard_clip: int = 0
    low_qual_score: int = 0
    low_mapq: int = 0
    num_filt_unpaired: int = 0
    too_many_reads: bool = False
    # Where the records' gates came from, not what the filter decided
    # (left out of ==): records of a decoded BAM window read their decode
    # batch's columns, the others (CRAM, an unindexed BAM, no native
    # library) compute them.
    reads_from_columns: int = field(default=0, compare=False)
    reads_fallback: int = field(default=0, compare=False)


def _write_pass(rec, writer):
    """BamProcessor::write_passing_alignment (bam_processor.cpp:37-42)."""
    if writer is not None:
        writer.save_alignment(rec)


def _write_filt(rec, reason, writer):
    """BamProcessor::write_filtered_alignment (bam_processor.cpp:44-55):
    tag the record FT=<reason> and save it."""
    if writer is not None:
        rec.tags["FT"] = reason
        writer.save_alignment(rec)


def read_and_filter_reads(reader, region_group, rg_to_sample, config,
                          use_bam_rgs: bool, logger=None,
                          pass_writer=None, filt_writer=None):
    """Returns (rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg, counters).

    ``reader`` must already be positioned on the locus window (the caller
    performs the padded SetRegion, bam_processor.cpp:586-588).
    ``pass_writer``/``filt_writer`` are optional BamWriters for the
    --pass-bam / --filt-bam outputs (bam_processor.cpp:191).
    """
    counters = FilterCounters()
    regions = region_group.regions
    g_start = region_group.start
    g_stop = region_group.stop
    paired, mates, unpaired = [], [], []
    potential_strs = {}
    potential_mates = {}
    prev_file = None
    file_index = 0
    file_label = "0_"
    from_columns = fallback = 0

    while True:
        rec = reader.get_next_alignment()
        if rec is None:
            break
        # A record of a decoded BAM window reads its gates (has an N, mean
        # base quality, hard-clipped) from the batch's columns by index.
        src = rec.__dict__.get("_src")
        if src is None:
            gates = None
            fallback += 1
        else:
            gates = src[0].read_gates()[src[1]]
            from_columns += 1
        # Overlap gate incl. mate rescue window (bam_processor.cpp:208-215)
        if rec.pos > g_stop or rec.end_pos < g_start:
            if not rec.is_paired or rec.mate_pos == rec.pos:
                continue
            if rec.mate_pos > g_stop:
                continue
            if rec.mate_pos + rec.length + 100 < g_start:
                continue
        if len(paired) > config.max_total_reads:
            counters.too_many_reads = True
            break
        if not rec.is_mapped or rec.pos == 0 or rec.n_cigar == 0 or rec.length == 0:
            continue

        overlaps = rec.pos < g_stop and rec.end_pos >= g_start
        # Hard-clipped reads overlapping the region are dropped outright:
        # BASE_QUAL_TRIM defaults to '5' so this branch is live upstream
        # (bam_processor.cpp:226-240; the quality trim itself is commented
        # out there, leaving only this check active).
        if config.base_qual_trim > " " and overlaps:
            if (gates[2] if gates is not None else
                    rec.starts_with_hard_clip() or rec.ends_with_hard_clip()):
                counters.read_count += 1
                counters.hard_clip += 1
                _write_filt(rec, "HARD_CLIPPED", filt_writer)
                continue

        if prev_file != rec.filename:
            prev_file = rec.filename
            potential_mates.clear()
            file_index += 1
            file_label = f"{file_index}_"

        if overlaps:
            pass_one = False
            pass_two = ["0"] * len(regions)
            filt = ""
            counters.read_count += 1
            if gates[0] if gates is not None else "N" in rec.seq:
                counters.read_has_N += 1
                filt = "HAS_N_BASES"
            elif (gates[1] if gates is not None else mean_phred(rec.qual)) \
                    < config.min_sum_qual_log_prob:
                counters.low_qual_score += 1
                filt = "LOW_BASE_QUALS"
            elif rec.mapq < config.min_mapq:
                counters.low_mapq += 1
                filt = "LOW_MAPQ"
            elif config.require_spanning and not spans_a_region(regions, rec):
                counters.not_spanning += 1
                filt = "NOT_SPANNING"
            else:
                pass_one = True

            if pass_one:
                for ri, region in enumerate(regions):
                    if config.min_flank > 0 and (
                            rec.pos > region.start - config.min_flank
                            or rec.end_pos < region.stop + config.min_flank):
                        continue
                    pass_two[ri] = "1"

            aln_key = file_label + trim_alignment_name(rec)
            if pass_one:
                rec.pass_two = [c == "1" for c in pass_two]
                rec.tags["PF"] = "".join(pass_two)
                mate = potential_mates.get(aln_key)
                if mate is not None:
                    if rec.is_first_mate == mate.is_first_mate:
                        del potential_mates[aln_key]
                        # std::map::insert keeps an existing entry
                        # (bam_processor.cpp:327): first-seen read wins
                        potential_strs.setdefault(aln_key, rec)
                        continue
                    p1, _p2 = get_valid_pairings(rec, mate, config.max_mate_dist)
                    if len(p1) == 1 and p1[0][1] == rec.pos:
                        paired.append(rec)
                        mates.append(mate)
                        _write_pass(rec, pass_writer)
                        _write_pass(mate, pass_writer)
                    else:
                        counters.unique_mapping += 1
                        _write_filt(rec, "NO_UNIQUE_MAPPING", filt_writer)
                    del potential_mates[aln_key]
                else:
                    # std::map::insert semantics (bam_processor.cpp:376):
                    # when BOTH mates of a pair pass and overlap the
                    # region, the FIRST-seen read is kept as the unpaired
                    # candidate and the second insert is a no-op
                    potential_strs.setdefault(aln_key, rec)
            else:
                _write_filt(rec, filt, filt_writer)
                potential_mates.setdefault(aln_key, rec)
        else:
            aln_key = file_label + trim_alignment_name(rec)
            str_rec = potential_strs.get(aln_key)
            if str_rec is not None:
                if rec.is_first_mate == str_rec.is_first_mate:
                    continue
                p1, _p2 = get_valid_pairings(str_rec, rec, config.max_mate_dist)
                if len(p1) == 1 and p1[0][1] == str_rec.pos:
                    paired.append(str_rec)
                    mates.append(rec)
                    _write_pass(str_rec, pass_writer)
                    _write_pass(rec, pass_writer)
                else:
                    counters.unique_mapping += 1
                    _write_filt(str_rec, "NO_UNIQUE_MAPPING", filt_writer)
                del potential_strs[aln_key]
            else:
                other = potential_mates.get(aln_key)
                if other is not None:
                    if rec.is_first_mate == other.is_first_mate:
                        continue
                    del potential_mates[aln_key]
                else:
                    potential_mates.setdefault(aln_key, rec)

    counters.reads_from_columns = from_columns
    counters.reads_fallback = fallback

    # std::map iteration is KEY-SORTED (bam_processor.cpp:421): the
    # unpaired-read order — and through the reverse RG fan-out below, the
    # read-group discovery order — follows sorted aln_keys, not insertion
    # order.  (Found by the randomized filter-parity campaign.)
    for _key, rec in sorted(potential_strs.items()):
        if rec.has_tag("XA"):
            counters.unique_mapping += 1
            _write_filt(rec, "NO_UNIQUE_MAPPING", filt_writer)
        elif config.require_paired_reads:
            counters.num_filt_unpaired += 1
            _write_filt(rec, "NO_MATE_PAIR", filt_writer)
        else:
            unpaired.append(rec)
            _write_pass(rec, pass_writer)

    if logger:
        msg = (f"{counters.read_count} reads overlapped region, of which\n"
               f"\t{counters.hard_clip} were hard clipped\n"
               f"\t{counters.read_has_N} had an 'N' base call\n"
               f"\t{counters.low_mapq} had low MAPQ\n"
               f"\t{counters.low_qual_score} had low base quality scores")
        if config.require_spanning:
            msg += f"\n\t{counters.not_spanning} did not span the STR"
        msg += f"\n\t{counters.unique_mapping} did not have a unique mapping"
        if config.require_paired_reads:
            msg += f"\n\t{counters.num_filt_unpaired} did not have a mate pair"
        msg += f"\n\t{len(paired) + len(unpaired)} PASSED ALL FILTERS"
        logger(msg)

    # Group by read-group/sample (bam_processor.cpp:452-483).  The reference
    # pops from the back of each list; we preserve its resulting order.
    rg_indices = {}
    rg_names = []
    paired_by_rg, mates_by_rg, unpaired_by_rg = [], [], []
    for type_idx, (src, mate_src) in enumerate(((paired, mates), (unpaired, None))):
        for k in range(len(src) - 1, -1, -1):
            rec = src[k]
            if use_bam_rgs:
                rg = rg_to_sample[rec.filename + rec.get_tag("RG", "")]
            else:
                rg = rg_to_sample[rec.filename]
            idx = rg_indices.get(rg)
            if idx is None:
                idx = len(rg_names)
                rg_indices[rg] = idx
                rg_names.append(rg)
                paired_by_rg.append([])
                mates_by_rg.append([])
                unpaired_by_rg.append([])
            if type_idx == 0:
                paired_by_rg[idx].append(rec)
                mates_by_rg[idx].append(mate_src[k])
            else:
                unpaired_by_rg[idx].append(rec)
    return rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg, counters
