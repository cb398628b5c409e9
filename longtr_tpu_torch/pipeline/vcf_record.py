"""VCF header + per-locus record emission.

Port of :mod:`longtr_tpu.pipeline.vcf_record`; only the genotyper import
differs.

Reference: ``Genotyper::get_vcf_header`` (src/genotyper.cpp:258-336) and
``SeqStutterGenotyper::write_vcf_record`` (src/seq_stutter_genotyper.cpp:
667-1402).  Formatting follows the reference exactly: stream precision 2 with
fixed float notation (:897-899), '.'-joined missing genotypes, length-sorted
allele reordering with the <DEL> special case (:667-686), INFO/FORMAT field
order, and the off-by-one POS fix (:784).

Behaviour notes carried over from the reference (SURVEY.md §7.5):
* AB/FS outputs are hardcoded off (:1167-1168) — the computations upstream
  are dead code,
* stutter/flank-indel counts only populate under SWITCH_OLD_ALIGN_LEN; in
  the default mode-A path DSTUTTER is absent and DFLANKINDEL counts are 0,
* MALLREADS in mode A is the ML allele's bp diff (:1035-1037).
"""

from __future__ import annotations

import numpy as np

from longtr_tpu_torch.models.genotyper import extract_genotypes_and_likelihoods
from longtr_tpu_torch.pipeline.alignment import extract_cigar
from longtr_tpu_torch.utils.mathops import TOLERANCE
from longtr_tpu_torch.utils.stringops import (condense_read_counts,
                                        order_by_length_and_sequence)

# Genotyper static output flags (genotyper.cpp:339-346)
class OutputFlags:
    def __init__(self):
        self.gls = False
        self.pls = False
        self.phased_gls = False
        self.allreads = True
        self.mallreads = True
        self.filters = False
        self.haplotype_data = False
        self.max_flank_indel_frac = 0.15


def get_vcf_header(fasta_path: str, full_command: str, contig_lines,
                   sample_names, flags: OutputFlags) -> str:
    out = []
    out.append("##fileformat=VCFv4.1")
    out.append("##command=" + full_command)
    out.append("##reference=" + fasta_path)
    out.extend(contig_lines)
    info = [
        ("START", "1", "Integer", "Inclusive start coodinate for the repetitive portion of the reference allele"),
        ("END", "1", "Integer", "Inclusive end coordinate for the repetitive portion of the reference allele"),
        ("MOTIF", ".", "String", "TR motif(s)"),
        ("PERIOD", ".", "Integer", "Length of TR motif(s)"),
        ("NSKIP", "1", "Integer", "Number of samples not genotyped due to various issues"),
        ("NFILT", "1", "Integer", "Number of samples whose genotypes were filtered due to various issues"),
        ("INEXACT_ALLELE", "A", "Integer", "Boolean showing if each alternate allele is exact or approximated by POA, 0 for exact 1 for approximated."),
        ("BPDIFFS", "A", "Integer", "Base pair difference of each alternate allele from the reference allele"),
        ("DP", "1", "Integer", "Total number of valid reads used to genotype all samples"),
        ("DSNP", "1", "Integer", "Total number of reads with SNP phasing information"),
        ("DFLANKINDEL", "1", "Integer", "Total number of reads with an indel in the regions flanking the STR"),
        ("AN", "1", "Integer", "Total number of alleles in called genotypes"),
        ("REFAC", "1", "Integer", "Reference allele count"),
        ("AC", "A", "Integer", "Alternate allele counts"),
    ]
    for i, n, t, d in info:
        out.append(f'##INFO=<ID={i},Number={n},Type={t},Description="{d}">')
    fmt = [
        ("GT", "1", "String", "Genotype"),
        ("GB", "1", "String", "Base pair differences of genotype from reference"),
        ("Q", "1", "Float", "Posterior probability of unphased genotype"),
        ("PQ", "1", "Float", "Posterior probability of phased genotype"),
        ("DP", "1", "Integer", "Number of valid reads used for sample's genotype"),
        ("DSNP", "1", "Integer", "Number of reads with SNP phasing information"),
        ("PSNP", "1", "String", "Number of reads with SNPs supporting each haploid genotype"),
        ("PDP", "1", "String", "Fractional reads supporting each haploid genotype"),
        ("GLDIFF", "1", "Float", "Difference in likelihood between the reported and next best genotypes"),
    ]
    for i, n, t, d in fmt:
        out.append(f'##FORMAT=<ID={i},Number={n},Type={t},Description="{d}">')
    if flags.haplotype_data:
        out.append('##FORMAT=<ID=HQ,Number=1,Type=Float,Description="Posterior probability of unphased haplotypes">')
        out.append('##FORMAT=<ID=PHQ,Number=1,Type=Float,Description="Posterior probability of phased haplotypes">')
    if flags.allreads:
        out.append('##FORMAT=<ID=ALLREADS,Number=1,Type=String,Description="Base pair difference observed in each read\'s Needleman-Wunsch alignment">')
    if flags.mallreads:
        out.append('##FORMAT=<ID=MALLREADS,Number=1,Type=String,Description="Maximum likelihood bp diff in each read based on haplotype alignments for reads that span the repeat region by at least 5 base pairs">')
    if flags.gls:
        out.append('##FORMAT=<ID=GL,Number=G,Type=Float,Description="log10 genotype likelihoods">')
    if flags.pls:
        out.append('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">')
    if flags.phased_gls:
        out.append('##FORMAT=<ID=PHASEDGL,Number=.,Type=Float,Description="log10 genotype likelihood for each phased genotype. Value for phased genotype X|Y is stored at a 0-based index of X*A + Y, where A is the number of alleles. Not applicable to haploid genotypes">')
    if flags.filters:
        out.append('##FORMAT=<ID=FILTER,Number=1,Type=String,Description="Reason for filtering the current call, or PASS if the call was not filtered">')
    out.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(sample_names) if sample_names else
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
    return "\n".join(out) + "\n"


def get_alleles(gt, region, block_index: int):
    """Allele extraction + trimming (seq_stutter_genotyper.cpp:688-785).

    Returns (pos_1based, alleles, inexact) where alleles may contain '<DEL>'.
    """
    block = gt.haplotype.get_block(block_index)
    chrom_seq = gt.chrom_seq
    alleles = []
    inexact = []
    deleted_index = -1
    for i in range(block.num_options()):
        seq = block.get_seq(i)
        if seq == "":
            alleles.append("<DEL>")
            deleted_index = i
            inexact.append(False)
            continue
        alleles.append(seq)
        inexact.append(block.get_inexact(i))
    if deleted_index != -1:
        tmp = alleles[1]
        alleles[1] = "<DEL>"
        alleles[deleted_index] = tmp

    left_trim = 0
    start = block.start
    while start + left_trim < region.start:
        trim = True
        for a in alleles:
            if a == "<DEL>":
                continue
            if left_trim + 1 >= len(a) or a[left_trim] != alleles[0][left_trim]:
                trim = False
                break
        if not trim:
            break
        left_trim += 1
    start += left_trim
    alleles = [a if a == "<DEL>" else a[left_trim:] for a in alleles]

    right_trim = 0
    end = block.end
    while end - right_trim > region.stop:
        trim = True
        ref_size = len(alleles[0])
        for a in alleles:
            if a == "<DEL>":
                continue
            if right_trim + 1 >= len(a) or \
                    a[len(a) - right_trim - 1] != alleles[0][ref_size - right_trim - 1]:
                trim = False
                break
        if not trim:
            break
        right_trim += 1
    end -= right_trim
    alleles = [a if a == "<DEL>" else a[: len(a) - right_trim] for a in alleles]

    left_flank = chrom_seq[region.start: start].upper() if start >= region.start else ""
    right_flank = chrom_seq[end: region.stop].upper() if end <= region.stop else ""
    pos = min(region.start, start)

    if left_flank == "":
        pad_left = False
        for a in alleles[1:]:
            if a == "<DEL>":
                continue
            if not a or a[0] != alleles[0][0]:
                pad_left = True
                break
        if pad_left:
            pos -= 1
            left_flank = chrom_seq[pos: pos + 1].upper()

    alleles = [a if a == "<DEL>" else left_flank + a + right_flank for a in alleles]
    return pos + 1, alleles, inexact


def reorder_alleles(alleles):
    """Length+sequence sort keeping ref (and <DEL> slot) fixed (:667-686)."""
    old_indices = {a: i for i, a in enumerate(alleles)}
    new_alleles = list(alleles)
    if len(alleles) > 1 and alleles[1] == "<DEL>":
        new_alleles[2:] = order_by_length_and_sequence(new_alleles[2:])
    else:
        new_alleles[1:] = order_by_length_and_sequence(new_alleles[1:])
    old_to_new = [-1] * len(alleles)
    new_to_old = []
    for i, a in enumerate(new_alleles):
        old = old_indices[a]
        new_to_old.append(old)
        old_to_new[old] = i
    return old_to_new, new_to_old


def write_vcf_record(gt, sample_names, flags: OutputFlags, vcf_writer,
                     logger=None):
    """Emit one record per repeat block (seq_stutter_genotyper.cpp:883-892)."""
    region_index = 0
    for bi in range(gt.haplotype.num_blocks()):
        if gt.haplotype.get_block(bi).repeat_info is not None:
            _write_block_record(gt, sample_names, bi,
                                gt.region_group.regions[region_index],
                                flags, vcf_writer, logger)
            region_index += 1


def _write_block_record(gt, sample_names, hap_block_index, region,
                        flags: OutputFlags, vcf_writer, logger):
    f2 = lambda x: f"{x:.2f}"
    pos, alleles, inexact = get_alleles(gt, region, hap_block_index)
    allele_bp_diffs = []
    for a in alleles:
        if a == "<DEL>":
            allele_bp_diffs.append(-len(alleles[0]))
        else:
            allele_bp_diffs.append(len(a) - len(alleles[0]))

    h2a = gt.haplotype.haps_to_alleles(hap_block_index)
    num_variants = gt.haplotype.get_block(hap_block_index).num_options()
    ext = extract_genotypes_and_likelihoods(
        gt.posteriors, gt.sample_total_lls, h2a, num_variants, gt.haploid,
        calc_gls=True, want_pls=flags.pls, calc_phased_gls=flags.phased_gls)
    haplotypes, gts = ext.best_haplotypes, ext.best_gts

    S = gt.num_samples
    num_aligned = np.zeros(S, dtype=int)
    num_with_snps = np.zeros(S, dtype=int)
    num_strand_one = np.zeros(S, dtype=int)
    num_strand_two = np.zeros(S, dtype=int)
    num_flank_indels = np.zeros(S, dtype=int)
    unique_hap_one = np.zeros(S, dtype=int)
    unique_hap_two = np.zeros(S, dtype=int)
    bps_per_sample = [[] for _ in range(S)]
    ml_bps_per_sample = [[] for _ in range(S)]
    # (the reference also computes per-read phase posteriors here, but its
    # only consumer is dead in the fork: PDP emits n_p1s|n_p2s)

    LL = gt.log_aln_probs
    seed_positions = getattr(gt, "seed_positions", None)
    # Vectorized transcription of the reference's per-read stats loop
    # (seq_stutter_genotyper.cpp:929-1039); the scalar ops are the same
    # ufuncs element-wise, so per-sample values are unchanged.
    if gt.switch_old_align_len and seed_positions is not None:
        # Mode B: unseeded reads are excluded from the per-sample stats
        # (seq_stutter_genotyper.cpp:946-951)
        idx = np.flatnonzero(np.asarray(seed_positions) >= 0)
    else:
        idx = np.arange(gt.num_reads)
    if len(idx):
        s_arr = np.asarray(gt.sample_label)[idx]
        haps_arr = np.asarray(haplotypes, dtype=int).reshape(-1, 2)
        hap_a = haps_arr[s_arr, 0]
        hap_b = haps_arr[s_arr, 1]
        LLa = np.asarray(LL)[idx, hap_a]
        LLb = np.asarray(LL)[idx, hap_b]
        p1 = np.asarray(gt.log_p1)[idx]
        p2 = np.asarray(gt.log_p2)[idx]
        het = (hap_a != hap_b) if not gt.haploid \
            else np.zeros(len(idx), dtype=bool)
        strand = (het & ~(p1 + LLa > p2 + LLb)).astype(int)
        np.add.at(unique_hap_one, s_arr[het & (strand == 0)], 1)
        np.add.at(unique_hap_two, s_arr[het & (strand == 1)], 1)
        np.add.at(num_aligned, s_arr, 1)
        snp = np.abs(p1 - p2) > TOLERANCE
        np.add.at(num_with_snps, s_arr[snp], 1)
        np.add.at(num_strand_one, s_arr[snp & (p1 > p2)], 1)
        np.add.at(num_strand_two, s_arr[snp & ~(p1 > p2)], 1)
        best_hap = np.where(strand == 0, hap_a, hap_b)
        ml_vals = np.asarray(allele_bp_diffs)[np.asarray(h2a)[best_hap]]
        ml_l = ml_vals.tolist()
        for k, r in enumerate(idx.tolist()):
            s = s_arr[k]
            aln = gt.alns[r]
            if aln.deleted:
                bps_per_sample[s].append(-len(alleles[0]))
            else:
                ok, bp_diff = extract_cigar(aln.cigar, aln.start,
                                            region.start - 5, region.stop + 5)
                if ok:
                    bps_per_sample[s].append(bp_diff)
            ml_bps_per_sample[s].append(ml_l[k])

    # Allele counts over samples of interest (:1041-1069)
    soi = set(sample_names)
    allele_counts = np.zeros(len(alleles), dtype=int)
    skip_count = filt_count = allele_number = 0
    for s, (ga, gb) in enumerate(gts):
        if gt.sample_names[s] not in soi:
            continue
        if num_aligned[s] == 0:
            continue
        if num_aligned[s] > 0 and \
                num_flank_indels[s] > flags.max_flank_indel_frac * num_aligned[s]:
            filt_count += 1
            continue
        if gt.call_sample[s] == "":
            if gt.haploid:
                allele_counts[ga] += 1
                allele_number += 1
            else:
                allele_counts[ga] += 1
                allele_counts[gb] += 1
                allele_number += 2
        else:
            skip_count += 1

    old_to_new, new_to_old = reorder_alleles(alleles)

    if logger:
        logger("Allele counts")
        for i in range(len(alleles)):
            logger(f"\t{alleles[new_to_old[i]]} {allele_counts[new_to_old[i]]}")

    if len(inexact) == 1:
        inexact_seq = "."
    else:
        inexact_seq = ",".join("1" if inexact[new_to_old[i]] else "0"
                               for i in range(1, len(alleles)))

    out = []
    out.append(f"{region.chrom}\t{pos}\t{region.name if region.name else '.'}")
    ref_allele = alleles[new_to_old[0]]
    if len(alleles) == 1:
        alt_str = "."
    else:
        alt_str = ",".join(alleles[new_to_old[i]] for i in range(1, len(alleles)))
    out.append(f"\t{ref_allele}\t{alt_str}")
    out.append("\t.\t.")

    info = (f"\tSTART={region.start + 1};END={region.stop};MOTIF={region.motif};"
            f"PERIOD={region.period_str()};NSKIP={skip_count};NFILT={filt_count};"
            f"INEXACT_ALLELE={inexact_seq};")
    if len(alleles) > 1:
        info += "BPDIFFS=" + ",".join(
            str(allele_bp_diffs[new_to_old[i]]) for i in range(1, len(alleles))) + ";"

    tot_dp = tot_dsnp = tot_dflank = 0
    for name in sample_names:
        s = gt.sample_indices.get(name)
        if s is None or gt.call_sample[s] != "":
            continue
        if num_aligned[s] > 0 and \
                num_flank_indels[s] > num_aligned[s] * flags.max_flank_indel_frac:
            continue
        tot_dp += num_aligned[s]
        tot_dsnp += num_with_snps[s]
        tot_dflank += num_flank_indels[s]
    info += f"DP={tot_dp};DSNP={tot_dsnp};DFLANKINDEL={tot_dflank};"
    info += f"AN={allele_number};REFAC={allele_counts[0]}"
    if len(allele_counts) > 1:
        info += ";AC=" + ",".join(
            str(allele_counts[new_to_old[i]]) for i in range(1, len(alleles)))
    out.append(info)

    if not gt.haploid:
        fmt = "GT:GB:Q:PQ:DP:DSNP:DFLANKINDEL:PDP:PSNP:GLDIFF"
        num_fields = 10
    else:
        fmt = "GT:GB:Q:DP:DFLANKINDEL:GLDIFF"
        num_fields = 6
    if flags.allreads:
        fmt += ":ALLREADS"
    if flags.mallreads:
        fmt += ":MALLREADS"
    if flags.gls:
        fmt += ":GL"
    if flags.pls:
        fmt += ":PL"
    if not gt.haploid and flags.phased_gls:
        fmt += ":PHASEDGL"
    if flags.haplotype_data:
        fmt += ":HQ:PHQ"
    if flags.filters:
        fmt += ":FILTER"
    out.append("\t" + fmt)

    num_fields += (1 if (not gt.haploid and flags.phased_gls) else 0)
    num_fields += (int(flags.allreads) + int(flags.mallreads) + int(flags.gls)
                   + int(flags.pls) + 2 * int(flags.haplotype_data))
    empty_str = ".:" * num_fields

    filter_reasons = {}
    for name in sample_names:
        out.append("\t")
        s = gt.sample_indices.get(name)
        if s is None:
            out.append("." if not flags.filters else empty_str + "NO_READS")
            continue
        if num_aligned[s] == 0:
            filter_reasons["NO_READS"] = filter_reasons.get("NO_READS", 0) + 1
            out.append("." if not flags.filters else empty_str + "NO_READS")
            continue
        if gt.call_sample[s] != "":
            reason = gt.call_sample[s]
            filter_reasons[reason] = filter_reasons.get(reason, 0) + 1
            out.append("." if not flags.filters else empty_str + reason)
            continue
        if num_aligned[s] > 0 and \
                num_flank_indels[s] > num_aligned[s] * flags.max_flank_indel_frac:
            gt.call_sample[s] = "FLANK_INDEL_FRAC"
            filter_reasons["FLANK_INDEL_FRAC"] = \
                filter_reasons.get("FLANK_INDEL_FRAC", 0) + 1
            out.append("." if not flags.filters else empty_str + "FLANK_INDEL_FRAC")
            continue

        ga, gb = gts[s]
        fields = []
        if not gt.haploid:
            fields.append(f"{old_to_new[ga]}|{old_to_new[gb]}")
            fields.append(f"{allele_bp_diffs[ga]}|{allele_bp_diffs[gb]}")
            fields.append(f2(np.exp(ext.log_unphased_posteriors[s])))
            fields.append(f2(np.exp(ext.log_phased_posteriors[s])))
            fields.append(str(num_aligned[s]))
            fields.append(str(num_with_snps[s]))
            fields.append(str(num_flank_indels[s]))
            fields.append(f"{gt.n_p1s[s]}|{gt.n_p2s[s]}")
            fields.append(f"{num_strand_one[s]}|{num_strand_two[s]}")
            fields.append("." if len(alleles) == 1 else f2(ext.gl_diffs[s]))
        else:
            fields.append(f"{old_to_new[ga]}")
            fields.append(f"{allele_bp_diffs[ga]}")
            fields.append(f2(np.exp(ext.log_unphased_posteriors[s])))
            fields.append(str(num_aligned[s]))
            fields.append(str(num_flank_indels[s]))
            fields.append("." if len(alleles) == 1 else f2(ext.gl_diffs[s]))

        if flags.allreads:
            fields.append(condense_read_counts(bps_per_sample[s]))
        if flags.mallreads:
            fields.append(condense_read_counts(ml_bps_per_sample[s]))

        if gt.haploid:
            if flags.gls:
                vals = [f2(ext.gls[s][0])] + [
                    f2(ext.gls[s][new_to_old[i]]) for i in range(1, len(new_to_old))]
                fields.append(",".join(vals))
            if flags.pls:
                vals = [str(ext.pls[s][0])] + [
                    str(ext.pls[s][new_to_old[i]]) for i in range(1, len(new_to_old))]
                fields.append(",".join(vals))
        else:
            if flags.gls:
                vals = [f2(ext.gls[s][0])]
                for i in range(1, len(new_to_old)):
                    for j in range(i + 1):
                        ia = min(new_to_old[i], new_to_old[j])
                        ib = max(new_to_old[i], new_to_old[j])
                        vals.append(f2(ext.gls[s][ib * (ib + 1) // 2 + ia]))
                fields.append(",".join(vals))
            if flags.pls:
                vals = [str(ext.pls[s][0])]
                for i in range(1, len(new_to_old)):
                    for j in range(i + 1):
                        ia = min(new_to_old[i], new_to_old[j])
                        ib = max(new_to_old[i], new_to_old[j])
                        vals.append(str(ext.pls[s][ib * (ib + 1) // 2 + ia]))
                fields.append(",".join(vals))
            if flags.phased_gls:
                V = len(new_to_old)
                vals = [f2(ext.phased_gls[s][0])]
                for i in range(V):
                    for j in range(V):
                        if i == 0 and j == 0:
                            continue
                        vals.append(f2(ext.phased_gls[s][new_to_old[i] * V + new_to_old[j]]))
                fields.append(",".join(vals))

        if flags.haplotype_data:
            fields.append(f2(np.exp(ext.hap_log_unphased_posteriors[s])))
            fields.append(f2(np.exp(ext.hap_log_phased_posteriors[s])))
        if flags.filters:
            fields.append("PASS")
        out.append(":".join(fields))

    record = "".join(out)
    vcf_writer.add_vcf_record(region.chrom, pos, record)

    if filter_reasons and logger:
        total = sum(filter_reasons.values())
        parts = "\t".join(f"{v}={k}" for k, v in sorted(filter_reasons.items()))
        logger(f"Filtered {total} sample genotypes for the following reasons:\t{parts}")
