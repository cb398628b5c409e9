"""Mode-B read-vs-haplotype scoring (seed-split stutter HMM).

Port of :mod:`longtr_tpu.pipeline.mode_b`, which cannot be imported
without JAX.  The host code (seeds, row tables, the f64 host transcription
``score_read`` and its seed marginalization ``compute_aln_logprob``) is the
JAX package's, line for line; the batch marginalizes all of a locus's
reads in one array pass, bit for bit that walk's.  The artifact tables, which the JAX package builds on the
host, are built on the device: the host phase hands over the reads' bytes
and the (block, option) descriptors, and the device phase runs
:func:`~longtr_tpu_torch.ops.mode_b_cuda.mode_b_artifacts` and then
:func:`~longtr_tpu_torch.ops.mode_b_device.mode_b_cols` on their output (the
CUDA kernels on a card, the plain torch versions on the CPU).  The host phase
builds the device's inputs with array operations: the reads' bytes gathered
into segments, per-base log-probs gathered from 256-entry tables, and the 2K
row tables of the K configs broadcast over the reads; they equal the JAX
package's per-row loop bit for bit.

Reference: HapAligner.cpp — ``process_read`` short path (:855-991),
``align_seq_to_hap_short`` (:27-163), ``compute_aln_logprob`` (:165-233) and
``calc_seed_base`` (:467-542).  Used when ``--stutter-align-len`` is active
and the repeat period is 1.

Matrices are kept flat (row-major [hap_position × read_position]) with the
C++'s exact index arithmetic; the non-repeat rows use the same vectorized
decayed-running-max formulation as mode A, so only the stutter-block rows
loop in Python (cheap for period-1 blocks — see ops.stutter_hmm).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from longtr_tpu_torch.device import select_device
from longtr_tpu_torch.ops.mode_b_artifacts import prefix_doubles
from longtr_tpu_torch.ops.stutter_hmm import (IMPOSSIBLE, MIN_SEED_DIST, StutterAligner,
                                              fast_lse, fast_lse_cols)
from longtr_tpu_torch.utils.base_quality import log_prob_correct, log_prob_error
from longtr_tpu_torch.utils.mathops import int_log
from longtr_tpu_torch.utils.timers import span
from longtr_tpu_torch.ops.mode_b_cuda import mode_b_artifacts
from longtr_tpu_torch.ops.mode_b_device import _pad_to, mode_b_cols
from longtr_tpu_torch.ops.pairhmm import AlignmentParams

# The prepared arrays the row DP reads, in mode_b_cols' order, around the
# artifact tables ("A_tab") that sit between them; and the arrays the
# artifact tables are built from, in mode_b_artifacts' order.
ROW_KEYS = ("codes", "quals_a", "lw_tab", "lc_tab", "pre_a", "last",
            "hapchar", "kind", "stut_ord", "A_tab", "tab", "bl_a", "d0_a",
            "dstep_a", "params")
ARTIFACT_KEYS = ("seg_codes", "seg_quals", "seg_len", "lw64", "lc64", "tdesc",
                 "blk_bytes", "upstream", "priors", "int_log")

# log P(error) and log P(correct) of each quality byte, the tables every
# per-base lookup of mode B gathers from: log_prob_* is itself a clamped
# table, so the gather gives its values bit for bit
LW64 = np.array([log_prob_error(chr(i)) for i in range(256)])
LC64 = np.array([log_prob_correct(chr(i)) for i in range(256)])
LW64.setflags(write=False)
LC64.setflags(write=False)


def _qual_bytes(quals: str) -> np.ndarray:
    return np.frombuffer(quals.encode("latin1"), dtype=np.uint8)


def _segment_index(start, step, lens, width, pad):
    """(2, P, width) indices into a flat array of segments: segment (side,
    p) is ``start[side, p] + step[side] * j`` for ``j < lens[side, p]``,
    and ``pad`` (the index of a pad element) past its end."""
    j = np.arange(width)
    idx = start[..., None] + step[:, None, None] * j
    return np.where(j < lens[..., None], idx, pad)


class _RevRepeatInfo:
    def __init__(self, block):
        self.max_ins = block.max_ins
        self.max_del = block.max_del


def reverse_blocks(blocks):
    """Reversed haplotype blocks (HapBlock::reverse / RepeatBlock::reverse)."""
    from longtr_tpu_torch.haplotype.blocks import HapBlock, RepeatBlock
    out = []
    for b in blocks:
        if b.repeat_info is not None:
            nb = RepeatBlock(b.start, b.end, b.seqs[0][::-1], b.period,
                             b.stutter_model)
            for alt, inx in zip(b.seqs[1:], b.inexact[1:]):
                nb.add_alternate(alt[::-1], inx)
        else:
            nb = HapBlock(b.end - 1, b.start - 1, b.seqs[0][::-1])
            for alt, inx in zip(b.seqs[1:], b.inexact[1:]):
                nb.add_alternate(alt[::-1], inx)
        out.append(nb)
    return list(reversed(out))


def calc_seed_base(aln, repeat_starts, repeat_ends, hap_start, hap_end):
    """Best seed base index or -1 (HapAligner.cpp:467-542)."""
    def calc_best_seed_position(region_start, region_end):
        best_dist = best_pos = -1
        pos = region_start
        ri = 0
        while ri < len(repeat_starts) and pos <= region_end:
            if pos < repeat_starts[ri]:
                dist = 1 + (min(region_end, repeat_starts[ri] - 1) - pos) // 2
                if dist >= best_dist:
                    best_dist = dist
                    best_pos = dist - 1 + pos
                pos = repeat_ends[ri]
                ri += 1
            elif pos < repeat_ends[ri]:
                pos = repeat_ends[ri]
                ri += 1
            else:
                ri += 1
        if pos <= region_end:
            dist = 1 + (region_end - pos) // 2
            if dist >= best_dist:
                best_dist = dist
                best_pos = dist - 1 + pos
        return best_dist, best_pos

    pos = aln.start
    best_seed = -1
    cur_base = 0
    max_dist = MIN_SEED_DIST
    for op, num in aln.cigar:
        if op == "=":
            min_region = max(pos, hap_start)
            max_region = min(pos + num - 1, hap_end - 1)
            if min_region <= max_region:
                distance, dist_pos = calc_best_seed_position(min_region, max_region)
                if distance >= max_dist:
                    max_dist = distance
                    best_seed = cur_base + (dist_pos - pos)
            pos += num
            cur_base += num
        elif op == "I":
            cur_base += num
        elif op == "X":
            pos += num
            cur_base += num
        elif op == "D":
            pos += num
        else:
            raise ValueError("Unrecognized CIGAR char in calc_seed_base: " + op)
    if best_seed < -1 or best_seed == 0 or best_seed >= len(aln.sequence) - 1:
        return -1
    return best_seed


class ModeBAligner:
    """Scores reads against all haplotype configs with the stutter HMM.

    ``device`` is where :meth:`score_reads_batch_finish` builds the
    artifact tables and runs the row DP (default:
    :func:`~longtr_tpu_torch.device.select_device`'s, the first card
    unless ``LONGTR_TORCH_DEVICE`` names another).
    """

    def __init__(self, haplotype, alignment_params=None,
                 device: torch.device | None = None):
        self.device = select_device(device)
        self.hap = haplotype
        p = (AlignmentParams.from_list(alignment_params) if alignment_params
             else AlignmentParams())
        self.i2i = np.float32(p.ins_to_ins)
        self.i2m = np.float32(p.ins_to_match)
        self.d2d = np.float32(p.del_to_del)
        self.d2m = np.float32(p.del_to_match)
        self.m2m = np.float32(p.match_to_match)
        self.m2i = np.float32(p.match_to_ins)
        self.m2d = np.float32(p.match_to_del)
        self.fw_blocks = haplotype.blocks
        self.rev_blocks = reverse_blocks(haplotype.blocks)
        self.repeat_starts = [b.start for b in self.fw_blocks
                              if b.repeat_info is not None]
        self.repeat_ends = [b.end for b in self.fw_blocks
                            if b.repeat_info is not None]
        # stutter aligners per block per allele; fw uses left_align=True
        self._fw_stutter = self._make_stutter(self.fw_blocks, True)
        self._rev_stutter = self._make_stutter(self.rev_blocks, False)
        # number of non-repeat haplotype positions (seed prior)
        self.num_seeds = sum(len(b.seqs[0]) for b in self.fw_blocks
                             if b.repeat_info is None)

    @staticmethod
    def _make_stutter(blocks, left_align):
        out = []
        for b in blocks:
            if b.repeat_info is None:
                out.append(None)
            else:
                out.append([StutterAligner(s, b.period, left_align, b)
                            for s in b.seqs])
        return out

    # ------------------------------------------------------------------
    def _align_short(self, blocks, stutter_aligners, config, seq, blw, blc):
        """align_seq_to_hap_short for one haplotype config.

        Returns (match, insert, delete (hap_size, L) arrays, left_prob,
        first_char, hap_seqs list).
        """
        L = len(seq)
        seqs = [b.get_seq(c) for b, c in zip(blocks, config)]
        hap_size = sum(len(s) for s in seqs)
        M = np.full((hap_size, L), IMPOSSIBLE)
        I = np.full((hap_size, L), IMPOSSIBLE)
        D = np.full((hap_size, L), IMPOSSIBLE)

        codes = np.frombuffer(seq.encode(), dtype=np.uint8)
        first_char = seqs[0][0]
        prefix = np.concatenate([[0.0], np.cumsum(blc)[:-1]])
        emit0 = np.where(codes == ord(first_char), blc, blw)
        M[0] = emit0 + prefix
        I[0] = blc + prefix
        left_prob = float(np.cumsum(blc)[-1]) if L else 0.0

        hap_index = 1
        stutter_R = -1
        for bi, block in enumerate(blocks):
            bseq = seqs[bi]
            if block.repeat_info is not None:
                option = config[bi]
                block_len = len(bseq)
                prev_row = hap_index - 1
                row = hap_index + block_len - 1
                sa = stutter_aligners[bi][option]
                sa.load_read(L, seq, blw, blc)
                period = block.period
                d_list = list(range(block.max_del, block.max_ins + 1, period))
                for j in range(L):
                    offset = L - 1 - j
                    probs = []
                    for Dart in d_list:
                        base_len = min(block_len + Dart, j + 1)
                        if base_len >= 0:
                            pr, _pos = sa.align(base_len, j, offset, Dart)
                            pre = (0.0 if j - base_len < 0
                                   else M[prev_row, j - base_len])
                            probs.append(block.log_prob_pcr_artifact(option, Dart)
                                         + pr + pre)
                        else:
                            probs.append(IMPOSSIBLE)
                    M[row, j] = fast_lse(probs)
                stutter_R = row
                hap_index += block_len
                continue

            coord0 = 1 if bi == 0 else 0
            for coord in range(coord0, len(bseq)):
                h = hap_index
                ch = ord(bseq[coord])
                emit = np.where(codes == ch, blc, blw)
                # boundary j = 0
                M[h, 0] = emit[0]
                I[h, 0] = IMPOSSIBLE if h == stutter_R + 1 else blc[0]
                D[h, 0] = IMPOSSIBLE if h == stutter_R + 1 else \
                    max(D[h - 1, 0] + self.d2d, M[h - 1, 0] + self.d2m)
                if h == stutter_R + 1:
                    # Stutter block must be followed by a match (:132-141)
                    M[h, 1:] = emit[1:] + M[h - 1, :-1]
                else:
                    # I[h, j] = blc[j] + max(M[h-1,j-1]+i2m, I[h,j-1]+i2i)
                    # (HapAligner.cpp:152-153).  The within-row chain through
                    # I accumulates blc at EVERY step, so the closed form is
                    #   I[h,j] = blc[j] + prefix[j] + j*i2i
                    #            + max_{k<=j}(src[k] - prefix[k] - k*i2i)
                    # with prefix[j] = sum_{t<j} blc[t], src[0] = I[h,0] -
                    # blc[0], src[k>=1] = M[h-1,k-1] + i2m — one cummax.
                    jj = np.arange(L)
                    src = np.empty(L)
                    src[0] = I[h, 0] - blc[0]
                    src[1:] = M[h - 1, :-1] + self.i2m
                    run = np.maximum.accumulate(src - prefix - jj * self.i2i)
                    I[h] = blc + prefix + jj * self.i2i + run
                    I[h, 0] = IMPOSSIBLE if h == stutter_R + 1 else blc[0]
                    M[h, 1:] = emit[1:] + np.maximum(
                        I[h, :-1] + self.m2i,
                        np.maximum(M[h - 1, :-1] + self.m2m,
                                   D[h - 1, :-1] + self.m2d))
                    D[h, 1:] = np.maximum(M[h - 1, 1:] + self.d2m,
                                          D[h - 1, 1:] + self.d2d)
                hap_index += 1
        return M, I, D, left_prob, seqs

    # ------------------------------------------------------------------
    def compute_aln_logprob(self, base_seq_len, seed_base, seed_char,
                            log_seed_wrong, log_seed_correct,
                            lm_col, l_prob, rm_col, r_prob, fw_seqs):
        """HapAligner.cpp:165-233.

        ``lm_col``/``rm_col`` are the LAST COLUMNS of the left/right match
        matrices (hapsize,): every flat-pointer access in the reference walk
        is at an index ≡ -1 mod the flank length, i.e. a last-column entry,
        so the column vectors carry all the needed state (this is also what
        the device kernel returns — ops/mode_b_device.py).
        """
        hapsize = sum(len(s) for s in fw_seqs)
        prior = -int_log(self.num_seeds)
        log_probs = []
        first_char = fw_seqs[0][0]
        last_char = fw_seqs[-1][-1]
        # boundary seeds: reference flat indices rf*(hs-1)-1 / lf*(hs-1)-1
        # are row hs-2, last column
        log_probs.append(prior + (log_seed_correct if seed_char == first_char
                                  else log_seed_wrong)
                         + l_prob + rm_col[hapsize - 2])
        log_probs.append(prior + (log_seed_correct if seed_char == last_char
                                  else log_seed_wrong)
                         + r_prob + lm_col[hapsize - 2])
        # seed at hap position p: left part ends at row p-1 of the forward
        # matrix, right part at row hapsize-p-2 of the reversed matrix
        l_row = 0
        r_row = hapsize - 3
        hap_index = 1
        for bi, block in enumerate(self.fw_blocks):
            bseq = fw_seqs[bi]
            if block.repeat_info is not None:
                l_row += len(bseq)
                r_row -= len(bseq)
                hap_index += len(bseq)
                continue
            coord = 1 if bi == 0 else 0
            end_coord = len(bseq) - 1 if bi == len(self.fw_blocks) - 1 else len(bseq)
            while coord < end_coord:
                log_probs.append(prior + (log_seed_correct
                                          if seed_char == bseq[coord]
                                          else log_seed_wrong)
                                 + lm_col[l_row] + rm_col[r_row])
                l_row += 1
                r_row -= 1
                coord += 1
                hap_index += 1
        return fast_lse(log_probs)

    # ------------------------------------------------------------------
    def _row_tables(self, blocks, config, seqs):
        """Per-row (char, kind, stutter ordinal) + per-ordinal block info.

        Mirrors the ``_align_short`` walk; kinds: 0 flank, 1 flank after a
        stutter row (match-only, HapAligner.cpp:132-141), 2 stutter row,
        3 repeat-block interior (skipped).  Returns None when the structure
        is outside the device kernel's envelope (empty block seq).
        """
        hap_size = sum(len(s) for s in seqs)
        if hap_size < 2 or any(len(s) == 0 for s in seqs):
            return None
        hapchar = np.zeros(hap_size, dtype=np.int32)
        kind = np.full(hap_size, 3, dtype=np.int32)
        stut_ord = np.zeros(hap_size, dtype=np.int32)
        stutter_info = []                       # [(block_index, option)]
        hapchar[0] = ord(seqs[0][0])
        hap_index = 1
        stutter_R = -1
        for bi, block in enumerate(blocks):
            bseq = seqs[bi]
            if block.repeat_info is not None:
                row = hap_index + len(bseq) - 1
                kind[row] = 2
                stut_ord[row] = len(stutter_info)
                stutter_info.append((bi, config[bi]))
                stutter_R = row
                hap_index += len(bseq)
                continue
            coord0 = 1 if bi == 0 else 0
            for coord in range(coord0, len(bseq)):
                h = hap_index
                kind[h] = 1 if h == stutter_R + 1 else 0
                hapchar[h] = ord(bseq[coord])
                hap_index += 1
        return hapchar, kind, stut_ord, stutter_info, hap_size

    def score_reads_batch(self, alns, seeds, dtype=np.float32):
        """Device-batched scoring of many reads (one dispatch per locus).

        Returns (P, num_combs) LLs, or None if any config falls outside the
        kernel envelope (caller falls back to per-read ``score_read``).
        Split into a host phase (table building — safe in a locus build
        worker) and a finish phase (device dispatch + marginalization —
        main thread at dispatch time).
        """
        prep = self.score_reads_batch_prepare(alns, seeds, dtype)
        if prep is None:
            return None
        return self.score_reads_batch_finish(prep)

    def score_reads_batch_prepare(self, alns, seeds, dtype=np.float32):
        """Host phase: the row tables and per-element arrays, and what the
        device builds the artifact tables from (the reversed read segments
        of each side, the (side, block, option) descriptors, and the
        element -> table index).  Returns an opaque dict for
        :meth:`score_reads_batch_finish`, or None if any config falls
        outside the device kernel envelope.  Its ``elements_real`` and
        ``elements_launched`` count the row DP's (read column x haplotype
        row x artifact size) elements: each segment's own columns, rows and
        artifact sizes, against the padded batch the kernels are handed
        (B_pad x L_max x R_max x n_d)."""
        configs = list(self.hap.all_configs())
        K = len(configs)
        sides = []                                   # per (k, side) rows
        n_d = 1
        for k, config in enumerate(configs):
            rev_config = tuple(reversed(config))
            fw_seqs = [b.get_seq(c) for b, c in zip(self.fw_blocks, config)]
            rv_seqs = [b.get_seq(c) for b, c in
                       zip(self.rev_blocks, rev_config)]
            fw = self._row_tables(self.fw_blocks, config, fw_seqs)
            rv = self._row_tables(self.rev_blocks, rev_config, rv_seqs)
            if fw is None or rv is None:
                return None
            sides.append((fw, rv, fw_seqs))
        for b in self.fw_blocks:
            if b.repeat_info is not None:
                n_d = max(n_d, len(range(b.max_del, b.max_ins + 1, b.period)))
        S_max = max(len(t[0][3]) for t in sides) or 1
        R_max = _pad_to(max(max(t[0][4], t[1][4]) for t in sides), 8)

        P = len(alns)
        B = P * K * 2
        B_pad = _pad_to(B, 32)
        # All reads' bases and quality bytes end to end, and a pad byte
        # past them that every column past a segment's end gathers.  The
        # per-base log-probs are gathers of the 256-entry tables; the pad's
        # log P(correct) is 0, so a segment's running sum ends at its end.
        seqs = [aln.sequence for aln in alns]
        quals = [aln.base_qualities for aln in alns]
        n = np.array([len(seq) for seq in seqs], dtype=np.int64)
        s = np.array(seeds, dtype=np.int64)
        off = np.cumsum(n) - n
        pad = int(n.sum())
        cat = np.frombuffer(("".join(seqs) + "\0").encode(), dtype=np.uint8)
        qcat = _qual_bytes("".join(quals) + "\0")
        lw, lc = LW64[qcat], LC64[qcat]
        lc[pad] = 0.0
        segs = [(seq, lw[o:o + m], lc[o:o + m], q)     # per read
                for seq, q, o, m in zip(seqs, quals, off, n)]
        # each read's two segments, (side, p): left of the seed, and right
        # of it reversed; the row DP reads them so, the artifact tables
        # reversed again
        lens = np.stack([s, n - s - 1])
        L_max = _pad_to(int(lens.max()), 8)
        valid = np.arange(L_max) < lens[..., None]
        fwd = _segment_index(np.stack([off, off + n - 1]), np.array([1, -1]),
                             lens, L_max, pad)
        rev = _segment_index(np.stack([off + s - 1, off + s + 1]),
                             np.array([-1, 1]), lens, L_max, pad)
        # numpy's cumsum adds in order: each prefix is a running sum's
        # double
        cs = np.cumsum(lc[fwd], axis=2)
        pre = np.zeros_like(cs)
        pre[..., 1:] = np.where(valid[..., 1:], cs[..., :-1], 0.0)
        # a segment's last prefix; an empty one's is the pad's 0
        lp = np.take_along_axis(cs, np.maximum(lens - 1, 0)[..., None],
                                axis=2)[..., 0]

        # one artifact table per (side, block, option) and read segment:
        # table t of segment p is row t * P + p of the device's tables
        needed = sorted({(side, bi, opt)
                         for k in range(K) for side in (0, 1)
                         for (bi, opt) in sides[k][side][3]})
        t_index = {key: t for t, key in enumerate(needed)}
        art = self._artifact_arrays(needed, cat[rev], qcat[rev],
                                    lens.astype(np.int32), n_d)

        # The 2K row tables, stacked to R_max and S_max: each row of the
        # batch is one of them with one of the 2P segments.  ``t_of`` is a
        # stutter ordinal's table index, -1 past the (k, side)'s blocks.
        row_hc = np.zeros((K, 2, R_max), dtype=np.uint8)
        row_kind = np.full((K, 2, R_max), 3, dtype=np.uint8)
        row_so = np.zeros((K, 2, R_max), dtype=np.uint8)
        t_of = np.full((K, 2, S_max), -1, dtype=np.int64)
        row_bl = np.ones((K, 2, S_max), dtype=np.int32)
        row_d0 = np.zeros((K, 2, S_max), dtype=np.int32)
        row_dstep = np.ones((K, 2, S_max), dtype=np.int32)
        seg_cols = [int(x) for x in lens.sum(axis=1)]
        elements_real = 0          # (column, row, artifact size) a segment
        for k in range(K):
            for side in (0, 1):
                hc, kd, so, sinfo, hs = sides[k][side]
                blocks = self.fw_blocks if side == 0 else self.rev_blocks
                row_hc[k, side, :hs] = hc
                row_kind[k, side, :hs] = kd
                row_so[k, side, :hs] = so
                sizes = [1]
                for s_i, (bi, opt) in enumerate(sinfo):
                    blk = blocks[bi]
                    t_of[k, side, s_i] = t_index[(side, bi, opt)]
                    row_bl[k, side, s_i] = len(blk.get_seq(opt))
                    row_d0[k, side, s_i] = blk.max_del
                    row_dstep[k, side, s_i] = blk.period
                    sizes.append(len(range(blk.max_del, blk.max_ins + 1,
                                           blk.period)))
                elements_real += seg_cols[side] * hs * max(sizes)

        # Row b is (read p, config k, side) in that order; padding rows
        # past B keep the fill values.  The batched device inputs are
        # allocated in the final device dtype: assignment casts each f64
        # value exactly as a whole-array astype would at dispatch, so the
        # finish phase copies them to the device as they are.  Narrow byte
        # formats (uint8 codes/quals/row tables, the per-base log-probs as
        # 256-entry gather tables) keep the copy small, and each is exact:
        # the device gathers the same dtype values.  Quality bytes past a
        # segment's end are don't-cares: columns past `last` never feed a
        # valid column (the DP only reads left-to-right along j).
        b = np.arange(B)
        p_b, k_b, side_b = b // (2 * K), b // 2 % K, b % 2
        codes = np.zeros((B_pad, L_max), dtype=np.uint8)
        quals_a = np.zeros((B_pad, L_max), dtype=np.uint8)
        pre_a = np.zeros((B_pad, L_max), dtype=dtype)
        last = np.zeros(B_pad, dtype=np.int32)
        hapchar = np.zeros((B_pad, R_max), dtype=np.uint8)
        kind = np.full((B_pad, R_max), 3, dtype=np.uint8)
        stut_ord = np.zeros((B_pad, R_max), dtype=np.uint8)
        tab = np.zeros((B_pad, S_max), dtype=np.int32)
        bl_a = np.ones((B_pad, S_max), dtype=np.int32)
        d0_a = np.zeros((B_pad, S_max), dtype=np.int32)
        dstep_a = np.ones((B_pad, S_max), dtype=np.int32)
        codes[:B] = cat[fwd][side_b, p_b]
        quals_a[:B] = qcat[fwd][side_b, p_b]
        pre_a[:B] = pre[side_b, p_b]
        last[:B] = np.maximum(lens - 1, 0)[side_b, p_b]
        hapchar[:B] = row_hc[k_b, side_b]
        kind[:B] = row_kind[k_b, side_b]
        stut_ord[:B] = row_so[k_b, side_b]
        t_b = t_of[k_b, side_b]
        tab[:B] = np.where(t_b >= 0, t_b * P + p_b[:, None], 0)
        bl_a[:B] = row_bl[k_b, side_b]
        d0_a[:B] = row_d0[k_b, side_b]
        dstep_a[:B] = row_dstep[k_b, side_b]
        elem = dict(zip(itertools.product(range(P), range(K), (0, 1)),
                        range(B)))
        lprob = np.ascontiguousarray(lp.T)

        params = np.array([self.i2i, self.i2m, self.d2d, self.d2m,
                           self.m2m, self.m2i, self.m2d], dtype=dtype)
        prep = dict(codes=codes, quals_a=quals_a,
                    lw_tab=art["lw64"].astype(dtype),
                    lc_tab=art["lc64"].astype(dtype), pre_a=pre_a, last=last,
                    hapchar=hapchar, kind=kind,
                    stut_ord=stut_ord, tab=tab, bl_a=bl_a, d0_a=d0_a,
                    dstep_a=dstep_a, params=params, n_d=n_d, dtype=dtype,
                    alns=alns, seeds=seeds, segs=segs, configs=configs,
                    sides=sides, elem=elem, lprob=lprob, P=P, K=K,
                    elements_real=elements_real,
                    elements_launched=B_pad * L_max * R_max * n_d, **art)
        return prep

    def artifact_inputs(self, tables, side_segs, L_max, n_d):
        """What the device builds the artifact tables from
        (:mod:`longtr_tpu_torch.ops.mode_b_artifacts`), as
        :meth:`_artifact_arrays` gives it, for read segments listed one by
        one: ``side_segs[side]`` lists the segments of a side in their own
        order as (base bytes, quality bytes) uint8 arrays of at most
        ``L_max`` bytes."""
        lens = np.array([[len(c) for c, _q in side_segs[side]]
                         for side in (0, 1)], dtype=np.int64).reshape(2, -1)
        flat = [np.concatenate([x[i][:len(x[0])] for side in (0, 1)
                                for x in side_segs[side]]
                               + [np.zeros(1, np.uint8)]).astype(np.uint8)
                for i in (0, 1)]
        off = (np.cumsum(lens) - lens.ravel()).reshape(lens.shape)
        rev = _segment_index(off + lens - 1, np.array([-1, -1]), lens, L_max,
                             int(lens.sum()))
        return self._artifact_arrays(tables, flat[0][rev], flat[1][rev],
                                     lens.astype(np.int32), n_d)

    def _artifact_arrays(self, tables, seg_codes, seg_quals, seg_len, n_d):
        """What the device builds the artifact tables from
        (:mod:`longtr_tpu_torch.ops.mode_b_artifacts`): each side's read
        segments reversed, ``seg_codes``
        and ``seg_quals`` (2, P, L_max) base and quality bytes zero past
        their ``seg_len``, the 256-entry log-prob tables, and per (side,
        block, option) of ``tables`` one descriptor row, prior row and
        slices of the block-byte and upstream arrays."""
        needed = list(tables)
        T = len(needed)
        tdesc = np.zeros((T, 9), dtype=np.int32)
        priors = np.zeros((T, n_d))
        blk_parts, up_parts = [], []
        blk_off = up_off = 0
        n_log = 2
        for t, (side, bi, opt) in enumerate(needed):
            blocks = self.fw_blocks if side == 0 else self.rev_blocks
            saln = self._fw_stutter if side == 0 else self._rev_stutter
            blk, sa = blocks[bi], saln[bi][opt]
            d_list = list(range(blk.max_del, blk.max_ins + 1, blk.period))
            if 1 + max(sa.num_deletions, 1) + max(sa.num_insertions, 1) \
                    > prefix_doubles(n_d):
                raise ValueError(f"block {bi} option {opt}: deletion and "
                                 "insertion multiples exceed the artifact "
                                 "sizes")
            tdesc[t] = (side, sa.block_len, blk.period, blk.max_del,
                        len(d_list), sa.num_deletions, sa.num_insertions,
                        blk_off, up_off)
            for di, D in enumerate(d_list):
                priors[t, di] = blk.log_prob_pcr_artifact(opt, D)
            blk_parts.append(np.frombuffer(sa.block_seq[::-1].encode(),
                                           dtype=np.uint8))
            ups = np.concatenate([np.asarray(u, dtype=np.int64)
                                  for u in sa.upstream])
            up_parts.append(ups.astype(np.int32))
            blk_off += sa.block_len
            up_off += len(ups)
            n_log = max(n_log, sa.block_len + 2)
        return dict(seg_codes=seg_codes, seg_quals=seg_quals, seg_len=seg_len,
                    lw64=LW64.copy(), lc64=LC64.copy(),
                    tdesc=tdesc, priors=priors,
                    blk_bytes=np.concatenate(blk_parts + [np.zeros(1, np.uint8)]),
                    upstream=np.concatenate(up_parts + [np.zeros(1, np.int32)]),
                    int_log=np.array([int_log(n) for n in range(n_log)]),
                    tables=needed)

    def score_reads_batch_finish(self, prep):
        """Finish phase: the artifact tables and the row DP on
        ``self.device``, then the f64 seed marginalization on the host.

        Two spans: ``Mode B device`` (copy to the device, the two kernels
        and the copy back, which waits for them) and ``Mode B
        marginalize`` (the f64 seed marginalization whose reduction order
        is part of the parity contract, DESIGN.md §2)."""
        with span("Mode B device"):
            A = self.artifact_tables(prep)
            args = [A if k == "A_tab"
                    else torch.from_numpy(prep[k]).to(self.device)
                    for k in ROW_KEYS]
            cols = mode_b_cols(*args, n_d=prep["n_d"])
            cols = cols.cpu().numpy().astype(np.float64)

        with span("Mode B marginalize"):
            return self._marginalize(prep, cols)

    def _marginalize(self, prep, cols):
        """:meth:`compute_aln_logprob` of every (read, config) at once: the
        (P, K) LLs from the row DP's last columns ``cols``.

        A config's seed entries depend on its forward row table alone: the
        two boundary seeds, then each flank row 1 <= h <= hs - 2 (kind 0
        or 1), whose left part ends at row h - 1 of the forward column and
        right part at row hs - 2 - h of the reversed one.  The entries are
        gathered into (n_max, P, K) with the reference walk's additions in
        its order, a config with fewer entries padded with trailing -inf
        (an exact +0.0 in the sum), and one column log-sum-exp takes them
        all."""
        P, K, sides = prep["P"], prep["K"], prep["sides"]
        segs, seeds = prep["segs"], prep["seeds"]
        seed_char = np.array([ord(segs[p][0][s]) for p, s in enumerate(seeds)])
        blw = np.array([segs[p][1][s] for p, s in enumerate(seeds)])
        blc = np.array([segs[p][2][s] for p, s in enumerate(seeds)])
        per_config = []
        for fw, _rv, fw_seqs in sides:
            hapchar, kind, hs = fw[0], fw[1], fw[4]
            h = 1 + np.flatnonzero(kind[1:hs - 1] <= 1)
            # each entry's character, its first term's forward row, and its
            # second term's side and row; the boundary seeds' first terms
            # are the whole-segment log-probs, set below
            per_config.append((
                np.r_[ord(fw_seqs[0][0]), ord(fw_seqs[-1][-1]), hapchar[h]],
                np.r_[0, 0, h - 1], np.r_[1, 0, np.ones_like(h)],
                np.r_[hs - 2, hs - 2, hs - 2 - h]))
        n_max = max(len(e[0]) for e in per_config)
        char, row1, side2, row2 = ent = np.zeros((4, n_max, K), dtype=np.int64)
        valid = np.zeros((n_max, K), dtype=bool)
        for k, e in enumerate(per_config):
            ent[:, :len(e[0]), k] = e
            valid[:len(e[0]), k] = True
        cols = cols[:P * K * 2].reshape(P, K, 2, -1)      # row b = (p, k, side)
        p_i = np.arange(P)[:, None]
        k_i = np.arange(K)
        term = np.where(seed_char[:, None] == char[:, None, :],
                        blc[:, None], blw[:, None])
        a1 = cols[p_i, k_i, 0, row1[:, None, :]]
        a1[:2] = prep["lprob"].T[:, :, None]
        a2 = cols[p_i, k_i, side2[:, None, :], row2[:, None, :]]
        prior = -int_log(self.num_seeds)
        E = np.where(valid[:, None, :], prior + term + a1 + a2, -np.inf)
        return fast_lse_cols(E.reshape(n_max, P * K)).reshape(P, K)

    def artifact_tables(self, prep):
        """``prep``'s artifact tables built on ``self.device`` (the CUDA
        kernel on a card, the plain version on the CPU), in its dtype."""
        dtype = torch.from_numpy(np.zeros(0, dtype=prep["dtype"])).dtype
        return mode_b_artifacts(
            *[torch.from_numpy(prep[k]).to(self.device) for k in ARTIFACT_KEYS],
            n_d=prep["n_d"], dtype=dtype)

    # ------------------------------------------------------------------
    def score_read(self, aln, seed_base: int) -> np.ndarray:
        """LLs against every haplotype config, in enumeration order."""
        seq = aln.sequence
        L = len(seq)
        q = _qual_bytes(aln.base_qualities)
        blw, blc = LW64[q], LC64[q]

        left_seq = seq[:seed_base]
        left_w, left_c = blw[:seed_base], blc[:seed_base]
        right_seq = seq[seed_base + 1:][::-1]
        right_w = blw[seed_base + 1:][::-1]
        right_c = blc[seed_base + 1:][::-1]

        out = np.empty(self.hap.num_combs())
        for k, config in enumerate(self.hap.all_configs()):
            rev_config = tuple(reversed(config))
            lM, _, _, l_prob, fw_seqs = self._align_short(
                self.fw_blocks, self._fw_stutter, config, left_seq,
                left_w, left_c)
            rM, _, _, r_prob, _ = self._align_short(
                self.rev_blocks, self._rev_stutter, rev_config, right_seq,
                right_w, right_c)
            out[k] = self.compute_aln_logprob(
                L, seed_base, seq[seed_base], blw[seed_base], blc[seed_base],
                lM[:, -1], l_prob, rM[:, -1], r_prob, fw_seqs)
        return out
