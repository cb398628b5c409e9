"""Mode-B read-vs-haplotype scoring (seed-split stutter HMM).

Port of :mod:`longtr_tpu.pipeline.mode_b`, which cannot be imported
without JAX.  The host code (seeds, row and artifact tables, the f64 host
transcription ``score_read`` and the f64 seed marginalization) is the JAX
package's, line for line; the device phase sends the tables to a
``torch.device`` and runs :func:`longtr_tpu_torch.ops.mode_b_device.mode_b_cols`
there (the CUDA kernel on a card, the plain torch rows on the CPU).

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

import time

import numpy as np
import torch

from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE, MIN_SEED_DIST, StutterAligner, fast_lse
from longtr_tpu_torch.utils.base_quality import log_prob_correct, log_prob_error
from longtr_tpu_torch.utils.mathops import int_log
from longtr_tpu_torch.ops.mode_b_device import _pad_to, mode_b_cols
from longtr_tpu_torch.ops.pairhmm import AlignmentParams


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

    ``device`` is where :meth:`score_reads_batch_finish` runs the row DP
    (default: the CPU); ``cols_fn`` replaces
    :func:`~longtr_tpu_torch.ops.mode_b_device.mode_b_cols` there (a
    program's reference run gives it the plain version).
    """

    def __init__(self, haplotype, alignment_params=None,
                 device: torch.device | None = None, cols_fn=None):
        self.device = torch.device("cpu") if device is None else \
            torch.device(device)
        self.cols_fn = cols_fn or mode_b_cols
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

    def _artifact_table_batch(self, blocks, stutter_aligners, bi, option,
                              segs_side, n_d, l_pad, enc=None):
        """(R, n_d, l_pad) artifact tables for ALL read segments of one
        (side, block, option) in ~n_D vector calls — bit-identical per read
        to the JAX package's per-read ``_artifact_table`` (the descent
        depends only on (block, D); reads ride a leading axis).  Entries:
        IMPOSSIBLE where base_len < 0 (HapAligner.cpp:92-113), -inf in
        d-padding (dropped by the LSE threshold without ever winning the
        max) and in column padding."""
        block = blocks[bi]
        bseq = block.get_seq(option)
        block_len = len(bseq)
        sa = stutter_aligners[bi][option]
        sa.load_read_batch(segs_side, enc=enc)
        Ls = sa._b["Ls"]
        Lmax = sa._b["Lmax"]
        R = len(segs_side)
        d_list = list(range(block.max_del, block.max_ins + 1, block.period))
        A = np.full((R, n_d, l_pad), -np.inf)
        iv = np.arange(min(Lmax, l_pad))
        valid = iv < Ls[:, None]                       # (R, l)
        A[:, :len(d_list), :Lmax][
            np.broadcast_to(valid[:, None, :],
                            (R, len(d_list), len(iv)))] = IMPOSSIBLE
        for di, Dart in enumerate(d_list):
            if block_len + Dart < 0:
                continue          # base_len < 0 everywhere: scalar skips
            prior = block.log_prob_pcr_artifact(option, Dart)
            tbl = sa.align_all_batch(Dart)             # (R, Lmax)
            vals = prior + tbl[:, :len(iv)]
            cur = A[:, di, :len(iv)]
            A[:, di, :len(iv)] = np.where(valid, vals, cur)
        return A

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
        """Host phase: row tables + artifact tables (cached per
        (read, side, block, option) — strictly less StutterAligner work
        than the per-config host path).  Returns an opaque dict for
        :meth:`score_reads_batch_finish`, or None if any config falls
        outside the device kernel envelope."""
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
        segs = []                                    # per (p, side) read data
        for aln in alns:
            quals = aln.base_qualities
            blw = np.array([log_prob_error(q) for q in quals])
            blc = np.array([log_prob_correct(q) for q in quals])
            segs.append((aln.sequence, blw, blc, quals))
        L_max = _pad_to(max(max(s, len(segs[p][0]) - s - 1)
                            for p, s in enumerate(seeds)), 8)

        def seg_arrays(p, side):
            seq, blw, blc, quals = segs[p]
            s = seeds[p]
            if side == 0:
                sseq, sw, sc = seq[:s], blw[:s], blc[:s]
                squal = quals[:s]
            else:
                sseq = seq[s + 1:][::-1]
                sw = blw[s + 1:][::-1]
                sc = blc[s + 1:][::-1]
                squal = quals[s + 1:][::-1]
            L = len(sseq)
            codes = np.zeros(L_max, dtype=np.uint8)
            codes[:L] = np.frombuffer(sseq.encode(), dtype=np.uint8)
            # qual BYTES ship to the device; the kernel gathers the f32/f64
            # log-prob values from 256-entry tables (bitwise-equal to the
            # host lookup — log_prob_* is itself a clamped table,
            # base_quality.py).  Pad bytes land on arbitrary table entries;
            # columns past `last` never feed a valid column (the DP only
            # reads left-to-right along j), so pad values are don't-cares.
            qb = np.zeros(L_max, dtype=np.uint8)
            qb[:L] = np.frombuffer(squal.encode("latin1"), dtype=np.uint8)
            cs = np.cumsum(sc)
            pre = np.zeros(L_max)
            pre[1:L] = cs[:-1]
            lp = float(cs[-1]) if L else 0.0
            return sseq, sw, sc, codes, qb, pre, lp, L

        B = P * K * 2
        B_pad = _pad_to(B, 32)
        # The batched device inputs are allocated in the final device dtype:
        # assignment casts each f64 row exactly as a whole-array astype would
        # at dispatch, so the finish phase copies them to the device as they
        # are.  Narrow byte formats (uint8 codes/quals/row tables, the
        # per-base log-probs as 256-entry gather tables) keep the copy
        # small, and each is exact: the device gathers the same dtype values.
        codes = np.zeros((B_pad, L_max), dtype=np.uint8)
        quals_a = np.zeros((B_pad, L_max), dtype=np.uint8)
        lw_tab = np.array([log_prob_error(chr(i)) for i in range(256)],
                          dtype=dtype)
        lc_tab = np.array([log_prob_correct(chr(i)) for i in range(256)],
                          dtype=dtype)
        pre_a = np.zeros((B_pad, L_max), dtype=dtype)
        last = np.zeros(B_pad, dtype=np.int32)
        hapchar = np.zeros((B_pad, R_max), dtype=np.uint8)
        kind = np.full((B_pad, R_max), 3, dtype=np.uint8)
        stut_ord = np.zeros((B_pad, R_max), dtype=np.uint8)
        A = np.full((B_pad, S_max, n_d, L_max), -np.inf, dtype=dtype)
        bl_a = np.ones((B_pad, S_max), dtype=np.int32)
        d0_a = np.zeros((B_pad, S_max), dtype=np.int32)
        dstep_a = np.ones((B_pad, S_max), dtype=np.int32)
        lprob = np.zeros((P, 2))

        seg_cache = {}
        for p in range(P):
            for side in (0, 1):
                seg_cache[(p, side)] = seg_arrays(p, side)
        # artifact tables for ALL reads per (side, block, option) in one
        # read-batched call chain
        art_cache = {}
        needed = sorted({(side, bi, opt)
                         for k in range(K) for side in (0, 1)
                         for (bi, opt) in sides[k][side][3]})
        # the reversed read-side arrays depend only on the side, not the
        # (block, option): encode once per side and share across the chain
        side_segs = {side: [seg_cache[(p, side)][:3] for p in range(P)]
                     for side in (0, 1)}
        side_enc = {side: StutterAligner.encode_segs_batch(side_segs[side])
                    for side in (0, 1)}
        for side, bi, opt in needed:
            blocks = self.fw_blocks if side == 0 else self.rev_blocks
            saln = self._fw_stutter if side == 0 else self._rev_stutter
            batch = self._artifact_table_batch(blocks, saln, bi, opt,
                                               side_segs[side], n_d, L_max,
                                               enc=side_enc[side])
            for p in range(P):
                art_cache[(p, side, bi, opt)] = batch[p]
        b = 0
        elem = {}
        for p in range(P):
            for k in range(K):
                for side in (0, 1):
                    fw, rv, _seqs = sides[k]
                    rows = fw if side == 0 else rv
                    blocks = self.fw_blocks if side == 0 else self.rev_blocks
                    saln = self._fw_stutter if side == 0 else self._rev_stutter
                    (sseq, sw, sc, cod, qb, pre, lp, L) = seg_cache[(p, side)]
                    codes[b] = cod
                    quals_a[b] = qb
                    pre_a[b] = pre
                    last[b] = max(L - 1, 0)
                    hc, kd, so, sinfo, hs = rows
                    hapchar[b, :hs] = hc
                    kind[b, :hs] = kd
                    stut_ord[b, :hs] = so
                    lprob[p, side] = lp
                    for s_i, (bi, opt) in enumerate(sinfo):
                        A[b, s_i] = art_cache[(p, side, bi, opt)]
                        blk = blocks[bi]
                        bl_a[b, s_i] = len(blk.get_seq(opt))
                        d0_a[b, s_i] = blk.max_del
                        dstep_a[b, s_i] = blk.period
                    elem[(p, k, side)] = b
                    b += 1

        params = np.array([self.i2i, self.i2m, self.d2d, self.d2m,
                           self.m2m, self.m2i, self.m2d], dtype=dtype)
        return dict(codes=codes, quals_a=quals_a, lw_tab=lw_tab,
                    lc_tab=lc_tab, pre_a=pre_a,
                    last=last, hapchar=hapchar, kind=kind,
                    stut_ord=stut_ord, A=A, bl_a=bl_a, d0_a=d0_a,
                    dstep_a=dstep_a, params=params, n_d=n_d, dtype=dtype,
                    alns=alns, seeds=seeds, segs=segs, configs=configs,
                    sides=sides, elem=elem, lprob=lprob, P=P, K=K)

    def score_reads_batch_finish(self, prep, timings=None):
        """Finish phase: the row DP on ``self.device`` + f64 seed
        marginalization on the host.

        ``timings`` (optional dict) accumulates the two sub-phase walls
        under ``dispatch_s`` (copy to the device, the row DP and the copy
        back, which waits for it) and ``marginalize_s`` (the f64 seed
        marginalization whose reduction order is part of the parity
        contract, DESIGN.md §2)."""
        t0 = time.time()
        tensors = [torch.from_numpy(prep[k]).to(self.device) for k in (
            "codes", "quals_a", "lw_tab", "lc_tab", "pre_a", "last",
            "hapchar", "kind", "stut_ord", "A", "bl_a", "d0_a", "dstep_a",
            "params")]
        cols = self.cols_fn(*tensors, n_d=prep["n_d"])
        cols = cols.cpu().numpy().astype(np.float64)
        t1 = time.time()
        if timings is not None:
            timings["dispatch_s"] = timings.get("dispatch_s", 0.0) + t1 - t0

        alns, seeds, segs = prep["alns"], prep["seeds"], prep["segs"]
        configs, sides, elem = prep["configs"], prep["sides"], prep["elem"]
        lprob = prep["lprob"]
        out = np.empty((prep["P"], prep["K"]))
        for p, aln in enumerate(alns):
            seq = aln.sequence
            _, blw, blc, _quals = segs[p]
            s = seeds[p]
            for k, config in enumerate(configs):
                fw_seqs = sides[k][2]
                out[p, k] = self.compute_aln_logprob(
                    len(seq), s, seq[s], blw[s], blc[s],
                    cols[elem[(p, k, 0)]], lprob[p, 0],
                    cols[elem[(p, k, 1)]], lprob[p, 1], fw_seqs)
        if timings is not None:
            timings["marginalize_s"] = (timings.get("marginalize_s", 0.0)
                                        + time.time() - t1)
        return out

    # ------------------------------------------------------------------
    def score_read(self, aln, seed_base: int) -> np.ndarray:
        """LLs against every haplotype config, in enumeration order."""
        seq = aln.sequence
        L = len(seq)
        quals = aln.base_qualities
        blw = np.array([log_prob_error(q) for q in quals])
        blc = np.array([log_prob_correct(q) for q in quals])

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
