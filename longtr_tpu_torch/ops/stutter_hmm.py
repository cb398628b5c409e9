"""Mode-B alignment: the legacy HipSTR stutter HMM for short homopolymers.

Reference: ``HapAligner::align_seq_to_hap_short`` (HapAligner.cpp:27-163),
``StutterAlignerClass`` (StutterAlignerClass.{h,cpp}) and
``compute_aln_logprob`` (HapAligner.cpp:165-233).  Active only when
``--stutter-align-len`` is set and the repeat period is 1
(HapAligner.cpp:552-555).

Semantics:
* a seed base (a `=` position >=5bp from indels/repeats, calc_seed_base,
  HapAligner.cpp:467-542) splits the read; left and right segments align
  independently against the forward and reversed haplotype,
* non-repeat blocks use a max-transition HMM with per-base quality
  emissions; the within-row insert recurrence is a decayed running max, so
  rows vectorize exactly like mode A,
* repeat blocks are scored by marginalizing PCR artifact sizes
  D ∈ [-6·period, +6·period] and artifact positions; for period-1 blocks the
  position loop collapses via the upstream-match skip
  (StutterAlignerClass.cpp:75-100), keeping the host transcription cheap,
* the total LL marginalizes the seed across all non-repeat haplotype
  positions with a uniform prior (compute_aln_logprob).

The reference's homopolymer-length lookups inside the flank recurrence
(HapAligner.cpp:121-122) are computed but never used — omitted here.
"""

from __future__ import annotations

import numpy as np

from longtr_tpu_torch.utils.mathops import LOG_THRESH, int_log

IMPOSSIBLE = -1000000000.0
MIN_SEED_DIST = 5


def fast_lse(vals) -> float:
    """fast_log_sum_exp semantics (term dropping); exact by default, the
    reference's Mineiro bit patterns in reference-fidelity mode.

    Exact mode accumulates kept exp terms SEQUENTIALLY in entry order
    (matching the reference's loop and the vectorized column variant
    below bit-for-bit; np.sum's pairwise order would diverge)."""
    from longtr_tpu_torch.utils import mathops
    if mathops.ref_fidelity():
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp_vec(vals)
    arr = np.asarray(vals, dtype=np.float64)
    m = arr.max()
    if not np.isfinite(m):
        return float(m)
    d = arr - m
    # One vectorized exp; the ADDITIONS stay sequential in entry order
    # (that is what the bit-identity contract requires — per-element
    # np.exp on scalars was ~10x slower for the same bits).
    e = np.exp(d)
    total = 0.0
    for dv, ev in zip(d.tolist(), e.tolist()):
        if dv > LOG_THRESH:
            total += ev
    return float(m + np.log(total))


def fast_lse_cols(entries) -> np.ndarray:
    """Column-wise fast_lse over a list of equal-length entry vectors.

    Bit-identical per column to calling :func:`fast_lse` on that column's
    entries: terms accumulate sequentially in entry order, dropped terms
    contribute an exact +0.0.
    """
    E = np.stack(entries)                          # (n_entries, N)
    from longtr_tpu_torch.utils import mathops
    if mathops.ref_fidelity():
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp_cols(E)
    m = E.max(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        total = np.zeros(E.shape[1])
        for row in E:
            d = row - m
            total = total + np.where(d > LOG_THRESH, np.exp(d), 0.0)
        out = m + np.log(total)
    return np.where(np.isfinite(m), out, m)


class StutterAligner:
    """Per-(block allele) artifact scorer (StutterAlignerClass)."""

    def __init__(self, block_seq: str, period: int, left_align: bool,
                 repeat_info):
        self.block_seq = block_seq
        self.block_len = len(block_seq)
        self.period = period
        self.left_align = left_align
        self.num_insertions = repeat_info.max_ins // period
        self.num_deletions = -(repeat_info.max_del // period)
        while self.num_deletions * period > self.block_len:
            self.num_deletions -= 1
        self.max_insertion = period * self.num_insertions
        self.max_deletion = -period * self.num_deletions

        # upstream_match_lengths_ per deletion multiple (h:36-43)
        self.upstream = []
        for p in range(period, -self.max_deletion + 1 if self.max_deletion else period + 1, period):
            self.upstream.append(self._num_upstream_matches(block_seq, p))
        if self.max_deletion == 0:
            self.upstream.append(self._num_upstream_matches(block_seq, period)
                                 if block_seq else np.zeros(0, dtype=np.int64))

    @staticmethod
    def _num_upstream_matches(seq: str, period: int):
        n = len(seq)
        out = np.zeros(n, dtype=np.int64)
        for i in range(period, n):
            out[i] = 0 if seq[i - period] != seq[i] else 1 + out[i - 1]
        return out

    def load_read(self, base_seq_len, base_seq, base_log_wrong,
                  base_log_correct):
        """Precompute per-offset prefix probabilities (cpp:12-53).

        ``base_seq`` etc. are python sequences indexed 0..base_seq_len-1 in
        READ order; the C++ uses reversed pointers — we mirror with explicit
        reversed indexing: C++ base_seq[-k] == seq_rev[k] here.
        """
        L = base_seq_len
        seq_rev = base_seq[::-1]
        lw_rev = base_log_wrong[::-1]
        lc_rev = base_log_correct[::-1]
        blk_rev = self.block_seq[::-1]
        nI, nD = self.num_insertions, self.num_deletions
        self.ins_probs = np.zeros((L, max(nI, 1)))
        self.del_probs = np.zeros((L, max(nD, 1))) if nD else None
        self.match_probs = np.zeros(L)
        # Vectorized over offsets i (one j step = one diagonal): every
        # offset accumulates its j terms in ascending order, exactly like
        # the scalar walk (StutterAlignerClass.cpp:12-53); truncated terms
        # (j >= L - i) add an exact +0.0, and del snapshots only write
        # where the scalar recorded (j < L - i).
        seqv = (np.frombuffer(seq_rev.encode(), np.uint8)
                if isinstance(seq_rev, str)
                else np.asarray([ord(c) for c in seq_rev], np.uint8))
        blkv = np.frombuffer(blk_rev.encode(), np.uint8)
        lwv = np.asarray(lw_rev, dtype=np.float64)
        lcv = np.asarray(lc_rev, dtype=np.float64)
        iv = np.arange(L)
        run = np.zeros(L)
        di = 0
        for j in range(self.block_len):
            rr = np.minimum(iv + j, L - 1)      # clamped; masked below
            s = np.where(seqv[rr] == blkv[j], lcv[rr], lwv[rr])
            run = run + np.where(j < L - iv, s, 0.0)
            if (j + 1) % self.period == 0 and j < -self.max_deletion \
                    and di < max(nD, 1) and self.del_probs is not None:
                self.del_probs[:, di] = np.where(j < L - iv, run,
                                                 self.del_probs[:, di])
                di += 1
        self.match_probs[:] = run

        run_ins = np.zeros(L)
        ii = 0
        for j in range(self.max_insertion):
            rr = np.minimum(iv + j, L - 1)
            if j % self.period < self.block_len:
                s = np.where(seqv[rr] == blkv[j % self.period],
                             lcv[rr], lwv[rr])
            else:
                s = lcv[rr]
            run_ins = run_ins + np.where(j < L - iv, s, 0.0)
            if (j + 1) % self.period == 0:
                self.ins_probs[:, ii] = run_ins
                ii += 1
        self._seq_rev = seq_rev
        self._lw_rev = lw_rev
        self._lc_rev = lc_rev
        self._blk_rev = blk_rev
        self._L = L
        # numpy views for the vectorized paths (same arrays as above)
        self._seqv = seqv
        self._blkv = blkv
        self._lwv = lwv
        self._lcv = lcv

    def _score(self, read_idx, blk_idx):
        """Match log-prob of reversed read pos vs reversed block pos."""
        return (self._lc_rev[read_idx]
                if self._seq_rev[read_idx] == self._blk_rev[blk_idx]
                else self._lw_rev[read_idx])

    def align(self, base_seq_len: int, j_end: int, offset: int, D: int):
        """align_stutter_region_reverse.

        ``j_end``: index of the rightmost read base of this segment in READ
        order (the C++ passes seq_0+j with reversed walking); ``offset``:
        reversed-offset of that base.  Returns (log_prob, best_pos).
        """
        if D == 0:
            return self.match_probs[offset], -1
        if D > 0:
            return self._align_insertion(base_seq_len, offset, D)
        return self._align_deletion(base_seq_len, offset, D)

    def _score_vec(self, r, blk_idx):
        """Vector of match log-probs at reversed read positions ``r`` vs a
        single reversed block position (elementwise _score)."""
        return np.where(self._seqv[r] == self._blkv[blk_idx],
                        self._lcv[r], self._lwv[r])

    def align_bulk(self, offsets, D) -> np.ndarray:
        """Vectorized :meth:`align` across read offsets, valid for columns
        whose ``base_len`` equals ``block_len + D`` (and, for deletions,
        ``offset + D >= 0``) — the constant-``base_len`` regime where the
        scalar walk takes the same control path for every offset, because
        upstream-match skips depend only on the block.  Bit-identical per
        column to the scalar methods: identical op order per element, LSE
        via :func:`fast_lse_cols`.  Discards best_pos (the dense artifact
        tables never use it).
        """
        offsets = np.asarray(offsets, dtype=np.int64)
        if D == 0:
            return self.match_probs[offsets]
        blk_len = self.block_len
        base_len = blk_len + D
        entries = []
        if D > 0:
            upstream = self.upstream[0]
            log_prior = -int_log(blk_len + 1)
            lp = log_prior + self.ins_probs[offsets, D // self.period - 1]
            if base_len > D:
                lp = lp + self.match_probs[offsets + D]
            entries.append(lp)
            i = 0
            lim = -min(max(0, base_len - D), blk_len)
            while i > lim:
                if -i + self.period < blk_len:
                    um = upstream[blk_len - 1 + i]
                    if um == 0:
                        idx = i - self.period
                        while idx >= i - D:
                            r = offsets - idx
                            lp = lp - self._score_vec(r, -i)
                            lp = lp + self._score_vec(r, -(i - self.period))
                            idx -= self.period
                        entries.append(lp)
                    else:
                        entries.append(int_log(um) + lp)
                        i -= (um - 1)
                else:
                    entries.append(lp)
                i -= 1
            if i > -blk_len:
                entries.append(int_log(blk_len + i) + lp)
            return fast_lse_cols(entries)
        # D < 0 (deletion); callers guarantee offsets + D >= 0
        upstream = self.upstream[-D // self.period - 1]
        log_prior = -int_log(blk_len + D + 1)
        lp = log_prior + (self.match_probs[offsets + D]
                          - self.del_probs[offsets + D,
                                           -D // self.period - 1])
        entries.append(lp)
        i = 0
        while i > -base_len:
            um = upstream[blk_len - 1 + i]
            r = offsets - i
            if um == 0:
                lp = lp - self._score_vec(r, -(i + D))
                lp = lp + self._score_vec(r, -i)
                entries.append(lp)
            else:
                entries.append(int_log(um) + lp)
                i -= (um - 1)
            i -= 1
        if -i < blk_len + D:
            entries.append(int_log(blk_len + D + i) + lp)
        return fast_lse_cols(entries)

    def align_short_batch(self, j_arr, D) -> np.ndarray:
        """Vectorized :meth:`align` for every non-bulk column (D != 0):
        short prefixes (``base_len == j+1 < block_len + D``) and, for
        deletions, the ``offset + D < 0`` columns whose initialization
        sums the whole segment prefix.

        The scalar walk's i-descent (including upstream-match jumps) is
        column-independent; only the exit point ``lim_j`` varies.  All
        columns ride one shared descent: entries are masked to the steps a
        column actually executed (masked slots hold -inf, an exact no-op
        in the term-dropping LSE), the running lp may keep updating after
        a column's exit but is never read for it again, and each column's
        tail entry captures lp at its own exit step — bit-identical per
        column to the scalar methods.
        """
        j_arr = np.asarray(j_arr, dtype=np.int64)
        offsets = (self._L - 1 - j_arr)
        N = j_arr.size
        NEG_INF = -np.inf
        blk_len = self.block_len
        base_len = np.minimum(blk_len + D, j_arr + 1)

        def masked(vec, act):
            return np.where(act, vec, NEG_INF)

        if D > 0:
            upstream = self.upstream[0]
            log_prior = -int_log(blk_len + 1)
            lp = log_prior + self.ins_probs[offsets, D // self.period - 1]
            has_match = base_len > D
            mo = np.minimum(offsets + D, self._L - 1)
            lp = lp + np.where(has_match, self.match_probs[mo], 0.0)
            lim = -np.minimum(np.maximum(0, base_len - D), blk_len)
            upstream_d = upstream
        else:
            assert D < 0
            upstream_d = self.upstream[-D // self.period - 1]
            log_prior = -int_log(blk_len + D + 1)
            od = offsets + D
            neg = od < 0
            odc = np.maximum(od, 0)
            main_lp = log_prior + (self.match_probs[odc]
                                   - self.del_probs[odc,
                                                    -D // self.period - 1])
            if neg.any():
                # offset+D < 0 columns: the scalar else branch sums the
                # whole segment prefix term-by-term (ascending t), with
                # truncated terms an exact +0.0
                else_lp = np.full(N, log_prior)
                for t in range(int(base_len[neg].max())):
                    r = np.minimum(offsets + t, self._L - 1)
                    s = np.where(self._blkv[t - D] == self._seqv[r],
                                 self._lcv[r], self._lwv[r])
                    else_lp = else_lp + np.where(t < base_len, s, 0.0)
                lp = np.where(neg, else_lp, main_lp)
            else:
                lp = main_lp
            lim = -base_len

        entries = [lp]
        tail = np.full(N, NEG_INF)
        lim_min = int(lim.min())
        i = 0
        # the scalar tail entry differs by sign of D:
        #   D>0: if i > -blk_len:        append(int_log(blk_len + i) + lp)
        #   D<0: if -i < blk_len + D:    append(int_log(blk_len + D + i) + lp)
        t_base = blk_len if D > 0 else blk_len + D

        def capture_exit(old_i, new_i):
            # columns whose loop condition first fails at new_i
            just = (old_i > lim) & (new_i <= lim)
            if not just.any():
                return tail
            ok = just & (new_i > -t_base)
            if not ok.any():
                return tail
            tval = int_log(t_base + new_i)
            return np.where(ok, tval + lp, tail)

        # columns with an empty loop exit at i == 0
        tail = capture_exit(1, 0) if (lim >= 0).any() else tail
        while i > lim_min and i > (-blk_len if D > 0 else lim_min - 1):
            act = i > lim
            if D > 0 and not (-i + self.period < blk_len):
                entries.append(masked(lp, act))
                old_i, i = i, i - 1
                tail = capture_exit(old_i, i)
                continue
            um = upstream_d[blk_len - 1 + i]
            if um == 0:
                if D > 0:
                    idx = i - self.period
                    while idx >= i - D:
                        r = np.minimum(offsets - idx, self._L - 1)
                        lp = lp - self._score_vec(r, -i)
                        lp = lp + self._score_vec(r, -(i - self.period))
                        idx -= self.period
                else:
                    r = np.minimum(offsets - i, self._L - 1)
                    lp = lp - self._score_vec(r, -(i + D))
                    lp = lp + self._score_vec(r, -i)
                entries.append(masked(lp, act))
                old_i, i = i, i - 1
            else:
                entries.append(masked(int_log(um) + lp, act))
                old_i, i = i, i - (um - 1) - 1
            tail = capture_exit(old_i, i)
        entries.append(tail)
        return fast_lse_cols(entries)

    # ------------------------------------------------------------------
    # Read-batched table construction (round 4).  The artifact-table cost
    # was 80%+ of the mode-B device path: 24k+ small numpy calls, one per
    # (read, D).  The descent structure depends only on (block, D) — never
    # on the read — so ALL reads ride one descent with a leading R axis.
    # numpy's exp/log are value-deterministic across array shapes (verified
    # empirically; elementwise ops trivially so), so every per-element op
    # sequence is unchanged and the batched tables are BIT-identical to the
    # per-read ones (fuzz-enforced in tests/test_mode_b_device.py).
    # ------------------------------------------------------------------

    @staticmethod
    def encode_segs_batch(segs):
        """Reversed per-read arrays for :meth:`load_read_batch`.

        Depends only on the read segments — NOT on this aligner's block —
        so callers scoring one read set against many (block, option)
        aligners build it once and pass it to every ``load_read_batch``.
        """
        R = len(segs)
        Ls = np.array([len(s[0]) for s in segs], dtype=np.int64)
        Lmax = max(int(Ls.max()) if R else 1, 1)
        seqv = np.zeros((R, Lmax), dtype=np.uint8)
        lwv = np.zeros((R, Lmax))
        lcv = np.zeros((R, Lmax))
        for r, (s, lw, lc) in enumerate(segs):
            L = len(s)
            if L:
                seqv[r, :L] = np.frombuffer(s.encode(), np.uint8)[::-1]
                lwv[r, :L] = np.asarray(lw, dtype=np.float64)[::-1]
                lcv[r, :L] = np.asarray(lc, dtype=np.float64)[::-1]
        return dict(R=R, Ls=Ls, Lmax=Lmax, seqv=seqv, lwv=lwv, lcv=lcv)

    def load_read_batch(self, segs, enc=None):
        """Batched :meth:`load_read` over R read segments.

        ``segs``: list of (seq_str, log_wrong, log_correct).  Stores
        (R, Lmax[, n]) prefix tables in the same op order per read.
        ``enc``: optional precomputed :meth:`encode_segs_batch` of the same
        segments (the read-side arrays are block-independent).
        """
        if enc is None:
            enc = self.encode_segs_batch(segs)
        R, Ls, Lmax = enc["R"], enc["Ls"], enc["Lmax"]
        seqv, lwv, lcv = enc["seqv"], enc["lwv"], enc["lcv"]
        blkv = np.frombuffer(self.block_seq[::-1].encode(), np.uint8)
        nI, nD = self.num_insertions, self.num_deletions
        ins = np.zeros((R, Lmax, max(nI, 1)))
        dels = np.zeros((R, Lmax, max(nD, 1))) if nD else None
        iv = np.arange(Lmax)
        Lcol = Ls[:, None]
        run = np.zeros((R, Lmax))
        di = 0
        for j in range(self.block_len):
            mask = iv + j < Lcol
            rr = np.clip(np.minimum(iv + j, Lcol - 1), 0, Lmax - 1)
            sv = np.take_along_axis(seqv, rr, 1)
            lcg = np.take_along_axis(lcv, rr, 1)
            lwg = np.take_along_axis(lwv, rr, 1)
            s = np.where(sv == blkv[j], lcg, lwg)
            run = run + np.where(mask, s, 0.0)
            if (j + 1) % self.period == 0 and j < -self.max_deletion \
                    and di < max(nD, 1) and dels is not None:
                dels[:, :, di] = np.where(mask, run, dels[:, :, di])
                di += 1
        match = run.copy()

        run_ins = np.zeros((R, Lmax))
        ii = 0
        for j in range(self.max_insertion):
            mask = iv + j < Lcol
            rr = np.clip(np.minimum(iv + j, Lcol - 1), 0, Lmax - 1)
            lcg = np.take_along_axis(lcv, rr, 1)
            if j % self.period < self.block_len:
                sv = np.take_along_axis(seqv, rr, 1)
                lwg = np.take_along_axis(lwv, rr, 1)
                s = np.where(sv == blkv[j % self.period], lcg, lwg)
            else:
                s = lcg
            run_ins = run_ins + np.where(mask, s, 0.0)
            if (j + 1) % self.period == 0:
                ins[:, :, ii] = run_ins
                ii += 1
        self._b = dict(R=R, Ls=Ls, Lmax=Lmax, seqv=seqv, lwv=lwv, lcv=lcv,
                       ins=ins, dels=dels, match=match, blkv=blkv)

    def _bscore(self, r_mat, blk_idx):
        """Batched :meth:`_score_vec`: (R, N) reversed read positions vs a
        single reversed block position."""
        b = self._b
        rc = np.clip(r_mat, 0, b["Lmax"] - 1)
        sv = np.take_along_axis(b["seqv"], rc, 1)
        return np.where(sv == b["blkv"][blk_idx],
                        np.take_along_axis(b["lcv"], rc, 1),
                        np.take_along_axis(b["lwv"], rc, 1))

    def align_all_batch(self, D) -> np.ndarray:
        """(R, Lmax) table of align() values for artifact size D over every
        column j of every loaded read (garbage where j >= L — the caller
        masks those).  One shared masked descent serves bulk AND
        short-prefix columns of ALL reads: per-element op order is the same
        as the scalar walk, masked slots hold -inf (exact no-ops in the
        term-dropping LSE), and each element's tail entry captures lp at
        its own exit step — bit-identical per (read, column) to
        :meth:`align`."""
        b = self._b
        R, Lmax, Ls = b["R"], b["Lmax"], b["Ls"]
        if D == 0:
            out = np.empty((R, Lmax))
            iv = np.arange(Lmax)
            offs = np.clip(Ls[:, None] - 1 - iv, 0, Lmax - 1)
            return np.take_along_axis(b["match"], offs, 1)
        blk_len = self.block_len
        iv = np.arange(Lmax)
        j_arr = np.broadcast_to(iv, (R, Lmax))
        offsets = Ls[:, None] - 1 - iv                  # < 0 where invalid
        valid = iv < Ls[:, None]
        offc = np.clip(offsets, 0, Lmax - 1)
        NEG_INF = -np.inf
        base_len = np.minimum(blk_len + D, j_arr + 1)

        def masked(vec, act):
            return np.where(act, vec, NEG_INF)

        def gather(tbl, idx):
            return np.take_along_axis(tbl, np.clip(idx, 0, Lmax - 1), 1)

        if D > 0:
            upstream_d = self.upstream[0]
            log_prior = -int_log(blk_len + 1)
            lp = log_prior + gather(b["ins"][:, :, D // self.period - 1],
                                    offc)
            has_match = base_len > D
            lp = lp + np.where(has_match, gather(b["match"], offsets + D),
                               0.0)
            lim = -np.minimum(np.maximum(0, base_len - D), blk_len)
        else:
            upstream_d = self.upstream[-D // self.period - 1]
            log_prior = -int_log(blk_len + D + 1)
            od = offsets + D
            neg = valid & (od < 0)
            main_lp = log_prior + (gather(b["match"], od)
                                   - gather(b["dels"][:, :,
                                                      -D // self.period - 1],
                                            od))
            if neg.any():
                blkv = b["blkv"]   # reversed block bytes, from load_read_batch
                else_lp = np.full((R, Lmax), log_prior)
                for t in range(int(base_len[neg].max())):
                    rr = np.clip(offsets + t, 0, Lmax - 1)
                    sv = np.take_along_axis(b["seqv"], rr, 1)
                    s = np.where(blkv[t - D] == sv,
                                 np.take_along_axis(b["lcv"], rr, 1),
                                 np.take_along_axis(b["lwv"], rr, 1))
                    else_lp = else_lp + np.where(t < base_len, s, 0.0)
                lp = np.where(neg, else_lp, main_lp)
            else:
                lp = main_lp
            lim = -base_len

        entries = [masked(lp, valid)]
        tail = np.full((R, Lmax), NEG_INF)
        lim_eff = np.where(valid, lim, 0)       # invalid: exit immediately
        lim_min = int(lim_eff.min())
        i = 0
        t_base = blk_len if D > 0 else blk_len + D

        def capture_exit(old_i, new_i, tail):
            just = valid & (old_i > lim) & (new_i <= lim)
            if not just.any():
                return tail
            ok = just & (new_i > -t_base)
            if not ok.any():
                return tail
            tval = int_log(t_base + new_i)
            return np.where(ok, tval + lp, tail)

        if (lim >= 0).any():
            tail = capture_exit(1, 0, tail)
        while i > lim_min and i > (-blk_len if D > 0 else lim_min - 1):
            act = valid & (i > lim)
            if D > 0 and not (-i + self.period < blk_len):
                entries.append(masked(lp, act))
                old_i, i = i, i - 1
                tail = capture_exit(old_i, i, tail)
                continue
            um = upstream_d[blk_len - 1 + i]
            if um == 0:
                if D > 0:
                    idx = i - self.period
                    while idx >= i - D:
                        r = offsets - idx
                        lp = lp - self._bscore(r, -i)
                        lp = lp + self._bscore(r, -(i - self.period))
                        idx -= self.period
                else:
                    r = offsets - i
                    lp = lp - self._bscore(r, -(i + D))
                    lp = lp + self._bscore(r, -i)
                entries.append(masked(lp, act))
                old_i, i = i, i - 1
            else:
                entries.append(masked(int_log(um) + lp, act))
                old_i, i = i, i - (um - 1) - 1
            tail = capture_exit(old_i, i, tail)
        entries.append(tail)
        return fast_lse_cols([e.reshape(-1) for e in entries]).reshape(
            R, Lmax)

    def _align_insertion(self, base_seq_len, offset, D):
        blk_len = self.block_len
        log_probs = []
        log_prior = -int_log(blk_len + 1)
        upstream = self.upstream[0]

        log_prob = log_prior + self.ins_probs[offset, D // self.period - 1] + \
            (self.match_probs[offset + D] if base_seq_len > D else 0.0)
        best_pos = 0
        best_ll = log_prob
        log_probs.append(log_prob)

        # reversed-index helpers: C++ base_seq[idx] with idx<=0 maps to
        # self reversed arrays at offset - idx... base_seq points at read pos
        # offset (reversed); base_seq[index] for index<=0 = rev[offset - index]
        i = 0
        lim = -min(max(0, base_seq_len - D), blk_len)
        while i > lim:
            if -i + self.period < blk_len:
                um = upstream[blk_len - 1 + i]
                if um == 0:
                    idx = i - self.period
                    while idx >= i - D:
                        r = offset - idx
                        log_prob -= self._score(r, -i)
                        log_prob += self._score(r, -(i - self.period))
                        idx -= self.period
                    log_probs.append(log_prob)
                else:
                    log_probs.append(int_log(um) + log_prob)
                    i -= (um - 1)
            else:
                log_probs.append(log_prob)
            if log_prob > best_ll or (self.left_align and log_prob == best_ll):
                best_pos = 1 - i
                best_ll = log_prob
            i -= 1

        if i > -blk_len:
            log_probs.append(int_log(blk_len + i) + log_prob)
        return fast_lse(log_probs), best_pos

    def _align_deletion(self, base_seq_len, offset, D):
        blk_len = self.block_len
        log_probs = []
        upstream = self.upstream[-D // self.period - 1]
        log_prior = -int_log(blk_len + D + 1)
        log_prob = log_prior
        if offset + D >= 0:
            log_prob += self.match_probs[offset + D] - \
                self.del_probs[offset + D, -D // self.period - 1]
        else:
            for j in range(0, -base_seq_len, -1):
                r = offset - j
                log_prob += (self._lc_rev[r]
                             if self._blk_rev[-(j + D)] == self._seq_rev[r]
                             else self._lw_rev[r])
        best_pos = 0
        best_ll = log_prob
        log_probs.append(log_prob)

        i = 0
        while i > -base_seq_len:
            um = upstream[blk_len - 1 + i]
            r = offset - i
            if um == 0:
                log_prob -= (self._lc_rev[r]
                             if self._blk_rev[-(i + D)] == self._seq_rev[r]
                             else self._lw_rev[r])
                log_prob += self._score(r, -i)
                log_probs.append(log_prob)
            else:
                log_probs.append(int_log(um) + log_prob)
                i -= (um - 1)
            if log_prob > best_ll or (self.left_align and log_prob == best_ll):
                best_pos = 1 - i
                best_ll = log_prob
            i -= 1

        if -i < blk_len + D:
            log_probs.append(int_log(blk_len + D + i) + log_prob)
        return fast_lse(log_probs), best_pos
