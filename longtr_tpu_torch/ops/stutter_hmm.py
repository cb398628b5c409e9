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
    """Column-wise fast_lse over an (n_entries, N) array or a list of
    equal-length entry vectors.

    Bit-identical per column to calling :func:`fast_lse` on that column's
    entries: terms accumulate sequentially in entry order (numpy's cumsum
    adds in order), dropped terms contribute an exact +0.0, so a column
    padded with trailing -inf entries gives the bits of its real ones.
    """
    E = np.asarray(entries, dtype=np.float64)      # (n_entries, N)
    from longtr_tpu_torch.utils import mathops
    if mathops.ref_fidelity():
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp_cols(E)
    m = E.max(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = E - m
        kept = np.where(d > LOG_THRESH, np.exp(d), 0.0)
        out = m + np.log(np.cumsum(kept, axis=0)[-1])
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
