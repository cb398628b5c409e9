"""Mode B: the legacy HipSTR stutter HMM that ``--stutter-align-len`` turns
on for period-1 repeats (HapAligner.cpp:552-555).

A read is split at a seed base, a ``=`` base at least five bases from any
indel and from the repeat (``calc_seed_base``, HapAligner.cpp:467-542).
The part left of the seed aligns to the haplotype read forwards, the part
right of it to the haplotype reversed (``align_seq_to_hap_short``,
:27-163): flank rows are a max-product M/I/D recurrence with base-quality
emissions and the transitions of Dindel; a repeat block is one row, each
column the log-sum over artifact sizes D in [-6, +6] of the block's
stutter prior for D (``log_prob_pcr_artifact`` of the default stutter
model 0.95, 0.05, 0.05, 0.95, 0.01, 0.01, hipstr_main.cpp:362-363), the
read's stretch aligned to the block with a D-base insertion or deletion
at each place (``StutterAlignerClass``, StutterAlignerClass.cpp:56-156)
and the row before the block where the stretch starts.  The read's score
marginalizes the seed over every flank position of the haplotype,
uniform prior (``compute_aln_logprob``, :165-233).  A read with no valid
seed scores 0 against every haplotype (:570-574).  Every log-sum drops the
terms more than log(0.001) below its largest, as ``fast_log_sum_exp``
does.

Precision: the artifact terms and the seed's marginalization are float64;
the rows run in ``score``'s ``rows``, float32 by default, as the
configuration runs them (the program's row DP is float32), in the order
the program's plain rows state, so the reference gives the program's
bits.  Upstream runs the rows in float64 (``rows=torch.float64``, held to
the JAX package's host mode B in the tests).  The check scores in
float32 because two genotypes can tie exactly under mode B (a sample's
reads of one haplotype split between two candidates in mirror image, one
base longer than the one and one shorter than the other, under the
model's equal up and down priors), and GB, Q and GLDIFF jump at a tie:
float64 rows keep the tie that float32 rows break by 1e-6, and GLDIFF
then differs by the gap to the third genotype.

Departures from the published description, each exact in real
arithmetic:

- An alignment's score at each place of its artifact is formed from the
  cumulative sums of the read's emissions, not by upstream's running
  update of one score from place to place; the places are visited and
  grouped as upstream's walk groups them (a run of places that give the
  same score is one term, ``log(run) + score``), because the dropping of
  small terms depends on that grouping.
- A deletion's stretch is always summed from the read's own emissions;
  upstream takes the difference of two prefix sums where the read is long
  enough.
- The insertion row (I) of a flank row is the closed form of its
  recurrence, one running maximum a row.
- Vectorized over reads and read columns; the artifact terms' sums run in
  another order than upstream's and differ from it in the last bits.

Only period-1 repeats take this route, and a haplotype must begin and end
with a flank block and hold no empty block; a locus outside that, or one
whose candidates do not match its block options one to one, is not scored
(None).  The transitions are Dindel's (the configurations run no
``--alignment-params``); a genotyper given other transitions is not scored.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMPOSSIBLE = -1000000000.0
LOG_THRESH = math.log(0.001)
MIN_SEED_DIST = 5
MAX_UNITS = 6                      # artifact sizes -6..+6 repeat units
# in_geom, in_up, in_down, out_geom, out_up, out_down
DEFAULT_STUTTER = (0.95, 0.05, 0.05, 0.95, 0.01, 0.01)
# Dindel's transitions as the program holds them (float32), in the order
# ins->ins, ins->match, del->del, del->match, match->match, match->ins,
# match->del
TRANSITIONS = np.array([-1.0, -0.458675, -1.0, -0.458675, -0.00005800168,
                        -10.448214728, -10.448214728],
                       dtype=np.float32).astype(np.float64)


def _quality_tables():
    """log P(correct) and log P(error) of each Phred+33 quality byte
    (base_quality.cpp: quality 0 is certain to be wrong; the error's
    exponent is divided by 5)."""
    correct, error = np.empty(42), np.empty(42)
    correct[0], error[0] = -100.0, 0.0
    for q in range(1, 42):
        correct[q] = math.log(1.0 - 10.0 ** (q / -10.0))
        error[q] = math.log(10.0 ** (q / (-10.0) / 5.0))
    return correct, error


LOG_CORRECT, LOG_ERROR = _quality_tables()


def stutter_log_pmf(size, artifact, period=1, model=DEFAULT_STUTTER):
    """log P(a read shows ``size + artifact`` bp of a ``size``-bp allele)
    (stutter_model.cpp:29-53)."""
    in_geom, in_up, in_down, out_geom, out_up, out_down = model
    if artifact > period * MAX_UNITS or artifact < -period * MAX_UNITS \
            or size + artifact < 0:
        return -10e6
    if artifact % period:
        eff = artifact - int(artifact / period)
        up, down, geom = out_up, out_down, out_geom
    else:
        eff = int(artifact / period)
        if eff == 0:
            return math.log(1 - in_up - in_down - out_up - out_down)
        up, down, geom = in_up, in_down, in_geom
    if eff < 0:
        return (math.log(down) + math.log(geom)
                + math.log(1 - geom) * (-eff - 1))
    return math.log(up) + math.log(geom) + math.log(1 - geom) * (eff - 1)


def seed_base(aln, repeats, hap_start, hap_end) -> int:
    """The read base the alignment is anchored at, or -1: of the read's
    ``=`` runs inside the haplotype, the base farthest (at least
    MIN_SEED_DIST) from both ends of its stretch of reference between
    repeats, the later one on a tie."""
    def best_in(lo, hi):
        best = (-1, -1)                     # (distance, position)
        pos = lo
        for r_lo, r_hi in repeats:
            if pos > hi:
                break
            if pos < r_lo:
                dist = 1 + (min(hi, r_lo - 1) - pos) // 2
                if dist >= best[0]:
                    best = (dist, dist - 1 + pos)
            pos = max(pos, r_hi)
        if pos <= hi:
            dist = 1 + (hi - pos) // 2
            if dist >= best[0]:
                best = (dist, dist - 1 + pos)
        return best

    pos, base, seed, need = aln.start, 0, -1, MIN_SEED_DIST
    for op, n in aln.cigar:
        if op == "=":
            lo, hi = max(pos, hap_start), min(pos + n - 1, hap_end - 1)
            if lo <= hi:
                dist, at = best_in(lo, hi)
                if dist >= need:
                    need, seed = dist, base + at - pos
            pos += n
            base += n
        elif op == "X":
            pos += n
            base += n
        elif op == "I":
            base += n
        elif op == "D":
            pos += n
        else:
            raise ValueError(f"CIGAR operation {op} in a trimmed read")
    if seed < -1 or seed == 0 or seed >= len(aln.sequence) - 1:
        return -1
    return seed


def _repeat_walk(text: str, artifact: int):
    """Upstream's walk over the places of an artifact in a period-1 block
    ``text`` (StutterAlignerClass.cpp), one tuple a step: the place m the
    step starts at, the place whose score its term takes, the term's log
    multiplicity, and the walk's place and scored place after the step.
    An insertion's place k puts the inserted bases after the block's last
    k bases; a deletion's place m matches the block's last m + 1 bases
    before the deleted ones, -1 none (the scores :func:`_align_block`
    indexes)."""
    n = len(text)
    d = abs(artifact)
    runs = np.zeros(n, dtype=np.int64)          # equal bases d back
    for x in range(d if artifact < 0 else 1, n):
        back = x - (d if artifact < 0 else 1)
        runs[x] = 0 if text[back] != text[x] else 1 + runs[x - 1]
    steps, m, cur = [], 0, (0 if artifact > 0 else -1)
    end = n if artifact > 0 else n - d
    while m < end:
        if artifact > 0 and m + 1 >= n:
            steps.append((m, cur, 0.0))
        else:
            um = int(runs[n - 1 - m])
            if um == 0:
                cur = m + 1 if artifact > 0 else m
                steps.append((m, cur, 0.0))
            else:
                steps.append((m, cur, math.log(um)))
                m += um - 1
        m += 1
        steps[-1] = steps[-1] + (m, cur)
    return steps


class _Segments:
    """One side's read segments, padded to a common width: bases, the
    log-probabilities of each base being right or wrong (float64, and in
    the rows' precision from the tables rounded to it), each column's sum
    of the preceding bases' log P(right) (summed in float64, in order),
    and each base's emission against every haplotype character shifted t
    columns (the t-th base left of a column; 0 past the first base)."""

    def __init__(self, segs, chars, rows, device):
        self.P = len(segs)
        lens = np.array([len(s) for s, _q in segs], np.int64)
        self.lens = torch.from_numpy(lens).to(device)
        L = self.L = max(1, int(lens.max()))
        codes = np.zeros((self.P, L), np.uint8)
        quals = np.zeros((self.P, L), np.int64)
        for p, (s, q) in enumerate(segs):
            codes[p, :len(s)] = np.frombuffer(s.encode(), np.uint8)
            quals[p, :len(q)] = np.clip(
                np.frombuffer(q.encode("latin1"), np.uint8).astype(np.int64)
                - 33, 0, 41)
        right = np.cumsum(LOG_CORRECT[quals]
                          * (np.arange(L) < lens[:, None]), axis=1)
        self.log_right = right[:, -1]                 # the segment's, f64
        prefix = np.zeros((self.P, L))
        prefix[:, 1:] = right[:, :-1]
        q = torch.from_numpy(quals).to(device)
        f64 = dict(dtype=torch.float64, device=device)
        self.codes = torch.from_numpy(codes).to(device)
        self.lc = torch.tensor(LOG_CORRECT, **f64)[q]
        self.lw = torch.tensor(LOG_ERROR, **f64)[q]
        self.lc_r = torch.tensor(LOG_CORRECT, dtype=rows, device=device)[q]
        self.lw_r = torch.tensor(LOG_ERROR, dtype=rows, device=device)[q]
        self.prefix = torch.from_numpy(prefix).to(dtype=rows, device=device)
        self.chars = {c: i for i, c in enumerate(sorted(chars))}
        self.rows, self.device = rows, device
        self.S = None

    def emit(self, c):
        """Emissions against ``c`` in the rows' precision."""
        return torch.where(self.codes == ord(c), self.lc_r, self.lw_r)

    def shifted(self, T):
        """(chars, T, P, L) float64 emissions, [c, t, p, j] that of read
        base j - t against character c."""
        if self.S is None or self.S.shape[1] < T:
            S = torch.zeros((len(self.chars), T, self.P, self.L),
                            dtype=torch.float64, device=self.device)
            for c, i in self.chars.items():
                e = torch.where(self.codes == ord(c), self.lc, self.lw)
                for t in range(min(T, self.L)):
                    S[i, t, :, t:] = e[:, :self.L - t]
            self.S = S
        return self.S

    def last(self, row):
        return row.gather(1, (self.lens - 1)[:, None])[:, 0]


def _lse(entries):
    """fast_log_sum_exp over the first axis: terms more than LOG_THRESH
    below the largest are dropped."""
    m = entries.amax(dim=0)
    diff = entries - m
    keep = torch.where(diff > LOG_THRESH, torch.exp(diff),
                       torch.zeros((), dtype=entries.dtype,
                                   device=entries.device))
    return m + torch.log(keep.sum(dim=0))


def _align_block(seg, text, artifact):
    """(P, L) log-probability of the read's stretch ending at each column
    against the period-1 block ``text`` with an artifact of ``artifact``
    bases, marginalized over its places
    (StutterAlignerClass::align_stutter_region_reverse); the stretch holds
    min(n + artifact, column + 1) bases, n + artifact >= 0."""
    n = len(text)
    L, dev, f64 = seg.L, seg.device, torch.float64
    width = torch.clamp(torch.arange(L, device=dev) + 1, max=n + artifact)
    S = seg.shifted(n + abs(artifact) + 1)
    ch = seg.chars
    at = lambda c, t: S[ch[c], t]                # (P, L)
    if artifact == 0:
        return sum(at(text[n - 1 - t], t) for t in range(n))
    if artifact < 0:
        d = -artifact
        prior = -math.log(n - d + 1)
        kept = [at(text[n - 1 - d - t], t) for t in range(n - d)]
        moved = [at(text[n - 1 - t], t) for t in range(n - d)]
        # score[m]: the block's last m + 1 bases matched before the
        # deleted ones; score[-1]: none
        base = prior + sum(kept, torch.zeros((seg.P, L), dtype=f64,
                                             device=dev))
        score = [base]
        for t in range(n - d):
            score.append(score[-1] + (moved[t] - kept[t]))
        score = torch.stack(score[1:] + [base])
        count, stop = n - d, width
    else:
        e = artifact
        prior = -math.log(n + 1)
        ins = sum(at(text[n - 1], t) for t in range(e))
        block = sum(at(text[n - 1 - (t - e)], t) for t in range(e, e + n))
        # score[k]: the inserted bases after the block's last k bases
        score = [prior + ins + torch.where(width > e, block, 0.0)]
        for k in range(n - 1):
            score.append(score[-1] + sum(
                at(text[n - 2 - k], t) - at(text[n - 1 - k], t)
                for t in range(k + 1, k + e + 1)))
        score = torch.stack(score)
        count, stop = n, torch.clamp(width - e, min=0, max=n)
    first = 0 if artifact > 0 else -1
    steps = _repeat_walk(text, artifact)
    NEG = torch.tensor(float("-inf"), dtype=f64, device=dev)
    terms = [score[first]]
    for m, cur, log_mult, _m_after, _cur_after in steps:
        terms.append(torch.where((m < stop)[None, :], score[cur] + log_mult,
                                 NEG))
    # where each column's walk stops, and one term for the places left
    walked = np.searchsorted(np.array([s[0] for s in steps], np.int64),
                             stop.cpu().numpy(), side="left")
    ends = np.array([(0, first)] + [s[3:] for s in steps], np.int64)[walked]
    left = count - ends[:, 0]
    idx = torch.from_numpy(ends[:, 1] % score.shape[0]).to(dev)
    tail = score.gather(0, idx[None, None, :].expand(1, seg.P, L))[0]
    log_left = torch.from_numpy(np.log(np.maximum(left, 1))).to(dev)
    terms.append(torch.where(torch.from_numpy(left > 0).to(dev)[None, :],
                             tail + log_left, NEG))
    return _lse(torch.stack(terms))


def _side_rows(seg, blocks, prior_of):
    """Each haplotype row's match score at each read's last column, the
    haplotype ``blocks`` [(text, is_repeat)] read left to right against
    the side's segments (align_seq_to_hap_short), in the rows' precision:
    a flank row from the row above, a repeat row from the row before the
    block and the block's artifact terms (float64, rounded to the rows'
    precision), the repeat's inner rows IMPOSSIBLE."""
    P, L, dev, dt = seg.P, seg.L, seg.device, seg.rows
    i2i, i2m, d2d, d2m, m2m, m2i, m2d = torch.tensor(
        TRANSITIONS, dtype=dt, device=dev).unbind(0)
    neg = torch.full((P, L), IMPOSSIBLE, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    thresh = torch.tensor(LOG_THRESH, dtype=dt, device=dev)
    prefix = seg.prefix
    jj = torch.arange(L, dtype=dt, device=dev)
    cols_j = torch.arange(L, device=dev)
    M = seg.emit(blocks[0][0][0]) + prefix
    D = neg
    cols = [seg.last(M)]
    after_repeat = False
    for bi, (text, is_repeat) in enumerate(blocks):
        if is_repeat:
            n = len(text)
            terms = []
            for artifact in range(-MAX_UNITS, MAX_UNITS + 1):
                if n + artifact < 0:
                    terms.append(neg)
                    continue
                table = (prior_of(n, artifact)
                         + _align_block(seg, text, artifact)).to(dt)
                # the row before the block, where the stretch starts
                src = cols_j - torch.clamp(cols_j + 1, max=n + artifact)
                before = torch.where((src >= 0)[None, :],
                                     M.gather(1, src.clamp(min=0)[None, :]
                                              .expand(P, L)), zero)
                terms.append(table + before)
            m = torch.stack(terms).amax(dim=0)
            acc = torch.zeros((P, L), dtype=dt, device=dev)
            for t in terms:
                diff = t - m
                acc = acc + torch.where(diff > thresh, torch.exp(diff), zero)
            cols += [seg.last(neg)] * (n - 1)
            M, D = m + torch.log(acc), neg
            cols.append(seg.last(M))
            after_repeat = True
            continue
        for c in text[1 if bi == 0 else 0:]:
            emit = seg.emit(c)
            if after_repeat:
                M = torch.cat([emit[:, :1], emit[:, 1:] + M[:, :-1]], dim=1)
                D = neg
                after_repeat = False
            else:
                src = torch.cat([torch.zeros((P, 1), dtype=dt, device=dev),
                                 M[:, :-1] + i2m], dim=1)
                run = torch.cummax(src - prefix - jj * i2i, dim=1).values
                I = seg.lc_r + prefix + jj * i2i + run
                I[:, 0] = seg.lc_r[:, 0]
                M_new = torch.cat([emit[:, :1], emit[:, 1:] + torch.maximum(
                    I[:, :-1] + m2i, torch.maximum(M[:, :-1] + m2m,
                                                   D[:, :-1] + m2d))], dim=1)
                D = torch.cat([torch.maximum(D[:, :1] + d2d, M[:, :1] + d2m),
                               torch.maximum(M[:, 1:] + d2m,
                                             D[:, 1:] + d2d)], dim=1)
                M = M_new
            cols.append(seg.last(M))
    return torch.stack(cols, dim=1).double().cpu().numpy()


def _lse_in_order(terms):
    """fast_log_sum_exp of each column of ``terms`` (a list of float64
    arrays), the kept terms added in the list's order."""
    m = np.max(terms, axis=0)
    total = np.zeros_like(m)
    for t in terms:
        d = t - m
        total = total + np.where(d > LOG_THRESH, np.exp(d), 0.0)
    return m + np.log(total)


def _structure(gt, seqs):
    """(blocks [(start, end, options, is_repeat)], configs in ``seqs``'s
    order) of a locus's haplotype, or None where the reference cannot
    score it."""
    if getattr(gt, "alignment_params", None):
        return None
    blocks = []
    for b in gt.haplotype.blocks:
        rep = b.repeat_info is not None
        if rep and b.period != 1:
            return None
        blocks.append((b.start, b.end, list(b.seqs), rep))
    if blocks[0][3] or blocks[-1][3] or not any(b[3] for b in blocks) \
            or any(len(o) == 0 for b in blocks for o in b[2]) \
            or len(blocks[0][2][0]) < 2 or len(blocks[-1][2][0]) < 2:
        return None
    by_seq = {}
    configs = [()]
    for b in blocks:
        configs = [c + (o,) for c in configs for o in range(len(b[2]))]
    for config in configs:
        s = "".join(b[2][o] for b, o in zip(blocks, config))
        by_seq[s] = None if s in by_seq else config
    configs = [by_seq.get(s) for s in seqs]
    if None in configs or len(set(seqs)) != len(seqs):
        return None
    return blocks, configs


def score(gt, seqs, device, rows=torch.float32, model=DEFAULT_STUTTER):
    """(pools, candidate haplotypes ``seqs``) mode-B log-likelihoods of one
    locus, float64 numpy, or None where it cannot be scored: the pooled
    reads of ``gt.pooler`` (as the program pooled them) against the
    candidates, split as ``gt.haplotype``'s blocks split them.  ``rows``
    is the precision of the row recurrence (float32, as the configuration
    runs it; float64 as upstream does; bfloat16 the control); the artifact
    terms and the seed's marginalization are float64.  ``model``: the
    stutter model's six parameters."""
    found = _structure(gt, seqs)
    if found is None:
        return None
    blocks, configs = found
    pools = gt.pooler.pooled_alns
    repeats = [(b[0], b[1]) for b in blocks if b[3]]
    seeds = [seed_base(a, repeats, blocks[0][0], blocks[-1][1])
             for a in pools]
    out = np.zeros((len(pools), len(seqs)))
    live = [p for p, s in enumerate(seeds) if s >= 0]
    if not live:
        return out
    chars = {c for b in blocks for o in b[2] for c in o}
    left = _Segments([(pools[p].sequence[:seeds[p]],
                       pools[p].base_qualities[:seeds[p]]) for p in live],
                     chars, rows, device)
    right = _Segments([(pools[p].sequence[seeds[p] + 1:][::-1],
                        pools[p].base_qualities[seeds[p] + 1:][::-1])
                       for p in live], chars, rows, device)
    longest = max(len(o) for b in blocks if b[3] for o in b[2])
    for seg in (left, right):
        seg.shifted(longest + MAX_UNITS + 1)
    prior_memo = {}

    def prior_of(n, artifact):
        key = (n, artifact)
        if key not in prior_memo:
            prior_memo[key] = stutter_log_pmf(n, artifact, 1, model)
        return prior_memo[key]

    seed_prior = -math.log(sum(len(b[2][0]) for b in blocks if not b[3]))
    seed_char = np.array([pools[p].sequence[seeds[p]] for p in live])
    q = np.array([min(max(ord(pools[p].base_qualities[seeds[p]]) - 33, 0), 41)
                  for p in live])
    for k, config in enumerate(configs):
        fw = [(b[2][o], b[3]) for b, o in zip(blocks, config)]
        rv = [(t[::-1], rep) for t, rep in reversed(fw)]
        hap = "".join(t for t, _r in fw)
        H = len(hap)
        lM = _side_rows(left, fw, prior_of)
        rM = _side_rows(right, rv, prior_of)

        def seed_term(c):
            return seed_prior + np.where(seed_char == c, LOG_CORRECT[q],
                                         LOG_ERROR[q])

        terms = [seed_term(hap[0]) + left.log_right + rM[:, H - 2],
                 seed_term(hap[-1]) + right.log_right + lM[:, H - 2]]
        pos = 0
        for text, rep in fw:
            for c_i, c in enumerate(text):
                p = pos + c_i
                if not rep and 0 < p < H - 1:
                    terms.append(seed_term(c) + lM[:, p - 1] + rM[:, H - p - 2])
            pos += len(text)
        out[live, k] = _lse_in_order(terms)
    return out
