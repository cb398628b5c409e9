"""Mode-B artifact tables: the plain PyTorch version.

Port of the host table code of :mod:`longtr_tpu.pipeline.mode_b` (longtr_tpu's
``_artifact_table_batch`` over its ``StutterAligner.load_read_batch``,
``align_all_batch`` and ``fast_lse_cols``), the table ``A`` that the mode-B row
DP reads in its stutter rows (HapAligner.cpp:75-113,
StutterAlignerClass.cpp:12-100). For one table (side, repeat block, allele
option) and one read segment, ``A[d, j]`` is the artifact prior of size ``D =
d_first + d * period`` plus the log-sum over the artifact's positions of the
segment's prefix ``[0, j]`` aligned through the block.

Inputs (the host computes only what needs no per-read work):

- ``seg_codes``, ``seg_quals`` (2, P, Lp) uint8: each side's read
  segments, reversed (longtr_tpu's ``encode_segs_batch``), base bytes
  and quality bytes; ``seg_len`` (2, P) int32 their lengths.
- ``lw64``, ``lc64`` (256,) float64: log P(error) and log P(correct) by
  quality byte.
- ``tdesc`` (T, 9) int32, one row a table (:data:`DESC_FIELDS`): side,
  block length, period, first artifact size, artifact sizes, the
  aligner's deletion and insertion multiples, and offsets into
  ``blk_bytes`` (each block's bytes, reversed) and ``upstream`` (the
  aligner's upstream-match arrays, one a deletion multiple or one if
  none, each block-length long).
- ``priors`` (T, n_d) float64: ``log_prob_pcr_artifact(option, D)``.
- ``int_log`` (N,) float64: ``int_log(n)`` for n < N.

Output: (T * P, n_d, Lp), table t of segment p at row ``t * P + p``:
IMPOSSIBLE where ``block_len + D < 0``, -inf in d-padding and past a
segment's end, in the requested dtype (computed in float64 and cast).

Every operation runs in numpy's order, so on the CPU the tables equal the
host's bit for bit.  The CUDA kernels of ``csrc/mode_b_artifacts.cu``
compute the same tables on a card; their float64 ``exp``/``log`` may differ
from the host's in the last bit, which the float32 tables the row DP reads
almost never show.
"""

from __future__ import annotations

import torch

from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.utils.mathops import LOG_THRESH

DESC_FIELDS = ("side", "block_len", "period", "d_first", "n_dl", "n_del",
               "n_ins", "blk_off", "up_off")


def prefix_doubles(n_d: int) -> int:
    """Prefix sums a segment offset holds (match, deletion and insertion
    snapshots), at most: ``1 + max(n_del, 1) + max(n_ins, 1)`` is at most
    ``n_d + 2`` for every table whose artifact sizes span its multiples."""
    return n_d + 2


def _lse_cols(entries):
    """``fast_lse_cols``: the max first, then a sequential sum in entry
    order, terms at or below LOG_THRESH dropped; ``m`` where not finite."""
    E = torch.stack(entries)
    m = E.max(dim=0).values
    total = torch.zeros_like(m)
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    for row in E:
        d = row - m
        total = total + torch.where(d > LOG_THRESH, torch.exp(d), zero)
    out = m + torch.log(total)
    return torch.where(torch.isfinite(m), out, m)


def _prefix_tables(seqv, lcv, lwv, Ls, blk, period, n_del, n_ins):
    """longtr_tpu's ``load_read_batch``: per offset, the match prefix over
    the block, its deletion snapshots and the insertion prefixes."""
    P, Lp = seqv.shape
    dt, dev = lcv.dtype, lcv.device
    iv = torch.arange(Lp, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def score_at(j, ch):
        mask = iv + j < Ls
        rr = torch.clamp(torch.minimum(iv + j, Ls - 1), 0, Lp - 1)
        lcg = lcv.gather(1, rr)
        if ch is None:
            return mask, lcg
        return mask, torch.where(seqv.gather(1, rr) == ch, lcg,
                                 lwv.gather(1, rr))

    dels = (torch.zeros((P, Lp, max(n_del, 1)), dtype=dt, device=dev)
            if n_del else None)
    run = torch.zeros((P, Lp), dtype=dt, device=dev)
    di = 0
    for j in range(len(blk)):
        mask, s = score_at(j, blk[j])
        run = run + torch.where(mask, s, zero)
        if (j + 1) % period == 0 and j < period * n_del \
                and di < max(n_del, 1) and dels is not None:
            dels[:, :, di] = torch.where(mask, run, dels[:, :, di])
            di += 1
    match = run.clone()
    ins = torch.zeros((P, Lp, max(n_ins, 1)), dtype=dt, device=dev)
    run_ins = torch.zeros((P, Lp), dtype=dt, device=dev)
    ii = 0
    for j in range(period * n_ins):
        ch = blk[j % period] if j % period < len(blk) else None
        mask, s = score_at(j, ch)
        run_ins = run_ins + torch.where(mask, s, zero)
        if (j + 1) % period == 0:
            ins[:, :, ii] = run_ins
            ii += 1
    return match, dels, ins


def _align_all(D, seqv, lcv, lwv, Ls, blk, period, upstream, il,
               match, dels, ins):
    """longtr_tpu's ``align_all_batch``: (P, Lp) align() values for
    artifact size D, one shared masked descent for every column of every
    segment."""
    P, Lp = seqv.shape
    dt, dev = lcv.dtype, lcv.device
    blk_len = len(blk)
    iv = torch.arange(Lp, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=dt, device=dev)

    def gather(tbl, idx):
        return tbl.gather(1, torch.clamp(idx, 0, Lp - 1))

    def bscore(r, blk_idx):
        rc = torch.clamp(r, 0, Lp - 1)
        return torch.where(seqv.gather(1, rc) == blk[blk_idx],
                           lcv.gather(1, rc), lwv.gather(1, rc))

    offsets = Ls - 1 - iv
    valid = iv < Ls
    if D == 0:
        return gather(match, offsets)
    offc = torch.clamp(offsets, 0, Lp - 1)
    base_len = torch.minimum(torch.full_like(offsets, blk_len + D),
                             iv + 1).expand(P, Lp)
    if D > 0:
        up = upstream[0]
        log_prior = -il[blk_len + 1]
        lp = log_prior + gather(ins[:, :, D // period - 1], offc)
        lp = lp + torch.where(base_len > D, gather(match, offsets + D), zero)
        lim = -torch.clamp(torch.clamp(base_len - D, min=0), max=blk_len)
    else:
        up = upstream[-D // period - 1]
        log_prior = -il[blk_len + D + 1]
        od = offsets + D
        neg = valid & (od < 0)
        main_lp = log_prior + (gather(match, od)
                               - gather(dels[:, :, -D // period - 1], od))
        if bool(neg.any()):
            else_lp = torch.full((P, Lp), log_prior, dtype=dt, device=dev)
            for t in range(int(base_len[neg].max())):
                rr = torch.clamp(offsets + t, 0, Lp - 1)
                s = torch.where(blk[t - D] == seqv.gather(1, rr),
                                lcv.gather(1, rr), lwv.gather(1, rr))
                else_lp = else_lp + torch.where(t < base_len, s, zero)
            lp = torch.where(neg, else_lp, main_lp)
        else:
            lp = main_lp
        lim = -base_len

    entries = [torch.where(valid, lp, neg_inf)]
    tail = torch.full((P, Lp), float("-inf"), dtype=dt, device=dev)
    lim_min = int(torch.where(valid, lim, 0).min())
    t_base = blk_len if D > 0 else blk_len + D

    def capture_exit(old_i, new_i, tail):
        ok = valid & (old_i > lim) & (new_i <= lim)
        if new_i <= -t_base or not bool(ok.any()):
            return tail
        return torch.where(ok, il[t_base + new_i] + lp, tail)

    if bool((lim >= 0).any()):
        tail = capture_exit(1, 0, tail)
    i = 0
    while i > lim_min and i > (-blk_len if D > 0 else lim_min - 1):
        act = valid & (i > lim)
        if D > 0 and not (-i + period < blk_len):
            entries.append(torch.where(act, lp, neg_inf))
            old_i, i = i, i - 1
            tail = capture_exit(old_i, i, tail)
            continue
        um = up[blk_len - 1 + i]
        if um == 0:
            if D > 0:
                idx = i - period
                while idx >= i - D:
                    r = offsets - idx
                    lp = lp - bscore(r, -i)
                    lp = lp + bscore(r, -(i - period))
                    idx -= period
            else:
                r = offsets - i
                lp = lp - bscore(r, -(i + D))
                lp = lp + bscore(r, -i)
            entries.append(torch.where(act, lp, neg_inf))
            old_i, i = i, i - 1
        else:
            entries.append(torch.where(act, il[um] + lp, neg_inf))
            old_i, i = i, i - (um - 1) - 1
        tail = capture_exit(old_i, i, tail)
    entries.append(tail)
    return _lse_cols(entries)


def mode_b_artifacts_plain(seg_codes, seg_quals, seg_len, lw64, lc64, tdesc,
                           blk_bytes, upstream, priors, int_log, *, n_d,
                           dtype=torch.float32):
    """(T * P, n_d, Lp) artifact tables; arguments as the module says."""
    _, P, Lp = seg_codes.shape
    dev = seg_codes.device
    f64 = torch.float64
    T = tdesc.shape[0]
    il = int_log.tolist()
    blk_all = blk_bytes.tolist()
    up_all = upstream.tolist()
    pri = priors.tolist()
    out = torch.full((T, P, n_d, Lp), float("-inf"), dtype=f64, device=dev)
    iv = torch.arange(Lp, device=dev)
    for t, row in enumerate(tdesc.tolist()):
        (side, blk_len, period, d_first, n_dl, n_del, n_ins, blk_off,
         up_off) = row
        seqv = seg_codes[side].long()
        qv = seg_quals[side].long()
        lwv, lcv = lw64[qv], lc64[qv]
        Ls = seg_len[side].long()[:, None]
        blk = blk_all[blk_off:blk_off + blk_len]
        upstream_t = [up_all[up_off + k * blk_len:up_off + (k + 1) * blk_len]
                      for k in range(max(n_del, 1))]
        match, dels, ins = _prefix_tables(seqv, lcv, lwv, Ls, blk, period,
                                          n_del, n_ins)
        valid = iv < Ls
        for di in range(n_dl):
            D = d_first + di * period
            col = torch.where(valid, IMPOSSIBLE, out[t, :, di])
            if blk_len + D >= 0:
                tbl = _align_all(D, seqv, lcv, lwv, Ls, blk, period,
                                 upstream_t, il, match, dels, ins)
                col = torch.where(valid, pri[t][di] + tbl, col)
            out[t, :, di] = col
    return out.reshape(T * P, n_d, Lp).to(dtype)
