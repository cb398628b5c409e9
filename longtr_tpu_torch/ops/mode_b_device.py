"""Mode-B flank scoring on the device: the row DP of the stutter HMM.

Port of :mod:`longtr_tpu.ops.mode_b_device`.  Reference:
``HapAligner::align_seq_to_hap_short`` (HapAligner.cpp:27-163).

The host (:mod:`longtr_tpu_torch.pipeline.mode_b`) precomputes, per element
b (one read segment × haplotype config × side), the per-row char code, row
kind and stutter ordinal, and a dense artifact table ``A[b, s, d, j]``; the
device runs the whole row DP and returns, per row, the match score at the
element's last column.  Row kinds:

  0 flank row            — M/I/D recurrence (HapAligner.cpp:120-158)
  1 flank after stutter  — match-only recurrence (:132-141); D IMPOSSIBLE
  2 stutter row          — artifact-size LSE (:75-113); D IMPOSSIBLE
  3 skip / padding       — carry M, D through (repeat-block interior rows)

:func:`mode_b_cols_plain` is the plain version: a Python loop over rows of
torch ops, every expression in the JAX package's association order, so in
float64 on the CPU it gives the bits of the JAX scan and of the host numpy
path.  It is the reference of the CUDA kernel
(:mod:`longtr_tpu_torch.ops.mode_b_cuda`), which gives its float32 bits on
a card.  :func:`mode_b_cols` routes a call by where its tensors lie.
"""

from __future__ import annotations

import torch

from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.utils.mathops import LOG_THRESH

# Elements (read segment × config × side, padding included) scored per
# route: "cuda" and "cpu" by mode_b_cols, "host_f64" by the host numpy path
# (pipeline/seq_genotyper.py).  chip_smoke.py reads these.
mode_b_elements_scored = {"cuda": 0, "cpu": 0, "host_f64": 0}


def mode_b_cols_plain(codes, quals, lw_tab, lc_tab, prefix, last, hapchar,
                      kind, stut_ord, A, bl, d0, dstep, params, *, n_d):
    """Last-column match vectors for a batch of mode-B alignments.

    codes/quals: (B, L) uint8 read base codes and quality bytes; the
      per-base log-wrong/correct values are gathered from the 256-entry
      lw_tab/lc_tab.
    prefix: (B, L) sequential prefix [0, cumsum(blc)[:-1]].
    last: (B,) index of the final valid column.
    hapchar/kind/stut_ord: (B, R) uint8 per-row char code, row kind,
      stutter ordinal (which slice of ``A`` a kind-2 row uses).
    A: (B, S, n_d, L) artifact scores (IMPOSSIBLE where base_len < 0, -inf
      in d-padding).
    bl/d0/dstep: (B, S) int32 repeat-block length, first artifact size and
      artifact stride per stutter ordinal.
    params: (7,) [i2i, i2m, d2d, d2m, m2m, m2i, m2d].

    Returns (B, R) M[row, last] in the dtype of the tables (float32 or
    float64), on the inputs' device.
    """
    B, L = codes.shape
    R = hapchar.shape[1]
    dev = codes.device
    dt = lc_tab.dtype
    codes = codes.long()
    hapchar = hapchar.long()
    kind = kind.long()
    stut_ord = stut_ord.long()
    qi = quals.long()
    blw = lw_tab[qi]
    blc = lc_tab[qi]
    i2i, i2m, d2d, d2m, m2m, m2i, m2d = params.to(dt).unbind(0)
    jj = torch.arange(L, dtype=dt, device=dev)
    jcol = torch.arange(L, device=dev)
    neg_row = torch.full((B, L), IMPOSSIBLE, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    thresh = torch.tensor(LOG_THRESH, dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    last_i = last.long()[:, None]
    d_off = torch.arange(n_d, device=dev)[None, :, None]

    M_prev = torch.where(codes == hapchar[:, :1], blc, blw) + prefix
    D_prev = neg_row
    cols = [M_prev.gather(1, last_i)[:, 0]]
    for r in range(1, R):
        emit = torch.where(codes == hapchar[:, r:r + 1], blc, blw)

        # kind 0: full flank recurrence.  I[h, j] in closed form: src[0] =
        # 0, src[j>=1] = M[h-1, j-1] + i2m; run = cummax(src - prefix - j*i2i)
        d_col0 = torch.maximum(D_prev[:, 0] + d2d, M_prev[:, 0] + d2m)
        src = torch.cat([torch.zeros((B, 1), dtype=dt, device=dev),
                         M_prev[:, :-1] + i2m], dim=1)
        run = torch.cummax(src - prefix - jj * i2i, dim=1).values
        I = blc + prefix + jj * i2i + run
        I[:, 0] = blc[:, 0]
        M_fl = torch.cat(
            [emit[:, :1],
             emit[:, 1:] + torch.maximum(
                 I[:, :-1] + m2i,
                 torch.maximum(M_prev[:, :-1] + m2m, D_prev[:, :-1] + m2d))],
            dim=1)
        D_fl = torch.cat(
            [d_col0[:, None],
             torch.maximum(M_prev[:, 1:] + d2m, D_prev[:, 1:] + d2d)], dim=1)

        # kind 1: match-only row after a stutter block
        M_as = torch.cat([emit[:, :1], emit[:, 1:] + M_prev[:, :-1]], dim=1)

        # kind 2: stutter row, the artifact sizes summed in d order with
        # fast_lse's term dropping
        sord = stut_ord[:, r]
        A_r = A[rows, sord]                                       # (B, nD, L)
        bl_r = bl[rows, sord].long()[:, None, None]
        dv = d0[rows, sord].long()[:, None, None] \
            + d_off * dstep[rows, sord].long()[:, None, None]     # (B, nD, 1)
        idx = jcol[None, None, :] - bl_r - dv                     # (B, nD, L)
        ok = (idx >= 0) & (idx <= jcol[None, None, :])
        gathered = M_prev[:, None, :].expand(B, n_d, L).gather(
            2, idx.clamp(0, L - 1))
        terms = A_r + torch.where(ok, gathered, zero)
        m = terms.amax(dim=1)                                     # (B, L)
        acc = torch.zeros((B, L), dtype=dt, device=dev)
        for d in range(n_d):
            diff = terms[:, d] - m
            acc = acc + torch.where(diff > thresh, torch.exp(diff), zero)
        M_st = m + torch.log(acc)

        k = kind[:, r:r + 1]
        M_new = torch.where(k == 0, M_fl,
                            torch.where(k == 1, M_as,
                                        torch.where(k == 2, M_st, M_prev)))
        D_new = torch.where(k == 0, D_fl, torch.where(k == 3, D_prev, neg_row))
        M_prev, D_prev = M_new, D_new
        cols.append(M_prev.gather(1, last_i)[:, 0])
    return torch.stack(cols, dim=1)


def mode_b_cols(codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
                stut_ord, A, bl, d0, dstep, params, *, n_d):
    """Route a batch by where it lies: CPU tensors take the plain version,
    float32 CUDA tensors the CUDA kernel; float64 on a card raises (the
    kernel is float32, and no card tensor is sent to the plain version)."""
    B = codes.shape[0]
    if codes.device.type == "cpu":
        mode_b_elements_scored["cpu"] += B
        return mode_b_cols_plain(codes, quals, lw_tab, lc_tab, prefix, last,
                                 hapchar, kind, stut_ord, A, bl, d0, dstep,
                                 params, n_d=n_d)
    if lc_tab.dtype != torch.float32:
        raise ValueError(f"mode_b_cols on {codes.device} takes float32 "
                         f"tables, got {lc_tab.dtype}")
    from longtr_tpu_torch.ops import mode_b_cuda
    mode_b_elements_scored["cuda"] += B
    return mode_b_cuda.mode_b_cols(codes, quals, lw_tab, lc_tab, prefix, last,
                                   hapchar, kind, stut_ord, A, bl, d0, dstep,
                                   params, n_d=n_d)


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)
