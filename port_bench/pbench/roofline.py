"""Peaks of the card and the operations and bytes of each kernel call.

Frozen copies of ``chip_smoke.py``'s ``bound`` and ``pairhmm_bound``,
with the bytes counted from the real lengths a call receives (never the padded widths), so the yardstick reads
the same work whatever implements it and however a later change pads.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Float operations a DP cell of the pair-HMM needs (chip_smoke.py).
PAIRHMM_OPS_PER_CELL = 21


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds the card could take: the larger of the operations over
    the peak rate and the bytes over the memory bandwidth."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def pairhmm_call(hap_lens, read_lens, full_lens) -> tuple[float, float]:
    """(operations, bytes) of one padded pair-HMM batch.  Padding rows
    (length 1, full length 1) are no pairs.  A pair the DP runs on (full
    haplotype above 60 bases, lengths within 600 of each other) needs 21
    operations a cell; every real pair reads its bases and three int32
    lengths once and writes one float32 score, and the seven transitions
    are read once."""
    hl = np.asarray(hap_lens, dtype=np.int64)
    rl = np.asarray(read_lens, dtype=np.int64)
    fl = np.asarray(full_lens, dtype=np.int64)
    real = ~((hl <= 1) & (rl <= 1) & (fl <= 1))
    live = real & (fl > 60) & (np.abs(hl - rl) <= 600)
    ops = PAIRHMM_OPS_PER_CELL * float((hl[live] * rl[live]).sum())
    nbytes = float((hl[real] + rl[real]).sum() + 16 * int(real.sum()) + 28)
    return ops, nbytes


def pairhmm_window(lengths) -> float:
    """Summed bound seconds of a window's pair-HMM calls, from each call's
    (hap, read, full) lengths."""
    return sum(bound_s(*pairhmm_call(*ls)) for ls in lengths)
