"""Mode-A pair-HMM: the max-product M/I/D scan, one row of torch ops per
haplotype position, every value built from float adds, integer-valued
products and max in one fixed order (the D row as a decayed running max,
one ``cummax`` a row).  ``dtype`` is the precision the whole scan runs in:
float32 is what the program states; bfloat16 is the control.
"""

from __future__ import annotations

import numpy as np
import torch

IMPOSSIBLE = -1000000000.0
MATCH_EMIT = -0.000100005
MISMATCH_EMIT = -9.0
BAND_FAIL_SCORE = -700.0
BAND_THRESH = -600.0
LEN_DIFF_LIMIT = 600
MIN_FULL_HAP_LEN = 60

# Dindel transition log-probabilities (ins->ins, ins->match, del->del,
# del->match, match->match, match->ins, match->del), the defaults of a run
# without --alignment-params.
DEFAULT_TRANSITIONS = np.array([-1.0, -0.458675, -1.0, -0.458675,
                                -0.00005800168, -10.448214728,
                                -10.448214728], dtype=np.float32)


def scan(hap, hap_len, read, read_len, full_hap_len, trans=None,
         dtype=torch.float32):
    """(B,) scores of a padded batch: hap (B, N) and read (B, M) uint8
    codes, the three (B,) lengths, trans (7,) (default
    ``DEFAULT_TRANSITIONS``)."""
    trans = torch.as_tensor(DEFAULT_TRANSITIONS if trans is None else trans)
    B, Mdim = read.shape
    n_max = hap.shape[1]
    dev = read.device
    f = dtype
    i2i, i2m, d2d, d2m, m2m, m2i, m2d = trans.to(dev).to(f).unbind(0)
    MA = torch.tensor(MATCH_EMIT, dtype=f, device=dev)
    MI = torch.tensor(MISMATCH_EMIT, dtype=f, device=dev)
    NEG = torch.tensor(IMPOSSIBLE, dtype=f, device=dev)

    j_idx = torch.arange(Mdim, device=dev)[None, :]
    jf = j_idx.to(f)
    n = hap_len.to(device=dev, dtype=torch.int64)[:, None]
    m = read_len.to(device=dev, dtype=torch.int64)[:, None]
    fl = full_hap_len.to(device=dev, dtype=torch.int64)
    valid_j = j_idx < m

    r0 = read[:, 0:1]
    hap_m = (hap[:, :Mdim] if n_max >= Mdim
             else torch.nn.functional.pad(hap, (0, Mdim - n_max)))
    emit_row0 = torch.where(hap_m == r0, MA, MI)
    Dk = torch.where(j_idx >= 1, m2d + (jf - 1) * d2d, NEG)
    M0 = torch.where(j_idx == 0, torch.where(hap[:, 0:1] == r0, MA, MI),
                     torch.roll(Dk, 1, dims=-1) + d2m + emit_row0)
    Mp = torch.where(valid_j, M0, NEG)
    Ip = torch.full((B, Mdim), IMPOSSIBLE, dtype=f, device=dev)
    Dp = torch.where(valid_j, Dk, NEG)

    col0_read = torch.where(m[:, 0] > 1, read[:, min(1, Mdim - 1)], read[:, 0])
    col0_emit = torch.where(hap[:, 0] == col0_read, MA, MI)
    corner_j = torch.clamp(m - 1, 0, Mdim - 1)

    def take_corner(row):
        return row.gather(1, corner_j)[:, 0]

    corner0 = torch.maximum(torch.maximum(take_corner(Mp), take_corner(Ip)),
                            take_corner(Dp))
    out = torch.where(n[:, 0] == 1, corner0, NEG)
    bandfail = torch.zeros(B, dtype=torch.bool, device=dev)
    neg_col = torch.full((B, 1), IMPOSSIBLE, dtype=f, device=dev)
    band_mask = (j_idx >= 1) & (j_idx <= m - 1)

    def shift(x):
        return torch.cat([neg_col, x[:, :-1]], dim=1)

    last_row = min(n_max, int(hap_len.max()) if B else 0)
    for i in range(1, last_row):
        emit = torch.where(hap[:, i:i + 1] == read, MA, MI)
        Mn = emit + torch.maximum(torch.maximum(shift(Mp) + m2m,
                                                shift(Dp) + d2m),
                                  shift(Ip) + i2m)
        In = MA + torch.maximum(Mp + m2i, Ip + i2i)
        Mn[:, 0] = Ip[:, 0] + i2m + col0_emit
        In[:, 0] = MA + m2i + float(i - 1) * i2i
        c = Mn + m2d - (jf + 1) * d2d
        cmax = torch.cummax(c, dim=1).values
        Dn = torch.cat([neg_col, jf[:, 1:] * d2d + cmax[:, :-1]], dim=1)
        Mn = torch.where(valid_j, Mn, NEG)
        In = torch.where(valid_j, In, NEG)
        Dn = torch.where(valid_j, Dn, NEG)
        best = torch.maximum(torch.maximum(Mn, In), Dn)
        band = ((n - m) - (i - j_idx)).abs().to(f) * d2d
        row_best = torch.where(band_mask, best + band, NEG).amax(dim=1)
        row_active = i <= n[:, 0] - 1
        bandfail |= row_active & (row_best < BAND_THRESH)
        out = torch.where(i == n[:, 0] - 1, take_corner(best), out)
        keep = row_active[:, None]
        Mp = torch.where(keep, Mn, Mp)
        Ip = torch.where(keep, In, Ip)
        Dp = torch.where(keep, Dn, Dp)

    score = torch.where(bandfail, BAND_FAIL_SCORE, out)
    score = torch.where((n[:, 0] - m[:, 0]).abs() > LEN_DIFF_LIMIT,
                        BAND_FAIL_SCORE, score)
    return torch.where(fl <= MIN_FULL_HAP_LEN, NEG, score)


def pack(pairs, width_step=64):
    """Padded (hap, hap_len, read, read_len, full_len) numpy arrays of a
    list of (hap, read, full_len) string triplets."""
    B = len(pairs)
    step = lambda n: max(width_step, -(-n // width_step) * width_step)
    N = step(max((len(h) for h, _r, _f in pairs), default=1))
    M = step(max((len(r) for _h, r, _f in pairs), default=1))
    hap = np.zeros((B, N), np.uint8)
    read = np.zeros((B, M), np.uint8)
    hl = np.zeros(B, np.int32)
    rl = np.zeros(B, np.int32)
    fl = np.zeros(B, np.int32)
    for i, (h, r, f) in enumerate(pairs):
        hap[i, :len(h)] = np.frombuffer(h.encode(), np.uint8)
        read[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
        hl[i], rl[i], fl[i] = len(h), len(r), f
    return hap, hl, read, rl, fl


def score_arrays(arrs, device, trans=None, dtype=torch.float32,
                 rows_per_batch=4096):
    """float64 numpy scores of a packed batch under the transitions
    ``trans`` (7,), scored on ``device`` in batches of ``rows_per_batch``
    rows grouped by length."""
    hap, hl, read, rl, fl = arrs
    out = np.empty(len(hl))
    order = np.argsort(np.maximum(hl, rl), kind="stable")
    for lo in range(0, len(order), rows_per_batch):
        sel = order[lo:lo + rows_per_batch]
        N = max(int(hl[sel].max()), 1)
        M = max(int(rl[sel].max()), 1)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
             (hap[sel, :N], hl[sel], read[sel, :M], rl[sel], fl[sel])]
        out[sel] = scan(*t, trans=trans, dtype=dtype).double().cpu().numpy()
    return out
