"""Batched pair-HMM (mode A) for read-vs-haplotype scoring, in PyTorch.

Port of :mod:`longtr_tpu.ops.pairhmm`.  Reference semantics:
``HapAligner::align_seq_to_hap`` (src/SeqAlignment/HapAligner.cpp:236-343),
a 3-matrix (M/I/D) max-product DP over (haplotype position i, read
position j) with

* fixed float emissions  MATCH = -0.000100005, MISMATCH = -9.0,
* 7 log transition parameters (Dindel defaults, HapAligner.h:118),
* shortcut |n-m| > 600  ->  -700,
* haplotype (untrimmed) length <= 60 -> -1e9,
* per-row band abort: if max_j(best(i,j) + |(n-m)-(i-j)|*del2del) < -600 for
  any row i>=1 the score is -700,
* result = max(M, I, D) at the (n-1, m-1) corner.

Row i of M and I depends only on row i-1; the D row is a decayed running
max along j: with c[k] = (M[i,k] + m2d) - (k+1)*d2d,
D[i,j] = j*d2d + max_{k<=j-1} c[k].  :func:`pairhmm_scan` computes that as
one ``torch.cummax`` per row.  It is the plain version of the two CUDA
kernels in :mod:`longtr_tpu_torch.ops.pairhmm_cuda`: both give the same
float32 bits, and so does the native C++ scorer
(``longtr_tpu.native.pairhmm_batch_native``).  Bit identity holds because
every value is built from float32 adds, integer-valued products and max,
evaluated in one fixed order with no fused multiply-add.

Boundary quirks of the reference are kept: row 0 compares hap[j] with
read[0] over the read axis (positions past the padded haplotype read code
0), and column 0 compares hap[0] with read[1].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

IMPOSSIBLE = -1000000000.0  # HapAligner.cpp:20
MATCH_EMIT = -0.000100005   # HapAligner.cpp:261 (float)
MISMATCH_EMIT = -9.0        # HapAligner.cpp:260 (float)
BAND_FAIL_SCORE = -700.0
BAND_THRESH = -600.0
LEN_DIFF_LIMIT = 600
MIN_FULL_HAP_LEN = 60       # full (untrimmed) haplotype length gate

# Reference flank geometry (HaplotypeGenerator.h:70, hipstr_main.cpp:140):
REF_FLANK_LEN = 35
DEF_INDEL_FLANK_LEN = 5

# Rows of batch scored per route by pairhmm_batch_auto (padding included).
# chip_smoke.py reads these to show that a run scored nothing on the host.
pairs_scored = {"cuda": 0, "cpu": 0, "host_f64": 0}


@dataclass(frozen=True)
class AlignmentParams:
    """The 7 log transition parameters (HapAligner.h:12-37).

    Defaults are the Dindel values used for Illumina + PacBio HiFi
    (HapAligner.h:118). ``--alignment-params`` supplies all seven.
    """

    ins_to_ins: float = -1.0
    ins_to_match: float = -0.458675
    del_to_del: float = -1.0
    del_to_match: float = -0.458675
    match_to_match: float = -0.00005800168
    match_to_ins: float = -10.448214728
    match_to_del: float = -10.448214728

    @staticmethod
    def from_list(vals):
        vals = list(vals)
        if len(vals) != 7:
            raise ValueError("alignment-params requires exactly 7 values")
        return AlignmentParams(*[float(v) for v in vals])

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.ins_to_ins, self.ins_to_match, self.del_to_del,
             self.del_to_match, self.match_to_match, self.match_to_ins,
             self.match_to_del], dtype=np.float32)


def params_from_numpy(arr) -> AlignmentParams:
    """AlignmentParams from a 7-float vector such as
    ``longtr_tpu``'s ``AlignmentParams.as_array()``.

    Each float32 widens exactly to a Python float, so ``as_array()`` of the
    result gives back the same float32 bits.
    """
    arr = np.asarray(arr, dtype=np.float32)
    if arr.shape != (7,):
        raise ValueError(f"expected 7 transition values, got shape {arr.shape}")
    return AlignmentParams(*[float(v) for v in arr])


# ---------------------------------------------------------------------------
# Float64 oracle — a faithful transcription of HapAligner.cpp:236-343.
# ---------------------------------------------------------------------------

def pairhmm_score_oracle(hap: str, read: str, params: AlignmentParams = AlignmentParams(),
                         full_hap_len: int | None = None) -> float:
    """Score one (haplotype, read) pair exactly as the reference C++ does.

    ``hap`` is the *trimmed* haplotype sequence (repeat +/- INDEL_FLANK_LEN),
    i.e. what remains after HapAligner.cpp:246 strips
    ``REF_FLANK_LEN - INDEL_FLANK_LEN`` from both ends.  ``full_hap_len`` is
    the untrimmed length used for the <=60 gate; if None it is inferred as
    ``len(hap) + 2*(REF_FLANK_LEN - DEF_INDEL_FLANK_LEN)``.
    """
    if full_hap_len is None:
        full_hap_len = len(hap) + 2 * (REF_FLANK_LEN - DEF_INDEL_FLANK_LEN)
    if full_hap_len <= MIN_FULL_HAP_LEN:
        return IMPOSSIBLE

    n, m = len(hap), len(read)
    if abs(n - m) > LEN_DIFF_LIMIT:
        return BAND_FAIL_SCORE

    i2i = np.float32(params.ins_to_ins)
    i2m = np.float32(params.ins_to_match)
    d2d = np.float32(params.del_to_del)
    d2m = np.float32(params.del_to_match)
    m2m = np.float32(params.match_to_match)
    m2i = np.float32(params.match_to_ins)
    m2d = np.float32(params.match_to_del)
    MA, MI = np.float32(MATCH_EMIT), np.float32(MISMATCH_EMIT)

    M = np.full((n, m), IMPOSSIBLE, dtype=np.float64)
    I = np.full((n, m), IMPOSSIBLE, dtype=np.float64)
    D = np.full((n, m), IMPOSSIBLE, dtype=np.float64)

    M[0, 0] = MA if hap[0] == read[0] else MI
    # Row 0 (HapAligner.cpp:267-272). NOTE the hap[j]-vs-read[0] quirk; the
    # reference reads hap out of bounds when j >= n (UB) — we treat those as
    # mismatches.
    # left_prob is a DOUBLE accumulator in the reference; it must be an
    # np.float64 so NEP50 promotion keeps every expression in f64 (a bare
    # python float is a weak scalar and np.float32 + weak -> float32).
    left = np.float64(0.0)
    for j in range(1, m):
        emit = MA if (j < n and hap[j] == read[0]) else MI
        D[0, j] = m2d + left
        M[0, j] = D[0, j - 1] + d2m + emit
        I[0, j] = IMPOSSIBLE
        left += d2d
    # Column 0 (HapAligner.cpp:274-280). NOTE hap[0]-vs-read[1] quirk.
    left = np.float64(0.0)
    col0_read = read[1] if m > 1 else read[0]
    for i in range(1, n):
        emit = MA if hap[0] == col0_read else MI
        M[i, 0] = I[i - 1, 0] + i2m + emit
        # MATCH + LOG_MATCH_TO_INS is float+float in the reference
        # (HapAligner.cpp:277) before the double accumulator joins
        I[i, 0] = np.float32(MA + m2i) + left
        D[i, 0] = IMPOSSIBLE
        left += i2i

    for i in range(1, n):
        row_best = IMPOSSIBLE
        for j in range(1, m):
            emit = MA if hap[i] == read[j] else MI
            M[i, j] = emit + max(M[i - 1, j - 1] + m2m,
                                 D[i - 1, j - 1] + d2m,
                                 I[i - 1, j - 1] + i2m)
            I[i, j] = MA + max(M[i - 1, j] + m2i, I[i - 1, j] + i2i)
            D[i, j] = max(M[i, j - 1] + m2d, D[i, j - 1] + d2d)
            best = max(M[i, j], I[i, j], D[i, j])
            cand = best + abs((n - m) - (i - j)) * d2d
            if cand > row_best:
                row_best = cand
        if row_best < BAND_THRESH:
            return BAND_FAIL_SCORE

    return float(max(M[n - 1, m - 1], I[n - 1, m - 1], D[n - 1, m - 1]))


# ---------------------------------------------------------------------------
# Batched torch implementation (row scan + cummax): the plain version.
# ---------------------------------------------------------------------------

def encode_seq(seq: str, length: int, pad_code: int = 0) -> np.ndarray:
    """ASCII-encode a sequence into a fixed-length uint8 vector."""
    arr = np.full(length, pad_code, dtype=np.uint8)
    b = seq.encode("ascii")
    arr[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return arr


def pairhmm_scan(hap, hap_len, read, read_len, full_hap_len, trans):
    """Score a padded batch with one torch op sequence per haplotype row.

    Shapes: hap (B, N) and read (B, M) uint8 codes; hap_len, read_len and
    full_hap_len (B,) integers; trans (7,) float32.  All on one device.
    Returns (B,) float32 scores, bit-identical to
    ``longtr_tpu.ops.pairhmm.pairhmm_scan`` and the native scorer.
    """
    B, Mdim = read.shape
    n_max = hap.shape[1]
    dev = read.device
    f32 = torch.float32
    i2i, i2m, d2d, d2m, m2m, m2i, m2d = trans.to(f32).unbind(0)
    MA = torch.tensor(MATCH_EMIT, dtype=f32, device=dev)
    MI = torch.tensor(MISMATCH_EMIT, dtype=f32, device=dev)
    NEG = torch.tensor(IMPOSSIBLE, dtype=f32, device=dev)

    j_idx = torch.arange(Mdim, device=dev)[None, :]                  # (1, M)
    jf = j_idx.to(f32)
    n = hap_len.to(device=dev, dtype=torch.int64)[:, None]           # (B, 1)
    m = read_len.to(device=dev, dtype=torch.int64)[:, None]          # (B, 1)
    fl = full_hap_len.to(device=dev, dtype=torch.int64)
    valid_j = j_idx < m                                              # (B, M)

    r0 = read[:, 0:1]
    # Row 0 closed forms; padded hap positions read code 0.
    hap_m = (hap[:, :Mdim] if n_max >= Mdim
             else torch.nn.functional.pad(hap, (0, Mdim - n_max)))
    emit_row0 = torch.where(hap_m == r0, MA, MI)
    Dk = torch.where(j_idx >= 1, m2d + (jf - 1) * d2d, NEG)           # D[0, j]
    M0 = torch.where(j_idx == 0, torch.where(hap[:, 0:1] == r0, MA, MI),
                     torch.roll(Dk, 1, dims=-1) + d2m + emit_row0)
    Mp = torch.where(valid_j, M0, NEG)
    Ip = torch.full((B, Mdim), IMPOSSIBLE, dtype=f32, device=dev)
    Dp = torch.where(valid_j, Dk, NEG)

    # Column-0 emission uses read[1] for every row (reference quirk).
    col0_read = torch.where(m[:, 0] > 1, read[:, min(1, Mdim - 1)], read[:, 0])
    col0_emit = torch.where(hap[:, 0] == col0_read, MA, MI)           # (B,)

    corner_j = torch.clamp(m - 1, 0, Mdim - 1)                        # (B, 1)

    def take_corner(row):
        return row.gather(1, corner_j)[:, 0]

    corner0 = torch.maximum(torch.maximum(take_corner(Mp), take_corner(Ip)),
                            take_corner(Dp))
    out = torch.where(n[:, 0] == 1, corner0, NEG)
    bandfail = torch.zeros(B, dtype=torch.bool, device=dev)
    neg_col = torch.full((B, 1), IMPOSSIBLE, dtype=f32, device=dev)
    band_mask = (j_idx >= 1) & (j_idx <= m - 1)

    def shift(x):
        return torch.cat([neg_col, x[:, :-1]], dim=1)

    # Rows past every pair's last haplotype row change no output.
    last_row = min(n_max, int(hap_len.max()) if B else 0)
    for i in range(1, last_row):
        emit = torch.where(hap[:, i:i + 1] == read, MA, MI)
        Mn = emit + torch.maximum(torch.maximum(shift(Mp) + m2m,
                                                shift(Dp) + d2m),
                                  shift(Ip) + i2m)
        In = MA + torch.maximum(Mp + m2i, Ip + i2i)
        # Column-0 boundary overrides.
        Mn[:, 0] = Ip[:, 0] + i2m + col0_emit
        In[:, 0] = MA + m2i + float(i - 1) * i2i
        # D row: decayed running max via cummax.
        c = Mn + m2d - (jf + 1) * d2d
        cmax = torch.cummax(c, dim=1).values
        Dn = torch.cat([neg_col, jf[:, 1:] * d2d + cmax[:, :-1]], dim=1)

        Mn = torch.where(valid_j, Mn, NEG)
        In = torch.where(valid_j, In, NEG)
        Dn = torch.where(valid_j, Dn, NEG)

        best = torch.maximum(torch.maximum(Mn, In), Dn)
        band = ((n - m) - (i - j_idx)).abs().to(f32) * d2d
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


class PairHMM(nn.Module):
    """Mode-A pair-HMM scorer.

    Its only state is the 7 transition log-probabilities, a float32 buffer
    named ``trans`` in ``AlignmentParams.as_array()`` order, so
    ``load_state_dict({"trans": ...})`` takes ``longtr_tpu``'s parameter
    vector bit for bit.  ``forward`` runs where its inputs lie: the CUDA
    kernels for tensors on a card, the plain scan for tensors on the CPU.
    """

    def __init__(self, params: AlignmentParams = AlignmentParams()):
        super().__init__()
        self.register_buffer("trans", torch.from_numpy(params.as_array()))

    def forward(self, hap, hap_len, read, read_len, full_hap_len):
        from longtr_tpu_torch.ops import pairhmm_cuda
        return pairhmm_cuda.pairhmm_batch(hap, hap_len, read, read_len,
                                          full_hap_len, self.trans)


def _check_batch(hap_codes, hap_lens, read_codes, read_lens, full_hap_lens):
    """Validate a host batch before it reaches a kernel's pointers."""
    hap = np.ascontiguousarray(hap_codes, dtype=np.uint8)
    read = np.ascontiguousarray(read_codes, dtype=np.uint8)
    hl = np.ascontiguousarray(hap_lens, dtype=np.int32)
    rl = np.ascontiguousarray(read_lens, dtype=np.int32)
    fl = np.ascontiguousarray(full_hap_lens, dtype=np.int32)
    if hap.ndim != 2 or read.ndim != 2 or hap.shape[0] != read.shape[0]:
        raise ValueError(f"hap {hap.shape} and read {read.shape} must be "
                         "(B, N) and (B, M)")
    B, N = hap.shape
    M = read.shape[1]
    if N < 1 or M < 1:
        raise ValueError("hap and read widths must be at least 1")
    for name, v in (("hap_lens", hl), ("read_lens", rl),
                    ("full_hap_lens", fl)):
        if v.shape != (B,):
            raise ValueError(f"{name} has shape {v.shape}, expected ({B},)")
    if B and (hl.min() < 0 or hl.max() > N or rl.min() < 0 or rl.max() > M):
        raise ValueError("sequence lengths must lie within the padded widths")
    return hap, hl, read, rl, fl


def pairhmm_batch_auto(hap_codes, hap_lens, read_codes, read_lens,
                       full_hap_lens, params: AlignmentParams = AlignmentParams(),
                       device: torch.device | None = None, mesh=None):
    """Score a padded host batch on ``device``, or over ``mesh``.

    * reference-fidelity mode (``--ref-fidelity``): the native f64 DP on the
      host, bit-identical to the compiled reference; returns numpy float64;
    * a mesh of more than one shard
      (:class:`longtr_tpu_torch.parallel.mesh.Mesh`): the batch split over
      its devices by
      :func:`~longtr_tpu_torch.parallel.mesh.pairhmm_batch_sharded`, which
      scores each shard as below; returns the list of shard scores;
    * a CUDA device: the hand-written kernels, enqueued on the current
      stream; returns a float32 tensor on the card without synchronising;
    * the CPU: the plain torch scan; returns a float32 CPU tensor.
    """
    from longtr_tpu.utils import mathops
    hap, hl, read, rl, fl = _check_batch(hap_codes, hap_lens, read_codes,
                                         read_lens, full_hap_lens)
    if mathops.ref_fidelity():
        from longtr_tpu import native
        out = native.pairhmm_batch_native_f64(hap, hl, read, rl, fl,
                                              params.as_array())
        if out is None:
            raise RuntimeError("--ref-fidelity needs the native library "
                               "(longtr_tpu/native), which failed to load")
        pairs_scored["host_f64"] += hap.shape[0]
        return out
    if mesh is not None and mesh.size > 1:
        from longtr_tpu_torch.parallel.mesh import pairhmm_batch_sharded
        return pairhmm_batch_sharded(hap, hl, read, rl, fl, params, mesh=mesh)
    device = torch.device("cpu") if device is None else torch.device(device)
    model = PairHMM(params)
    cuda = device.type == "cuda"
    t = [torch.from_numpy(a) for a in (hap, hl, read, rl, fl)]
    if cuda:
        # Pinned sources with non_blocking copies queue behind the batches
        # already launched instead of waiting for them to finish.
        model.trans = model.trans.pin_memory()
        model = model.to(device, non_blocking=True)
        t = [x.pin_memory().to(device, non_blocking=True) for x in t]
    pairs_scored["cuda" if cuda else "cpu"] += hap.shape[0]
    return model(*t)
