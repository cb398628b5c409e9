"""The port's CUDA kernels against their plain versions, on a CUDA card:
the pair-HMM kernels against the plain scan and the native scorer, and
the mode-B kernel against the plain torch rows.

This file imports no JAX, so it also runs where JAX is not installed, with
the suite's JAX conftest switched off:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Without a card its tests skip.  It also holds the seeded batches that
tests/test_torch_pairhmm.py and tests/test_torch_mode_b.py feed to the
plain versions and to longtr_tpu's scorers on the CPU.
"""

import numpy as np
import pytest
import torch

from longtr_tpu import native
from longtr_tpu.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.ops import mode_b_cuda
from longtr_tpu_torch.ops import mode_b_device
from longtr_tpu_torch.ops import pairhmm as port
from longtr_tpu_torch.ops import pairhmm_cuda

BASES = np.array(list("ACGT"))
CUSTOM = [-2.0, -0.3, -1.5, -0.25, -0.0001, -8.0, -9.0]


def _rand(rng, n):
    return "".join(rng.choice(BASES, size=n))


def _mutate(rng, seq, sub=0.02, ind=0.01):
    out = []
    for ch in seq:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out += [ch, str(rng.choice(BASES))]
        elif r < ind + sub:
            out.append(str(rng.choice(BASES)))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _encode(pairs, N=None, M=None, full_lens=None):
    N = N or max(len(h) for h, _ in pairs)
    M = M or max(len(r) for _, r in pairs)
    H = np.stack([port.encode_seq(h, N) for h, _ in pairs])
    R = np.stack([port.encode_seq(r, M) for _, r in pairs])
    hl = np.array([len(h) for h, _ in pairs], np.int32)
    rl = np.array([len(r) for _, r in pairs], np.int32)
    fl = hl + 60 if full_lens is None else np.asarray(full_lens, np.int32)
    return H, hl, R, rl, fl


def _case_default(params=None):
    rng = np.random.default_rng(101)
    pairs = []
    for _ in range(10):
        hap = _rand(rng, int(rng.integers(8, 40)))
        pairs.append((hap, _mutate(rng, hap)))
    pairs += [("A", "A"), ("ACGTACGTAC", "A"), ("A", "ACGTACG")]
    return _encode(pairs), params


def _case_gates_bandfail():
    rng = np.random.default_rng(102)
    pairs = [(_rand(rng, int(rng.integers(15, 30))), "") for _ in range(6)]
    pairs = [(h, _mutate(rng, h)) for h, _ in pairs]
    pairs[1] = (pairs[1][0], "G" * len(pairs[1][1]))     # band fail
    pairs[4] = (pairs[4][0], _rand(rng, len(pairs[4][0])))  # unrelated read
    H, hl, R, rl, fl = _encode(pairs)
    fl[0] = 60                                           # short-hap gate
    fl[2] = 61                                           # just above it
    return (H, hl, R, rl, fl), None


def _case_length_skew():
    """|n-m| of 250-550 bp: the band term keeps the shifted diagonal alive."""
    rng = np.random.default_rng(103)
    pairs = []
    for k in range(4):
        hap = _rand(rng, 1024 - int(rng.integers(0, 40)))
        skew = int(rng.integers(250, 550)) * (1 if k % 2 else -1)
        cut = len(hap) // 2
        if skew > 0:
            read = hap[:cut] + hap[cut + skew:]
        else:
            read = hap[:cut] + _rand(rng, -skew) + hap[cut:]
        rd = list(read)
        for p in rng.integers(0, len(rd), size=len(rd) // 50):
            rd[p] = str(rng.choice(BASES))
        pairs.append((hap, "".join(rd)))
    return _encode(pairs), None


def _case_padded():
    """Widths bucketed past every length and padded lanes (hl=rl=fl=1), as
    the pipeline hands batches to the scorer."""
    rng = np.random.default_rng(104)
    pairs = []
    for _ in range(5):
        hap = _rand(rng, int(rng.integers(20, 50)))
        pairs.append((hap, _mutate(rng, hap)))
    H, hl, R, rl, fl = _encode(pairs, N=64, M=128)
    pad = 3
    H = np.pad(H, ((0, pad), (0, 0)))
    R = np.pad(R, ((0, pad), (0, 0)))
    hl, rl, fl = (np.pad(a, (0, pad), constant_values=1) for a in (hl, rl, fl))
    return (H, hl, R, rl, fl), None


# name -> () -> ((hap, hap_len, read, read_len, full_len), params or None)
CASES = {
    "default": lambda: _case_default(),
    "custom_params": lambda: _case_default(CUSTOM),
    "gates_bandfail": _case_gates_bandfail,
    "length_skew": _case_length_skew,
    "padded": _case_padded,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_bit_identical(cuda_device, case):
    """Both kernels, at their default and at small thread counts (so short
    pairs span several segments and tiles), equal the plain scan on the CPU
    and the native scorer bit for bit."""
    batch, params = CASES[case]()
    trans = (port.AlignmentParams.from_list(params) if params
             else port.AlignmentParams()).as_array()
    want = port.pairhmm_scan(*(torch.from_numpy(a)
                               for a in (*batch, trans))).numpy()
    nat = native.pairhmm_batch_native(*batch, trans)
    assert nat is not None, "native library unavailable"
    assert np.array_equal(want, nat)
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    outs = [pairhmm_cuda.pairhmm_batch(*g), port.pairhmm_scan(*g)]
    for threads in (None, 32, 64):
        outs.append(pairhmm_cuda.pairhmm_resident(*g, threads=threads))
        outs.append(pairhmm_cuda.pairhmm_streamed(*g, threads=threads))
    torch.cuda.synchronize()
    for out in outs:
        assert out.device == cuda_device and out.dtype == torch.float32
        assert np.array_equal(out.cpu().numpy(), want), case


@pytest.mark.gpu
def test_cuda_routing(cuda_device, monkeypatch):
    """pairhmm_batch sends a width that fits the resident kernel's shared
    memory there and a wider one to the streamed kernel."""
    batch, _ = CASES["padded"]()
    trans = port.AlignmentParams().as_array()
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    width = batch[2].shape[1]
    assert pairhmm_cuda.resident_fits(width, cuda_device)
    for limit, kernel in ((None, "pairhmm_resident"),
                          (pairhmm_cuda.resident_smem_bytes(width) - 1,
                           "pairhmm_streamed")):
        monkeypatch.setattr(pairhmm_cuda, "resident_limit_bytes", limit)
        pairhmm_cuda.reset_launches()
        out = pairhmm_cuda.pairhmm_batch(*g)
        torch.cuda.synchronize()
        assert pairhmm_cuda.launches == {
            k: int(k == kernel) for k in pairhmm_cuda.launches}
        assert np.array_equal(out.cpu().numpy(),
                              port.pairhmm_scan(*g).cpu().numpy())


# ---------------------------------------------------------------------------
# Mode B: homopolymer loci (the fixtures of tests/test_mode_b_device.py,
# rebuilt here without JAX) and synthetic row tables.
# ---------------------------------------------------------------------------

def homopolymer_hap(copies_list, flank_l="ACGTTGCAGC", flank_r="GTCAGGCTAT",
                    start=100):
    """A flank | T-homopolymer (first entry = reference) | flank haplotype."""
    from longtr_tpu.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
    from longtr_tpu.models.stutter import default_stutter_model
    sm = default_stutter_model().with_period(1)
    blocks = [HapBlock(start - len(flank_l), start, flank_l)]
    rb = RepeatBlock(start, start + copies_list[0], "T" * copies_list[0], 1, sm)
    for c in copies_list[1:]:
        rb.add_alternate("T" * c)
    blocks.append(rb)
    blocks.append(HapBlock(start + copies_list[0],
                           start + copies_list[0] + len(flank_r), flank_r))
    return Haplotype(blocks)


def homopolymer_read(copies, flank_l, flank_r, rng, err=0.02, start=100,
                     ref_copies=12):
    """A read of `copies` T's with substitution noise and random qualities;
    its CIGAR is written against `ref_copies` reference T's."""
    from longtr_tpu.pipeline.alignment import Alignment
    seq = list(flank_l + "T" * copies + flank_r)
    for i in range(len(seq)):
        if rng.random() < err:
            seq[i] = rng.choice([c for c in "ACGT" if c != seq[i]])
    seq = "".join(seq)
    quals = "".join(chr(33 + int(q)) for q in rng.integers(15, 40, len(seq)))
    aln = Alignment(start - len(flank_l), start + copies + len(flank_r) - 1,
                    False, False, "r", quals, seq, seq)
    if copies == ref_copies:
        aln.cigar = [("=", len(seq))]
    elif copies > ref_copies:
        aln.cigar = [("=", len(flank_l) + ref_copies),
                     ("I", copies - ref_copies), ("=", len(flank_r))]
    else:
        aln.cigar = [("=", len(flank_l) + copies),
                     ("D", ref_copies - copies), ("=", len(flank_r))]
    return aln


def _mb_fixed(alleles, copies, seed, params=None, err=0.02):
    def make():
        rng = np.random.default_rng(seed)
        fl, fr = "ACGTTGCAGC", "GTCAGGCTAT"
        return (homopolymer_hap(alleles, fl, fr),
                [homopolymer_read(c, fl, fr, rng, err) for c in copies], params)
    return make


def _mb_random(trial):
    def make():
        rng = np.random.default_rng(1000 + trial)
        fl = "".join(rng.choice(list("ACGT"), 8 + rng.integers(0, 6)))
        fr = "".join(rng.choice(list("ACGT"), 8 + rng.integers(0, 6)))
        ref = int(rng.integers(8, 16))
        alleles = [ref] + sorted({int(a) for a in
                                  rng.integers(4, 22, rng.integers(1, 4))}
                                 - {ref})
        hap = homopolymer_hap(alleles, fl, fr)
        alns = [homopolymer_read(int(rng.choice(alleles)), fl, fr, rng,
                                 err=0.05) for _ in range(5)]
        return hap, alns, None
    return make


# name -> () -> (haplotype, alignments, alignment params or None)
MODE_B_CASES = {
    "fixed_12_9_15": _mb_fixed([12, 9, 15], (12, 9, 15, 11, 13, 14), 97),
    "fixed_12_9_15_4": _mb_fixed([12, 9, 15, 4], (12, 4, 9, 15, 10), 98),
    "fixed_custom_params": _mb_fixed([14, 13, 16, 10], (14, 13, 16, 10, 15),
                                     99, CUSTOM, err=0.03),
    **{f"random_{t}": _mb_random(t) for t in range(8)},
}


def mode_b_case(name, aligner_cls):
    """(aligner, seedable alignments, their seeds) of a mode-B case."""
    from longtr_tpu_torch.pipeline.mode_b import calc_seed_base
    hap, alns, params = MODE_B_CASES[name]()
    aligner = aligner_cls(hap, params)
    hs, he = hap.blocks[0].start, hap.blocks[-1].end
    seeds = [calc_seed_base(a, aligner.repeat_starts, aligner.repeat_ends,
                            hs, he) for a in alns]
    keep = [i for i, s in enumerate(seeds) if s >= 0]
    assert keep, f"{name}: no seedable read"
    return aligner, [alns[i] for i in keep], [seeds[i] for i in keep]


TABLE_KEYS = ("codes", "quals_a", "lw_tab", "lc_tab", "pre_a", "last",
              "hapchar", "kind", "stut_ord", "A", "bl_a", "d0_a", "dstep_a",
              "params")


def synthetic_tables(rng, B, L, R, S, n_d, dtype=np.float32):
    """Random mode-B row tables: every row kind, stutter rows over S
    ordinals, IMPOSSIBLE and -inf artifact entries, `last` anywhere."""
    from longtr_tpu.utils.base_quality import log_prob_correct, log_prob_error
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lw = np.array([log_prob_error(chr(i)) for i in range(256)], dtype)
    lc = np.array([log_prob_correct(chr(i)) for i in range(256)], dtype)
    codes = rng.choice(acgt, (B, L))
    quals = rng.integers(33, 75, (B, L)).astype(np.uint8)
    prefix = np.zeros((B, L), dtype)
    for b in range(B):
        prefix[b, 1:] = np.cumsum(lc[quals[b]].astype(np.float64))[:-1]
    kind = np.zeros((B, R), np.uint8)
    stut = np.zeros((B, R), np.uint8)
    for b in range(B):
        r, s = 1, 0
        while r < R:
            n0 = int(rng.integers(1, 5))
            n3 = int(rng.integers(0, 4))
            kind[b, r + n0:r + n0 + n3] = 3
            r += n0 + n3
            if r < R:
                kind[b, r], stut[b, r] = 2, s % S
                s += 1
            if r + 1 < R:
                kind[b, r + 1] = 1
            r += 2
    A = rng.uniform(-30, 0, (B, S, n_d, L)).astype(dtype)
    A[rng.random(A.shape) < 0.1] = IMPOSSIBLE
    A[:, :, n_d - 2:, :] = -np.inf
    A[:, :, :, L - 3:] = -np.inf
    return dict(codes=codes, quals_a=quals, lw_tab=lw, lc_tab=lc,
                pre_a=prefix, last=rng.integers(0, L, B).astype(np.int32),
                hapchar=rng.choice(acgt, (B, R)), kind=kind, stut_ord=stut,
                A=A, bl_a=rng.integers(1, 12, (B, S)).astype(np.int32),
                d0_a=-rng.integers(0, 6, (B, S)).astype(np.int32),
                dstep_a=rng.integers(1, 3, (B, S)).astype(np.int32),
                params=np.array([-1.0, -0.458675, -1.0, -0.458675,
                                 -0.00005800168, -10.448214728,
                                 -10.448214728], dtype),
                n_d=n_d)


def _tables_on(prep, device):
    return [torch.from_numpy(np.ascontiguousarray(prep[k])).to(device)
            for k in TABLE_KEYS]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MODE_B_CASES))
def test_mode_b_kernel_bit_identical(cuda_device, case, monkeypatch):
    """The kernel, with its rows on chip (default and 32 threads, so
    threads own several columns) and on the workspace, equals the plain
    rows on the card bit for bit."""
    from longtr_tpu_torch.pipeline.mode_b import ModeBAligner
    aligner, alns, seeds = mode_b_case(case, ModeBAligner)
    prep = aligner.score_reads_batch_prepare(alns, seeds)
    g = _tables_on(prep, cuda_device)
    want = mode_b_device.mode_b_cols_plain(*g, n_d=prep["n_d"])
    outs = [mode_b_cuda.mode_b_cols(*g, n_d=prep["n_d"]),
            mode_b_cuda.mode_b_cols(*g, n_d=prep["n_d"], threads=32)]
    monkeypatch.setattr(mode_b_cuda, "smem_limit_bytes", 0)
    outs.append(mode_b_cuda.mode_b_cols(*g, n_d=prep["n_d"]))
    torch.cuda.synchronize()
    for out in outs:
        assert out.dtype == torch.float32 and out.shape == want.shape
        assert torch.equal(out, want), case


@pytest.mark.gpu
def test_mode_b_kernel_wider_than_shared_memory(cuda_device):
    """A width whose rows do not fit one block's shared memory runs on the
    workspace, on the card, bit for bit like the plain rows."""
    L = 20000
    assert not mode_b_cuda.fits_on_chip(L, cuda_device)
    prep = synthetic_tables(np.random.default_rng(7), 3, L, 24, 2, 13)
    g = _tables_on(prep, cuda_device)
    mode_b_cuda.reset_launches()
    got = mode_b_device.mode_b_cols(*g, n_d=prep["n_d"])
    want = mode_b_device.mode_b_cols_plain(*g, n_d=prep["n_d"])
    torch.cuda.synchronize()
    assert mode_b_cuda.launches == {"mode_b_cols": 1}
    assert got.device == cuda_device and torch.equal(got, want)


@pytest.mark.gpu
def test_mode_b_cuda_routing(cuda_device):
    """mode_b_cols launches the kernel for float32 card tensors (one count
    per launch) and raises for float64 ones."""
    prep = synthetic_tables(np.random.default_rng(8), 5, 40, 16, 1, 7)
    g = _tables_on(prep, cuda_device)
    mode_b_cuda.reset_launches()
    out = mode_b_device.mode_b_cols(*g, n_d=prep["n_d"])
    torch.cuda.synchronize()
    assert mode_b_cuda.launches == {"mode_b_cols": 1}
    assert torch.equal(out, mode_b_device.mode_b_cols_plain(
        *g, n_d=prep["n_d"]))
    g64 = _tables_on(synthetic_tables(np.random.default_rng(8), 5, 40, 16, 1,
                                      7, dtype=np.float64), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        mode_b_device.mode_b_cols(*g64, n_d=prep["n_d"])
    with pytest.raises(ValueError, match="dtype"):
        mode_b_cuda.mode_b_cols(*g64, n_d=prep["n_d"])
    assert mode_b_cuda.launches == {"mode_b_cols": 1}
