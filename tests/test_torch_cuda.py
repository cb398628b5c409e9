"""The port's CUDA kernels against their plain versions, on a CUDA card:
the pair-HMM kernels against the plain scan and the native scorer, the
mode-B kernels against the plain torch tables and rows, and the
window posteriors and EM train kernels against the plain torch
posteriors and train loop.

This file imports no JAX, so it also runs where JAX is not installed, with
the suite's JAX conftest switched off:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Without a card its tests skip.  It also holds the seeded batches that
tests/test_torch_pairhmm.py and tests/test_torch_mode_b.py feed to the
plain versions and to longtr_tpu's scorers on the CPU (the cases of the
window posteriors and the EM train loop are tests/_torch_cases.py's);
the mode-B fixtures build their haplotypes and reads from the classes they are given
(the port's by default), so that each package scores its own objects.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from longtr_tpu_torch import native
from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.ops import em_cuda
from longtr_tpu_torch.ops import mode_b_cuda
from longtr_tpu_torch.ops import mode_b_device
from longtr_tpu_torch.ops import pairhmm as port
from longtr_tpu_torch.ops import pairhmm_cuda
from longtr_tpu_torch.ops import posterior
from longtr_tpu_torch.parallel import mesh as pm
from longtr_tpu_torch.pipeline.mode_b import ARTIFACT_KEYS, ROW_KEYS

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import (assert_em_close, assert_posteriors_close,  # noqa: E402
                          cohort_case, em_case, mixed_window, plain_em_train,
                          posterior_window, random_case, real_window,
                          realistic_em_locus)

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


def k1_variants(width):
    """The K1 variants that take a read width, by launch-count name."""
    pc = pairhmm_cuda
    out = {}
    if width <= pc.WARP_MAX_WIDTH:
        out["pairhmm_resident_warp"] = pc.pairhmm_resident_warp
    if width <= pc.BLOCK_MAX_WIDTH:
        out["pairhmm_resident_block"] = pc.pairhmm_resident_block
    return out


def _width_batch(width, B=8, seed=0, full=2):
    """B pairs padded to read width `width`, the first `full` nearly that
    long and the rest shorter, so a batch at a wide edge stays cheap."""
    rng = np.random.default_rng(seed + width)
    pairs = []
    for k in range(B):
        n = width - int(rng.integers(0, 20)) if k < full else int(
            rng.integers(40, 200))
        hap = _rand(rng, n)
        pairs.append((hap, _mutate(rng, hap, 0.01, 0.004)[:width]))
    return _encode(pairs, M=width)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_bit_identical(cuda_device, case):
    """Every K1 variant that takes the width, and the streamed kernel also
    at small thread counts (so short pairs span several tiles), equal the
    plain scan on the CPU and the native scorer bit for bit."""
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
    outs += [fn(*g) for fn in k1_variants(batch[2].shape[1]).values()]
    for threads in (None, 32, 64):
        outs.append(pairhmm_cuda.pairhmm_streamed(*g, threads=threads))
    # the cluster kernel by default, and with many narrow CTAs, so that
    # short pairs span several CTAs and some CTAs hold no real column
    outs.append(pairhmm_cuda.pairhmm_streamed_cluster(*g))
    for C in (2, 3, 5, 8):
        outs.append(pairhmm_cuda.pairhmm_streamed_cluster(*g, cluster=C))
    torch.cuda.synchronize()
    for out in outs:
        assert out.device == cuda_device and out.dtype == torch.float32
        assert np.array_equal(out.cpu().numpy(), want), case


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 65, 128, 129, 192, 193, 256, 257,
                                   384, 385, 512, 513, 768, 769, 1024, 1025,
                                   4096, 4097, 8192])
def test_k1_variants_at_width_edges(cuda_device, width):
    """At each register variant's edges (32*K and 32*K+1 columns, warp to
    block, 8 to 16 columns a thread, the block variant's widest) every K1
    variant that takes the width equals the plain scan and the native
    scorer, and each launch is counted once under its variant's name."""
    batch = _width_batch(width)
    trans = port.AlignmentParams().as_array()
    want = native.pairhmm_batch_native(*batch, trans)
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    assert np.array_equal(port.pairhmm_scan(*g).cpu().numpy(), want)
    for name, fn in k1_variants(width).items():
        before = dict(pairhmm_cuda.launches)
        out = fn(*g)
        torch.cuda.synchronize()
        assert np.array_equal(out.cpu().numpy(), want), (width, name)
        assert {k: v - before[k] for k, v in pairhmm_cuda.launches.items()
                } == {k: int(k == name) for k in pairhmm_cuda.launches}


@pytest.mark.gpu
def test_cuda_routing(cuda_device, monkeypatch):
    """pairhmm_batch sends a width to K1's warp or block variant up to
    BLOCK_MAX_WIDTH, to K2's cluster kernel up to CLUSTER_MAX_WIDTH and to the
    workspace kernel past that: each threshold lowered below the width
    hands the batch to the next kernel."""
    batch, _ = CASES["padded"]()
    trans = port.AlignmentParams().as_array()
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    below = batch[2].shape[1] - 1
    for routing, kernel in (
            ({}, "pairhmm_resident_warp"),
            ({"WARP_MAX_WIDTH": below}, "pairhmm_resident_block"),
            ({"BLOCK_MAX_WIDTH": below}, "pairhmm_streamed_cluster"),
            ({"BLOCK_MAX_WIDTH": below, "CLUSTER_MAX_WIDTH": below},
             "pairhmm_streamed")):
        for k, v in routing.items():
            monkeypatch.setattr(pairhmm_cuda, k, v)
        pairhmm_cuda.reset_launches()
        out = pairhmm_cuda.pairhmm_batch(*g)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert pairhmm_cuda.launches == {
            k: int(k == kernel) for k in pairhmm_cuda.launches}, routing
        assert np.array_equal(out.cpu().numpy(),
                              port.pairhmm_scan(*g).cpu().numpy())


@pytest.mark.gpu
def test_cuda_routing_by_width(cuda_device):
    """The router's own thresholds at their edges: 1024/1025 (warp to
    block), 8192/8193 (block to cluster), 65536/65537 (cluster to
    workspace), one launch each, bit for bit the native scorer's."""
    trans = port.AlignmentParams().as_array()
    pc = pairhmm_cuda
    for width, kernel in ((pc.WARP_MAX_WIDTH, "pairhmm_resident_warp"),
                          (pc.WARP_MAX_WIDTH + 1, "pairhmm_resident_block"),
                          (pc.BLOCK_MAX_WIDTH, "pairhmm_resident_block"),
                          (pc.BLOCK_MAX_WIDTH + 1, "pairhmm_streamed_cluster"),
                          (pc.CLUSTER_MAX_WIDTH, "pairhmm_streamed_cluster"),
                          (pc.CLUSTER_MAX_WIDTH + 1, "pairhmm_streamed")):
        batch = _width_batch(width, B=3, full=int(width <= 8193))
        g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
        pc.reset_launches()
        out = pc.pairhmm_batch(*g)
        torch.cuda.synchronize()
        assert pc.launches == {k: int(k == kernel) for k in pc.launches}, \
            width
        assert np.array_equal(out.cpu().numpy(),
                              native.pairhmm_batch_native(*batch, trans))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [8192, 8193, 16384, 16385, 24576, 24577,
                                   32768, 32769, 40960, 40961, 49152, 49153,
                                   57344, 57345, 65536])
def test_cluster_kernel_at_width_edges(cuda_device, width):
    """At each C step (C CTAs of 8192 columns, and one column more) the
    cluster kernel, by default and with C full CTAs forced, equals the
    native scorer and the plain scan; pairs nearly as wide as the batch up
    to 16385 columns, short pairs (whose CTAs past m still take every
    barrier) beyond."""
    pc = pairhmm_cuda
    batch = _width_batch(width, B=4, full=2 if width <= 16385 else 0)
    trans = port.AlignmentParams().as_array()
    want = native.pairhmm_batch_native(*batch, trans)
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    assert np.array_equal(port.pairhmm_scan(*g).cpu().numpy(), want)
    runs = [{}]
    if width % pc.CTA_MAX_WIDTH == 0:
        runs.append({"cluster": width // pc.CTA_MAX_WIDTH})
    for kw in runs:
        pc.reset_launches()
        out = pc.pairhmm_streamed_cluster(*g, **kw)
        torch.cuda.synchronize()
        assert np.array_equal(out.cpu().numpy(), want), (width, kw)
        assert pc.launches["pairhmm_streamed_cluster"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7])
def test_cluster_kernel_batches(cuda_device, B):
    """B = 1 and an odd B, with a gated pair (short haplotype), a
    band-failed pair (unrelated read) and a pair past the |n-m| limit
    among long ones, at 9000 columns: bit for bit the native scorer's, at
    the default shape and at every C given."""
    rng = np.random.default_rng(300 + B)
    pairs = []
    for k in range(B):
        hap = _rand(rng, int(rng.integers(8200, 9000)) if k % 2 == 0
                    else int(rng.integers(60, 400)))
        kind = k % 4
        read = (_rand(rng, len(hap)) if kind == 2 else
                hap[:len(hap) // 2] if kind == 0 and k else
                _mutate(rng, hap, 0.002, 0.001))
        pairs.append((hap, read[:9000]))
    H, hl, R, rl, fl = _encode(pairs, M=9000)
    if B > 1:
        fl[1] = 60                                  # short-hap gate
    trans = port.AlignmentParams().as_array()
    want = native.pairhmm_batch_native(H, hl, R, rl, fl, trans)
    if B > 1:
        assert (want == port.IMPOSSIBLE).any()
        assert (want == port.BAND_FAIL_SCORE).sum() >= 2
    g = [torch.from_numpy(a).to(cuda_device) for a in (H, hl, R, rl, fl,
                                                       trans)]
    for kw in ({}, {"cluster": 2}, {"cluster": 3}, {"cluster": 8}):
        out = pairhmm_cuda.pairhmm_streamed_cluster(*g, **kw)
        torch.cuda.synchronize()
        assert np.array_equal(out.cpu().numpy(), want), kw


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 8])
def test_cluster_kernel_short_pairs_one_pair(cuda_device, C):
    """One pair a launch (B = 1) at one, two and eight CTAs, over short
    pairs of 1 to 40 haplotype rows (every row count around one warp's 32
    rows) and 1 to 40 read columns, the gated, band-failed and aligned ones
    among them: each launch ends and equals the native scorer bit for
    bit."""
    rng = np.random.default_rng(400 + C)
    trans = port.AlignmentParams().as_array()
    seen = set()
    for n in range(1, 41):
        for m in (1, 2, 31, 32, 33, 40):
            hap = _rand(rng, n)
            read = ("G" * m if n % 3 == 0 else
                    (_mutate(rng, hap, 0.05, 0.02) + _rand(rng, 40))[:m])
            batch = _encode([(hap, read)], M=48,
                            full_lens=[60 if n % 7 == 0 else n + 60])
            want = native.pairhmm_batch_native(*batch, trans)
            g = [torch.from_numpy(a).to(cuda_device)
                 for a in (*batch, trans)]
            out = pairhmm_cuda.pairhmm_streamed_cluster(*g, cluster=C)
            torch.cuda.synchronize()
            assert np.array_equal(out.cpu().numpy(), want), (n, m)
            seen.add("gate" if want[0] == port.IMPOSSIBLE else
                     "band fail" if want[0] == port.BAND_FAIL_SCORE
                     else "aligned")
    assert seen == {"aligned", "band fail", "gate"}, seen


@pytest.mark.gpu
def test_cluster_kernel_refuses_what_it_cannot_launch(cuda_device):
    """A shape the kernel cannot take raises and counts nothing: more than
    512 threads a CTA, a cluster above the portable 8 CTAs or below 1, a
    width past CLUSTER_MAX_WIDTH without an explicit cluster."""
    pc = pairhmm_cuda
    batch = _width_batch(8193, B=2, full=0)
    trans = port.AlignmentParams().as_array()
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    pc.reset_launches()
    for kw in ({"cluster": 1}, {"cluster": 9}, {"cluster": 0}):
        with pytest.raises(RuntimeError, match="launch failed"):
            pc.pairhmm_streamed_cluster(*g, **kw)
    wide = _width_batch(pc.CLUSTER_MAX_WIDTH + 1, B=2, full=0)
    gw = [torch.from_numpy(a).to(cuda_device) for a in (*wide, trans)]
    with pytest.raises(ValueError, match="exceeds the cluster kernel"):
        pc.pairhmm_streamed_cluster(*gw)
    assert pc.launches["pairhmm_streamed_cluster"] == 0


# ---------------------------------------------------------------------------
# Mode B: homopolymer loci (the fixtures of tests/test_mode_b_device.py,
# rebuilt here without JAX) and synthetic row tables.
# ---------------------------------------------------------------------------

def port_classes():
    """The port's classes that the mode-B fixtures build their objects of."""
    from longtr_tpu_torch.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
    from longtr_tpu_torch.models.stutter import default_stutter_model
    from longtr_tpu_torch.pipeline.alignment import Alignment
    from longtr_tpu_torch.pipeline.mode_b import calc_seed_base
    return types.SimpleNamespace(
        HapBlock=HapBlock, Haplotype=Haplotype, RepeatBlock=RepeatBlock,
        default_stutter_model=default_stutter_model, Alignment=Alignment,
        calc_seed_base=calc_seed_base)


def homopolymer_hap(copies_list, flank_l="ACGTTGCAGC", flank_r="GTCAGGCTAT",
                    start=100, cls=None):
    """A flank | T-homopolymer (first entry = reference) | flank haplotype,
    of ``cls``'s classes (default :func:`port_classes`)."""
    cls = cls or port_classes()
    sm = cls.default_stutter_model().with_period(1)
    blocks = [cls.HapBlock(start - len(flank_l), start, flank_l)]
    rb = cls.RepeatBlock(start, start + copies_list[0], "T" * copies_list[0],
                         1, sm)
    for c in copies_list[1:]:
        rb.add_alternate("T" * c)
    blocks.append(rb)
    blocks.append(cls.HapBlock(start + copies_list[0],
                               start + copies_list[0] + len(flank_r), flank_r))
    return cls.Haplotype(blocks)


def homopolymer_read(copies, flank_l, flank_r, rng, err=0.02, start=100,
                     ref_copies=12, cls=None):
    """A read of `copies` T's with substitution noise and random qualities;
    its CIGAR is written against `ref_copies` reference T's."""
    Alignment = (cls or port_classes()).Alignment
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
    def make(cls):
        rng = np.random.default_rng(seed)
        fl, fr = "ACGTTGCAGC", "GTCAGGCTAT"
        return (homopolymer_hap(alleles, fl, fr, cls=cls),
                [homopolymer_read(c, fl, fr, rng, err, cls=cls)
                 for c in copies], params)
    return make


def _mb_random(trial):
    def make(cls):
        rng = np.random.default_rng(1000 + trial)
        fl = "".join(rng.choice(list("ACGT"), 8 + rng.integers(0, 6)))
        fr = "".join(rng.choice(list("ACGT"), 8 + rng.integers(0, 6)))
        ref = int(rng.integers(8, 16))
        alleles = [ref] + sorted({int(a) for a in
                                  rng.integers(4, 22, rng.integers(1, 4))}
                                 - {ref})
        hap = homopolymer_hap(alleles, fl, fr, cls=cls)
        alns = [homopolymer_read(int(rng.choice(alleles)), fl, fr, rng,
                                 err=0.05, cls=cls) for _ in range(5)]
        return hap, alns, None
    return make


# name -> (classes) -> (haplotype, alignments, alignment params or None)
MODE_B_CASES = {
    "fixed_12_9_15": _mb_fixed([12, 9, 15], (12, 9, 15, 11, 13, 14), 97),
    "fixed_12_9_15_4": _mb_fixed([12, 9, 15, 4], (12, 4, 9, 15, 10), 98),
    "fixed_custom_params": _mb_fixed([14, 13, 16, 10], (14, 13, 16, 10, 15),
                                     99, CUSTOM, err=0.03),
    **{f"random_{t}": _mb_random(t) for t in range(8)},
}


def mode_b_case(name, aligner_cls, cls=None):
    """(aligner, seedable alignments, their seeds) of a mode-B case, its
    objects of ``cls``'s classes (default :func:`port_classes`)."""
    cls = cls or port_classes()
    hap, alns, params = MODE_B_CASES[name](cls)
    aligner = aligner_cls(hap, params)
    hs, he = hap.blocks[0].start, hap.blocks[-1].end
    seeds = [cls.calc_seed_base(a, aligner.repeat_starts,
                                aligner.repeat_ends, hs, he) for a in alns]
    keep = [i for i, s in enumerate(seeds) if s >= 0]
    assert keep, f"{name}: no seedable read"
    return aligner, [alns[i] for i in keep], [seeds[i] for i in keep]


# the prepared arrays of the row DP and of the artifact tables, in the
# kernels' argument order
TABLE_KEYS = ROW_KEYS


def artifact_case(trial, aligner_cls, cls=None):
    """Seeded random artifact-table inputs: one repeat block (a homopolymer
    on even trials, random bases on odd ones, so upstream matches both jump
    and rescan; some blocks shorter than the largest deletion) with up to
    three alternates, and each side's read segments (empty, one-base and
    up to 69 bases; padding past the longest).  Returns (aligner, tables,
    side_segs, L_max, n_d): the inputs are
    ``aligner.artifact_inputs(tables, side_segs, L_max, n_d)``."""
    cls = cls or port_classes()
    rng = np.random.default_rng(5100 + trial)
    lf = _rand(rng, int(rng.integers(3, 20)))
    rf = _rand(rng, int(rng.integers(3, 20)))
    rep_len = int(rng.integers(1, 30))
    rep = "A" * rep_len if trial % 2 == 0 else _rand(rng, rep_len)
    sm = cls.default_stutter_model().with_period(1)
    rs = 1000 + len(lf)
    rb = cls.RepeatBlock(rs, rs + rep_len, rep, 1, sm)
    for d in sorted({int(x) for x in rng.integers(-6, 7, 3)} - {0}):
        if rep_len + d >= 1:
            rb.add_alternate(rep[:rep_len + d] if d < 0
                             else rep + _rand(rng, d))
    hap = cls.Haplotype([cls.HapBlock(1000, rs, lf), rb,
                         cls.HapBlock(rs + rep_len, rs + rep_len + len(rf),
                                      rf)])
    aligner = aligner_cls(hap)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    side_segs = {}
    for side in (0, 1):
        lens = [0, 1] + [int(x) for x in rng.integers(0, 70, 4)]
        side_segs[side] = [(rng.choice(acgt, L),
                            rng.integers(33, 75, L).astype(np.uint8))
                           for L in lens]
    L_max = max(len(c) for ss in side_segs.values() for c, _q in ss) + 5
    tables = [(side, bi, opt) for side in (0, 1)
              for bi, al in enumerate(aligner._fw_stutter if side == 0
                                      else aligner._rev_stutter) if al
              for opt in range(len(al))]
    n_d = len(range(rb.max_del, rb.max_ins + 1, rb.period))
    return aligner, tables, side_segs, L_max, n_d


def synthetic_tables(rng, B, L, R, S, n_d, dtype=np.float32):
    """Random mode-B row tables: every row kind, stutter rows over S
    ordinals, B * S + 3 artifact tables with IMPOSSIBLE and -inf entries
    and a random table per element and ordinal, `last` anywhere before
    the three padding columns."""
    from longtr_tpu_torch.utils.base_quality import (log_prob_correct,
                                                     log_prob_error)
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
    NT = B * S + 3
    A = rng.uniform(-30, 0, (NT, n_d, L)).astype(dtype)
    A[rng.random(A.shape) < 0.1] = IMPOSSIBLE
    A[:, n_d - 2:, :] = -np.inf
    A[:, :, L - 3:] = -np.inf
    return dict(codes=codes, quals_a=quals, lw_tab=lw, lc_tab=lc,
                pre_a=prefix, last=rng.integers(0, L - 3, B).astype(np.int32),
                hapchar=rng.choice(acgt, (B, R)), kind=kind, stut_ord=stut,
                A_tab=A, tab=rng.integers(0, NT, (B, S)).astype(np.int32),
                bl_a=rng.integers(1, 12, (B, S)).astype(np.int32),
                d0_a=-rng.integers(0, 6, (B, S)).astype(np.int32),
                dstep_a=rng.integers(1, 3, (B, S)).astype(np.int32),
                params=np.array([-1.0, -0.458675, -1.0, -0.458675,
                                 -0.00005800168, -10.448214728,
                                 -10.448214728], dtype),
                n_d=n_d)


def _tables_on(prep, device):
    return [torch.from_numpy(np.ascontiguousarray(prep[k])).to(device)
            for k in TABLE_KEYS]


def _card_aligner(device):
    from longtr_tpu_torch.pipeline.mode_b import ModeBAligner
    return lambda hap, params=None: ModeBAligner(hap, params, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MODE_B_CASES))
def test_mode_b_kernel_bit_identical(cuda_device, case, monkeypatch):
    """Both row kernels on the plain artifact tables, the warp kernel (the
    route of these widths) and the block kernel with its rows on chip
    (default and 32 threads, so threads own several columns) and on the
    workspace, equal the plain rows on the card bit for bit."""
    aligner, alns, seeds = mode_b_case(case, _card_aligner(cuda_device))
    prep = aligner.score_reads_batch_prepare(alns, seeds)
    prep["A_tab"] = _plain_artifacts(prep, prep["n_d"], torch.float32)
    g = _tables_on(prep, cuda_device)
    n_d = prep["n_d"]
    want = mode_b_device.mode_b_cols_plain(*g, n_d=n_d)
    mode_b_cuda.reset_launches()
    outs = [mode_b_cuda.mode_b_cols(*g, n_d=n_d),
            mode_b_cuda.mode_b_cols(*g, n_d=n_d, variant="block"),
            mode_b_cuda.mode_b_cols(*g, n_d=n_d, variant="block", threads=32)]
    monkeypatch.setattr(mode_b_cuda, "smem_limit_bytes", 0)
    outs.append(mode_b_cuda.mode_b_cols(*g, n_d=n_d, variant="block"))
    torch.cuda.synchronize()
    assert mode_b_cuda.launches == {"mode_b_artifacts": 0,
                                    "mode_b_cols": 1, "mode_b_cols_block": 3}
    for out in outs:
        assert out.dtype == torch.float32 and out.shape == want.shape
        assert torch.equal(out, want), case


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1024, 1025])
def test_mode_b_warp_block_edge(cuda_device, L):
    """At the warp kernel's widest rows and one column more: the router's
    kernel and the other one equal the plain rows."""
    prep = synthetic_tables(np.random.default_rng(L), 5, L, 30, 2, 13)
    g = _tables_on(prep, cuda_device)
    want = mode_b_device.mode_b_cols_plain(*g, n_d=13)
    mode_b_cuda.reset_launches()
    got = mode_b_device.mode_b_cols(*g, n_d=13)
    routed = "mode_b_cols" if L <= 1024 else "mode_b_cols_block"
    assert mode_b_cuda.launches[routed] == 1
    assert torch.equal(got, want)
    assert torch.equal(mode_b_cuda.mode_b_cols(*g, n_d=13, variant="block"),
                       want)
    if L <= 1024:
        assert torch.equal(mode_b_cuda.mode_b_cols(*g, n_d=13,
                                                   variant="warp"), want)
    else:
        with pytest.raises(ValueError, match="warp kernel"):
            mode_b_cuda.mode_b_cols(*g, n_d=13, variant="warp")


@pytest.mark.gpu
def test_mode_b_many_artifact_sizes_take_block(cuda_device):
    """More artifact sizes than the warp kernel holds in registers go to
    the block kernel."""
    prep = synthetic_tables(np.random.default_rng(17), 4, 64, 20, 1, 17)
    g = _tables_on(prep, cuda_device)
    mode_b_cuda.reset_launches()
    got = mode_b_device.mode_b_cols(*g, n_d=17)
    assert mode_b_cuda.launches["mode_b_cols_block"] == 1
    assert torch.equal(got, mode_b_device.mode_b_cols_plain(*g, n_d=17))


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
    assert mode_b_cuda.launches == {"mode_b_artifacts": 0,
                                    "mode_b_cols": 0, "mode_b_cols_block": 1}
    assert got.device == cuda_device and torch.equal(got, want)


@pytest.mark.gpu
def test_mode_b_cuda_routing(cuda_device):
    """mode_b_cols launches a kernel for float32 card tensors (one count
    per launch) and raises for float64 ones."""
    prep = synthetic_tables(np.random.default_rng(8), 5, 40, 16, 1, 7)
    g = _tables_on(prep, cuda_device)
    mode_b_cuda.reset_launches()
    out = mode_b_device.mode_b_cols(*g, n_d=prep["n_d"])
    torch.cuda.synchronize()
    assert mode_b_cuda.launches["mode_b_cols"] == 1
    assert torch.equal(out, mode_b_device.mode_b_cols_plain(
        *g, n_d=prep["n_d"]))
    g64 = _tables_on(synthetic_tables(np.random.default_rng(8), 5, 40, 16, 1,
                                      7, dtype=np.float64), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        mode_b_device.mode_b_cols(*g64, n_d=prep["n_d"])
    with pytest.raises(ValueError, match="dtype"):
        mode_b_cuda.mode_b_cols(*g64, n_d=prep["n_d"])
    assert sum(mode_b_cuda.launches.values()) == 1


def _artifact_inputs_on(inp, device):
    return [torch.from_numpy(np.ascontiguousarray(inp[k])).to(device)
            for k in ARTIFACT_KEYS]


def _plain_artifacts(inp, n_d, dtype):
    """The plain version's artifact tables of ``inp``, built on the CPU
    (where tests/test_torch_mode_b_artifacts.py holds them to longtr_tpu's
    bit for bit), as a numpy array."""
    from longtr_tpu_torch.ops.mode_b_artifacts import mode_b_artifacts_plain
    return mode_b_artifacts_plain(*_artifact_inputs_on(inp, "cpu"), n_d=n_d,
                                  dtype=dtype).numpy()


def _artifact_kernel_vs_plain(inp, n_d, device):
    """The artifact kernel's float32 tables against the plain version's
    float64 tables run on the CPU, cast (tolerance 0), and its float64
    values within rtol 1e-12 of them (a last-bit exp/log difference);
    returns the float64 tables on the card."""
    g = _artifact_inputs_on(inp, device)
    plain = _plain_artifacts(inp, n_d, torch.float64)
    got32 = mode_b_cuda.mode_b_artifacts(*g, n_d=n_d)
    got64 = mode_b_cuda.mode_b_artifacts(*g, n_d=n_d, dtype=torch.float64)
    torch.cuda.synchronize()
    assert got32.dtype == torch.float32 and got32.shape == plain.shape
    np.testing.assert_array_equal(got32.cpu().numpy(),
                                  plain.astype(np.float32))
    np.testing.assert_allclose(got64.cpu().numpy(), plain, rtol=1e-12, atol=0)
    return got64.cpu().numpy()


# the warp kernel's plans (ARTIFACT_BLOCK_COLUMNS): the route's, one
# segment a block, four (a ragged last group of the six segments)
WARP_PLANS = (None, 1, 300)


@pytest.mark.gpu
@pytest.mark.parametrize("trial", range(12))
def test_mode_b_artifacts_kernel_random_blocks(cuda_device, trial,
                                               monkeypatch):
    """Random repeat blocks (homopolymers and not, shorter than the largest
    deletion), empty and one-base segments, padding: the warp kernel's tables
    equal the plain version's under each plan, with the region in shared memory
    and on the workspace, and its float64 values are the same under every
    plan."""
    aligner, tables, ss, L_max, n_d = artifact_case(
        trial, _card_aligner(cuda_device))
    inp = aligner.artifact_inputs(tables, ss, L_max, n_d)
    P = len(ss[0])
    mode_b_cuda.reset_launches()
    first = None
    for columns in WARP_PLANS:
        if columns is not None:
            monkeypatch.setattr(mode_b_cuda, "ARTIFACT_BLOCK_COLUMNS", columns)
        got = _artifact_kernel_vs_plain(inp, n_d, cuda_device)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)
    monkeypatch.undo()
    monkeypatch.setattr(mode_b_cuda, "smem_limit_bytes", 0)
    assert mode_b_cuda.artifact_plan(L_max, n_d, P, len(inp["int_log"]),
                                     cuda_device) == (1, False)
    _artifact_kernel_vs_plain(inp, n_d, cuda_device)
    assert mode_b_cuda.launches == {
        "mode_b_artifacts": 2 * len(WARP_PLANS) + 2, "mode_b_cols": 0,
        "mode_b_cols_block": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MODE_B_CASES))
def test_mode_b_card_path_equals_plain_versions(cuda_device, case):
    """The default path on the card (both kernels) gives the LLs of the
    same aligner run on the plain versions (artifact tables built on the
    CPU, plain rows on the card) exactly, and the artifact kernel's tables
    equal the plain version's, with its region in shared memory and on the
    workspace."""
    from longtr_tpu_torch.pipeline import mode_b as port_mode_b
    card, alns, seeds = mode_b_case(case, _card_aligner(cuda_device))
    prep = card.score_reads_batch_prepare(alns, seeds)
    assert "A_tab" not in prep
    _artifact_kernel_vs_plain(prep, prep["n_d"], cuda_device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mode_b_cuda, "smem_limit_bytes", 0)
        _artifact_kernel_vs_plain(prep, prep["n_d"], cuda_device)
    mode_b_cuda.reset_launches()
    got = card.score_reads_batch_finish(prep)
    assert mode_b_cuda.launches == {"mode_b_artifacts": 1,
                                    "mode_b_cols": 1, "mode_b_cols_block": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mode_b, "mode_b_cols", mode_b_device.mode_b_cols_plain)
        mp.setattr(card, "artifact_tables", lambda p: torch.from_numpy(
            _plain_artifacts(p, p["n_d"], torch.float32)).to(cuda_device))
        want = card.score_reads_batch(alns, seeds)
    assert sum(mode_b_cuda.launches.values()) == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_mode_b_artifacts_refuses_what_it_cannot_take(cuda_device):
    aligner, tables, ss, L_max, n_d = artifact_case(
        0, _card_aligner(cuda_device))
    g = _artifact_inputs_on(aligner.artifact_inputs(tables, ss, L_max, n_d),
                            cuda_device)
    mode_b_cuda.reset_launches()
    with pytest.raises(ValueError, match="dtype"):
        mode_b_cuda.mode_b_artifacts(*g[:3], g[3].float(), *g[4:], n_d=n_d)
    with pytest.raises(ValueError, match="shape"):
        mode_b_cuda.mode_b_artifacts(*g, n_d=n_d + 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        mode_b_cuda.mode_b_artifacts(*g, n_d=n_d, dtype=torch.float16)
    assert not any(mode_b_cuda.launches.values())


@pytest.mark.gpu
def test_mode_b_artifacts_warp_refuses_shapes_it_cannot_take(cuda_device,
                                                             monkeypatch):
    """A segment's n_d * Lp outputs must index in 32 bits; the plan takes
    at most 16 segments a block, fewer where they do not fit, one on the
    workspace where none fits."""
    with pytest.raises(ValueError, match="32 bits"):
        mode_b_cuda.artifact_plan(2 ** 31 // 13 + 1, 13, 8, 21, cuda_device)
    assert mode_b_cuda.artifact_plan(72, 13, 512, 21, cuda_device) \
        == (2, True)
    assert mode_b_cuda.artifact_plan(20000, 13, 4, 21, cuda_device) \
        == (1, False)
    monkeypatch.setattr(mode_b_cuda, "ARTIFACT_BLOCK_COLUMNS", 10 ** 6)
    G, on_chip = mode_b_cuda.artifact_plan(72, 13, 512, 21, cuda_device)
    assert on_chip and G <= mode_b_cuda._build.load_library() \
        .mode_b_artifacts_max_segments() == 16


# ---------------------------------------------------------------------------
# The window posteriors (J3) and the EM train loop (J4), csrc/em.cu
# ---------------------------------------------------------------------------

# posterior_window: unequal loci, its 2000-read locus large; real: the
# 512-STR catalog's window, (256, 60, 4, 3), every locus small; mixed: one
# R=2000, A=12 locus among 255 small ones
J3_WINDOWS = {"unequal": posterior_window, "real": real_window,
              "mixed": mixed_window}


def _j3_on_card(loci, device):
    """The window kernel and the plain version on the card on ``loci``'s
    padded window: (P, totals) of two launches and of the plain version."""
    arrays, S_max = posterior.pad_window(loci)
    g = [torch.from_numpy(x).to(device) for x in arrays]
    counts = [l["log_aln_probs"].shape[0] for l in loci]
    one = em_cuda.window_posteriors(*g, S_max, counts)
    two = em_cuda.window_posteriors(*g, S_max, counts)
    want_P, want_tot, _ = posterior.calc_log_sample_posteriors(
        *g[:4], S_max, g[5], read_mask=g[4])
    torch.cuda.synchronize()
    return one, two, (want_P, want_tot)


def _assert_loci_close(loci, got, want):
    for i, l in enumerate(loci):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        assert_posteriors_close(got[0][i, :S, :A, :A].cpu(),
                                got[1][i, :S].cpu(),
                                want[0][i, :S, :A, :A].cpu(),
                                want[1][i, :S].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("window", sorted(J3_WINDOWS))
def test_window_posteriors_kernel_matches_plain(cuda_device, window):
    """The window kernel on a padded window equals the plain posteriors on
    the card at the tolerances, locus by locus, in one launch, and a
    second launch gives the same bits."""
    loci = J3_WINDOWS[window]()
    em_cuda.reset_launches()
    one, two, want = _j3_on_card(loci, cuda_device)
    assert em_cuda.launches == {"window_posteriors": 2, "em_train": 0}
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    _assert_loci_close(loci, one, want)


@pytest.mark.gpu
@pytest.mark.parametrize("small_steps", [0, 10 ** 9])
@pytest.mark.parametrize("window", ["real", "unequal"])
def test_window_posteriors_kernel_either_route(cuda_device, monkeypatch,
                                               window, small_steps):
    """Every locus sent to the large route (the real window's three
    samples' warps in J = 5 sub-teams of a block) or to the small one (the
    unequal window's 2000-read locus too): the kernel meets the tolerances
    against the plain version and two launches give the same bits."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", small_steps)
    loci = J3_WINDOWS[window]()
    one, two, want = _j3_on_card(loci, cuda_device)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    _assert_loci_close(loci, one, want)


@pytest.mark.gpu
@pytest.mark.parametrize("small_steps", [0, 10 ** 9])
def test_window_posteriors_kernel_takes_samples_in_batches(
        cuda_device, monkeypatch, small_steps):
    """A 300-sample cohort locus at A=10, whose 30000 float64 sums do not
    fit a block's shared memory: both routes take the samples in batches
    and meet the tolerances against the plain version."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", small_steps)
    loci = [random_case(np.random.default_rng(41), R=1500, A=10, S=300),
            random_case(np.random.default_rng(42), R=90, A=4, S=300)]
    one, two, want = _j3_on_card(loci, cuda_device)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    _assert_loci_close(loci, one, want)


@pytest.mark.gpu
def test_window_posteriors_kernel_maps_many_large_loci(cuda_device,
                                                       monkeypatch):
    """A window of 1100 loci of 5-59 reads, those of more than 30 sent to
    the large route: the kernel finds the clusters' loci past its first
    ballot slice of 512 counts, each locus meets the tolerances against
    the plain version and two launches give the same bits."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", 10)
    rng = np.random.default_rng(51)
    loci = [random_case(rng, R=int(rng.integers(5, 60)), A=4, S=3)
            for _ in range(1100)]
    plan = em_cuda.window_plan(4, 3)
    n_large, _n_small = em_cuda.window_grid(
        plan, [l["log_aln_probs"].shape[0] for l in loci])
    assert plan.small_max == 30 and 300 < n_large < 800
    one, two, want = _j3_on_card(loci, cuda_device)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    _assert_loci_close(loci, one, want)


@pytest.mark.gpu
def test_window_posteriors_kernel_takes_an_infinite_prior(cuda_device):
    """calc_log_sample_posteriors's own inputs for a haploid locus, whose
    heterozygote prior is -inf in float32: the kernel meets the tolerances
    against the plain version on the card."""
    c = random_case(np.random.default_rng(33), R=30, A=6, S=2, haploid=True)
    with np.errstate(over="ignore"):
        prior = posterior.genotype_log_priors(6, True).astype(np.float32)
    assert np.isneginf(prior).any()
    g = [torch.from_numpy(np.asarray(x, np.float32)[None]).to(cuda_device)
         for x in (c["log_aln_probs"], c["log_p1"], c["log_p2"])]
    lab = torch.from_numpy(c["sample_label"].astype(np.int64)[None]).to(
        cuda_device)
    mask = torch.ones_like(lab, dtype=torch.bool)
    pr = torch.from_numpy(prior[None]).to(cuda_device)
    P, tot = em_cuda.window_posteriors(*g, lab, mask, pr, 2, [30])
    want_P, want_tot, _ = posterior.calc_log_sample_posteriors(
        *g, lab, 2, pr, read_mask=mask)
    assert_posteriors_close(P[0].cpu(), tot[0].cpu(), want_P[0].cpu(),
                            want_tot[0].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("window", sorted(J3_WINDOWS))
def test_window_posteriors_mesh_bit_identical(cuda_device, window, shards):
    """batched_posteriors on one card and split over a mesh of shards of
    it: one launch a shard that holds loci, the same bits."""
    loci = J3_WINDOWS[window]()
    em_cuda.reset_launches()
    one = posterior.batched_posteriors(loci, cuda_device)
    assert em_cuda.launches["window_posteriors"] == 1
    many = posterior.batched_posteriors(loci,
                                        mesh=pm.Mesh([cuda_device] * shards))
    step = -(-len(loci) // shards)
    assert em_cuda.launches["window_posteriors"] == \
        1 + len(range(0, len(loci), step))
    for (P, t), (Pm, tm) in zip(one, many):
        assert np.array_equal(P, Pm) and np.array_equal(t, tm)


def em_branch_of(tables, shards, device):
    """em_cuda.em_branch for em_train_sharded's arguments on ``shards``."""
    arrays = pm.em_tables(*tables[:9], shards)
    S = tables[10]
    return em_cuda.em_branch(np.shape(tables[0])[1], S, shards,
                             em_cuda.em_layout(arrays[5], arrays[9], shards,
                                               S), device)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", ["diploid", "haploid", "max_iter"])
def test_em_train_kernel_matches_plain(cuda_device, name, shards):
    """em_train_sharded on a mesh of shards of the card, its terms kept in
    shared memory: one launch a train, the same bits from launch to
    launch, the full tolerances against the plain loop on as many shards
    of the card, and the cross-shard criterion ((converged, n_iter) equal,
    parameters within 1e-5) against the plain loop on as many CPU
    shards."""
    tables, max_iter = em_case(name)
    args = (*tables, max_iter, 0.01, 0.001)
    mesh = pm.Mesh([cuda_device] * shards)
    assert em_branch_of(tables, shards, cuda_device) == "kept"
    em_cuda.reset_launches()
    got = pm.em_train_sharded(mesh, *args)
    again = pm.em_train_sharded(mesh, *args)
    assert em_cuda.launches == {"window_posteriors": 0, "em_train": 2}
    assert (got[0], got[2]) == (again[0], again[2])
    for a, b in zip((got[1], got[3], got[4]), (again[1], again[3],
                                               again[4])):
        np.testing.assert_array_equal(a, b)
    assert got[0] == (name != "max_iter")
    assert_em_close(got, plain_em_train(mesh, tables, max_iter, 0.01, 0.001))
    same = pm.em_train_sharded(pm.Mesh(["cpu"] * shards), *args)
    assert (got[0], got[2]) == (same[0], same[2])
    np.testing.assert_allclose(got[1], same[1], rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", ["diploid", "haploid", "max_iter",
                                  "realistic"])
def test_em_train_kernel_branches_agree(cuda_device, monkeypatch, name,
                                        shards):
    """The branch that recomputes the terms (forced by a shared-memory
    limit of 0) gives the bits of the branch that keeps them, one launch
    a train each."""
    if name == "realistic":
        tables, max_iter = realistic_em_locus()().mesh_inputs(), 100
    else:
        tables, max_iter = em_case(name)
    args = (*tables, max_iter, 0.01, 0.001)
    mesh = pm.Mesh([cuda_device] * shards)
    assert em_branch_of(tables, shards, cuda_device) == "kept"
    em_cuda.reset_launches()
    kept = pm.em_train_sharded(mesh, *args)
    monkeypatch.setattr(em_cuda, "smem_limit_bytes", 0)
    assert em_branch_of(tables, shards, cuda_device) == "recomputed"
    recomputed = pm.em_train_sharded(mesh, *args)
    assert em_cuda.launches["em_train"] == 2
    assert (kept[0], kept[2]) == (recomputed[0], recomputed[2])
    for a, b in zip(kept[1:], recomputed[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
def test_em_train_kernel_realistic_locus(cuda_device, shards):
    """The realistic locus (R=2000, A=12, S=3), its terms kept: one launch
    a train, two launches bit-identical, (converged, n_iter) = (True, 7)
    as on as many CPU shards and as the plain loop on the card, parameters
    and posterior probabilities within 1e-5 of both.  (Its log-posteriors,
    up to ~2e4 in magnitude, cannot meet rtol 1e-6 / atol 1e-4 between two
    float32 orders: tests/test_torch_em_kernel.py.)"""
    tables = realistic_em_locus()().mesh_inputs()
    args = (*tables, 100, 0.01, 0.001)
    mesh = pm.Mesh([cuda_device] * shards)
    assert em_branch_of(tables, shards, cuda_device) == "kept"
    em_cuda.reset_launches()
    got = pm.em_train_sharded(mesh, *args)
    again = pm.em_train_sharded(mesh, *args)
    assert em_cuda.launches["em_train"] == 2
    for a, b in zip(got[1:], again[1:]):
        np.testing.assert_array_equal(a, b)
    for want in (pm.em_train_sharded(pm.Mesh(["cpu"] * shards), *args),
                 plain_em_train(mesh, tables, 100, 0.01, 0.001)):
        assert (got[0], got[2]) == (want[0], want[2]) == (True, 7)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.exp(got[3]), np.exp(want[3]), rtol=0,
                                   atol=1e-5)


@pytest.mark.gpu
def test_em_train_kernel_first_iteration_and_no_budget(cuda_device):
    """The first iteration's NaN frac_change cannot stop the train: a
    one-step budget ends unconverged; no budget runs nothing and returns
    the initial parameters and zero posteriors."""
    tables, _ = em_case("diploid")
    mesh = pm.Mesh([cuda_device] * 2)
    got = pm.em_train_sharded(mesh, *tables, 1, 1e9, 1e9)
    assert (got[0], got[2]) == (False, 1)
    assert_em_close(got, plain_em_train(mesh, tables, 1, 1e9, 1e9))
    zero = pm.em_train_sharded(mesh, *tables, 0, 0.01, 0.001)
    assert zero[:1] == (False,) and zero[2] == 0
    assert not zero[3].any() and not zero[4].any()
    np.testing.assert_array_equal(
        zero[1], np.float32([0.9, 0.1, 0.1, 0.8, 0.01, 0.01]))


@pytest.mark.gpu
def test_em_train_kernel_many_samples(cuda_device):
    """A cohort whose terms and posteriors do not fit the blocks' shared
    memory: the kernel recomputes the terms and reads the posteriors from
    device memory, one launch a train, the same bits twice.  It meets
    the full tolerances against the plain loop on as many CPU shards, and
    against the plain loop on the card (another float32 order of the same
    sums, which on this cohort is itself as far from CPU shards as the
    bound) (converged, n_iter) equal, parameters and posterior
    probabilities within 1e-5."""
    tables = cohort_case()
    assert em_branch_of(tables, 2, cuda_device) == "recomputed"
    args = (*tables, 100, 0.01, 0.001)
    mesh = pm.Mesh([cuda_device] * 2)
    em_cuda.reset_launches()
    got = pm.em_train_sharded(mesh, *args)
    again = pm.em_train_sharded(mesh, *args)
    assert em_cuda.launches["em_train"] == 2
    for a, b in zip(got[1:], again[1:]):
        np.testing.assert_array_equal(a, b)
    assert_em_close(got, pm.em_train_sharded(pm.Mesh(["cpu"] * 2), *args))
    want = plain_em_train(mesh, tables, 100, 0.01, 0.001)
    assert (got[0], got[2]) == (want[0], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.exp(got[3]), np.exp(want[3]), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
def test_em_kernels_refuse_what_they_cannot_take(cuda_device):
    tables, _ = em_case("haploid")
    R, A = np.shape(tables[0])
    rep = torch.from_numpy(np.asarray(tables[0], np.int32)).to(cuda_device)
    eff = torch.from_numpy(np.asarray(tables[1], np.int32)).to(cuda_device)
    inf = torch.from_numpy(np.asarray(tables[2], bool)).to(cuda_device)
    p1, p2, wi, wo = (torch.from_numpy(np.asarray(x, np.float32)).to(
        cuda_device) for x in (tables[3], tables[4], tables[7], tables[8]))
    lab = torch.from_numpy(np.asarray(tables[5], np.int64)).to(cuda_device)
    cat = torch.from_numpy(np.asarray(tables[6], np.int32)).to(cuda_device)
    valid = torch.ones(R, dtype=torch.bool, device=cuda_device)
    init = torch.from_numpy(np.asarray(tables[9], np.float32)).to(cuda_device)
    kw = dict(num_samples=tables[10], haploid=True, max_iter=5, min_abs=0.01,
              min_frac=0.001, layout=em_cuda.em_layout(tables[5], np.ones(R),
                                                       1, tables[10]))
    em_cuda.reset_launches()
    with pytest.raises(ValueError, match="dtype"):
        em_cuda.em_train(rep, eff, inf, p1, p2, lab, cat, wi.double(), wo,
                         valid, init, n_shards=1, **kw)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        em_cuda.em_train(rep, eff, inf, p1, p2, lab, cat, wi, wo, valid,
                         init, n_shards=R + 1, **kw)
    window = [torch.zeros((1, 4, 2), device=cuda_device),
              torch.zeros((1, 4), device=cuda_device),
              torch.zeros((1, 4), device=cuda_device),
              torch.zeros((1, 4), dtype=torch.int64, device=cuda_device),
              torch.ones((1, 4), dtype=torch.bool, device=cuda_device),
              torch.zeros((1, 2, 2), device=cuda_device)]
    with pytest.raises(ValueError, match="dtype"):
        em_cuda.window_posteriors(*window[:3], window[3].int(), *window[4:],
                                  1, [4])
    with pytest.raises(ValueError, match="counts"):
        em_cuda.window_posteriors(*window, 1, [5])
    with pytest.raises(ValueError, match="counts"):
        em_cuda.window_posteriors(*window, 1, [4, 4])
    with pytest.raises(ValueError, match="counts"):
        em_cuda.window_posteriors(*window, 1, [-1])
    with pytest.raises(ValueError, match="shape"):
        em_cuda.window_posteriors(*window[:5], window[5][:, :1], 1, [4])
    assert not any(em_cuda.launches.values())
