"""The port's mode B (longtr_tpu_torch.pipeline.mode_b and the plain torch
rows of ops.mode_b_device) against longtr_tpu's, on the CPU.

* The host phase's table dict equals longtr_tpu's array for array, and
  the artifact tables the finish phase builds from it (on the CPU, the plain
  torch version) equal longtr_tpu's wherever an element reads them (the port
  keeps one table per (side, block, option, read) and an index per element,
  where longtr_tpu copies a table per element); also at the mode-B cell's scale
  (``hp_mix_scale``).  Its array operations give every key, dtype and value of
  the loop over bases and (read, config, side) rows they replace, kept at the
  end of this file as the oracle.
* float64: the plain rows equal the host numpy transcription
  (``_align_short``, itself held to HapAligner.cpp) on every real row,
  tolerance 0, and the marginalized LLs equal both the host ``score_read``
  and longtr_tpu's batched f64 LLs exactly.  Against longtr_tpu's jnp row
  scan the columns agree to rtol 1e-12, not exactly: XLA's float64 exp and
  log on the CPU differ from glibc's (which numpy and torch use) in the
  last bit on ~15% and ~0.05% of inputs, and a stutter row passes that on.
* float32: the LLs lie within rtol 1e-4, atol 1e-4 of longtr_tpu's float32
  device LLs and of the host f64, the JAX package's own bound
  (tests/test_mode_b_device.py): float32 exp/log in XLA and in torch
  differ in the last bit on ~10% of inputs.

The fixtures live in tests/test_torch_cuda.py, whose `gpu` tests hold the
CUDA kernels to the plain versions bit for bit on a card;
tests/test_torch_mode_b_artifacts.py holds the plain artifact tables to
longtr_tpu's table code.
"""

import copy
import functools
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from longtr_tpu.ops.mode_b_device import mode_b_cols as jax_mode_b_cols
from longtr_tpu.pipeline.mode_b import ModeBAligner as JaxAligner
from longtr_tpu_torch.ops import mode_b_cuda, mode_b_device
from longtr_tpu_torch.ops.mode_b_artifacts import prefix_doubles
from longtr_tpu_torch.ops.mode_b_device import _pad_to
from longtr_tpu_torch.pipeline import mode_b as port_mode_b
from longtr_tpu_torch.pipeline.mode_b import ModeBAligner as PortAligner
from longtr_tpu_torch.utils.base_quality import log_prob_correct, log_prob_error
from longtr_tpu_torch.utils.mathops import int_log

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import (MODE_B_CASES, TABLE_KEYS, homopolymer_hap,  # noqa: E402
                             homopolymer_read, mode_b_case, port_classes,
                             synthetic_tables)

CASES = sorted(MODE_B_CASES)
# MODE_B_CASES and a case at the mode-B cell's scale, for the host phase
# alone (the host matrices of test_mode_b_cols_f64_exact would take minutes)
PREPARE_CASES = CASES + ["hp_mix_scale"]
# the port's aligner on the CPU (its default device is the card)
ModeBAligner = functools.partial(PortAligner, device="cpu")


def jax_classes():
    """The JAX package's classes: its side of a case builds its own
    haplotypes and reads from the same seeded draws as the port's."""
    from longtr_tpu.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
    from longtr_tpu.models.stutter import default_stutter_model
    from longtr_tpu.pipeline.alignment import Alignment
    from longtr_tpu.pipeline.mode_b import calc_seed_base
    return types.SimpleNamespace(
        HapBlock=HapBlock, Haplotype=Haplotype, RepeatBlock=RepeatBlock,
        default_stutter_model=default_stutter_model, Alignment=Alignment,
        calc_seed_base=calc_seed_base)


def _port_cols(prep):
    return mode_b_device.mode_b_cols(
        *[torch.from_numpy(np.ascontiguousarray(prep[k])) for k in TABLE_KEYS],
        n_d=prep["n_d"]).numpy()


def per_element_tables(prep):
    """longtr_tpu's (B, S, n_d, L) layout of the port's indexed tables."""
    return prep["A_tab"][prep["tab"]]


def prepare_with_tables(aligner, alns, seeds, dtype):
    """The host phase's dict with the artifact tables the finish phase
    builds from it (``artifact_tables``: on the CPU the plain version) as
    ``A_tab``, in numpy."""
    prep = aligner.score_reads_batch_prepare(alns, seeds, dtype)
    prep["A_tab"] = aligner.artifact_tables(prep).numpy()
    return prep


def _jax_cols(prep):
    args = [per_element_tables(prep) if k == "A_tab" else prep[k]
            for k in TABLE_KEYS if k != "tab"]
    if prep["lc_tab"].dtype == np.float64:
        with jax.enable_x64():
            return np.asarray(jax_mode_b_cols(*args, n_d=prep["n_d"]))
    return np.asarray(jax_mode_b_cols(*args, n_d=prep["n_d"]))


def hp_mix_scale(cls):
    """A locus of the mode-B cell's shape (``hp_mix``): one T-homopolymer
    with four alleles between 500-base flanks, 44 reads of unequal length
    (each starts and ends at its own place in the flanks), their seeds in
    a flank so that both segments run 250-500 bases, but one read seeded
    at base 1 and one at its length - 2.  Returns (haplotype, alignments,
    seeds)."""
    rng = np.random.default_rng(2101)
    fl = "".join(rng.choice(list("ACGT"), 500))
    fr = "".join(rng.choice(list("ACGT"), 500))
    alleles = [14, 11, 17, 15]
    hap = homopolymer_hap(alleles, fl, fr, cls=cls)
    alns, seeds = [], []
    for i in range(44):
        copies = int(rng.choice(alleles))
        if i < 2:          # short reads: one segment of one base
            a, e = 250, 230
        else:
            a, e = int(rng.integers(0, 241)), int(rng.integers(260, 481))
        aln = homopolymer_read(copies, fl[a:], fr[:e], rng, ref_copies=14,
                               cls=cls)
        n, rep = len(aln.sequence), (len(fl) - a, len(fl) - a + copies)
        if i < 2:
            seeds.append(1 if i == 0 else n - 2)
        else:
            lo, hi = max(250, n - 501), min(500, n - 251)
            seed = rep[0]
            while rep[0] <= seed < rep[1]:
                seed = int(rng.integers(lo, hi + 1))
            seeds.append(seed)
        alns.append(aln)
    return hap, alns, seeds


def prepare_case(name, aligner_cls, cls=None):
    """(aligner, alignments, seeds) of a case of PREPARE_CASES, its objects
    of ``cls``'s classes (default the port's)."""
    if name in MODE_B_CASES:
        return mode_b_case(name, aligner_cls, cls)
    hap, alns, seeds = hp_mix_scale(cls or port_classes())
    return aligner_cls(hap), alns, seeds


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_tables_equal_jax(case):
    port, alns, seeds = prepare_case(case, ModeBAligner)
    jaxa, jalns, jseeds = prepare_case(case, JaxAligner, jax_classes())
    assert jseeds == seeds
    for dtype in (np.float32, np.float64):
        got = prepare_with_tables(port, alns, seeds, dtype)
        want = jaxa.score_reads_batch_prepare(jalns, jseeds, dtype)
        assert set(want) - set(got) == {"A"}
        for k, v in want.items():
            if isinstance(v, np.ndarray) and k != "A":
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        # the artifact tables every element's stutter rows read
        assert got["A_tab"].dtype == want["A"].dtype
        for (p, k, side), b in got["elem"].items():
            n_s = len(got["sides"][k][side][3])
            np.testing.assert_array_equal(
                got["A_tab"][got["tab"][b, :n_s]], want["A"][b, :n_s])
        for k in ("n_d", "P", "K", "elem", "configs", "seeds"):
            assert got[k] == want[k], k


@pytest.mark.parametrize("case", CASES)
def test_mode_b_cols_f64_exact(case):
    aligner, alns, seeds = mode_b_case(case, ModeBAligner)
    prep = prepare_with_tables(aligner, alns, seeds, np.float64)
    cols = _port_cols(prep)
    assert cols.dtype == np.float64
    # every real (read, config, side) element's rows == the host matrices'
    # last columns; repeat-block interior rows (kind 3) carry M on the
    # device and stay IMPOSSIBLE on the host, and nothing reads them
    for (p, k, side), b in prep["elem"].items():
        seq, blw, blc, _q = prep["segs"][p]
        s = seeds[p]
        config = prep["configs"][k]
        if side == 0:
            sl = slice(0, s)
            M = aligner._align_short(aligner.fw_blocks, aligner._fw_stutter,
                                     config, seq[sl], blw[sl], blc[sl])[0]
        else:
            M = aligner._align_short(aligner.rev_blocks, aligner._rev_stutter,
                                     tuple(reversed(config)), seq[s + 1:][::-1],
                                     blw[s + 1:][::-1], blc[s + 1:][::-1])[0]
        rows = np.flatnonzero(prep["kind"][b, :M.shape[0]] != 3)
        assert rows[0] == 1 and (prep["kind"][b, rows] == 2).sum() == 1
        np.testing.assert_array_equal(cols[b, 0], M[0, -1])
        np.testing.assert_array_equal(cols[b, rows], M[rows, -1])
    np.testing.assert_allclose(cols, _jax_cols(prep), rtol=1e-12, atol=0)
    got = aligner.score_reads_batch(alns, seeds, dtype=np.float64)
    host = np.stack([aligner.score_read(a, s) for a, s in zip(alns, seeds)])
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        got, jaxa.score_reads_batch(jalns, jseeds, dtype=np.float64))


@pytest.mark.parametrize("case", CASES)
def test_mode_b_f32_close(case):
    aligner, alns, seeds = mode_b_case(case, ModeBAligner)
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    got = aligner.score_reads_batch(alns, seeds)
    want = jaxa.score_reads_batch(jalns, jseeds)
    host = np.stack([aligner.score_read(a, s) for a, s in zip(alns, seeds)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, host, rtol=1e-4, atol=1e-4)


def test_synthetic_tables_vs_jax():
    """Every row kind, several stutter ordinals and `last` anywhere: the
    plain rows against the jnp scan (tolerances as above)."""
    rng = np.random.default_rng(11)
    for dtype, rtol, atol in ((np.float64, 1e-12, 0), (np.float32, 1e-4, 1e-4)):
        prep = synthetic_tables(rng, 6, 45, 28, 3, 9, dtype)
        got, want = _port_cols(prep), _jax_cols(prep)
        assert got.dtype == dtype and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_envelope_empty_allele_returns_none():
    """A config with an empty repeat allele is outside the row tables'
    envelope: the batch declines, and the caller scores on the host."""
    from longtr_tpu_torch.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
    from longtr_tpu_torch.models.stutter import default_stutter_model
    from longtr_tpu_torch.pipeline.mode_b import calc_seed_base
    sm = default_stutter_model().with_period(1)
    rb = RepeatBlock(100, 106, "TTTTTT", 1, sm)
    rb.add_alternate("")
    hap = Haplotype([HapBlock(90, 100, "ACGTTGCAGC"), rb,
                     HapBlock(106, 116, "GTCAGGCTAT")])
    aligner = ModeBAligner(hap)
    aln = homopolymer_read(6, "ACGTTGCAGC", "GTCAGGCTAT",
                           np.random.default_rng(1), err=0.0, ref_copies=6)
    seed = calc_seed_base(aln, aligner.repeat_starts, aligner.repeat_ends,
                          hap.blocks[0].start, hap.blocks[-1].end)
    assert seed >= 0
    assert aligner.score_reads_batch([aln], [seed]) is None


def test_genotype_direct_call_runs_deferred_finish():
    """genotype() runs a deferred mode-B finish itself: genotype_prepare
    leaves the device work to the cross-locus scheduler, which a direct
    caller does not have."""
    from longtr_tpu_torch.pipeline.seq_genotyper import SeqStutterGenotyper

    gt = object.__new__(SeqStutterGenotyper)
    scores = np.zeros((3, 2))
    ran = []

    def prepare(max_total_haplotypes=1000):
        gt._mode_b_finish = lambda: (ran.append(1), scores)[1]
        return True, None

    gt.genotype_prepare = prepare
    gt.genotype_finalize = lambda **kw: True
    assert gt.genotype() is True
    assert ran == [1]
    assert gt._pool_scores is scores
    assert gt._mode_b_finish is None


def test_cpu_routes_to_plain():
    """On CPU tensors both the router and the kernel's wrapper run the
    plain rows; the router counts the elements, no kernel is launched."""
    prep = synthetic_tables(np.random.default_rng(3), 4, 24, 12, 1, 5)
    g = [torch.from_numpy(np.ascontiguousarray(prep[k])) for k in TABLE_KEYS]
    want = mode_b_device.mode_b_cols_plain(*g, n_d=5)
    before = dict(mode_b_device.mode_b_elements_scored)
    mode_b_cuda.reset_launches()
    assert torch.equal(mode_b_device.mode_b_cols(*g, n_d=5), want)
    assert torch.equal(mode_b_cuda.mode_b_cols(*g, n_d=5), want)
    moved = {k: v - before[k]
             for k, v in mode_b_device.mode_b_elements_scored.items()}
    assert moved == {"cuda": 0, "cpu": 4, "host_f64": 0}
    assert not any(mode_b_cuda.launches.values())


def test_score_read_prefers_matching_allele():
    """The port's host transcription picks the read's allele (as
    tests/test_mode_b.py holds for longtr_tpu's)."""
    from longtr_tpu_torch.pipeline.mode_b import calc_seed_base
    fl, fr = "ACGTTGCAGC", "GTCAGGCTAT"
    hap = homopolymer_hap([12, 9, 15], fl, fr)
    aligner = ModeBAligner(hap)
    h2a = hap.haps_to_alleles(1)
    rng = np.random.default_rng(4)
    for allele, copies in ((0, 12), (1, 9), (2, 15)):
        aln = homopolymer_read(copies, fl, fr, rng, err=0.0)
        seed = calc_seed_base(aln, aligner.repeat_starts, aligner.repeat_ends,
                              hap.blocks[0].start, hap.blocks[-1].end)
        scores = aligner.score_read(aln, seed)
        assert h2a[int(np.argmax(scores))] == allele
        batch = aligner.score_reads_batch([aln], [seed], np.float64)
        np.testing.assert_array_equal(batch[0], scores)


def with_seed_chars(aligner, alns, seeds):
    """The case's reads with the seed base of read 0 set to the haplotype's
    first base, of read 1 to its last and of read 2 to a base that is
    neither; the others keep theirs.  The row DP never reads a seed base,
    only the marginalization does."""
    fw = aligner.fw_blocks
    first, last = fw[0].get_seq(0)[0], fw[-1].get_seq(0)[-1]
    forced = [first, last, next(c for c in "ACGT" if c not in (first, last))]
    out = []
    for p, (aln, s) in enumerate(zip(alns, seeds)):
        aln = copy.copy(aln)
        if p < len(forced):
            aln.sequence = aln.sequence[:s] + forced[p] + aln.sequence[s + 1:]
        out.append(aln)
    return out, (first, last)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_marginalize_equals_the_per_read_walk(case, dtype, monkeypatch):
    """The finish phase's one array pass over a locus's (read, config)
    seed entries gives, bit for bit, ``compute_aln_logprob`` called per
    read and config on the same row DP columns: configs of unequal
    haplotype sizes, seed bases equal to the boundary bases and to
    neither."""
    aligner, alns, seeds = mode_b_case(case, ModeBAligner)
    alns, (first, last) = with_seed_chars(aligner, alns, seeds)
    prep = aligner.score_reads_batch_prepare(alns, seeds, dtype)
    sizes = {fw[4] for fw, _rv, _seqs in prep["sides"]}
    assert len(sizes) == prep["K"] > 1
    chars = [aln.sequence[s] for aln, s in zip(alns, seeds)]
    assert chars[0] == first and chars[1] == last
    assert chars[2] not in (first, last)
    seen = []
    row_dp = port_mode_b.mode_b_cols
    monkeypatch.setattr(port_mode_b, "mode_b_cols",
                        lambda *a, **kw: seen.append(row_dp(*a, **kw))
                        or seen[-1])
    got = aligner.score_reads_batch_finish(prep)
    cols = seen[0].numpy().astype(np.float64)
    want = np.empty((prep["P"], prep["K"]))
    for p, (aln, s) in enumerate(zip(alns, seeds)):
        seq, blw, blc, _q = prep["segs"][p]
        for k in range(prep["K"]):
            want[p, k] = aligner.compute_aln_logprob(
                len(seq), s, seq[s], blw[s], blc[s],
                cols[prep["elem"][(p, k, 0)]], prep["lprob"][p, 0],
                cols[prep["elem"][(p, k, 1)]], prep["lprob"][p, 1],
                prep["sides"][k][2])
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def lse_columns(name):
    """(entries, real entries a column) of a case of
    test_fast_lse_cols_equals_fast_lse: random columns around the named
    one, which is column 3."""
    from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
    from longtr_tpu_torch.utils.mathops import LOG_THRESH
    rng = np.random.default_rng(23)
    E = rng.uniform(-12, 0, size=(9, 6))
    n = np.full(6, 9)
    if name == "impossible":
        E[:, 3] = IMPOSSIBLE
    elif name == "minus_inf":
        E[:, 3] = -np.inf
    elif name == "trailing_padding":
        n[3:] = (4, 2, 7)
        E[np.arange(9)[:, None] >= n] = -np.inf
        E[1, 4] = IMPOSSIBLE
    else:                 # terms above, at (dropped: > is strict) and below
        E[:, 3] = LOG_THRESH * np.array([0, .5, 1, .99, 1.5, 3, 1, 1.01, 50])
    return E, n


@pytest.mark.parametrize("fidelity", [False, True])
@pytest.mark.parametrize("name", ["impossible", "minus_inf",
                                  "trailing_padding", "below_thresh"])
def test_fast_lse_cols_equals_fast_lse(name, fidelity):
    """The column log-sum-exp on an (entries, columns) array gives each
    column the bits of ``fast_lse`` on that column's real entries, with
    trailing -inf padding past them, in both math modes."""
    import warnings

    from longtr_tpu_torch.ops.stutter_hmm import fast_lse, fast_lse_cols
    from longtr_tpu_torch.utils import mathops
    E, n = lse_columns(name)
    mathops.set_ref_fidelity(fidelity)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = fast_lse_cols(E)
            want = np.array([fast_lse(E[:n[c], c]) for c in range(E.shape[1])])
            as_list = fast_lse_cols(list(E))
    finally:
        mathops.set_ref_fidelity(False)
    assert got.dtype == np.float64 and got.shape == (E.shape[1],)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.array_equal(as_list.view(np.int64), want.view(np.int64))


# ---------------------------------------------------------------------------
# The host phase's array operations against its loop, as it was written
# before them, copied here unchanged.

def prepare_per_row(aligner, alns, seeds, dtype=np.float32):
    """``ModeBAligner.score_reads_batch_prepare`` as a loop over bases and
    over (read, config, side) rows: the oracle of its array operations,
    which have to give every key, dtype and value of it."""
    configs = list(aligner.hap.all_configs())
    K = len(configs)
    sides = []                                   # per (k, side) rows
    n_d = 1
    for k, config in enumerate(configs):
        rev_config = tuple(reversed(config))
        fw_seqs = [b.get_seq(c) for b, c in zip(aligner.fw_blocks, config)]
        rv_seqs = [b.get_seq(c) for b, c in
                   zip(aligner.rev_blocks, rev_config)]
        fw = aligner._row_tables(aligner.fw_blocks, config, fw_seqs)
        rv = aligner._row_tables(aligner.rev_blocks, rev_config, rv_seqs)
        if fw is None or rv is None:
            return None
        sides.append((fw, rv, fw_seqs))
    for b in aligner.fw_blocks:
        if b.repeat_info is not None:
            n_d = max(n_d, len(range(b.max_del, b.max_ins + 1, b.period)))
    S_max = max(len(t[0][3]) for t in sides) or 1
    R_max = _pad_to(max(max(t[0][4], t[1][4]) for t in sides), 8)

    P = len(alns)
    segs = []                                    # per (p, side) read data
    for aln in alns:
        quals = aln.base_qualities
        blw = np.array([log_prob_error(q) for q in quals])
        blc = np.array([log_prob_correct(q) for q in quals])
        segs.append((aln.sequence, blw, blc, quals))
    L_max = _pad_to(max(max(s, len(segs[p][0]) - s - 1)
                        for p, s in enumerate(seeds)), 8)

    def seg_arrays(p, side):
        seq, blw, blc, quals = segs[p]
        s = seeds[p]
        if side == 0:
            sseq, sw, sc = seq[:s], blw[:s], blc[:s]
            squal = quals[:s]
        else:
            sseq = seq[s + 1:][::-1]
            sw = blw[s + 1:][::-1]
            sc = blc[s + 1:][::-1]
            squal = quals[s + 1:][::-1]
        L = len(sseq)
        codes = np.zeros(L_max, dtype=np.uint8)
        codes[:L] = np.frombuffer(sseq.encode(), dtype=np.uint8)
        # qual BYTES ship to the device; the kernel gathers the f32/f64
        # log-prob values from 256-entry tables (bitwise-equal to the
        # host lookup — log_prob_* is itself a clamped table,
        # base_quality.py).  Pad bytes land on arbitrary table entries;
        # columns past `last` never feed a valid column (the DP only
        # reads left-to-right along j), so pad values are don't-cares.
        qb = np.zeros(L_max, dtype=np.uint8)
        qb[:L] = np.frombuffer(squal.encode("latin1"), dtype=np.uint8)
        cs = np.cumsum(sc)
        pre = np.zeros(L_max)
        pre[1:L] = cs[:-1]
        lp = float(cs[-1]) if L else 0.0
        return sseq, sw, sc, codes, qb, pre, lp, L

    B = P * K * 2
    B_pad = _pad_to(B, 32)
    # The batched device inputs are allocated in the final device dtype:
    # assignment casts each f64 row exactly as a whole-array astype would
    # at dispatch, so the finish phase copies them to the device as they
    # are.  Narrow byte formats (uint8 codes/quals/row tables, the
    # per-base log-probs as 256-entry gather tables) keep the copy
    # small, and each is exact: the device gathers the same dtype values.
    codes = np.zeros((B_pad, L_max), dtype=np.uint8)
    quals_a = np.zeros((B_pad, L_max), dtype=np.uint8)
    pre_a = np.zeros((B_pad, L_max), dtype=dtype)
    last = np.zeros(B_pad, dtype=np.int32)
    hapchar = np.zeros((B_pad, R_max), dtype=np.uint8)
    kind = np.full((B_pad, R_max), 3, dtype=np.uint8)
    stut_ord = np.zeros((B_pad, R_max), dtype=np.uint8)
    tab = np.zeros((B_pad, S_max), dtype=np.int32)
    bl_a = np.ones((B_pad, S_max), dtype=np.int32)
    d0_a = np.zeros((B_pad, S_max), dtype=np.int32)
    dstep_a = np.ones((B_pad, S_max), dtype=np.int32)
    lprob = np.zeros((P, 2))

    seg_cache = {}
    side_segs = {0: [], 1: []}      # (bases, quality bytes) per segment
    for p in range(P):
        for side in (0, 1):
            arrs = seg_cache[(p, side)] = seg_arrays(p, side)
            L = arrs[7]
            side_segs[side].append((arrs[3][:L], arrs[4][:L]))
    # one artifact table per (side, block, option) and read segment:
    # table t of segment p is row t * P + p of the device's tables
    needed = sorted({(side, bi, opt)
                     for k in range(K) for side in (0, 1)
                     for (bi, opt) in sides[k][side][3]})
    t_index = {key: t for t, key in enumerate(needed)}
    art = artifact_inputs_per_segment(aligner, needed, side_segs, L_max, n_d)
    b = 0
    elem = {}
    elements_real = 0          # (column, row, artifact size) a segment
    for p in range(P):
        for k in range(K):
            for side in (0, 1):
                fw, rv, _seqs = sides[k]
                rows = fw if side == 0 else rv
                blocks = aligner.fw_blocks if side == 0 else aligner.rev_blocks
                (sseq, sw, sc, cod, qb, pre, lp, L) = seg_cache[(p, side)]
                codes[b] = cod
                quals_a[b] = qb
                pre_a[b] = pre
                last[b] = max(L - 1, 0)
                hc, kd, so, sinfo, hs = rows
                hapchar[b, :hs] = hc
                kind[b, :hs] = kd
                stut_ord[b, :hs] = so
                lprob[p, side] = lp
                elements_real += L * hs * max(
                    [1] + [len(range(blocks[bi].max_del,
                                     blocks[bi].max_ins + 1,
                                     blocks[bi].period))
                           for bi, _opt in sinfo])
                for s_i, (bi, opt) in enumerate(sinfo):
                    tab[b, s_i] = t_index[(side, bi, opt)] * P + p
                    blk = blocks[bi]
                    bl_a[b, s_i] = len(blk.get_seq(opt))
                    d0_a[b, s_i] = blk.max_del
                    dstep_a[b, s_i] = blk.period
                elem[(p, k, side)] = b
                b += 1

    params = np.array([aligner.i2i, aligner.i2m, aligner.d2d, aligner.d2m,
                       aligner.m2m, aligner.m2i, aligner.m2d], dtype=dtype)
    prep = dict(codes=codes, quals_a=quals_a,
                lw_tab=art["lw64"].astype(dtype),
                lc_tab=art["lc64"].astype(dtype), pre_a=pre_a, last=last,
                hapchar=hapchar, kind=kind,
                stut_ord=stut_ord, tab=tab, bl_a=bl_a, d0_a=d0_a,
                dstep_a=dstep_a, params=params, n_d=n_d, dtype=dtype,
                alns=alns, seeds=seeds, segs=segs, configs=configs,
                sides=sides, elem=elem, lprob=lprob, P=P, K=K,
                elements_real=elements_real,
                elements_launched=B_pad * L_max * R_max * n_d, **art)
    return prep


def artifact_inputs_per_segment(aligner, tables, side_segs, L_max, n_d):
    """``ModeBAligner.artifact_inputs`` as a loop over segments, the
    oracle's."""
    P = len(side_segs[0])
    seg_codes = np.zeros((2, P, L_max), dtype=np.uint8)
    seg_quals = np.zeros((2, P, L_max), dtype=np.uint8)
    seg_len = np.zeros((2, P), dtype=np.int32)
    for side in (0, 1):
        for p, (cod, qb) in enumerate(side_segs[side]):
            L = len(cod)
            seg_codes[side, p, :L] = cod[:L][::-1]
            seg_quals[side, p, :L] = qb[:L][::-1]
            seg_len[side, p] = L
    needed = list(tables)
    T = len(needed)
    tdesc = np.zeros((T, 9), dtype=np.int32)
    priors = np.zeros((T, n_d))
    blk_parts, up_parts = [], []
    blk_off = up_off = 0
    n_log = 2
    for t, (side, bi, opt) in enumerate(needed):
        blocks = aligner.fw_blocks if side == 0 else aligner.rev_blocks
        saln = aligner._fw_stutter if side == 0 else aligner._rev_stutter
        blk, sa = blocks[bi], saln[bi][opt]
        d_list = list(range(blk.max_del, blk.max_ins + 1, blk.period))
        if 1 + max(sa.num_deletions, 1) + max(sa.num_insertions, 1) \
                > prefix_doubles(n_d):
            raise ValueError(f"block {bi} option {opt}: deletion and "
                             "insertion multiples exceed the artifact "
                             "sizes")
        tdesc[t] = (side, sa.block_len, blk.period, blk.max_del,
                    len(d_list), sa.num_deletions, sa.num_insertions,
                    blk_off, up_off)
        for di, D in enumerate(d_list):
            priors[t, di] = blk.log_prob_pcr_artifact(opt, D)
        blk_parts.append(np.frombuffer(sa.block_seq[::-1].encode(),
                                       dtype=np.uint8))
        ups = np.concatenate([np.asarray(u, dtype=np.int64)
                              for u in sa.upstream])
        up_parts.append(ups.astype(np.int32))
        blk_off += sa.block_len
        up_off += len(ups)
        n_log = max(n_log, sa.block_len + 2)
    return dict(seg_codes=seg_codes, seg_quals=seg_quals, seg_len=seg_len,
                lw64=np.array([log_prob_error(chr(i)) for i in range(256)]),
                lc64=np.array([log_prob_correct(chr(i))
                               for i in range(256)]),
                tdesc=tdesc, priors=priors,
                blk_bytes=np.concatenate(blk_parts + [np.zeros(1, np.uint8)]),
                upstream=np.concatenate(up_parts + [np.zeros(1, np.int32)]),
                int_log=np.array([int_log(n) for n in range(n_log)]),
                tables=needed)


def _assert_same(got, want, key):
    """Equal key for key, array for array (values and dtypes)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=str(key))
    elif isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_same(got[k], want[k], (key, k))
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, (key, i))
    else:
        assert type(got) is type(want) and got == want, key


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_equals_the_per_row_loop(case):
    aligner, alns, seeds = prepare_case(case, ModeBAligner)
    for dtype in (np.float32, np.float64):
        got = aligner.score_reads_batch_prepare(alns, seeds, dtype)
        want = prepare_per_row(aligner, alns, seeds, dtype)
        _assert_same(got, want, "prep")
        assert got["elem"] == want["elem"]


def test_quality_tables_are_log_prob_of_every_byte():
    for i in range(256):
        assert port_mode_b.LW64[i] == log_prob_error(chr(i))
        assert port_mode_b.LC64[i] == log_prob_correct(chr(i))
    assert port_mode_b.LW64.dtype == port_mode_b.LC64.dtype == np.float64
