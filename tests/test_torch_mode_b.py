"""The port's mode B (longtr_tpu_torch.pipeline.mode_b and the plain torch
rows of ops.mode_b_device) against longtr_tpu's, on the CPU.

* The host phase is the JAX package's code: its table dict equals
  longtr_tpu's array for array, and the artifact tables it builds on the
  reference path (``reference=True``, numpy) equal longtr_tpu's wherever
  an element reads them (the port keeps one table per (side, block,
  option, read) and an index per element, where longtr_tpu copies a table
  per element).
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
CUDA kernels to the plain versions and the host tables bit for bit on a
card; tests/test_torch_mode_b_artifacts.py holds the plain artifact tables
to longtr_tpu's table code.
"""

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
from longtr_tpu_torch.pipeline.mode_b import ModeBAligner as PortAligner

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import (MODE_B_CASES, TABLE_KEYS, homopolymer_hap,  # noqa: E402
                             homopolymer_read, mode_b_case,
                             synthetic_tables)

CASES = sorted(MODE_B_CASES)
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


def _jax_cols(prep):
    args = [per_element_tables(prep) if k == "A_tab" else prep[k]
            for k in TABLE_KEYS if k != "tab"]
    if prep["lc_tab"].dtype == np.float64:
        with jax.enable_x64():
            return np.asarray(jax_mode_b_cols(*args, n_d=prep["n_d"]))
    return np.asarray(jax_mode_b_cols(*args, n_d=prep["n_d"]))


@pytest.mark.parametrize("case", CASES)
def test_prepare_tables_equal_jax(case):
    port, alns, seeds = mode_b_case(
        case, functools.partial(ModeBAligner, reference=True))
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    assert jseeds == seeds
    for dtype in (np.float32, np.float64):
        got = port.score_reads_batch_prepare(alns, seeds, dtype)
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
    aligner, alns, seeds = mode_b_case(
        case, functools.partial(ModeBAligner, reference=True))
    prep = aligner.score_reads_batch_prepare(alns, seeds, np.float64)
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
