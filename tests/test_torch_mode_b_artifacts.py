"""The port's mode-B artifact tables (longtr_tpu_torch.ops.mode_b_artifacts,
built on the device from the reads' bytes) against longtr_tpu's host
table code, on the CPU.

* The plain torch tables equal longtr_tpu's read-batched
  ``_artifact_table_batch`` and per-read ``_artifact_table`` to rtol 1e-12,
  atol 0 in float64 (the bound tests/test_torch_mode_b.py uses for XLA's
  exp; on the CPU torch's and numpy's float64 exp and log agree, and the
  tables are in fact equal), and exactly after the cast to float32: on
  seeded random repeat blocks (homopolymers and not, some shorter than the
  largest deletion) with segments that are empty, one base long and
  padded, and on the mode-B fixtures of tests/test_torch_mode_b.py.
* The finish path on CPU tensors (plain tables, plain rows) gives the LLs
  of the host-table path (numpy tables, plain rows) exactly.

tests/test_torch_cuda.py holds the CUDA kernel to the host tables on a
card.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu.pipeline.mode_b import ModeBAligner as JaxAligner
from longtr_tpu_torch.ops import mode_b_cuda, mode_b_device
from longtr_tpu_torch.ops.mode_b_artifacts import (DESC_FIELDS,
                                                   mode_b_artifacts_plain,
                                                   prefix_doubles)
from longtr_tpu_torch.pipeline.mode_b import ModeBAligner as PortAligner
from longtr_tpu_torch.utils.mathops import int_log

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import (ARTIFACT_KEYS, MODE_B_CASES,  # noqa: E402
                             artifact_case, mode_b_case)
from test_torch_mode_b import jax_classes, per_element_tables  # noqa: E402

CASES = sorted(MODE_B_CASES)
TRIALS = range(12)
# the port's aligner on the CPU (its default device is the card)
ModeBAligner = functools.partial(PortAligner, device="cpu")


def _plain(inp, n_d, dtype):
    return mode_b_artifacts_plain(
        *[torch.from_numpy(np.ascontiguousarray(inp[k]))
          for k in ARTIFACT_KEYS], n_d=n_d, dtype=dtype).numpy()


@pytest.mark.parametrize("trial", TRIALS)
def test_plain_tables_equal_jax_tables(trial):
    port, tables, ss, L_max, n_d = artifact_case(trial, ModeBAligner)
    jaxa, jtables, jss, jL, jn_d = artifact_case(trial, JaxAligner,
                                                 jax_classes())
    assert (jtables, jL, jn_d) == (tables, L_max, n_d)
    inp = port.artifact_inputs(tables, ss, L_max, n_d)
    P = len(ss[0])
    got = _plain(inp, n_d, torch.float64).reshape(len(tables), P, n_d, L_max)
    got32 = _plain(inp, n_d, torch.float32).reshape(got.shape)
    lw, lc = inp["lw64"], inp["lc64"]
    for t, (side, bi, opt) in enumerate(tables):
        blocks = jaxa.fw_blocks if side == 0 else jaxa.rev_blocks
        saln = jaxa._fw_stutter if side == 0 else jaxa._rev_stutter
        segs = [(c.tobytes().decode(), lw[q], lc[q]) for c, q in jss[side]]
        batch = jaxa._artifact_table_batch(blocks, saln, bi, opt, segs, n_d,
                                           L_max)
        per_read = np.stack([jaxa._artifact_table(blocks, saln, bi, opt, s,
                                                  w, c, n_d, L_max)
                             for s, w, c in segs])
        for want in (batch, per_read):
            np.testing.assert_allclose(got[t], want, rtol=1e-12, atol=0)
            np.testing.assert_array_equal(got32[t], want.astype(np.float32))


def test_artifact_cases_cover_the_edges():
    """The random cases reach what the descent treats apart: deletions past
    a segment's start (the `neg` rescan), D = 0, D > 0, artifact sizes
    longer than the block (IMPOSSIBLE), upstream rescans (um == 0 inside
    the block) and jumps, empty and one-base segments, padding."""
    seen = set()
    for trial in TRIALS:
        port, tables, ss, L_max, n_d = artifact_case(trial, ModeBAligner)
        inp = port.artifact_inputs(tables, ss, L_max, n_d)
        for row in inp["tdesc"]:
            d = dict(zip(DESC_FIELDS, row.tolist()))
            if d["block_len"] + d["d_first"] < 0:
                seen.add("D longer than the block (IMPOSSIBLE)")
            ups = inp["upstream"][d["up_off"]:d["up_off"] + d["block_len"]]
            if (ups[d["period"]:] == 0).any():
                seen.add("upstream rescan")
            if (ups > 1).any():
                seen.add("upstream jump")
        lens = inp["seg_len"]
        if (lens == 0).any() and (lens == 1).any():
            seen.add("empty and one-base segments")
        if lens.max() < L_max and (lens > 6).any():
            seen.add("padding; deletions past a segment's start")
    assert seen == {"D longer than the block (IMPOSSIBLE)",
                    "upstream rescan", "upstream jump",
                    "empty and one-base segments",
                    "padding; deletions past a segment's start"}


def test_artifact_inputs_describe_the_aligners():
    """Each descriptor row, prior row and array slice is what the host's
    StutterAligner and RepeatBlock hold."""
    port, tables, ss, L_max, n_d = artifact_case(3, ModeBAligner)
    inp = port.artifact_inputs(tables, ss, L_max, n_d)
    for t, (side, bi, opt) in enumerate(tables):
        blocks = port.fw_blocks if side == 0 else port.rev_blocks
        saln = port._fw_stutter if side == 0 else port._rev_stutter
        blk, sa = blocks[bi], saln[bi][opt]
        d = dict(zip(DESC_FIELDS, inp["tdesc"][t].tolist()))
        d_list = list(range(blk.max_del, blk.max_ins + 1, blk.period))
        assert d == dict(side=side, block_len=sa.block_len,
                         period=blk.period, d_first=blk.max_del,
                         n_dl=len(d_list), n_del=sa.num_deletions,
                         n_ins=sa.num_insertions, blk_off=d["blk_off"],
                         up_off=d["up_off"])
        assert 1 + max(d["n_del"], 1) + max(d["n_ins"], 1) \
            <= prefix_doubles(n_d)
        assert inp["blk_bytes"][d["blk_off"]:d["blk_off"] + sa.block_len] \
            .tobytes().decode() == sa.block_seq[::-1]
        np.testing.assert_array_equal(
            inp["upstream"][d["up_off"]:d["up_off"]
                            + len(sa.upstream) * sa.block_len],
            np.concatenate(sa.upstream))
        np.testing.assert_array_equal(
            inp["priors"][t, :len(d_list)],
            [blk.log_prob_pcr_artifact(opt, D) for D in d_list])
    np.testing.assert_array_equal(
        inp["int_log"], [int_log(n) for n in range(len(inp["int_log"]))])
    for side in (0, 1):
        for p, (c, q) in enumerate(ss[side]):
            L = len(c)
            assert inp["seg_len"][side, p] == L
            np.testing.assert_array_equal(inp["seg_codes"][side, p, :L],
                                          c[::-1])
            np.testing.assert_array_equal(inp["seg_quals"][side, p, :L],
                                          q[::-1])


@pytest.mark.parametrize("case", CASES)
def test_prepared_tables_equal_host_and_jax(case):
    """On the mode-B fixtures: the plain tables of a prepared batch equal
    the host numpy tables (both dtypes, exactly) and, where an element
    reads them, longtr_tpu's."""
    port, alns, seeds = mode_b_case(case, ModeBAligner)
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    for dtype in (np.float32, np.float64):
        prep = port.score_reads_batch_prepare(alns, seeds, dtype)
        assert "A_tab" not in prep
        got = port.artifact_tables(prep).numpy()
        np.testing.assert_array_equal(got, port.host_artifact_tables(prep))
        want = jaxa.score_reads_batch_prepare(jalns, jseeds, dtype)["A"]
        mine = per_element_tables(dict(prep, A_tab=got))
        for (p, k, side), b in prep["elem"].items():
            n_s = len(prep["sides"][k][side][3])
            np.testing.assert_array_equal(mine[b, :n_s], want[b, :n_s])


@pytest.mark.parametrize("case", CASES)
def test_finish_on_cpu_equals_host_table_path(case):
    """Plain tables and plain rows give the LLs of numpy tables and plain
    rows exactly, in float32 and float64, and count the elements on the
    CPU route."""
    port, alns, seeds = mode_b_case(case, ModeBAligner)
    ref, _a, _s = mode_b_case(case, functools.partial(ModeBAligner,
                                                      reference=True))
    for dtype in (np.float32, np.float64):
        before = dict(mode_b_device.mode_b_elements_scored)
        got = port.score_reads_batch(alns, seeds, dtype)
        moved = {k: v - before[k]
                 for k, v in mode_b_device.mode_b_elements_scored.items()}
        assert moved["cpu"] > 0 and moved["cuda"] == 0
        np.testing.assert_array_equal(got, ref.score_reads_batch(alns, seeds,
                                                                 dtype))


def test_cpu_artifacts_route_to_plain():
    """On CPU tensors the kernel's wrapper runs the plain tables and
    launches nothing."""
    port, tables, ss, L_max, n_d = artifact_case(1, ModeBAligner)
    inp = port.artifact_inputs(tables, ss, L_max, n_d)
    g = [torch.from_numpy(np.ascontiguousarray(inp[k]))
         for k in ARTIFACT_KEYS]
    want = mode_b_artifacts_plain(*g, n_d=n_d)
    mode_b_cuda.reset_launches()
    assert torch.equal(mode_b_cuda.mode_b_artifacts(*g, n_d=n_d), want)
    assert want.dtype == torch.float32
    assert want.shape == (len(tables) * len(ss[0]), n_d, L_max)
    assert not any(mode_b_cuda.launches.values())
