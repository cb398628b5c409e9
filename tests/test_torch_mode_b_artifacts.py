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
  of the same path run on longtr_tpu's tables exactly.
* A numpy model of the CUDA warp kernel's work split
  (``csrc/mode_b_artifacts.cu::mode_b_artifacts_warp_kernel``: a block a
  table and G segments, the segments staged, one valid offset a thread
  for the prefixes, then warps of 32 lanes over (artifact size, valid
  column) D-major, each warp walking one shared descent per artifact size
  it holds with a per-lane exit) gives the plain tables and longtr_tpu's
  at tolerance 0 in float64.

tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on
a card.
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
from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.utils.mathops import LOG_THRESH, int_log

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
    longtr_tpu's where an element reads them, in both dtypes, exactly."""
    port, alns, seeds = mode_b_case(case, ModeBAligner)
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    for dtype in (np.float32, np.float64):
        prep = port.score_reads_batch_prepare(alns, seeds, dtype)
        assert "A_tab" not in prep
        got = port.artifact_tables(prep).numpy()
        want = jaxa.score_reads_batch_prepare(jalns, jseeds, dtype)["A"]
        mine = per_element_tables(dict(prep, A_tab=got))
        for (p, k, side), b in prep["elem"].items():
            n_s = len(prep["sides"][k][side][3])
            np.testing.assert_array_equal(mine[b, :n_s], want[b, :n_s])


def jax_tables_as_rows(prep, want):
    """longtr_tpu's per-element tables ``want`` (B, S, n_d, L) laid into
    the port's table rows (T * P, n_d, L) through ``prep["tab"]``; every
    row is read by some element, and elements that share a row agree."""
    rows = np.full((len(prep["tables"]) * prep["P"],) + want.shape[2:],
                   np.nan, dtype=want.dtype)
    for (p, k, side), b in prep["elem"].items():
        for s_i in range(len(prep["sides"][k][side][3])):
            r = prep["tab"][b, s_i]
            if not np.isnan(rows[r]).all():
                np.testing.assert_array_equal(rows[r], want[b, s_i])
            rows[r] = want[b, s_i]
    assert not np.isnan(rows).any()
    return rows


@pytest.mark.parametrize("case", CASES)
def test_finish_on_cpu_equals_jax_table_path(case, monkeypatch):
    """Plain tables and plain rows give the LLs of longtr_tpu's tables and
    plain rows exactly, in float32 and float64, and count the elements on
    the CPU route."""
    port, alns, seeds = mode_b_case(case, ModeBAligner)
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    for dtype in (np.float32, np.float64):
        before = dict(mode_b_device.mode_b_elements_scored)
        got = port.score_reads_batch(alns, seeds, dtype)
        moved = {k: v - before[k]
                 for k, v in mode_b_device.mode_b_elements_scored.items()}
        assert moved["cpu"] > 0 and moved["cuda"] == 0
        want = jaxa.score_reads_batch_prepare(jalns, jseeds, dtype)["A"]
        monkeypatch.setattr(port, "artifact_tables", lambda prep: (
            torch.from_numpy(jax_tables_as_rows(prep, want))))
        np.testing.assert_array_equal(
            got, port.score_reads_batch(alns, seeds, dtype))
        monkeypatch.undo()


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


# ---------------------------------------------------------------------------
# A numpy model of the warp kernel's work split.
# ---------------------------------------------------------------------------

ART_THREADS, WARP = 128, 32     # csrc/mode_b_artifacts.cu


def _at(code, lw, lc, r, c):
    """The staged score of positions ``r`` (clamped: masked lanes read
    something) against base byte(s) ``c``."""
    r = np.clip(r, 0, code.shape[0] - 1)
    return np.where(code[r] == c, lc[r], lw[r])


def _warp_descent(D, lanes, desc, blk, ups, il, region, codes):
    """One warp's lanes of one (table, D): the shared descent, each lane
    leaving at its own exit; returns the lanes' LSEs (no prior)."""
    _side, bl, per, _d0, _n_dl, _n_del, _n_ins, nDc = desc
    g, j, L = (np.array(x) for x in zip(*lanes))
    offset = L - 1 - j
    lw, lc = region[g, 0], region[g, 1]

    def at(r, c):
        rr = np.clip(r, 0, codes.shape[1] - 1)
        return np.where(codes[g, rr] == c, lc[np.arange(len(g)), rr],
                        lw[np.arange(len(g)), rr])

    def pre(row, o):
        return region[g, row, np.clip(o, 0, codes.shape[1] - 1)]

    base_len = np.minimum(bl + D, j + 1)
    if D > 0:
        up = ups[:bl]
        lp = -il[bl + 1] + pre(3 + nDc + D // per - 1, offset)
        lp = lp + np.where(base_len > D, pre(2, offset + D), 0.0)
        lim = -np.minimum(np.maximum(0, base_len - D), bl)
    else:
        k = -D // per - 1
        up = ups[k * bl:(k + 1) * bl]
        log_prior = -il[bl + D + 1]
        od = offset + D
        lp = log_prior + (pre(2, od) - pre(3 + k, od))
        past = od < 0
        if past.any():                  # the lanes past the start loop
            lpn = np.full(len(g), log_prior)
            for q in range(int(base_len[past].max())):
                add = (q < base_len) & past
                lpn = np.where(add, lpn + at(offset + q, blk[q - D]), lpn)
            lp = np.where(past, lpn, lp)
        lim = -base_len
    entries = [(lp, np.ones(len(g), bool))]
    i = 0
    i_exit = np.zeros(len(g), int)
    while (i > lim).any():
        act = i > lim
        if D > 0 and not (-i + per < bl):
            entries.append((lp, act))
            new_i = i - 1
        else:
            um = int(up[bl - 1 + i])
            if um == 0:
                if D > 0:
                    for idx in range(i - per, i - D - 1, -per):
                        r = offset - idx
                        lp = np.where(act, lp - at(r, blk[-i]), lp)
                        lp = np.where(act, lp + at(r, blk[-(i - per)]), lp)
                else:
                    r = offset - i
                    lp = np.where(act, lp - at(r, blk[-(i + D)]), lp)
                    lp = np.where(act, lp + at(r, blk[-i]), lp)
                entries.append((lp, act))
                new_i = i - 1
            else:
                entries.append((il[um] + lp, act))
                new_i = i - um
        i_exit = np.where(act & (new_i <= lim), new_i, i_exit)
        i = new_i
    t_base = bl if D > 0 else bl + D
    tail_ok = i_exit > -t_base
    entries.append((il[np.clip(t_base + i_exit, 0, len(il) - 1)] + lp,
                    tail_ok))
    m = np.full(len(g), -np.inf)
    for e, a in entries:
        m = np.where(a & (e > m), e, m)
    total = np.zeros(len(g))
    with np.errstate(invalid="ignore", over="ignore"):
        for e, a in entries:
            df = e - m
            keep = a & (df > LOG_THRESH)
            total = np.where(keep, total + np.exp(np.where(keep, df, 0.0)),
                             total)
        with np.errstate(divide="ignore"):
            lse = m + np.log(total)
    return np.where(np.isfinite(m), lse, m)


def emulate_warp_kernel(inp, n_d, G):
    """The warp kernel's (T * P, n_d, Lp) float64 tables, built as its
    blocks, threads and warps build them (see the module docstring)."""
    codes_all, quals_all = inp["seg_codes"], inp["seg_quals"]
    _, P, Lp = codes_all.shape
    T = len(inp["tdesc"])
    il = inp["int_log"]
    out = np.full((T * P, n_d, Lp), np.nan)
    n_grp = -(-P // G)
    for gb in range(T * n_grp):                     # one block
        t, p0 = gb // n_grp, (gb % n_grp) * G
        ng = min(G, P - p0)
        side, bl, per, d0, n_dl, n_del, n_ins, bo, uo = \
            inp["tdesc"][t].tolist()
        nDc, nIc = max(n_del, 1), max(n_ins, 1)
        blk = inp["blk_bytes"][bo:bo + bl]
        ups = inp["upstream"][uo:uo + nDc * bl]
        desc = (side, bl, per, d0, n_dl, n_del, n_ins, nDc)
        # 1. the staged region: per segment rows lw, lc, match, dels, ins
        codes = codes_all[side, p0:p0 + ng]
        q = quals_all[side, p0:p0 + ng]
        region = np.full((ng, prefix_doubles(n_d) + 2, Lp), np.nan)
        region[:, 0], region[:, 1] = inp["lw64"][q], inp["lc64"][q]
        lens = np.clip(inp["seg_len"][side, p0:p0 + ng], 0, Lp)
        start = np.concatenate([[0], np.cumsum(lens)])
        V = int(start[-1])
        ob = out[t * P + p0:t * P + p0 + ng]
        jj, dd = np.arange(Lp), np.arange(n_d)[:, None]
        for g in range(ng):
            ob[g] = np.where((jj >= lens[g]) | (dd >= n_dl), -np.inf,
                             ob[g])
        # 2. the prefixes, one valid offset a thread, a round of threads
        for v0 in range(0, V, ART_THREADS):
            v = np.arange(v0, min(V, v0 + ART_THREADS))
            g = np.searchsorted(start, v, side="right") - 1
            o, L = v - start[g], lens[g]

            def at(r, c):
                return np.array([_at(codes[gg], region[gg, 0], region[gg, 1],
                                     rr, c) for gg, rr in zip(g, r)])
            run = np.zeros(len(v))
            di = 0
            for j in range(bl):
                inside = o + j < L
                run = np.where(inside, run + at(o + j, blk[j]), run)
                if (j + 1) % per == 0 and j < per * n_del and di < nDc:
                    region[g, 3 + di, o] = np.where(inside, run, 0.0)
                    di += 1
            region[g, 2, o] = run
            ri = np.zeros(len(v))
            ii = 0
            for j in range(per * n_ins):
                inside = o + j < L
                jm = j % per
                s = (at(o + j, blk[jm]) if jm < bl else
                     region[g, 1, np.clip(o + j, 0, Lp - 1)])
                ri = np.where(inside, ri + s, ri)
                if (j + 1) % per == 0:
                    region[g, 3 + nDc + ii, o] = ri
                    ii += 1
        # 3. warps of 32 consecutive items, D-major over the valid columns
        pri = inp["priors"][t]
        n_items = n_dl * V
        for k0 in range(0, n_items, WARP):
            items = range(k0, min(n_items, k0 + WARP))
            by_d = {}
            for k in items:
                d, v = divmod(k, V)
                g = int(np.searchsorted(start, v, side="right") - 1)
                by_d.setdefault(d, []).append((g, v - start[g], lens[g]))
            for d, lanes in by_d.items():           # a descent per D held
                D = d0 + d * per
                if bl + D < 0:
                    vals = np.full(len(lanes), IMPOSSIBLE)
                elif D == 0:
                    vals = np.array([pri[d] + region[g, 2, L - 1 - j]
                                     for g, j, L in lanes])
                else:
                    vals = pri[d] + _warp_descent(D, lanes, desc, blk, ups,
                                                  il, region, codes)
                for (g, j, _L), x in zip(lanes, vals):
                    ob[g, d, j] = x
    assert not np.isnan(out).any()
    return out


def _default_segments(Lp, P):
    return max(1, min(P, 16, -(-mode_b_cuda.ARTIFACT_BLOCK_COLUMNS // Lp)))


@pytest.mark.parametrize("trial", TRIALS)
def test_warp_kernel_model_equals_plain_and_jax(trial):
    """The warp kernel's model, at the wrapper's default segments a block
    and at 4 (a ragged last group), equals the plain tables and
    longtr_tpu's batched builder at tolerance 0 in float64."""
    port, tables, ss, L_max, n_d = artifact_case(trial, ModeBAligner)
    jaxa, _jt, jss, _jL, _jn = artifact_case(trial, JaxAligner,
                                             jax_classes())
    inp = port.artifact_inputs(tables, ss, L_max, n_d)
    P = len(ss[0])
    want = _plain(inp, n_d, torch.float64)
    lw, lc = inp["lw64"], inp["lc64"]
    jax_tabs = []
    for side, bi, opt in tables:
        blocks = jaxa.fw_blocks if side == 0 else jaxa.rev_blocks
        saln = jaxa._fw_stutter if side == 0 else jaxa._rev_stutter
        segs = [(c.tobytes().decode(), lw[q], lc[q]) for c, q in jss[side]]
        jax_tabs.append(jaxa._artifact_table_batch(blocks, saln, bi, opt,
                                                   segs, n_d, L_max))
    jax_tabs = np.concatenate(jax_tabs)
    for G in sorted({_default_segments(L_max, P), 4}):
        got = emulate_warp_kernel(inp, n_d, G)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_tabs)


@pytest.mark.parametrize("case", CASES)
def test_warp_kernel_model_on_fixtures(case):
    """On the mode-B fixtures: the warp kernel's model equals the plain
    tables at tolerance 0 in float64, and longtr_tpu's per-element tables
    where an element reads them."""
    port, alns, seeds = mode_b_case(case, ModeBAligner)
    jaxa, jalns, jseeds = mode_b_case(case, JaxAligner, jax_classes())
    prep = port.score_reads_batch_prepare(alns, seeds, np.float64)
    n_d, P = prep["n_d"], prep["P"]
    got = emulate_warp_kernel(prep, n_d,
                              _default_segments(prep["seg_codes"].shape[2],
                                                P))
    np.testing.assert_array_equal(got, _plain(prep, n_d, torch.float64))
    want = jaxa.score_reads_batch_prepare(jalns, jseeds, np.float64)["A"]
    mine = per_element_tables(dict(prep, A_tab=got))
    for (p, k, side), b in prep["elem"].items():
        n_s = len(prep["sides"][k][side][3])
        np.testing.assert_array_equal(mine[b, :n_s], want[b, :n_s])
