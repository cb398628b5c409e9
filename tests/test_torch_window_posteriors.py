"""A numpy model of the window posteriors kernel
(csrc/em.cu::window_posteriors_kernel, J3) against the plain torch
posteriors, the JAX package and the float64 oracle, on the CPU.

The kernel cannot run here, so its work split is held through a model
that takes it in its order, in float32: each locus on its own, its
unmasked reads among the rows [0, n) of its count; the route, cluster and
sub-teams of ``em_cuda.window_plan`` (a small locus one team, KB = J = 1;
a large one KB blocks, block k taking the rounds of 32 reads k, k + KB,
..., its rounds dealt to J sub-teams in turn); the kernel's own map of
its blocks to loci (``emulate_grid``); in each round a
warp's bit mask a sample (the ballot loop, emulated lane by lane below),
each output (sample, a1, a2) adding its sample's terms bit by bit in read
order in float64; the sub-teams' sums added in order, the blocks' in
block order, rounded once, the prior added; a sample's logsumexp over its
A*A entries a warp's (lane-strided sums, then a butterfly).  Elementwise
functions are torch's on the CPU, as the plain version's are.

Tolerances are tests/test_posterior.py's and tests/test_torch_posterior.py's:
normalized log posteriors within atol 5e-3 where the oracle is above -50,
per-sample totals within rtol 1e-5 / atol 1e-2, MAP diplotypes equal.  A
locus's result does not depend on how the window is split over shards
(tolerance 0).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu.ops import posterior as jax_post
from longtr_tpu_torch.ops import em_cuda
from longtr_tpu_torch.ops import posterior as port

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_em_kernel import (F32, F64, LOG_HALF, lae, lse,  # noqa: E402
                                  seqsum, warp_lse)
from _torch_cases import (mixed_window, random_case,  # noqa: E402
                          real_window)
from test_torch_posterior import _close, _f32, _window  # noqa: E402


def emulate_block_sort(keys, nkeys):
    """The kernel's block_sort (J4's set-up), lane by lane: rounds of 32
    items; in a round the lanes of one key see each other
    (__match_any_sync), each writes at its key's cursor plus the lanes of
    its key below it, and the lowest of them moves the cursor.  Returns
    (start (nkeys + 1), order)."""
    n = len(keys)
    start = np.zeros(nkeys + 1, np.int64)
    rounds = [keys[b:b + 32] for b in range(0, n, 32)]
    for ks in rounds:
        for lane, k in enumerate(ks):
            if k >= 0 and k not in ks[:lane]:
                start[k + 1] += int((ks == k).sum())
    start = np.cumsum(start)
    cursor = start[:-1].copy()
    order = np.full(int(start[-1]), -1, np.int64)
    for b, ks in zip(range(0, n, 32), rounds):
        for lane, k in enumerate(ks):
            if k >= 0:
                order[cursor[k] + int((ks[:lane] == k).sum())] = b + lane
        for lane, k in enumerate(ks):
            if k >= 0 and k not in ks[:lane]:
                cursor[k] += int((ks == k).sum())
    return start, order


def emulate_round_masks(keys):
    """The masks a warp gives one round of up to 32 reads (key: the read's
    sample, -1 for none), lane by lane: left = ballot(key >= 0); while
    left, the key of its lowest lane (__ffs, __shfl) gets
    ballot(key == that key), and those lanes leave.  Returns {key: the
    lanes of its set bits, lowest first}."""
    keys = list(keys) + [-1] * (32 - len(keys))
    left = [lane for lane in range(32) if keys[lane] >= 0]
    masks = {}
    while left:
        k = keys[left[0]]
        bits = [lane for lane in range(32) if keys[lane] == k]
        masks[k] = bits
        left = [lane for lane in left if lane not in bits]
    return masks


def locus_sums(a, b, keys, s, kb, J):
    """Sample s's float64 sums (A, A) of one locus: round g is reads
    [32 g, 32 g + 32); block k of kb takes the rounds k, k + kb, ..., its
    i-th round going to sub-team i % J, which adds its reads' terms bit by
    bit; the sub-teams' sums are added in order, then the blocks' in block
    order."""
    n, A = len(keys), a.shape[1]
    blocks = []
    for k in range(kb):
        rows = [[] for _ in range(J)]
        for i, r0 in enumerate(range(32 * k, n, 32 * kb)):
            bits = emulate_round_masks(keys[r0:r0 + 32]).get(s, [])
            rows[i % J] += [r0 + q for q in bits]
        subs = [seqsum(lae(a[r][:, :, None], b[r][:, None, :]), dtype=F64)
                if r else np.zeros((A, A), F64) for r in rows]
        blocks.append(seqsum(np.stack(subs), dtype=F64))
    return seqsum(np.stack(blocks), dtype=F64)


def emulate_grid(plan, counts):
    """The loci the kernel's blocks take, as csrc/em.cu maps them: cluster
    c the c-th locus whose count exceeds small_max, found by the warps'
    ballots over slices of WINDOW_THREADS counts and thread 0's walk of
    the words (the c-th set bit: c lowest bits cleared, then __ffs); team
    t of small block b locus b * teams + t where that locus is small.
    Returns ([locus of each cluster], {(block, team): locus})."""
    n_large, n_small = em_cuda.window_grid(plan, counts)
    counts = np.asarray(counts)
    L, T = len(counts), em_cuda.WINDOW_THREADS
    clusters = []
    for c in range(n_large):
        left, found = c, -1
        for base in range(0, L, T):
            words = [sum(1 << lane for lane in range(32)
                         if base + 32 * w + lane < L
                         and counts[base + 32 * w + lane] > plan.small_max)
                     for w in range(T // 32)]
            for x, m in enumerate(words):
                nb = bin(m).count("1")
                if left < nb:
                    for _ in range(left):
                        m &= m - 1
                    found = base + 32 * x + (m & -m).bit_length() - 1
                    break
                left -= nb
            if found >= 0:
                break
        clusters.append(found)
    teams = {(b, t): b * plan.teams + t for b in range(n_small)
             for t in range(plan.teams)
             if b * plan.teams + t < L
             and counts[b * plan.teams + t] <= plan.small_max}
    return clusters, teams


def window_model(LL, p1, p2, label, mask, prior, num_samples, counts):
    """The kernel's (P (L, S, A, A), totals (L, S)) on a padded window
    whose loci hold ``counts`` reads, each locus taken by the cluster or
    the team the kernel's grid gives it."""
    L, R, A = LL.shape
    S = num_samples
    plan = em_cuda.window_plan(A, S)
    clusters, teams = emulate_grid(plan, counts)
    assert sorted(clusters + list(teams.values())) == list(range(L))
    P = np.zeros((L, S, A, A), F32)
    totals = np.zeros((L, S), F32)
    for i in range(L):
        n = int(counts[i])
        kb, J = (em_cuda.WINDOW_CLUSTER, plan.j) if i in clusters else (1, 1)
        keys = np.where(mask[i, :n] & (label[i, :n] >= 0)
                        & (label[i, :n] < S), label[i, :n], -1)
        LLc = np.where(LL[i, :n] < F32(-600), F32(-600), LL[i, :n])
        a = ((LLc.astype(F32) + p1[i, :n, None]) + LOG_HALF).astype(F32)
        b = ((LLc.astype(F32) + p2[i, :n, None]) + LOG_HALF).astype(F32)
        for s in range(S):
            P[i, s] = locus_sums(a, b, keys, s, kb, J).astype(F32) + prior[i]
        totals[i] = warp_lse(P[i].reshape(S, -1))
        with np.errstate(invalid="ignore"):
            P[i] -= totals[i][:, None, None]
    return P, totals


def test_block_sort_is_a_stable_counting_sort():
    """Rounds with one key, all keys different, excluded items (-1) and a
    ragged last round: the emulated sort equals a stable argsort."""
    rng = np.random.default_rng(5)
    for n, nkeys in ((1, 1), (31, 3), (32, 1), (33, 40), (100, 7),
                     (257, 300)):
        keys = rng.integers(-1, nkeys, n)
        start, order = emulate_block_sort(keys, nkeys)
        kept = np.flatnonzero(keys >= 0)
        want = kept[np.argsort(keys[kept], kind="stable")]
        np.testing.assert_array_equal(order, want)
        np.testing.assert_array_equal(
            np.diff(start), np.bincount(keys[kept], minlength=nkeys))


def test_round_masks_give_the_stable_sort_order():
    """Walking each sample's masks round by round, bit by bit, lists the
    reads a stable sort by sample lists: one key, all keys different (up
    to 40 samples), excluded reads (-1) and ragged last rounds."""
    rng = np.random.default_rng(6)
    for n, nkeys in ((1, 1), (31, 3), (32, 1), (33, 40), (100, 7),
                     (257, 300)):
        keys = rng.integers(-1, nkeys, n)
        masks = [emulate_round_masks(keys[r0:r0 + 32])
                 for r0 in range(0, n, 32)]
        got = [r0 * 32 + q for s in range(nkeys)
               for r0, m in enumerate(masks) for q in m.get(s, [])]
        kept = np.flatnonzero(keys >= 0)
        np.testing.assert_array_equal(
            got, kept[np.argsort(keys[kept], kind="stable")])


@pytest.mark.parametrize("case", sorted(["diploid_unphased", "diploid_phased",
                                         "haploid", "single_allele"]))
def test_model_matches_plain_oracle_and_jax(case):
    """tests/test_torch_posterior.py's cases, the haploid one with its
    -inf heterozygote prior as calc_log_sample_posteriors takes it."""
    shapes = {"diploid_unphased": dict(R=40, A=5, S=3),
              "diploid_phased": dict(R=60, A=4, S=4, phased=True),
              "haploid": dict(R=30, A=6, S=2, haploid=True),
              "single_allele": dict(R=10, A=1, S=2)}
    rng = np.random.default_rng(31 + sorted(shapes).index(case))
    c = random_case(rng, **shapes[case])
    A, S = c["log_aln_probs"].shape[1], c["num_samples"]
    prior = _f32(port.genotype_log_priors(A, c["haploid"]))
    args = [_f32(c[k])[None] for k in ("log_aln_probs", "log_p1", "log_p2")]
    label = torch.from_numpy(c["sample_label"].astype(np.int64))[None]
    mask = torch.ones_like(label, dtype=torch.bool)
    R = label.shape[1]
    P, tot = window_model(*(x.numpy() for x in args), label.numpy(),
                          mask.numpy(), prior[None].numpy(), S, [R])
    if c["haploid"]:
        assert np.isneginf(prior.numpy()).any()
    plain_P, plain_tot = em_cuda.window_posteriors(*args, label, mask,
                                                   prior[None], S, [R])
    _close(P[0], tot[0], plain_P[0].numpy().astype(np.float64),
           plain_tot[0].numpy().astype(np.float64))
    want = port.posteriors_oracle(c["log_aln_probs"], c["log_p1"],
                                  c["log_p2"], c["sample_label"], S,
                                  c["haploid"])
    _close(P[0], tot[0], want[0], want[1])
    with np.errstate(over="ignore"):
        j_P, j_tot, _ = jax_post.calc_log_sample_posteriors(
            c["log_aln_probs"].astype(np.float32),
            c["log_p1"].astype(np.float32), c["log_p2"].astype(np.float32),
            c["sample_label"], S, prior.numpy())
    _close(P[0], tot[0], np.asarray(j_P, np.float64),
           np.asarray(j_tot, np.float64))


def _unequal_window():
    """tests/test_torch_posterior.py's window (unequal R, A and S, one
    locus haploid, one of one allele), a locus whose reads all have one
    sample, one whose last reads are those of a sample listed first, and
    one of 700 reads, which takes the large route."""
    loci = _window()
    rng = np.random.default_rng(22)
    one = random_case(rng, R=70, A=3, S=3)
    one["sample_label"][:] = 2
    late = random_case(rng, R=45, A=7, S=2, phased=True)
    late["sample_label"] = np.r_[np.ones(30), np.zeros(15)].astype(np.int32)
    big = random_case(rng, R=700, A=10, S=3)
    return loci + [one, late, big]


WINDOWS = {"unequal": _unequal_window,
           "real": real_window,
           "mixed": lambda: mixed_window(L=32)}


def _hold_window(loci, jax_batched=True):
    """Each locus of the model on the padded window equals the plain
    version, longtr_tpu, the oracle and the model's own locus alone at the
    tolerances.  The plain version and longtr_tpu take the whole padded
    window, or (jax_batched False) each locus alone."""
    arrays, S_max = port.pad_window(loci)
    counts = [l["log_aln_probs"].shape[0] for l in loci]
    P, tot = window_model(*arrays, S_max, counts)
    if jax_batched:
        plain_P, plain_tot = em_cuda.window_posteriors(
            *(torch.from_numpy(x) for x in arrays), S_max, counts)
        jout = jax_post.batched_posteriors(loci)
    for i, l in enumerate(loci):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        got_P, got_tot = P[i, :S, :A, :A], tot[i, :S]
        if jax_batched:
            pP = plain_P[i, :S, :A, :A].numpy()
            pt = plain_tot[i, :S].numpy()
            jP, jtot = jout[i]
        else:
            (pP, pt), = port.batched_posteriors([l], "cpu")
            (jP, jtot), = jax_post.batched_posteriors([l])
        _close(got_P, got_tot, pP.astype(F64), pt.astype(F64))
        _close(got_P, got_tot, np.asarray(jP, F64), np.asarray(jtot, F64))
        want = port.posteriors_oracle(l["log_aln_probs"], l["log_p1"],
                                      l["log_p2"], l["sample_label"], S,
                                      l["haploid"])
        _close(got_P, got_tot, want[0], want[1])
        if not jax_batched and l["log_aln_probs"].shape[0] < 2000:
            continue
        alone, _S = port.pad_window([l])
        a_P, a_tot = window_model(*alone, S, [l["log_aln_probs"].shape[0]])
        _close(got_P, got_tot, a_P[0].astype(F64), a_tot[0].astype(F64))


def _hold_plan_and_window(window):
    loci = WINDOWS[window]()
    arrays, S_max = port.pad_window(loci)
    L, R, A = arrays[0].shape
    counts = np.array([l["log_aln_probs"].shape[0] for l in loci])
    clusters, _teams = emulate_grid(em_cuda.window_plan(A, S_max), counts)
    np.testing.assert_array_equal(clusters, np.flatnonzero(counts >= 700))
    if window == "real":
        assert (L, R, A, S_max) == (256, 60, 4, 3)
    _hold_window(loci, jax_batched=window != "mixed")


def test_model_on_a_window_matches_each_locus():
    """On the unequal window (its 700-read locus large): each locus equals
    the plain window call, longtr_tpu's batched call, the oracle and the
    model's own locus alone at the tolerances."""
    _hold_plan_and_window("unequal")


@pytest.mark.parametrize("window", ["real", "mixed"])
def test_model_on_a_real_or_mixed_window_matches_each_locus(window):
    """A real window of the 512-STR catalog's shape, (256, 60, 4, 3), every
    locus small, and a mixed one (one R=2000, A=12 locus, large, among 31
    small ones), each locus held as above; on the mixed window the plain
    version and longtr_tpu take each locus alone (padded to the 2000-read
    locus, the plain version's (L, R, A, A) terms would take hundreds of
    MB)."""
    _hold_plan_and_window(window)


@pytest.mark.parametrize("window,small_steps,j", [("unequal", 0, 1),
                                                   ("unequal", 10 ** 9, 1),
                                                   ("real", 0, 5)])
def test_model_on_either_route_matches_each_locus(monkeypatch, window,
                                                  small_steps, j):
    """Every locus sent to the large route (a cluster of 8 blocks; at the
    real window's three samples of 16 outputs, a warp each, a block's 16
    warps in J = 5 sub-teams of 3) or every locus, the 700-read one too,
    to the small one: the tolerances still hold."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", small_steps)
    loci = WINDOWS[window]()
    arrays, S_max = port.pad_window(loci)
    plan = em_cuda.window_plan(arrays[0].shape[2], S_max)
    counts = [l["log_aln_probs"].shape[0] for l in loci]
    n_large, _n_small = em_cuda.window_grid(plan, counts)
    assert n_large == (len(loci) if small_steps == 0 else 0)
    assert plan.j == j
    _hold_window(loci)


def _hold_split(window, shards):
    loci = WINDOWS[window]()
    arrays, S_max = port.pad_window(loci)
    counts = np.array([l["log_aln_probs"].shape[0] for l in loci])
    whole = window_model(*arrays, S_max, counts)
    step = -(-len(loci) // shards)
    parts = [window_model(*(x[k:k + step] for x in arrays), S_max,
                          counts[k:k + step])
             for k in range(0, len(loci), step)]
    for j in range(2):
        np.testing.assert_array_equal(
            np.concatenate([p[j] for p in parts]), whole[j])


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_model_is_the_same_on_any_split(shards):
    """The window split as batched_posteriors splits it over a mesh (each
    slice keeps the padded shape): each slice's model equals the whole
    window's bit for bit."""
    _hold_split("unequal", shards)


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_model_is_the_same_on_any_split_of_a_mixed_window(shards):
    """The same on the mixed window, whose 2000-read locus takes the large
    route on every split."""
    _hold_split("mixed", shards)


def test_window_plan_depends_on_the_shape_and_each_count_only():
    """A locus's route, and the j that orders a large locus's sums, follow
    from its own count and the padded (A, S): the kernel's grid gives each
    locus the same route in the whole window, in each shard's slice of it
    and with the loci in another order."""
    loci = mixed_window()
    arrays, S_max = port.pad_window(loci)
    A = arrays[0].shape[2]
    counts = np.array([l["log_aln_probs"].shape[0] for l in loci])
    plan = em_cuda.window_plan(A, S_max)
    assert em_cuda.window_plan(A, S_max) == plan

    def routes(part):
        clusters, _teams = emulate_grid(plan, part)
        r = np.zeros(len(part), bool)
        r[clusters] = True
        return r

    big = routes(counts)
    assert big.sum() == 1 and counts[big][0] == 2000
    for shards in (2, 3, 4, 8):
        step = -(-len(counts) // shards)
        for k in range(0, len(counts), step):
            np.testing.assert_array_equal(routes(counts[k:k + step]),
                                          big[k:k + step])
    perm = np.random.default_rng(3).permutation(len(counts))
    np.testing.assert_array_equal(routes(counts[perm]), big[perm])


@pytest.mark.parametrize("L,teams_of", [(1, 1), (256, 1), (1100, 1),
                                        (1100, 4), (37, 2)])
def test_kernel_grid_takes_each_locus_once(monkeypatch, L, teams_of):
    """The kernel's map of blocks to loci (emulate_grid) on random counts,
    a third of them large, with teams of 1, 2 or 4 a block and more loci
    than one ballot slice of WINDOW_THREADS: each locus is taken once, the
    large ones by the clusters in window order, the small ones by the team
    of their own slot; the small blocks come in whole clusters, and none
    where every locus is large."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", 100)
    A = {1: 12, 2: 4, 4: 4}[teams_of]
    S = {1: 3, 2: 2, 4: 1}[teams_of]
    plan = em_cuda.window_plan(A, S)
    assert plan.teams == teams_of
    rng = np.random.default_rng(L + teams_of)
    counts = np.where(rng.random(L) < 1 / 3,
                      plan.small_max + 1 + rng.integers(0, 500, L),
                      rng.integers(0, plan.small_max + 1, L))
    n_large, n_small = em_cuda.window_grid(plan, counts)
    clusters, teams = emulate_grid(plan, counts)
    assert n_small or n_large == L
    np.testing.assert_array_equal(clusters,
                                  np.flatnonzero(counts > plan.small_max))
    assert len(clusters) == n_large
    assert all(l == b * plan.teams + t for (b, t), l in teams.items())
    assert sorted(teams.values()) == list(
        np.flatnonzero(counts <= plan.small_max))
    assert n_small * plan.teams >= L or n_large == L
    if n_large:
        assert n_small % em_cuda.WINDOW_CLUSTER == 0


def test_model_adds_blocks_in_block_order(monkeypatch):
    """A large locus of one round a block whose blocks' sums cancel: block
    0's reads +2^60 each, block 1's -2^60 each, the rest 1.0 + log 1/2 +
    log 2 each.  Added in block order the float64 sum keeps the small
    terms; in any order that adds block 1's before block 0's it loses them,
    so a model that took the blocks in another order fails here."""
    monkeypatch.setattr(em_cuda, "WINDOW_SMALL_STEPS", 0)
    kb = em_cuda.WINDOW_CLUSTER
    n = 32 * kb
    LL = np.zeros((1, n, 1), F32)
    p1 = np.zeros((1, n), F32)
    LL[0, :32] = 2.0 ** 60
    p1[0, 32:64] = -2.0 ** 60
    LL[0, 64:] = 1.0
    p2 = p1.copy()
    label = np.zeros((1, n), np.int64)
    mask = np.ones((1, n), bool)
    prior = np.zeros((1, 1, 1), F32)
    plan = em_cuda.window_plan(1, 1)
    assert emulate_grid(plan, [n])[0] == [0] and plan.j == 16
    keys = np.zeros(n, np.int64)
    a = ((LL[0] + p1[0, :, None]) + LOG_HALF).astype(F32)
    terms = lae(a, a)[:, 0].astype(F64)
    in_order = 0.0
    for k in range(kb):
        in_order += terms[32 * k:32 * k + 32].sum()
    assert in_order == (n - 64) * float(lae(a[-1], a[-1])[0])
    got = locus_sums(a, a, keys, 0, kb, plan.j)
    assert float(got[0, 0]) == in_order
    P, tot = window_model(LL, p1, p2, label, mask, prior, 1, [n])
    assert tot[0, 0] == F32(in_order) and P[0, 0, 0, 0] == 0


def test_model_keeps_torchs_infinities_and_nan():
    """A sample whose reads all have p1 = p2 = -inf (torch's logaddexp of
    two -inf is -inf, where m + log1p(exp(-|a - b|)) gives NaN), a NaN
    log-likelihood in a masked row (ignored) and one in an unmasked row of
    another sample (propagated): the model's totals equal the plain
    version's, infinities and NaN in place."""
    rng = np.random.default_rng(8)
    c = random_case(rng, R=50, A=3, S=3)
    loci = [c, random_case(rng, R=40, A=3, S=3)]
    arrays, S_max = port.pad_window(loci)
    LL, p1, p2, label, mask, prior = arrays
    p1[0, label[0] == 1] = -np.inf
    p2[0, label[0] == 1] = -np.inf
    LL[1, 45, 0] = np.nan                # a masked row (R = 40)
    LL[1, np.flatnonzero(label[1, :40] == 2)[0], 1] = np.nan
    P, tot = window_model(*arrays, S_max, [50, 40])
    pP, ptot = em_cuda.window_posteriors(
        *(torch.from_numpy(x) for x in arrays), S_max, [50, 40])
    assert np.isneginf(tot[0, 1]) and np.isnan(tot[1, 2])
    np.testing.assert_allclose(tot, ptot.numpy(), rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(np.isnan(P), np.isnan(pP.numpy()))
    fin = np.isfinite(pP.numpy()) & (pP.numpy() > -50)
    np.testing.assert_allclose(P[fin], pP.numpy()[fin], atol=5e-3)


def test_logaddexp_is_torchs_on_special_values():
    """The model's (and the kernel's) logaddexp on infinities, NaN, equal
    and far-apart operands equals torch.logaddexp bit for bit: two -inf
    give -inf, where m + log1p(exp(-|a - b|)) gives NaN."""
    vals = np.array([-np.inf, np.inf, np.nan, -1e30, -600.0, -1.5, 0.0, 3.0,
                     88.0, 1e30], F32)
    a, b = np.meshgrid(vals, vals)
    want = torch.logaddexp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    got = lae(a, b)
    np.testing.assert_array_equal(got, want)
    assert lae(F32(-np.inf), F32(-np.inf)) == -np.inf
    assert math.isnan(float(lse(F32([np.nan, 0.0]))))
    assert lse(F32([-np.inf, -np.inf])) == -np.inf


def test_cpu_tensors_take_the_plain_version():
    """em_cuda.window_posteriors on CPU tensors is calc_log_sample_posteriors
    on the padded window and counts no launch; batched_posteriors on the
    CPU goes through it."""
    loci = _unequal_window()
    arrays, S_max = port.pad_window(loci)
    g = [torch.from_numpy(x) for x in arrays]
    em_cuda.reset_launches()
    P, tot = em_cuda.window_posteriors(
        *g, S_max, [l["log_aln_probs"].shape[0] for l in loci])
    want_P, want_tot, _ = port.calc_log_sample_posteriors(
        *g[:4], S_max, g[5], read_mask=g[4])
    assert torch.equal(P, want_P) and torch.equal(tot, want_tot)
    out = port.batched_posteriors(loci, "cpu")
    for i, (l, (bP, btot)) in enumerate(zip(loci, out)):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        np.testing.assert_array_equal(bP, P[i, :S, :A, :A].numpy())
        np.testing.assert_array_equal(btot, tot[i, :S].numpy())
    assert not any(em_cuda.launches.values())
