"""A numpy model of the window posteriors kernel
(csrc/em.cu::window_posteriors_kernel, J3) against the plain torch
posteriors, the JAX package and the float64 oracle, on the CPU.

The kernel cannot run here, so its work split is held through a model that
takes it in its order, in float32: one locus at a time (a cluster of KB
blocks, ``em_cuda.window_plan``), the unmasked reads sorted by sample
stably (the kernel's counting sort, emulated lane by lane below), block k
taking every KB-th tile of CH sorted reads; each (sample, a1, a2) sums its
sample's terms of a block's tiles in read order in float64, the blocks'
partials added in block order and rounded once, the prior added; a
sample's logsumexp over its A*A entries a warp's (lane-strided sums, then
a butterfly).  Elementwise functions are torch's on the CPU, as the plain
version's are.

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
from _torch_cases import random_case  # noqa: E402
from test_torch_posterior import _close, _f32, _window  # noqa: E402


def emulate_block_sort(keys, nkeys):
    """The kernel's block_sort, lane by lane: rounds of 32 items; in a
    round the lanes of one key see each other (__match_any_sync), each
    writes at its key's cursor plus the lanes of its key below it, and the
    lowest of them moves the cursor.  Returns (start (nkeys + 1), order)."""
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


def window_model(LL, p1, p2, label, mask, prior, num_samples):
    """The kernel's (P (L, S, A, A), totals (L, S)) on a padded window."""
    L, R, A = LL.shape
    S = num_samples
    KB, CH = em_cuda.window_plan(S, A)
    P = np.zeros((L, S, A, A), F32)
    totals = np.zeros((L, S), F32)
    for i in range(L):
        keys = np.where(mask[i] & (label[i] >= 0) & (label[i] < S),
                        label[i], -1)
        start, order = emulate_block_sort(keys, S)
        LLc = np.where(LL[i] < F32(-600), F32(-600), LL[i]).astype(F32)
        a = (LLc + p1[i][:, None]) + LOG_HALF
        b = (LLc + p2[i][:, None]) + LOG_HALF
        for s in range(S):
            pos = np.arange(start[s], start[s + 1])
            blk = (pos // CH) % KB          # the block that takes each read
            part = np.zeros((KB, A, A), F64)
            for k in range(KB):
                rows = order[pos[blk == k]]
                part[k] = seqsum(lae(a[rows][:, :, None],
                                     b[rows][:, None, :]), dtype=F64)
            P[i, s] = seqsum(part, dtype=F64).astype(F32) + prior[i]
        totals[i] = warp_lse(P[i].reshape(S, -1))
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
    P, tot = window_model(*(x.numpy() for x in args), label.numpy(),
                          mask.numpy(), prior[None].numpy(), S)
    if c["haploid"]:
        assert np.isneginf(prior.numpy()).any()
    plain_P, plain_tot = em_cuda.window_posteriors(*args, label, mask,
                                                   prior[None], S)
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
    one of 700 reads, whose tiles spread over six of the cluster's
    blocks."""
    loci = _window()
    rng = np.random.default_rng(22)
    one = random_case(rng, R=70, A=3, S=3)
    one["sample_label"][:] = 2
    late = random_case(rng, R=45, A=7, S=2, phased=True)
    late["sample_label"] = np.r_[np.ones(30), np.zeros(15)].astype(np.int32)
    big = random_case(rng, R=700, A=10, S=3)
    return loci + [one, late, big]


def test_model_on_a_window_matches_each_locus():
    """On a padded window: each locus equals the plain window call,
    longtr_tpu's batched call, the oracle and the model's own locus alone
    at the tolerances."""
    loci = _unequal_window()
    arrays, S_max = port.pad_window(loci)
    KB, CH = em_cuda.window_plan(S_max, arrays[0].shape[2])
    assert KB == 8 and 700 > 5 * CH     # the big locus spans six blocks
    P, tot = window_model(*arrays, S_max)
    plain_P, plain_tot = em_cuda.window_posteriors(
        *(torch.from_numpy(x) for x in arrays), S_max)
    jout = jax_post.batched_posteriors(loci)
    for i, (l, (jP, jtot)) in enumerate(zip(loci, jout)):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        got_P, got_tot = P[i, :S, :A, :A], tot[i, :S]
        _close(got_P, got_tot, plain_P[i, :S, :A, :A].numpy().astype(F64),
               plain_tot[i, :S].numpy().astype(F64))
        _close(got_P, got_tot, np.asarray(jP, F64), np.asarray(jtot, F64))
        want = port.posteriors_oracle(l["log_aln_probs"], l["log_p1"],
                                      l["log_p2"], l["sample_label"], S,
                                      l["haploid"])
        _close(got_P, got_tot, want[0], want[1])
        alone, _S = port.pad_window([l])
        a_P, a_tot = window_model(*alone, S)
        _close(got_P, got_tot, a_P[0].astype(F64), a_tot[0].astype(F64))


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_model_is_the_same_on_any_split(shards):
    """The window split as batched_posteriors splits it over a mesh: each
    slice's model equals the whole window's bit for bit."""
    loci = _unequal_window()
    arrays, S_max = port.pad_window(loci)
    whole = window_model(*arrays, S_max)
    step = -(-len(loci) // shards)
    parts = [window_model(*(x[k:k + step] for x in arrays), S_max)
             for k in range(0, len(loci), step)]
    for j in range(2):
        np.testing.assert_array_equal(
            np.concatenate([p[j] for p in parts]), whole[j])


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
    P, tot = em_cuda.window_posteriors(*g, S_max)
    want_P, want_tot, _ = port.calc_log_sample_posteriors(
        *g[:4], S_max, g[5], read_mask=g[4])
    assert torch.equal(P, want_P) and torch.equal(tot, want_tot)
    out = port.batched_posteriors(loci, "cpu")
    for i, (l, (bP, btot)) in enumerate(zip(loci, out)):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        np.testing.assert_array_equal(bP, P[i, :S, :A, :A].numpy())
        np.testing.assert_array_equal(btot, tot[i, :S].numpy())
    assert not any(em_cuda.launches.values())
