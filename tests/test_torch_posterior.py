"""The port's diplotype posteriors (longtr_tpu_torch.ops.posterior) against
longtr_tpu's float32 device path and the float64 oracle, on the CPU.

Tolerances are tests/test_posterior.py's: normalized log posteriors within
atol 5e-3 where the oracle is above -50, per-sample totals within rtol
1e-5 / atol 1e-2, and the MAP diplotypes equal.  The batched call must
give each locus its own result and the same bits on every run.
"""

import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu.ops import posterior as jax_post
from longtr_tpu_torch.ops import posterior as port

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import random_case  # noqa: E402

CASES = {"diploid_unphased": dict(R=40, A=5, S=3),
         "diploid_phased": dict(R=60, A=4, S=4, phased=True),
         "haploid": dict(R=30, A=6, S=2, haploid=True),
         "single_allele": dict(R=10, A=1, S=2)}


def _close(got_P, got_tot, want_P, want_tot):
    got_P = np.asarray(got_P, dtype=np.float64)
    mask = want_P > -50
    np.testing.assert_allclose(got_P[mask], want_P[mask], atol=5e-3)
    np.testing.assert_allclose(np.asarray(got_tot), want_tot, rtol=1e-5,
                               atol=1e-2)
    S = want_P.shape[0]
    ga, gb = port.map_genotypes(torch.from_numpy(np.asarray(got_P)))
    np.testing.assert_array_equal(ga.numpy() * want_P.shape[1] + gb.numpy(),
                                  np.argmax(want_P.reshape(S, -1), axis=1))


def _f32(x):
    with np.errstate(over="ignore"):
        # the haploid het prior (-DBL_MAX/2) becomes -inf in float32
        return torch.from_numpy(np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_oracle_and_jax(case):
    rng = np.random.default_rng(7 + sorted(CASES).index(case))
    c = random_case(rng, **CASES[case])
    A, S = c["log_aln_probs"].shape[1], c["num_samples"]
    want = port.posteriors_oracle(c["log_aln_probs"], c["log_p1"], c["log_p2"],
                                  c["sample_label"], S, c["haploid"])
    jwant = jax_post.posteriors_oracle(c["log_aln_probs"], c["log_p1"],
                                       c["log_p2"], c["sample_label"], S,
                                       c["haploid"])
    for a, b in zip(want, jwant):
        np.testing.assert_array_equal(a, b)
    prior = port.genotype_log_priors(A, c["haploid"])
    np.testing.assert_array_equal(
        prior, jax_post.genotype_log_priors(A, c["haploid"]))
    got_P, got_tot, got_LL = port.calc_log_sample_posteriors(
        _f32(c["log_aln_probs"]), _f32(c["log_p1"]), _f32(c["log_p2"]),
        torch.from_numpy(c["sample_label"]), S, _f32(prior))
    assert got_P.dtype == torch.float32 and got_P.shape == (S, A, A)
    _close(got_P.numpy(), got_tot.numpy(), want[0], want[1])
    assert abs(float(got_LL) - want[2]) <= 1e-2 + 1e-5 * abs(want[2])
    with np.errstate(over="ignore"):
        j_P, j_tot, _ = jax_post.calc_log_sample_posteriors(
            c["log_aln_probs"].astype(np.float32),
            c["log_p1"].astype(np.float32), c["log_p2"].astype(np.float32),
            c["sample_label"], S, prior.astype(np.float32))
    _close(got_P.numpy(), got_tot.numpy(), np.asarray(j_P, np.float64),
           np.asarray(j_tot, np.float64))


def test_read_mask_excludes_padding():
    c = random_case(np.random.default_rng(20), R=20, A=3, S=2)
    want_P, want_tot, _ = port.posteriors_oracle(
        c["log_aln_probs"][:15], c["log_p1"][:15], c["log_p2"][:15],
        c["sample_label"][:15], 2, False)
    got_P, got_tot, _ = port.calc_log_sample_posteriors(
        _f32(c["log_aln_probs"]), _f32(c["log_p1"]), _f32(c["log_p2"]),
        torch.from_numpy(c["sample_label"]), 2,
        _f32(port.genotype_log_priors(3, False)),
        read_mask=torch.arange(20) < 15)
    _close(got_P.numpy(), got_tot.numpy(), want_P, want_tot)


def _window():
    """Loci of different R, A and S, one of them haploid."""
    rng = np.random.default_rng(21)
    shapes = [dict(R=40, A=5, S=3), dict(R=12, A=2, S=1),
              dict(R=33, A=6, S=2, haploid=True), dict(R=60, A=4, S=4,
                                                       phased=True),
              dict(R=7, A=1, S=2)]
    return [random_case(rng, **kw) for kw in shapes]


def test_batched_window_matches_each_locus():
    loci = _window()
    out = port.batched_posteriors(loci, torch.device("cpu"))
    jout = jax_post.batched_posteriors(loci)
    again = port.batched_posteriors(loci, "cpu")
    assert len(out) == len(loci)
    for l, (P, tot), (jP, jtot), (P2, tot2) in zip(loci, out, jout, again):
        A, S = l["log_aln_probs"].shape[1], l["num_samples"]
        assert P.dtype == np.float32 and P.shape == (S, A, A)
        assert tot.shape == (S,)
        # bit-identical from call to call
        np.testing.assert_array_equal(P, P2)
        np.testing.assert_array_equal(tot, tot2)
        want = port.posteriors_oracle(l["log_aln_probs"], l["log_p1"],
                                      l["log_p2"], l["sample_label"], S,
                                      l["haploid"])
        _close(P, tot, want[0], want[1])
        _close(P, tot, np.asarray(jP, np.float64), np.asarray(jtot, np.float64))
        # the locus alone, unpadded
        one_P, one_tot, _ = port.calc_log_sample_posteriors(
            _f32(l["log_aln_probs"]), _f32(l["log_p1"]), _f32(l["log_p2"]),
            torch.from_numpy(l["sample_label"]), S,
            _f32(port.genotype_log_priors(A, l["haploid"])))
        _close(P, tot, one_P.numpy().astype(np.float64),
               one_tot.numpy().astype(np.float64))


def test_map_genotypes_ties_take_the_first():
    P = torch.full((2, 3, 3), -5.0)
    P[0, 1, 2] = P[0, 2, 1] = 0.0
    P[1, 0, 0] = P[1, 2, 2] = -1.0
    a, b = port.map_genotypes(P)
    assert a.tolist() == [1, 0] and b.tolist() == [2, 0]
