"""Seeded cases of the window posteriors (J3) and the EM train loop (J4),
shared by the CPU tests, the card tests (tests/test_torch_cuda.py) and
chip_smoke.py: the locus and window builders, the plain train loop on a
mesh's devices in ``em_train_sharded``'s form, and the tolerances each
pair of results is held to.

It imports no JAX and nothing of the JAX package; pytest does not collect
it.
"""

import numpy as np
import torch

from longtr_tpu_torch.models.em import EMStutterGenotyper
from longtr_tpu_torch.models.stutter import StutterModel
from longtr_tpu_torch.parallel import mesh as pm


def simulate_reads(rng, model, allele_pairs, reads_per_sample):
    """Per-sample read bp-diffs from diploid genotypes + stutter (the
    simulation of tests/test_em_stutter.py, with its own generator)."""
    diffs = np.arange(-30, 31)
    pmf = np.exp(model.log_pmf_table(diffs))
    pmf /= pmf.sum()
    out = []
    for a, b in allele_pairs:
        out.append([int((a if rng.random() < 0.5 else b)
                        + rng.choice(diffs, p=pmf))
                    for _ in range(reads_per_sample)])
    return out


def em_case(name):
    rng = np.random.default_rng({"diploid": 5, "haploid": 6,
                                 "max_iter": 7}[name])
    if name == "haploid":
        truth = StutterModel(0.9, 0.08, 0.10, 0.85, 0.015, 0.015, "NN")
        pairs = [(0, 0), (4, 4), (-4, -4), (8, 8), (2, 2)] * 6
    else:
        truth = StutterModel(0.9, 0.10, 0.12, 0.85, 0.015, 0.015, "NN")
        pairs = [(0, 0), (0, 4), (4, 4), (0, -4), (-4, 4), (4, 8), (1, 4)] * 5
    num_bps = simulate_reads(rng, truth, pairs, 23)
    # phased reads: per-read haplotype log-weights, as --snp-vcf gives them
    u = [rng.uniform(0.05, 0.95, len(s)) for s in num_bps]
    p1 = [np.log(x).tolist() for x in u]
    p2 = [np.log1p(-x).tolist() for x in u]
    em = EMStutterGenotyper(name == "haploid", "NN", num_bps, p1, p2,
                            [f"S{i}" for i in range(len(pairs))])
    return em.mesh_inputs(), (3 if name == "max_iter" else 100)


def random_case(rng, R=40, A=5, S=3, haploid=False, phased=False):
    LL = -rng.exponential(20, size=(R, A))
    LL[rng.random((R, A)) < 0.05] = -900      # exercise the -600 clamp
    if phased:
        p1 = np.where(rng.random(R) < 0.5, -1e-6, -1000.0)
        p2 = np.where(p1 == -1e-6, -1000.0, -1e-6)
    else:
        p1 = np.zeros(R)
        p2 = np.zeros(R)
    labels = rng.integers(0, S, size=R).astype(np.int32)
    return dict(log_aln_probs=LL, log_p1=p1, log_p2=p2, sample_label=labels,
                num_samples=S, haploid=haploid)


def posterior_window(seed=21):
    """Loci of unequal R, A and S (one haploid, one of one allele, one
    phased) and one at chip_smoke.py's realistic size (R=2000, A=12,
    S=3)."""
    rng = np.random.default_rng(seed)
    shapes = [dict(R=40, A=5, S=3), dict(R=12, A=2, S=1),
              dict(R=33, A=6, S=2, haploid=True),
              dict(R=60, A=4, S=4, phased=True), dict(R=7, A=1, S=2),
              dict(R=2000, A=12, S=3)]
    return [random_case(rng, **kw) for kw in shapes]


def real_window(seed=12, L=256):
    """A window at the shape the 512-STR catalog sends with
    LONGTR_DEVICE_POSTERIOR=1, (L, R_max, A_max, S_max) = (256, 60, 4, 3):
    each locus 30-60 reads of 3 samples and 1-4 alleles, its reads grouped
    by sample (as the pipeline lists them) or, one locus in four, in a
    random order; the first locus at the full (60, 4)."""
    rng = np.random.default_rng(seed)
    loci = []
    for i in range(L):
        R, A = (60, 4) if i == 0 else (int(rng.integers(30, 61)),
                                       int(rng.integers(1, 5)))
        c = random_case(rng, R=R, A=A, S=3)
        if i % 4:
            c["sample_label"] = np.sort(c["sample_label"])
        loci.append(c)
    return loci


def mixed_window(seed=13, L=256):
    """``real_window``'s loci with one of them, the 101st (or the middle
    one of fewer), replaced by a VNTR-sized locus of R=2000 reads, A=12
    alleles and S=3 samples: a window that holds both routes of the
    window kernel."""
    loci = real_window(seed, L)
    loci[min(100, L // 2)] = random_case(np.random.default_rng(seed + 1),
                                         R=2000, A=12, S=3)
    return loci


def assert_posteriors_close(got_P, got_tot, want_P, want_tot):
    """tests/test_posterior.py's tolerances on one locus: log posteriors
    within atol 5e-3 where the reference is above -50, totals within rtol
    1e-5 / atol 1e-2, the MAP diplotypes equal."""
    got_P, want_P = (np.asarray(x, np.float64) for x in (got_P, want_P))
    mask = want_P > -50
    np.testing.assert_allclose(got_P[mask], want_P[mask], atol=5e-3)
    np.testing.assert_allclose(np.asarray(got_tot, np.float64),
                               np.asarray(want_tot, np.float64), rtol=1e-5,
                               atol=1e-2)
    S = want_P.shape[0]
    np.testing.assert_array_equal(np.argmax(got_P.reshape(S, -1), axis=1),
                                  np.argmax(want_P.reshape(S, -1), axis=1))


def plain_em_train(mesh, tables, max_iter, min_abs, min_frac):
    """The plain train loop (the EM kernel's plain version) on ``mesh``'s
    devices, cards included, on ``em_train_sharded``'s arguments; host
    values like it."""
    S, A = tables[10], np.shape(tables[0])[1]
    return pm.em_result(pm.em_train_plain(
        mesh, pm.em_tables(*tables[:9], mesh.size),
        torch.from_numpy(np.asarray(tables[9], np.float32)), num_samples=S,
        haploid=tables[11], max_iter=max_iter, min_abs=min_abs,
        min_frac=min_frac), S, A)


def assert_em_close(got, want):
    """tests/test_torch_mesh.py's tolerances between two trains:
    (converged, n_iter) equal, parameters within 1e-5, log-posteriors
    within rtol 1e-6 / atol 1e-4, posterior probabilities within 1e-5,
    totals within rtol 1e-6 / atol 1e-4."""
    assert (got[0], got[2]) == (want[0], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np.exp(got[3]), np.exp(want[3]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=1e-4)


def cohort_case():
    """The EM tables of a 300-sample cohort, 4 reads a sample, diploid
    genotypes over even length differences of -12 .. 12."""
    rng = np.random.default_rng(12)
    truth = StutterModel(0.9, 0.10, 0.12, 0.85, 0.015, 0.015, "NN")
    pairs = [tuple(int(x) for x in rng.choice(np.arange(-12, 13, 2), 2))
             for _ in range(300)]
    num_bps = simulate_reads(rng, truth, pairs, 4)
    zeros = [[0.0] * len(b) for b in num_bps]
    return EMStutterGenotyper(False, "NN", num_bps, zeros, zeros,
                              [f"S{i}" for i in range(len(pairs))]
                              ).mesh_inputs()


def realistic_em_locus():
    """A factory of the EM trainer of one locus at a realistic size: 2000
    reads of 3 diploid samples over 12 distinct length differences of a
    dinucleotide repeat (in-frame and out-of-frame), drawn from a seed."""
    rng = np.random.default_rng(7)
    lengths = np.array([-8, -6, -4, -3, -2, -1, 0, 1, 2, 4, 6, 8])
    num_bps = []
    for (a, b), n in zip(((-4, 0), (0, 4), (2, 6)), (667, 667, 666)):
        w = np.exp(-np.abs(lengths - a)) + np.exp(-np.abs(lengths - b))
        num_bps.append(rng.choice(lengths, n, p=w / w.sum()).tolist())
    zeros = [[0.0] * len(x) for x in num_bps]
    names = ["S1", "S2", "S3"]
    return lambda: EMStutterGenotyper(False, "NN", num_bps, zeros, zeros,
                                      names)
