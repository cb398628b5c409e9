"""The port's mesh (longtr_tpu_torch.parallel.mesh) against the JAX package.

On the CPU a mesh of the port is a list of ``cpu`` devices, the
counterpart of the JAX package's eight virtual CPU devices
(tests/conftest.py).  The same seeded numpy inputs go through
``longtr_tpu.parallel.mesh`` on ``make_mesh(8)`` and through the port:

* ``pairhmm_batch_sharded`` on 1, 3 and 8 shards equals the port's
  single-device batch and the JAX package's sharded batch exactly;
* ``em_train_sharded`` (diploid, haploid, stopped by ``max_iter``) stops
  at the same iteration with the same ``converged``; parameters within
  1e-5, posteriors within 1e-4 (both float32 programs; the sums run in
  another order);
* the port's counterparts of tests/test_em_stutter.py's mesh tests;
* ``batched_posteriors`` over a mesh equals the meshless call bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu.parallel import mesh as jax_mesh
from longtr_tpu_torch.models.em import EMStutterGenotyper
from longtr_tpu_torch.models.stutter import StutterModel
from longtr_tpu_torch.ops import pairhmm as ph
from longtr_tpu_torch.ops.posterior import batched_posteriors
from longtr_tpu_torch.parallel import mesh as port_mesh
from longtr_tpu_torch.parallel.mesh import Mesh
from longtr_tpu_torch.pipeline.seq_genotyper import _gather

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import em_case, simulate_reads  # noqa: E402


def cpu_mesh(n):
    return Mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def pair_batch():
    """tests/test_sharding.py's batch: B=83, not a multiple of the grid."""
    rng = np.random.default_rng(9)
    bases = np.array(list("ACGT"))
    B, N, M = 83, 96, 90
    haps = ["".join(rng.choice(bases, size=int(rng.integers(40, N))))
            for _ in range(B)]
    reads = ["".join(ch for ch in h if rng.random() > 0.01)[:M] for h in haps]
    hap_codes = np.stack([ph.encode_seq(h, N) for h in haps])
    read_codes = np.stack([ph.encode_seq(r, M) for r in reads])
    hl = np.array([len(h) for h in haps], np.int32)
    rl = np.array([len(r) for r in reads], np.int32)
    return hap_codes, hl, read_codes, rl, hl + 60


@pytest.fixture(scope="module")
def jax_sharded_scores(pair_batch):
    from longtr_tpu.ops.pairhmm import AlignmentParams
    return jax_mesh.pairhmm_batch_sharded(*pair_batch, AlignmentParams(),
                                          mesh=jax_mesh.make_mesh(8))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_pairhmm_batch_sharded_matches_single_device_and_jax(
        pair_batch, jax_sharded_scores, shards):
    single = ph.pairhmm_batch_auto(*pair_batch, device="cpu").numpy()
    out = port_mesh.pairhmm_batch_sharded(*pair_batch, ph.AlignmentParams(),
                                          mesh=cpu_mesh(shards))
    step = -(-83 // shards)
    assert [len(s) for s in out] == [min(step, 83 - k * step)
                                     for k in range(shards)]
    got = _gather([out])[0]
    assert got.shape == (83,)
    assert np.array_equal(got, single.astype(np.float64))
    assert np.array_equal(got, np.asarray(jax_sharded_scores, np.float64))


def test_pairhmm_batch_auto_routes_to_the_mesh(pair_batch):
    """A mesh of more than one shard takes the batch; its padded rows are
    counted per route like any other."""
    before = dict(ph.pairs_scored)
    out = ph.pairhmm_batch_auto(*pair_batch, mesh=cpu_mesh(8))
    assert isinstance(out, list) and len(out) == 8
    assert ph.pairs_scored["cpu"] - before["cpu"] == 88
    one = ph.pairhmm_batch_auto(*pair_batch, device="cpu",
                                mesh=cpu_mesh(1))
    assert isinstance(one, torch.Tensor)
    assert np.array_equal(_gather([out])[0], one.numpy())


def test_shard_batch_and_padding():
    a = np.arange(12).reshape(6, 2)
    (shards,) = port_mesh.shard_batch(cpu_mesh(3), a)
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                            [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="does not split evenly"):
        port_mesh.shard_batch(cpu_mesh(4), a)
    (p,), n = port_mesh.pad_to_multiple((a,), 4)
    assert n == 6 and p.shape == (8, 2) and not p[6:].any()
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    assert port_mesh._psum(cpu_mesh(3), [torch.tensor([1.0]),
                                         torch.tensor([2.0]),
                                         torch.tensor([4.0])]).item() == 7.0


def test_gather_mixed_chunks():
    """_gather takes host arrays, tensors and lists of shards in one call
    and keeps their order."""
    chunks = [np.array([1.0, 2.0]), torch.tensor([3.0], dtype=torch.float32),
              [torch.tensor([4.0, 5.0]), torch.tensor([6.0])]]
    got = _gather(chunks)
    assert [g.tolist() for g in got] == [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]]
    assert all(g.dtype == np.float64 for g in got)


# ---------------------------------------------------------------------------
# EM stutter training on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["diploid", "haploid", "max_iter"])
def test_em_train_sharded_matches_jax(name):
    tables, max_iter = em_case(name)
    args = (*tables, max_iter, 0.01, 0.001)
    want = jax_mesh.em_train_sharded(jax_mesh.make_mesh(8), *args)
    got = port_mesh.em_train_sharded(cpu_mesh(8), *args)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[0] == (name != "max_iter")
    if name == "max_iter":
        assert got[2] == 3
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    # log-posteriors reach -600 here, where one float32 step is 6.1e-5:
    # the other summation order moves the largest by a few steps
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np.exp(got[3]), np.exp(want[3]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=1e-4)
    # the mesh size changes only the order of the sums
    three = port_mesh.em_train_sharded(cpu_mesh(3), *args)
    assert three[0] == got[0] and three[2] == got[2]
    np.testing.assert_allclose(three[1], got[1], rtol=0, atol=1e-5)


def test_em_first_iteration_does_not_stop_on_nan():
    """LL starts at -inf, so the first iteration's frac_change is NaN and
    its LL test cannot stop it: with parameters that move, a one-step
    budget ends unconverged."""
    tables, _ = em_case("diploid")
    converged, params, n_iter, P, totals = port_mesh.em_train_sharded(
        cpu_mesh(2), *tables, 1, 1e9, 1e9)
    assert (converged, n_iter) == (False, 1)
    assert np.isfinite(params).all() and np.isfinite(totals).all()
    zero = port_mesh.em_train_sharded(cpu_mesh(2), *tables, 0, 0.01, 0.001)
    assert zero[:1] == (False,) and zero[2] == 0 and not zero[3].any()


def _names(n):
    return [f"S{i}" for i in range(n)]


@pytest.fixture(scope="module")
def em_stutter_reads():
    """The reads of tests/test_em_stutter.py's three mesh tests: its module
    generator, default_rng(99), drawn by its tests in file order."""
    rng = np.random.default_rng(99)
    nn = StutterModel(0.9, 0.10, 0.12, 0.85, 0.015, 0.015, "NN")
    eight = [(0, 0), (0, 4), (4, 4), (0, -4), (-4, 4), (0, 0), (4, 8), (0, 8)]
    draws = [(nn, eight * 12, 30),
             (StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, "NNN"),
              [(0, 6), (0, 0), (6, 6), (3, 6)] * 10, 25),
             (StutterModel(0.9, 0.08, 0.08, 0.9, 0.01, 0.01, "N"),
              [(0, 0), (3, 3), (0, 0), (5, 5)] * 8, 20),
             (nn, [(0, 0), (0, 4), (4, 4), (0, -4), (-4, 4), (4, 8)] * 8, 25),
             (nn, eight * 12, 30),
             (StutterModel(0.9, 0.08, 0.10, 0.85, 0.015, 0.015, "NN"),
              [(0, 0), (4, 4), (-4, -4), (8, 8)] * 10, 25)]
    reads = [simulate_reads(rng, m, pairs, n) for m, pairs, n in draws]
    return dict(zip(("estep", "recovers", "haploid"), reads[3:]))


def _trained(haploid, num_bps, mesh=None):
    zeros = [[0.0] * len(s) for s in num_bps]
    em = EMStutterGenotyper(haploid, "NN", num_bps, zeros, zeros,
                            _names(len(num_bps)))
    assert em.train(mesh=mesh)
    return em


PARAMS = ("in_geom", "in_up", "in_down", "out_geom", "out_up", "out_down")


def test_em_mesh_estep_matches_host(em_stutter_reads):
    """Port of test_em_stutter.test_em_mesh_estep_matches_host: the train
    loop on an 8-shard CPU mesh reaches the host path's stutter model."""
    host = _trained(False, em_stutter_reads["estep"])
    before = port_mesh.em_trains["cpu"]
    em = _trained(False, em_stutter_reads["estep"], cpu_mesh(8))
    assert port_mesh.em_trains["cpu"] == before + 1
    h, m = host.stutter_model, em.stutter_model
    for attr in PARAMS:
        assert getattr(m, attr) == pytest.approx(getattr(h, attr), abs=2e-3)
    np.testing.assert_allclose(em.posteriors, host.posteriors, atol=1e-3)


def test_em_mesh_recovers_stutter_params(em_stutter_reads):
    """Port of test_em_stutter.test_em_mesh_recovers_stutter_params."""
    truth = StutterModel(0.9, 0.10, 0.12, 0.85, 0.015, 0.015, "NN")
    m = _trained(False, em_stutter_reads["recovers"], cpu_mesh(8)).stutter_model
    assert m.in_up == pytest.approx(truth.in_up, abs=0.05)
    assert m.in_down == pytest.approx(truth.in_down, abs=0.05)
    assert m.in_geom == pytest.approx(truth.in_geom, abs=0.1)
    assert m.out_up == pytest.approx(truth.out_up, abs=0.03)
    assert m.out_down == pytest.approx(truth.out_down, abs=0.03)


def test_em_mesh_haploid_matches_host(em_stutter_reads):
    """Port of test_em_stutter.test_em_mesh_haploid_matches_host."""
    h = _trained(True, em_stutter_reads["haploid"]).stutter_model
    m = _trained(True, em_stutter_reads["haploid"], cpu_mesh(8)).stutter_model
    for attr in PARAMS:
        assert getattr(m, attr) == pytest.approx(getattr(h, attr), abs=5e-3)


# ---------------------------------------------------------------------------
# Window posteriors on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [3, 8])
def test_batched_posteriors_mesh_bit_identical(shards):
    """Loci split over the shards give the meshless call's bits; 5 loci
    leave some of the 8 shards empty."""
    rng = np.random.default_rng(41)
    loci = []
    for i in range(5 if shards == 8 else 11):
        R, A, S = int(rng.integers(3, 40)), int(rng.integers(1, 6)), \
            int(rng.integers(1, 4))
        loci.append(dict(
            log_aln_probs=rng.uniform(-700, 0, (R, A)).astype(np.float32),
            log_p1=np.log(rng.uniform(0.1, 0.9, R)).astype(np.float32),
            log_p2=np.log(rng.uniform(0.1, 0.9, R)).astype(np.float32),
            sample_label=rng.integers(0, S, R), num_samples=S,
            haploid=bool(i % 3 == 0)))
    want = batched_posteriors(loci, "cpu")
    got = batched_posteriors(loci, mesh=cpu_mesh(shards))
    for (P, t), (Pw, tw) in zip(got, want):
        assert np.array_equal(P, Pw) and np.array_equal(t, tw)
