"""The benchmark's plain mode-B reference (``port_bench/pbref/mode_b.py``)
against the JAX package's float64 host mode B and the port's device path,
on the CPU.

The loci are the homopolymers of ``dryrun_catalog`` as the port genotyped
them under ``--stutter-align-len 25`` (its pooled reads, its candidate
haplotypes) and the seeded mode-B fixtures of ``tests/test_torch_cuda.py``
(reads with substitution noise, alleles shorter than the largest
deletion).  Tolerances:

* against ``longtr_tpu.pipeline.mode_b.ModeBAligner.score_read`` 1e-9
  absolute: both are float64 and the same arithmetic up to the order of
  the sums (the reference sums each alignment from the read's emissions
  where upstream updates a running score), a few ulps of scores near -100;
* against the port's device path on CPU tensors (float32 rows, float64
  marginalization) rtol 1e-4 / atol 1e-4, the bound
  ``tests/test_torch_mode_b.py`` holds the port's float32 LLs to the host
  float64 by: the rows' float32 rounding; with its rows in float32 too
  (its default, what the benchmark's check scores with) the reference
  gives the port's bits, tolerance 0;
* a stutter model of 0.90 in place of the default 0.95 moves the
  reference's scores by more than that bound, so the benchmark's check
  can tell a wrong prior from rounding.
"""

import functools
import os
import sys

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

from longtr_tpu_torch.cli import main as port_main
from longtr_tpu_torch.pipeline import processor
from longtr_tpu_torch.pipeline.mode_b import ModeBAligner as PortAligner
from longtr_tpu_torch.testing.catalogs import dryrun_catalog

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "port_bench"))
from pbref import mode_b as ref  # noqa: E402
from test_torch_cuda import MODE_B_CASES, mode_b_case  # noqa: E402
from test_torch_mode_b import jax_classes  # noqa: E402

CPU = torch.device("cpu")
F64_TOL = 1e-9
F32_RTOL = F32_ATOL = 1e-4
WRONG_PRIOR = (0.90, 0.05, 0.05, 0.90, 0.01, 0.01)
# the fixtures the reference scores: Dindel's transitions (it scores no
# other), every other case
CASES = sorted(c for c in MODE_B_CASES if "custom" not in c)
HOMOPOLYMERS = ["chr1_HOMO4", "chr1_HOMO9", "chr2_HOMO4", "chr2_HOMO9"]


class _Locus:
    """What the reference reads of a genotyper: its haplotype and its
    pooled reads."""

    def __init__(self, haplotype, alns):
        self.haplotype = haplotype
        self.pooler = type("Pooler", (), {"pooled_alns": alns})()


@pytest.fixture(scope="module")
def dryrun_loci(tmp_path_factory):
    """{locus: genotyper} of the dryrun catalog's homopolymers, as the
    port genotyped them under --stutter-align-len 25."""
    tmp = tmp_path_factory.mktemp("dryrun")
    fx = dryrun_catalog(str(tmp))
    got = {}
    orig = processor.write_vcf_record

    def keep(gt, *args, **kw):
        if gt._use_mode_b():
            got[gt.region_group.regions[0].name] = gt
        return orig(gt, *args, **kw)

    processor.write_vcf_record = keep
    try:
        assert port_main(["--bams", ",".join(fx["bams"]), "--fasta",
                          fx["fasta"], "--regions", fx["bed"], "--tr-vcf",
                          str(tmp / "out.vcf.gz"), "--min-reads", "5",
                          "--quiet", "--use-unpaired",
                          "--stutter-align-len", "25"], device=CPU) == 0
    finally:
        processor.write_vcf_record = orig
    assert sorted(got) == HOMOPOLYMERS
    return got


def _jax_locus(gt):
    """The JAX package's haplotype and pooled reads of a port genotyper."""
    c = jax_classes()
    blocks = []
    for b in gt.haplotype.blocks:
        if b.repeat_info is not None:
            nb = c.RepeatBlock(b.start, b.end, b.seqs[0], b.period,
                               c.default_stutter_model().with_period(b.period))
        else:
            nb = c.HapBlock(b.start, b.end, b.seqs[0])
        for s, inexact in zip(b.seqs[1:], b.inexact[1:]):
            nb.add_alternate(s, inexact)
        blocks.append(nb)
    alns = []
    for a in gt.pooler.pooled_alns:
        j = c.Alignment(a.start, a.stop, a.rev_strand, a.deleted, a.name,
                        a.base_qualities, a.sequence, a.alignment)
        j.cigar = [tuple(op) for op in a.cigar]
        alns.append(j)
    return c.Haplotype(blocks), alns


def _jax_scores(hap, alns):
    """longtr_tpu's float64 host mode B: score_read of each seedable read,
    a zero row for the others (HapAligner.cpp:570-574)."""
    from longtr_tpu.pipeline.mode_b import ModeBAligner, calc_seed_base
    aligner = ModeBAligner(hap)
    hs, he = hap.blocks[0].start, hap.blocks[-1].end
    out = np.zeros((len(alns), hap.num_combs()))
    for p, a in enumerate(alns):
        s = calc_seed_base(a, aligner.repeat_starts, aligner.repeat_ends,
                           hs, he)
        if s >= 0:
            out[p] = aligner.score_read(a, s)
    return out


def _locus(request, name):
    """(the reference's view of a locus, the JAX package's (haplotype,
    reads)) of a dryrun homopolymer or a fixture case."""
    if name in HOMOPOLYMERS:
        gt = request.getfixturevalue("dryrun_loci")[name]
        return gt, _jax_locus(gt)
    port = functools.partial(PortAligner, device="cpu")
    aligner, alns, _seeds = mode_b_case(name, port)
    from longtr_tpu.pipeline.mode_b import ModeBAligner as JaxAligner
    _ja, jalns, _js = mode_b_case(name, JaxAligner, cls=jax_classes())
    return _Locus(aligner.hap, alns), (_ja.hap, jalns)


@pytest.mark.parametrize("name", HOMOPOLYMERS + CASES)
def test_reference_equals_the_jax_packages_f64_mode_b(request, name):
    gt, (jhap, jalns) = _locus(request, name)
    got = ref.score(gt, gt.haplotype.all_seqs(), CPU, rows=torch.float64)
    want = _jax_scores(jhap, jalns)
    assert got.shape == want.shape == (len(gt.pooler.pooled_alns),
                                       gt.haplotype.num_combs())
    assert np.abs(got - want).max() <= F64_TOL


def _port_scores(gt):
    """The port's default mode-B path on CPU tensors: its host phase, the
    plain artifact tables and float32 rows, the float64 marginalization."""
    from longtr_tpu_torch.pipeline.mode_b import calc_seed_base
    aligner = PortAligner(gt.haplotype, device="cpu")
    hs, he = gt.haplotype.blocks[0].start, gt.haplotype.blocks[-1].end
    alns = gt.pooler.pooled_alns
    seeds = [calc_seed_base(a, aligner.repeat_starts, aligner.repeat_ends,
                            hs, he) for a in alns]
    live = [p for p, s in enumerate(seeds) if s >= 0]
    out = np.zeros((len(alns), gt.haplotype.num_combs()))
    out[live] = aligner.score_reads_batch([alns[p] for p in live],
                                          [seeds[p] for p in live])
    return out


@pytest.mark.parametrize("name", HOMOPOLYMERS + CASES)
def test_reference_is_near_the_ports_device_path(request, name):
    """The float64 reference within the port's float32 rounding."""
    gt, _jax = _locus(request, name)
    got = ref.score(gt, gt.haplotype.all_seqs(), CPU, rows=torch.float64)
    np.testing.assert_allclose(got, _port_scores(gt), rtol=F32_RTOL,
                               atol=F32_ATOL)


@pytest.mark.parametrize("name", HOMOPOLYMERS + CASES)
def test_float32_rows_give_the_ports_scores_bit_for_bit(request, name):
    """In the configuration's precision (float32 rows, the default the
    check scores in) the reference gives the program's own bits: the rows
    in the plain versions' order on the artifact terms rounded from
    float64, the marginalization's sums in upstream's order."""
    gt, _jax = _locus(request, name)
    got = ref.score(gt, gt.haplotype.all_seqs(), CPU)
    np.testing.assert_array_equal(got, _port_scores(gt))


@pytest.mark.parametrize("name", HOMOPOLYMERS + CASES[:3])
def test_a_wrong_stutter_prior_moves_the_reference(request, name):
    gt, _jax = _locus(request, name)
    seqs = gt.haplotype.all_seqs()
    right = ref.score(gt, seqs, CPU)
    wrong = ref.score(gt, seqs, CPU, model=WRONG_PRIOR)
    assert not np.allclose(wrong, right, rtol=F32_RTOL, atol=F32_ATOL)
