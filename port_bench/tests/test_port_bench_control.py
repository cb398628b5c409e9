"""The control and the planted faults come out not correct; the program
comes out correct.  On the CPU, at a size a test run holds: the program
takes its plain versions there, the reference is the same either way.

The check follows what the configuration's flags select, so the
configuration is varied here in memory (never in ``BENCHMARK.json``): its
transitions, its phasing, mode B's route; a program that departs from
what the flags select comes out not correct."""

import time

import pytest
import torch

from _paths import HARNESS
from pbench import cells, check, control, runner

CELL = "str_mix.hifi_trio"
ONT_LIKE = "--alignment-params=-1.5,-0.3,-1.5,-0.3,-0.0001,-8.0,-8.0"
SCORING = ("pairhmm_gap", "vcf_gap")


def _cell(flags=None, reads=None, checks=None):
    cell = cells.find(HARNESS + "/..", HARNESS, CELL)
    cell.traffic.update(n_loci=12, warm_loci=2)
    cell.config["reads"]["coverage"] = 10
    cell.config["reads"].update(reads or {})
    cell.checks["sample"].update(loci=6, rows_per_call=10 ** 6)
    cell.checks.update(checks or {})
    if flags is not None:
        cell.config["flags"] = flags
    return cell


def _run(monkeypatch, hook=None, seed=11, cell=None, harness=HARNESS):
    monkeypatch.setenv("LONGTR_TORCH_DEVICE", "cpu")
    return runner.run_cell(cell or _cell(), harness, seed, 0.5, 0,
                           torch.device("cpu"), time.perf_counter(),
                           log=lambda s: None, setup_hook=hook)


def _without(flag):
    return [f for f in _cell().config["flags"] if f != flag]


def test_the_program_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"] is True
    assert set(res["checks"]) == {"pairhmm_gap", "vcf_gap", "unscored_share"}
    assert res["checks"]["unscored_share"]["value"] == 0


def test_the_bfloat16_control_fails_both_scoring_numbers(monkeypatch):
    """Every number that compares scores; it scores every locus the
    program does."""
    res = _run(monkeypatch, control.bf16_control)
    assert res["correct"] is False
    for name in SCORING:
        v = res["checks"][name]
        assert v["value"] > v["limit"], name
    assert res["checks"]["unscored_share"]["value"] == 0


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer",
                                   "phasing_dropped", "mode_b_forced"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, getattr(control, fault))
    assert res["correct"] is False


def test_a_sampled_locus_never_written_counts_against_correct(monkeypatch):
    """A homopolymer whose genotyping fails is in no pass's VCF: it is
    unscored, and the run is not correct."""
    cell = _cell()
    cell.checks["sample"]["loci"] = cell.traffic["n_loci"]
    res = _run(monkeypatch, control.homopolymers_fail, cell=cell)
    share = res["checks"]["unscored_share"]
    assert res["correct"] is False
    assert res["failed"] > 0
    assert share["value"] > share["limit"]


@pytest.mark.parametrize("hook, correct", [(None, True),
                                           (control.default_transitions,
                                            False)])
def test_transitions_are_the_configurations(monkeypatch, hook, correct):
    """With --alignment-params the reference scores under its
    transitions: the program is correct, a program that ignores the flag
    is not."""
    cell = _cell(flags=_cell().config["flags"] + [ONT_LIKE])
    res = _run(monkeypatch, hook, cell=cell)
    assert res["correct"] is correct
    if not correct:
        v = res["checks"]["pairhmm_gap"]
        assert v["value"] > v["limit"]


@pytest.mark.parametrize("haplotags, hook, correct", [
    (False, None, True), (True, control.hp_priors_forced, False)])
def test_phasing_is_the_configurations(monkeypatch, haplotags, hook,
                                       correct):
    """Without --phased-bam the reference takes no phasing priors: an
    untagged catalog is correct, a program that takes the HP tags without
    the flag is not."""
    cell = _cell(flags=_without("--phased-bam"),
                 reads={"haplotags": haplotags})
    res = _run(monkeypatch, hook, cell=cell)
    assert res["correct"] is correct
    assert res["checks"]["unscored_share"]["value"] == 0


# the program's own final scores of each pool (the rows of its reads'
# log-likelihoods, none of them a mate's sum here: the catalog's reads are
# single), against the candidates as pruning left them
OWN_SCORES = '''import numpy as np


def score(gt, seqs, device):
    out = np.empty((int(gt.pool_index.max()) + 1, len(seqs)))
    out[gt.pool_index] = gt.log_aln_probs
    return out
'''


@pytest.mark.parametrize("scorer", [None, "own_scores"])
def test_a_route_without_a_scorer_counts_against_correct(
        monkeypatch, tmp_path, scorer):
    """The plumbing of a scoring route other than the pair-HMM, not mode B
    itself: with --stutter-align-len the homopolymers take mode B; with no
    scorer named for that route they go unscored and the run is not
    correct; with a test-only scorer that hands back the program's own
    scores of the locus (no reference at all) the run is correct."""
    (tmp_path / "pbref").mkdir()
    (tmp_path / "pbref" / "own_scores.py").write_text(OWN_SCORES)
    cell = _cell(flags=_cell().config["flags"]
                 + ["--stutter-align-len", "25"],
                 checks={"scorers": {"mode_b": scorer}} if scorer else None)
    cell.checks["sample"]["loci"] = cell.traffic["n_loci"]
    res = _run(monkeypatch, cell=cell, harness=str(tmp_path))
    share = res["checks"]["unscored_share"]
    assert res["correct"] is (scorer is not None)
    if scorer is None:
        assert share["value"] > share["limit"]
    else:
        assert share["value"] == 0


@pytest.mark.parametrize("flag", ["--snp-vcf", "--ref-vcf"])
@pytest.mark.parametrize("form", ["=", " "])
def test_a_flag_without_a_reference_stops_the_run(monkeypatch, flag, form):
    extra = [f"{flag}=x.vcf.gz"] if form == "=" else [flag, "x.vcf.gz"]
    cell = _cell(flags=_cell().config["flags"] + extra)
    with pytest.raises(ValueError, match=flag):
        _run(monkeypatch, cell=cell)


def test_the_flags_are_read_in_either_form():
    two = check.semantics(["--alignment-params", ONT_LIKE.split("=")[1],
                           "--stutter-align-len", "25"])
    one = check.semantics([ONT_LIKE, "--stutter-align-len=25",
                           "--phased-bam"])
    assert two.trans.tolist() == one.trans.tolist()
    assert two.trans.dtype == one.trans.dtype == "float32"
    assert two.trans.tolist()[4] == pytest.approx(-0.0001)
    assert (two.phased, one.phased, two.mode_b, one.mode_b) == \
        (False, True, True, True)
    plain = check.semantics(_cell().config["flags"])
    assert plain.trans.tolist() == \
        check.ref_pairhmm.DEFAULT_TRANSITIONS.tolist()
    assert (plain.phased, plain.mode_b) == (True, False)
    assert (plain.route("A"), plain.route("AC"), one.route("A"),
            one.route("AC")) == ("pair_hmm", "pair_hmm", "mode_b",
                                 "pair_hmm")
