"""Scorers put in the program's place: the control and the planted faults.

The control is the reference computed one precision below what the
configuration states: the pair-HMM scan in bfloat16 instead of float32.
A check that cannot tell it from the program sets no limit.  The faults
break the timed path where its answers are produced, or make the program
depart from what the configuration's flags select.  Each function patches
the program and returns the undo.
"""

from __future__ import annotations

import numpy as np
import torch


def _patch(pairs):
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in pairs]
    for owner, attr, fn in pairs:
        setattr(owner, attr, fn)

    def undo():
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)
    return undo


def _processor():
    from longtr_tpu_torch.pipeline import processor
    return processor


def bf16_control(device):
    """The pair-HMM replaced by the reference scan in bfloat16."""
    from pbref import pairhmm as ref_pairhmm

    def pairhmm(hap, hl, read, rl, fl, params=None, device=None, mesh=None):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in (hap, hl, read, rl, fl)]
        trans = None if params is None else params.as_array()
        return ref_pairhmm.scan(*t, trans=trans, dtype=torch.bfloat16).float()

    return _patch([(_processor(), "pairhmm_batch_auto", pairhmm)])


def half_batch(device):
    """Each pair-HMM call scores the first half of its rows; the rest get
    the mean of those."""
    processor = _processor()
    orig = processor.pairhmm_batch_auto

    def pairhmm(hap, hl, read, rl, fl, params=None, **kw):
        h = max(1, len(hl) // 2)
        out = orig(hap[:h], hl[:h], read[:h], rl[:h], fl[:h], params, **kw)
        return torch.cat([out, out.mean().expand(len(hl) - h)])
    return _patch([(processor, "pairhmm_batch_auto", pairhmm)])


def altered_answer(device):
    """The first score of every pair-HMM call one higher."""
    processor = _processor()
    orig = processor.pairhmm_batch_auto

    def pairhmm(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0] += 1.0
        return out
    return _patch([(processor, "pairhmm_batch_auto", pairhmm)])


def phasing_dropped(device):
    """The HP tags' phasing priors lost: every read's left at 0 and 0, as
    if no read were tagged."""
    processor = _processor()
    orig = processor.phased_bam_factors

    def factors(*args, **kw):
        alignments, p1s, p2s = orig(*args, **kw)
        return (alignments, [[0.0] * len(p) for p in p1s],
                [[0.0] * len(p) for p in p2s])
    return _patch([(processor, "phased_bam_factors", factors)])


def default_transitions(device):
    """The pair-HMM given Dindel's default transitions whatever
    ``--alignment-params`` says."""
    processor = _processor()
    orig = processor.pairhmm_batch_auto

    def pairhmm(hap, hl, read, rl, fl, params=None, **kw):
        return orig(hap, hl, read, rl, fl, **kw)
    return _patch([(processor, "pairhmm_batch_auto", pairhmm)])


def hp_priors_forced(device):
    """The HP tags' phasing priors taken without ``--phased-bam``: the
    unphased path returns what ``--phased-bam`` would (each paired read
    taken as its own mate)."""
    processor = _processor()

    def factors(paired, unpaired):
        return processor.phased_bam_factors(paired, paired, unpaired,
                                            [""] * len(paired))
    return _patch([(processor, "unphased_factors", factors)])


def mode_b_forced(device):
    """Mode B taken for every period-1 repeat without
    ``--stutter-align-len``."""
    from longtr_tpu_torch.pipeline import seq_genotyper
    cls = seq_genotyper.SeqStutterGenotyper

    def use_mode_b(gt):
        rb = [b for b in gt.haplotype.blocks if b.repeat_info is not None]
        return bool(rb) and rb[0].period == 1
    return _patch([(cls, "_use_mode_b", use_mode_b)])


def homopolymers_fail(device):
    """Genotyping fails for every period-1 repeat: the program writes no
    record of it, as it would where mode B's preparation failed."""
    from longtr_tpu_torch.pipeline import seq_genotyper
    cls = seq_genotyper.SeqStutterGenotyper
    orig = cls.genotype_prepare

    def genotype_prepare(gt, *args, **kw):
        hap = gt.haplotype
        rb = [] if hap is None else [b for b in hap.blocks
                                     if b.repeat_info is not None]
        if rb and rb[0].period == 1:
            return False, None
        return orig(gt, *args, **kw)
    return _patch([(cls, "genotype_prepare", genotype_prepare)])
