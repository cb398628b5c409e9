"""Mode B's controls and planted faults, put in the program's place as
:mod:`pbench.control`'s are (each patches the program and returns the
undo; ``calibrate.py --control`` names one of them once it is set on
:mod:`pbench.control`).

- :func:`mode_b_bf16`: mode B's scores from the plain reference computed
  in bfloat16, below the float32 of the program's row DP.
- :func:`reference_bf16`: both scoring routes so (the pair-HMM's as
  :func:`pbench.control.bf16_control`).
- :func:`stutter_prior_090`: the program's artifact priors taken from a
  stutter model whose geometric parameters are 0.90 in place of the
  default 0.95 (for a period-1 repeat only the in-frame one counts).
- :func:`mode_b_bypassed`: the homopolymers scored by the pair-HMM though
  the flags select mode B.
"""

from __future__ import annotations

import torch

from pbench.control import _patch


def mode_b_bf16(device):
    """Each mode-B locus's scores replaced by the reference's in
    bfloat16 (the program's own host phase still runs first, for its
    seeds)."""
    from longtr_tpu_torch.pipeline import seq_genotyper
    from pbref import mode_b as ref_mode_b
    cls = seq_genotyper.SeqStutterGenotyper
    orig = cls._mode_b_scores

    def _mode_b_scores(gt, deferred=False):
        own = orig(gt, deferred=False)
        low = ref_mode_b.score(gt, gt.haplotype.all_seqs(), device,
                               rows=torch.bfloat16)
        return own if low is None else low
    return _patch([(cls, "_mode_b_scores", _mode_b_scores)])


def stutter_prior_090(device):
    """Mode B's artifact priors from the default stutter model with both
    geometric parameters 0.90."""
    from longtr_tpu_torch.haplotype import blocks
    from longtr_tpu_torch.models.stutter import StutterModel
    cls = blocks.RepeatBlock
    orig = cls.log_prob_pcr_artifact

    def log_prob_pcr_artifact(block, seq_index, artifact_size):
        right = orig(block, seq_index, artifact_size)
        if right == blocks.LARGE_NEGATIVE:
            return right
        m = block.stutter_model
        wrong = StutterModel(0.90, m.in_up, m.in_down, 0.90, m.out_up,
                             m.out_down, m.motif)
        n = len(block.seqs[seq_index])
        return wrong.log_stutter_pmf(n, n + artifact_size)
    return _patch([(cls, "log_prob_pcr_artifact", log_prob_pcr_artifact)])


def reference_bf16(device):
    """Both scoring routes from the reference in bfloat16: the pair-HMM
    (:func:`pbench.control.bf16_control`) and mode B."""
    from pbench.control import bf16_control
    undo = [bf16_control(device), mode_b_bf16(device)]

    def undo_all():
        for u in reversed(undo):
            u()
    return undo_all


def mode_b_bypassed(device):
    """Every locus through the pair-HMM whatever ``--stutter-align-len``
    selects: the homopolymers leave mode B."""
    from longtr_tpu_torch.pipeline import seq_genotyper
    cls = seq_genotyper.SeqStutterGenotyper
    return _patch([(cls, "_use_mode_b", lambda gt: False)])
