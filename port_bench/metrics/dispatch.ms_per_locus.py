"""Pair-HMM dispatch (pipeline/seq_genotyper.score_pairs_async,
ops/pairhmm.pairhmm_batch_auto: encoding, padding, copies, launches) a
locus: the Device dispatch stage, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Device dispatch",))
