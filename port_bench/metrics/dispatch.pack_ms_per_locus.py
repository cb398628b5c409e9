"""Grouping a window's pairs into length classes and encoding and padding
them in numpy (pipeline/seq_genotyper.score_pairs_async) a locus: the
Pair packing span inside Device dispatch, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Pair packing",))
