"""Mode B's host phase before the device a locus: seeds, row tables and
the packing of the device's inputs (the Mode B prepare span,
pipeline/seq_genotyper.py), ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Mode B prepare",))
