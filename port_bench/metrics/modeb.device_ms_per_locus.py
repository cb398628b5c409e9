"""Mode B's device work a locus: the copies to the card, the artifact
tables (H1) and the row DP (J2), and the copy back that waits for them
(the Mode B device span, pipeline/mode_b.py), ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Mode B device",))
