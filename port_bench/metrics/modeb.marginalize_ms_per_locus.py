"""Mode B's float64 seed marginalization on the host a locus
(compute_aln_logprob; the Mode B marginalize span,
pipeline/mode_b.py), ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Mode B marginalize",))
