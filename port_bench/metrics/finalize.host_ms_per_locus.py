"""The host's work on a locus after its scores arrive: the Call finalize
(models/genotyper.py, f64 posteriors and the call) and VCF write
(pipeline/vcf_record.py) spans inside Genotyping, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Call finalize", "VCF write"))
