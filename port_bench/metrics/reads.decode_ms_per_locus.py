"""Reading, inflating and decoding new BAM windows (io/bam.py fetch_fast,
native/) a locus: the BAM window decode span inside BAM seek, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("BAM window decode",))
