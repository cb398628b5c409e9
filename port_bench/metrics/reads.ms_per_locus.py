"""Host read handling a locus: BAM seek, read filtering and trimming
alignment (io/bam.py, pipeline/filters.py, pipeline/alignment.py,
native/), ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("BAM seek", "Read filtering", "Trimming alignment"))
