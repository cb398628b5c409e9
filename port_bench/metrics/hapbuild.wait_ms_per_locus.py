"""Main-thread wall waiting on the haplotype builds (haplotype/*, the
builder threads of pipeline/processor.py) a locus: the Build wait stage,
ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Build wait",))
