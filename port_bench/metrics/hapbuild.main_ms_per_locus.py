"""Main-thread wall of the haplotype builds a locus: Build inline (a short
locus built on the main thread, inside Genotyping) plus Build wait (the
wait on the builder threads' builds), ms.  Nothing to read from a program
that records no Pass span: it has no Build inline either."""

from pbench.readers import stage_ms


def read(w):
    if "Pass" not in w.stage_s:
        return None
    return stage_ms(w, ("Build inline", "Build wait"))
