"""What no stage span holds a locus: the Outside stages total, the Pass
span's wall (cli._main) less its direct main-thread children, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Outside stages",))
