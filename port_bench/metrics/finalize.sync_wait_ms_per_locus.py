"""Wall the main thread waited on the device at the window's sync
(ScoreHandle.result) a locus: the Device sync wait stage, ms."""

from pbench.readers import stage_ms


def read(w):
    return stage_ms(w, ("Device sync wait",))
