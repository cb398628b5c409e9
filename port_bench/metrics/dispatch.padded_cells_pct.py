"""Padding's share of the pair-HMM cells launched: 100 x (cells_launched
- cells_real) / cells_launched, the program's counters of Bpad x n_max x
m_max and of len(hap) x len(read) summed over the scored batches
(pipeline/seq_genotyper.score_pairs_async), %."""


def read(w):
    launched = w.counters.get("cells_launched")
    if not launched or "cells_real" not in w.counters:
        return None
    return 100.0 * (launched - w.counters["cells_real"]) / launched
