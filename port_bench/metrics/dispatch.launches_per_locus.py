"""Kernel launches a locus: the port's launch counters (pair-HMM, mode B,
EM), zeroed before the window."""


def read(w):
    return w.launches / w.loci if w.loci else None
