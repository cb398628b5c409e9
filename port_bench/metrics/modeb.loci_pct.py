"""The loci mode B scored over the loci processed: 100 x mode_b_loci /
loci, the program's counter, %."""


def read(w):
    n = w.counters.get("mode_b_loci")
    return None if n is None or not w.loci else 100.0 * n / w.loci
