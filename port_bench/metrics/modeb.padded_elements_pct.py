"""Padding's share of the mode-B row DP's elements (read column x
haplotype row x artifact size) handed to the device: 100 x
(mode_b_elements_launched - mode_b_elements_real) /
mode_b_elements_launched, the program's counters, %."""


def read(w):
    launched = w.counters.get("mode_b_elements_launched")
    if not launched or "mode_b_elements_real" not in w.counters:
        return None
    return 100.0 * (launched - w.counters["mode_b_elements_real"]) / launched
