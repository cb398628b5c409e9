"""The filter's (record, locus) pairs served from the decode window's
columns: 100 x reads_from_columns / (reads_from_columns + reads_fallback),
the program's counters (pipeline/filters.py), %."""


def read(w):
    cols = w.counters.get("reads_from_columns")
    total = (cols or 0) + w.counters.get("reads_fallback", 0)
    return 100.0 * cols / total if cols is not None and total else None
