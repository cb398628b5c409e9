"""String helpers (reference: src/stringops.{h,cpp})."""

from __future__ import annotations

import functools


def length_suffix_match(s1: str, s2: str) -> int:
    n = 0
    while n < len(s1) and n < len(s2) and s1[-1 - n] == s2[-1 - n]:
        n += 1
    return n


def _cmp_length_seq(a: str, b: str) -> int:
    """orderByLengthAndSequence: shorter first, ties lexicographic."""
    if len(a) != len(b):
        return -1 if len(a) < len(b) else 1
    if a == b:
        return 0
    return -1 if a < b else 1


def order_by_length_and_sequence(seqs):
    return sorted(seqs, key=functools.cmp_to_key(_cmp_length_seq))


def condense_read_counts(read_diffs) -> str:
    """-1,0,-1,2,2 -> '-1|2;0|1;2|2' (genotyper.h:50-63)."""
    if not read_diffs:
        return "."
    counts = {}
    for d in read_diffs:
        counts[d] = counts.get(d, 0) + 1
    return ";".join(f"{k}|{v}" for k, v in sorted(counts.items()))
