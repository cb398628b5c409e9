"""Edit-distance clustering of unexplained read sequences.

Reference: HaplotypeGenerator.cpp:201-293 — a unit-cost global edit distance
with per-row early abort at threshold T, greedy centroid clustering (max 15
clusters), and POA-refined centroid merging.
"""

from __future__ import annotations

import numpy as np


def edit_distance_banded(a: str, b: str, T: int) -> int:
    """Unit-cost NW edit distance: exact when < T, else a value >= T.

    Transcription of HaplotypeGenerator::needleman_wunsch
    (HaplotypeGenerator.cpp:201-234) with one conscious deviation
    (PARITY.md ledger): the reference returns the exact distance even when
    it exceeds the threshold unless its per-row band abort fires first;
    every call site only ever tests ``score < threshold``, so this
    implementation clamps all above-threshold results to T+1.  That fixed
    contract lets the native path use a true Ukkonen band (O(n*T) instead
    of O(n*m)) — unit-cost distance satisfies d[i][j] >= |i-j|, so cells
    off the 2T+1-wide diagonal band can never produce a value <= T.
    Exactly at d == T the two paths may return T or T+1 (the reference's
    displacement-augmented row abort is data-dependent there); every
    call-site DECISION (d < T) is identical.  Dispatches to the native
    C++ scorer when available (tests/test_components.py fuzzes the two
    against each other).

    Empty-string semantics mirror the reference asymmetry: ``b`` (the
    centroid position, needleman_wunsch's read_seq) empty -> the row
    abort fires unconditionally, T+1, so nothing ever joins an
    empty-centroid cluster; ``a`` empty -> exact distance len(b).
    """
    n, m = len(a), len(b)
    if abs(n - m) > T:
        return T + 1
    if m == 0:
        return 0 if n == 0 else T + 1
    if n == 0:
        return m           # <= T here, by the length check above
    try:
        from longtr_tpu_torch import native
        d = native.edit_distance_banded(a, b, T)
        if d is not None:
            return d
    except Exception:
        pass
    av = np.frombuffer(a.encode(), dtype=np.uint8)
    bv = np.frombuffer(b.encode(), dtype=np.uint8)
    prev = np.arange(m + 1, dtype=np.int32)
    jj = np.arange(1, m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int32)
        cur[0] = i
        sub = prev[:-1] + (av[i - 1] != bv).astype(np.int32)
        # dp recurrence with a sequential min along the row: compute via
        # running minimum (cur[j] = min(sub[j], prev[j]+1, cur[j-1]+1)).
        base = np.minimum(sub, prev[1:] + 1)
        # cur[j] = min over k<=j of base[k] + (j-k); decayed running min:
        run = np.minimum.accumulate(base - jj)
        cur[1:] = np.minimum(base, run + jj)
        # account for paths through cur[0]
        cur[1:] = np.minimum(cur[1:], cur[0] + jj)
        band = cur[1:] + np.abs((n - m) - (i - jj))
        if band.min() > T:
            return T + 1
        prev = cur
    return min(int(prev[m]), T + 1)


def greedy_clustering(seqs, threshold: int):
    """Greedy centroid clustering (HaplotypeGenerator.cpp:237-268).

    Returns dict centroid -> member list, or None if >15 clusters formed.
    """
    try:
        from longtr_tpu_torch import native
        batch = native.edit_distance_batch
        from longtr_tpu_torch.utils.workers import in_locus_worker, spare_workers
        # inside a locus worker, size the native fan-out to the cores this
        # locus can actually claim (1 when the window is uniformly busy;
        # even then the single-threaded batch call amortizes the per-pair
        # ctypes/encode overhead across all centroids)
        width = spare_workers() if in_locus_worker() else 0
    except Exception:
        batch = None
        width = 0
    clusters = {seqs[0]: [seqs[0]]}
    centroids = [seqs[0]]
    for s in seqs[1:]:
        best_score, best = None, None
        # one threaded native call for all centroid distances; the
        # first-minimum tie-break below matches the sequential loop
        dists = batch(s, centroids, threshold, width) if batch else None
        if dists is None:
            dists = [edit_distance_banded(s, c, threshold)
                     for c in centroids]
        for c, score in zip(centroids, dists):
            if score < threshold and (best_score is None or score < best_score):
                best_score, best = score, c
        if best is not None:
            clusters[best].append(s)
        else:
            centroids.append(s)
            if len(centroids) > 15:
                return None
            clusters[s] = [s]
    return clusters


def merge_clusters(new_centroids, clusters, threshold: int) -> bool:
    """Merge clusters whose centroids are within threshold
    (HaplotypeGenerator.cpp:271-293). Mutates ``clusters``; returns True if
    anything merged."""
    updated = False
    for i in range(len(new_centroids)):
        for j in range(1, len(new_centroids)):
            ci, cj = new_centroids[i], new_centroids[j]
            if i == j or ci not in clusters or cj not in clusters:
                continue
            score = edit_distance_banded(ci, cj, threshold)
            if score < threshold:
                updated = True
                clusters[ci].extend(clusters[cj])
                del clusters[cj]
    return updated
