"""De Bruijn graph over flank sequences.

Reference: src/debruijn_graph.{h,cpp} + src/directed_graph.{h,cpp}.  Used to
(a) reject loci whose flanks are too repetitive (smallest acyclic k in
[10, 15]; seq_stutter_genotyper.cpp:612-625) and (b) assemble alternate flank
haplotypes (enumerate_paths best-first by min edge weight, with 1bp-mismatch
alternates of the source/sink kmers; debruijn_graph.cpp:150-199).
"""

from __future__ import annotations

import heapq
import math


class DebruijnGraph:
    def __init__(self, k: int, ref_seq: str):
        assert len(ref_seq) > k
        self.k = k
        self.ref_seq = ref_seq
        self.source_kmer = ref_seq[:k]
        self.sink_kmer = ref_seq[len(ref_seq) - k:]
        self.num_strings = 0
        self.node_id = {}          # kmer -> id
        self.node_label = []       # id -> kmer
        self.out_edges = []        # id -> {dst: weight}
        self.in_edges = []         # id -> {src: weight}
        self.ref_edges = set()     # (src, dst) pairs from the reference
        self.add_string(ref_seq, 2)
        self.ref_edges = {(s, d) for s in range(len(self.out_edges))
                          for d in self.out_edges[s]}

    def _node(self, kmer: str) -> int:
        nid = self.node_id.get(kmer)
        if nid is None:
            nid = len(self.node_label)
            self.node_id[kmer] = nid
            self.node_label.append(kmer)
            self.out_edges.append({})
            self.in_edges.append({})
        return nid

    def add_string(self, seq: str, weight: int = 1):
        if len(seq) <= self.k:
            return
        self.num_strings += 1
        prev = self._node(seq[: self.k])
        for i in range(1, len(seq) + 1 - self.k):
            nxt = self._node(seq[i: i + self.k])
            self.out_edges[prev][nxt] = self.out_edges[prev].get(nxt, 0) + weight
            self.in_edges[nxt][prev] = self.in_edges[nxt].get(prev, 0) + weight
            prev = nxt

    def has_cycles(self) -> bool:
        n = len(self.node_label)
        color = [0] * n
        for start in range(n):
            if color[start]:
                continue
            stack = [(start, iter(self.out_edges[start]))]
            color[start] = 1
            while stack:
                v, it = stack[-1]
                adv = next(it, None)
                if adv is None:
                    color[v] = 2
                    stack.pop()
                elif color[adv] == 1:
                    return True
                elif color[adv] == 0:
                    color[adv] = 1
                    stack.append((adv, iter(self.out_edges[adv])))
        return False

    def is_source_ok(self) -> bool:
        nid = self.node_id[self.source_kmer]
        return len(self.out_edges[nid]) > 0 and len(self.in_edges[nid]) == 0

    def is_sink_ok(self) -> bool:
        nid = self.node_id[self.sink_kmer]
        return len(self.in_edges[nid]) > 0 and len(self.out_edges[nid]) == 0

    def prune_edges(self, min_edge_freq: float, min_weight: int):
        """Drop non-reference edges below the weight threshold
        (debruijn_graph.cpp:47-60)."""
        min_weight = max(min_weight, math.ceil(min_edge_freq * self.num_strings))
        for s in range(len(self.out_edges)):
            for d in list(self.out_edges[s]):
                if (s, d) in self.ref_edges:
                    continue
                if self.out_edges[s][d] < min_weight:
                    del self.out_edges[s][d]
                    del self.in_edges[d][s]

    def _alt_kmer_nodes(self, kmer: str, source: bool, sink: bool):
        out = []
        for i in range(len(kmer)):
            for b in "ACGT":
                if b == kmer[i]:
                    continue
                alt = kmer[:i] + b + kmer[i + 1:]
                nid = self.node_id.get(alt)
                if nid is None:
                    continue
                if source and len(self.in_edges[nid]) > 0:
                    continue
                if sink and len(self.out_edges[nid]) > 0:
                    continue
                out.append(nid)
        return out

    def enumerate_paths(self, min_weight: int, max_paths: int):
        """Best-first path enumeration (debruijn_graph.cpp:150-199).

        Returns [(sequence, min_edge_weight), ...], up to max_paths.
        """
        source = self.node_id[self.source_kmer]
        sink = self.node_id[self.sink_kmer]
        sink_ids = {sink}
        for nid in self._alt_kmer_nodes(self.sink_kmer, False, True):
            sink_ids.add(nid)

        counter = 0
        # heap of (-min_weight, tiebreak, node, path_prefix)
        heap = [(-1000000, counter, source, self.node_label[source])]
        for nid in self._alt_kmer_nodes(self.source_kmer, True, False):
            counter += 1
            heap.append((-1000000, counter, nid, self.node_label[nid]))
        heapq.heapify(heap)

        paths = []
        while heap and len(paths) < max_paths:
            neg_w, _, node, seq = heapq.heappop(heap)
            if node in sink_ids:
                paths.append((seq, -neg_w))
            for dst, w in self.out_edges[node].items():
                if w < min_weight:
                    continue
                counter += 1
                heapq.heappush(heap, (max(neg_w, -w), counter, dst,
                                      seq + self.node_label[dst][-1]))
        return paths


def calc_kmer_length(ref_seq: str, min_kmer: int, max_kmer: int):
    """Smallest k in [min_kmer, max_kmer] with an acyclic reference path
    (debruijn_graph.cpp:22-29). Returns None if none."""
    for k in range(min_kmer, max_kmer + 1):
        if len(ref_seq) <= k:
            return None
        if not DebruijnGraph(k, ref_seq).has_cycles():
            return k
    return None
