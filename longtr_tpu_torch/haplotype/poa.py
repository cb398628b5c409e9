"""Partial-order alignment (POA) consensus.

Reference: the reference links spoa (HaplotypeGenerator.cpp:167-199) with
global alignment and scores (match, mismatch, gap) = (1, -1, -1), a 30-read
cap per cluster with *nondeterministic* subsampling (std::random_device,
HaplotypeGenerator.cpp:182-192).  This implementation is a from-scratch POA:

* sequences are aligned to the growing graph with global DP over a
  topological order, scores (1, -1, -1),
* matched bases fuse into existing nodes (accumulating edge weights),
* consensus = maximum-weight path through the graph (spoa's
  GenerateConsensus traversal).

Divergence (conscious, SURVEY.md §7.5): subsampling is seeded/deterministic
(first-30 in arrival order) so runs are reproducible.
"""

from __future__ import annotations

import numpy as np

MATCH = 1
MISMATCH = -1
GAP = -1
CLUSTER_SIZE_LIMIT = 30


class PoaGraph:
    def __init__(self):
        self.char = []          # node id -> base
        self.out_edges = []     # node id -> {next_id: weight}
        self.in_edges = []      # node id -> {prev_id: weight}
        self.aligned_to = []    # node id -> list of node ids aligned (same column)
        self._order = None

    def _new_node(self, ch: str) -> int:
        self.char.append(ch)
        self.out_edges.append({})
        self.in_edges.append({})
        self.aligned_to.append([])
        self._order = None
        return len(self.char) - 1

    def _add_edge(self, a: int, b: int, w: int = 1):
        self.out_edges[a][b] = self.out_edges[a].get(b, 0) + w
        self.in_edges[b][a] = self.in_edges[b].get(a, 0) + w

    def topo_order(self):
        if self._order is not None:
            return self._order
        n = len(self.char)
        indeg = [len(self.in_edges[i]) for i in range(n)]
        stack = [i for i in range(n) if indeg[i] == 0]
        order = []
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.out_edges[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        assert len(order) == n, "POA graph has a cycle"
        self._order = order
        return order

    def add_sequence(self, seq: str):
        if not seq:
            return
        if not self.char:
            prev = None
            for ch in seq:
                v = self._new_node(ch)
                if prev is not None:
                    self._add_edge(prev, v)
                prev = v
            return
        aln = self._align(seq)
        self._fuse(seq, aln)

    def _align(self, seq: str):
        """Global align seq to graph. Returns list of (node_id or None) per base."""
        order = self.topo_order()
        n = len(order)
        m = len(seq)
        pos_in_order = {v: i for i, v in enumerate(order)}
        NEG = -(10 ** 9)
        # dp[i+1][j+1]: best score ending with node order[i] consumed and
        # seq[:j] consumed.  Row 0 = no node consumed yet.
        dp = np.full((n + 1, m + 1), NEG, dtype=np.int64)
        bt_node = np.full((n + 1, m + 1), -1, dtype=np.int32)  # pred row for diag/up
        bt_type = np.full((n + 1, m + 1), 2, dtype=np.int8)    # 0 diag,1 up,2 left
        dp[0, :] = np.arange(m + 1) * GAP
        sv = np.frombuffer(seq.encode(), dtype=np.uint8)
        for i, v in enumerate(order, start=1):
            preds = [pos_in_order[p] + 1 for p in self.in_edges[v]]
            if not preds:
                preds = [0]
            match_sc = np.where(sv == ord(self.char[v]), MATCH, MISMATCH)
            best_diag = np.full(m, NEG, dtype=np.int64)
            best_diag_p = np.full(m, -1, dtype=np.int32)
            best_up = np.full(m + 1, NEG, dtype=np.int64)
            best_up_p = np.full(m + 1, -1, dtype=np.int32)
            for p in preds:
                d = dp[p, :-1]
                upd = d > best_diag
                best_diag = np.where(upd, d, best_diag)
                best_diag_p = np.where(upd, p, best_diag_p)
                u = dp[p, :]
                updu = u > best_up
                best_up = np.where(updu, u, best_up)
                best_up_p = np.where(updu, p, best_up_p)
            # up (consume node, gap in seq)
            row = best_up + GAP
            rowp = best_up_p.copy()
            rowt = np.full(m + 1, 1, dtype=np.int8)
            # diag (consume node + base)
            diag = np.concatenate(([NEG], best_diag + match_sc))
            diag_p = np.concatenate(([-1], best_diag_p)).astype(np.int32)
            better = diag > row
            row = np.where(better, diag, row)
            rowp = np.where(better, diag_p, rowp)
            rowt = np.where(better, np.int8(0), rowt)
            # left (consume base, gap in node): a decayed running max —
            # row[j] = max_k<=j (row[k] + (j-k)*GAP), same cummax trick as
            # the pair-HMM deletion chain; strict-improvement cells mark a
            # left backtrack exactly like the sequential loop did
            jj = np.arange(m + 1, dtype=np.int64)
            run = np.maximum.accumulate(row - jj * GAP) + jj * GAP
            came_left = run > row
            row = np.where(came_left, run, row)
            rowp = np.where(came_left, np.int32(i), rowp)
            rowt = np.where(came_left, np.int8(2), rowt)
            dp[i, :] = row
            bt_node[i, :] = rowp
            bt_type[i, :] = rowt

        # endpoint: best sink row at j=m (global alignment over graph ends)
        sinks = [pos_in_order[v] + 1 for v in range(len(self.char))
                 if not self.out_edges[v]]
        best_i = max(sinks, key=lambda i: dp[i, m]) if sinks else \
            int(np.argmax(dp[:, m]))
        aln = [None] * m
        i, j = best_i, m
        while i != 0 or j != 0:
            if i == 0:
                j -= 1  # leading gaps in graph: aln[j] stays None
                continue
            t = bt_type[i, j]
            if t == 0:
                aln[j - 1] = order[i - 1]
                i, j = bt_node[i, j], j - 1
            elif t == 1:
                i = bt_node[i, j]
            else:
                j -= 1
        return aln

    def _fuse(self, seq: str, aln):
        prev = None
        for j, ch in enumerate(seq):
            node = aln[j]
            target = None
            if node is not None:
                if self.char[node] == ch:
                    target = node
                else:
                    for alt in self.aligned_to[node]:
                        if self.char[alt] == ch:
                            target = alt
                            break
                    if target is None:
                        target = self._new_node(ch)
                        ring = [node] + list(self.aligned_to[node])
                        self.aligned_to[target] = ring
                        # register the new node with EVERY ring member —
                        # skipping one leaves it blind to this base and a
                        # later read duplicates the node in the same
                        # column, splitting edge weights
                        for other in ring:
                            if target not in self.aligned_to[other]:
                                self.aligned_to[other].append(target)
            if target is None:
                target = self._new_node(ch)
            if prev is not None:
                self._add_edge(prev, target)
            prev = target
        self._order = None

    def consensus(self) -> str:
        """Heaviest-bundle traversal (Lee 2003; spoa/poapy
        GenerateConsensus semantics): each node greedily picks the single
        heaviest in-edge (ties: higher predecessor score, then smaller
        node id) rather than a globally maximum-weight path, then the
        consensus backtracks from the best-scoring node (ties: latest in
        topological order).  All tie-breaks are explicit so the native
        C++ mirror is order-independent of container iteration."""
        if not self.char:
            return ""
        order = self.topo_order()
        score = {v: 0 for v in order}
        prev = {v: None for v in order}
        for v in order:
            best_w, best_ps, best_p = 0, -1, None
            for p, w in self.in_edges[v].items():
                key = (w, score[p], -p)
                if best_p is None or key > (best_w, best_ps, -best_p):
                    best_w, best_ps, best_p = w, score[p], p
            if best_p is not None:
                score[v] = best_w + score[best_p]
                prev[v] = best_p
        end, best = order[0], score[order[0]]
        for v in order:
            if score[v] >= best:
                end, best = v, score[v]
        out = []
        v = end
        while v is not None:
            out.append(self.char[v])
            v = prev[v]
        return "".join(reversed(out))


# Consensus is a pure function of the (ordered) member list, and the
# cluster-convergence loop in generator.py recomputes clusters whose
# membership did not change between iterations (and across threshold
# retries) — memoize so each distinct cluster pays its POA DP once.
# Keys are 16-byte blake2b digests of the member list, not the members
# (a key of 30 x 25kb reads would pin ~750KB of finished-locus data).
_memo: dict = {}
_MEMO_CAP = 4096


def _memo_key(seqs) -> bytes:
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for s in seqs:
        h.update(s.encode())
        h.update(b"\x00")
    return h.digest()


def poa_consensus(seqs) -> str:
    """Consensus of a cluster (HaplotypeGenerator::poa semantics)."""
    seqs = list(seqs)
    if len(seqs) > CLUSTER_SIZE_LIMIT:
        seqs = seqs[:CLUSTER_SIZE_LIMIT]  # deterministic subsample
    key = _memo_key(seqs)
    hit = _memo.get(key)
    if hit is not None:
        return hit
    try:
        from longtr_tpu_torch import native
        out = native.poa_consensus(seqs)
    except Exception:
        out = None
    if out is None:
        g = PoaGraph()
        for s in seqs:
            g.add_sequence(s)
        out = g.consensus()
    if len(_memo) >= _MEMO_CAP:
        _memo.clear()
    _memo[key] = out
    return out
