"""What the benchmark wraps around the program's calls into each layer.

Each wrapper calls the program's own function and then, in the
benchmark's memory, keeps references to what the call received and
returned and nothing more: a sample, drawn from the seed, of what the
timed path produced for the check after the window, and in the traced
window the lengths of every pair-HMM call, which the roofline's bound is
counted from once the window has closed.  No arithmetic of the benchmark
runs inside the program's own stage timers.  The program is patched at
module attributes its callers resolve at call time, and restored by
:meth:`Probes.remove`.

Spans (traced window): ``pass`` (one ``cli.main`` call),
``pairhmm_batch_auto`` and ``score_sync`` (``ScoreHandle.result``, the
window's one host sync).
"""

from __future__ import annotations

import time

import numpy as np


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream (main thread)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


class Probes:
    def __init__(self, seed: int, chosen_loci, sample: dict):
        rng = np.random.default_rng([seed, 0x5EED])
        self.pair_calls = Reservoir(sample["pair_calls"], rng)
        self.loci_rng = rng
        self.chosen = set(chosen_loci)
        self.loci = {}               # name -> (pass index, genotyper)
        self.loci_seen = {}
        self.capturing = False       # the window's passes, not the warm one
        self.tracing = False
        self.pass_index = -1
        self.spans = []              # (name, t0, t1, depth), perf_counter s
        self.pair_lengths = []       # (hap, read, full lengths) a call
        self._depth = 0
        self._saved = []

    # -- spans ----------------------------------------------------------
    def span(self, name, fn):
        """fn() inside a host span (traced window; main thread only)."""
        if not self.tracing:
            return fn()
        self._depth += 1
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.spans.append((name, t0, time.perf_counter(), self._depth))
            self._depth -= 1

    # -- patching -------------------------------------------------------
    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def install(self) -> None:
        from longtr_tpu_torch.pipeline import processor, seq_genotyper
        self._patch(processor, "pairhmm_batch_auto", self._pairhmm)
        self._patch(processor, "write_vcf_record", self._write_record)
        self._patch(seq_genotyper.SeqStutterGenotyper, "genotype_prepare",
                    self._prepare)
        self._patch(seq_genotyper.ScoreHandle, "result", self._result)

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    # -- wrappers -------------------------------------------------------
    def _pairhmm(self, orig):
        def pairhmm_batch_auto(hap, hl, read, rl, fl, params=None, **kw):
            out = self.span("pairhmm_batch_auto",
                            lambda: orig(hap, hl, read, rl, fl, params, **kw)
                            if params is not None
                            else orig(hap, hl, read, rl, fl, **kw))
            if self.capturing:
                # the batch's arrays are the caller's own, made for this
                # call and never written again: kept as they are
                if self.tracing:
                    self.pair_lengths.append((hl, rl, fl))
                self.pair_calls.offer((hap, hl, read, rl, fl,
                                       None if params is None
                                       else params.as_array(), out))
            return out
        return pairhmm_batch_auto

    def _prepare(self, orig):
        def genotype_prepare(gt, *args, **kw):
            chosen = (self.capturing
                      and gt.region_group.regions[0].name in self.chosen)
            ok, pairs = orig(gt, *args, **kw)
            if chosen:
                # the route the program took (a locus that fails here is
                # never written, which the check counts as unscored): a
                # pair-HMM request, or mode B's scores made through
                # gt._mode_b_finish
                gt._pb_chosen = True
                gt._pb_pairs = pairs
                gt._pb_route = None if not ok else (
                    "pair_hmm" if pairs is not None else "mode_b")
            return ok, pairs
        return genotype_prepare

    def _result(self, orig):
        def result(handle):
            return self.span("score_sync", lambda: orig(handle))
        return result

    def _write_record(self, orig):
        def write_vcf_record(gt, *args, **kw):
            r = orig(gt, *args, **kw)
            if getattr(gt, "_pb_chosen", False):
                name = gt.region_group.regions[0].name
                n = self.loci_seen[name] = self.loci_seen.get(name, 0) + 1
                if int(self.loci_rng.integers(0, n)) == 0:
                    self.loci[name] = (self.pass_index, gt)
            return r
        return write_vcf_record
