"""Whether what the timed path produced is correct.

Three numbers over a sample drawn from the seed, the first two the widest
gap between the program and the plain reference (``pbref``):

- ``pairhmm_gap``: the pair-HMM scores the card returned for sampled rows
  of sampled ``pairhmm_batch_auto`` calls, against the reference scan of
  the same (haplotype, read) pairs under the configuration's transitions.
- ``vcf_gap``: for sampled loci, Q, PQ and GLDIFF as each pass wrote them
  to its VCF, against the reference's own: its scores of the locus's reads
  and final candidate haplotypes, the phasing priors the configuration
  selects, the allele each candidate carries found from the candidates'
  sequences, and its float64 posteriors; a called allele pair (GB) that
  differs counts as a gap of 1000 (above every limit).
- ``unscored_share``: the sampled loci the reference could not score over
  the sampled loci.

What is compared follows the configuration's flags (:func:`semantics`),
never the program's own state: the transitions of ``--alignment-params``
(Dindel's defaults without it); with ``--phased-bam`` the priors of the
generated reads' HP tags, without it none; and each locus's scoring route,
mode B (``--stutter-align-len``) for a period-1 repeat and the pair-HMM
otherwise.  The pair-HMM route is scored here; another route by the module
the cell's ``checks/<cell>.json`` names under ``scorers``
(``pbref/<module>.py``'s ``score(gt, seqs, device)``).  A locus is
unscored where the program took another route than the configuration
selects, where its route has no scorer or its scorer returns None, where
no combination of the haplotype's blocks gives its candidates' alleles,
where its pass's VCF has no record of it, or where a pass of the window
never wrote it (its genotyping failed or it was skipped).

The reference follows the program's state where it has to: it scores the
reads as the program trimmed and pooled them, against the candidate
haplotypes the program built, and takes the samples in the order the
program grouped the locus's reads (PERF.md says so).  Everything else it
derives from the generated inputs.
"""

from __future__ import annotations

import gzip
import itertools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from pbref import pairhmm as ref_pairhmm
from pbref import posterior as ref_posterior

# REF_FLANK_LEN - indel flank (5, the default the configurations keep):
# the bases the pair-HMM clips from each end of a candidate haplotype.
HAP_CLIP = 35 - 5
CALL_DIFFERS = 1000.0
# flags whose semantics the reference does not hold yet
UNCHECKED_FLAGS = ("--snp-vcf", "--ref-vcf")


@dataclass(frozen=True)
class Semantics:
    """What a configuration's flags select for the check."""
    trans: np.ndarray        # (7,) float32 pair-HMM transitions
    phased: bool             # priors from the reads' HP tags
    mode_b: bool             # period-1 repeats scored by mode B

    def route(self, motif: str) -> str:
        """The scoring route of a repeat of ``motif`` (the legacy stutter
        HMM for homopolymers, HapAligner.cpp:552-555)."""
        return "mode_b" if self.mode_b and len(motif) == 1 else "pair_hmm"


def _value(flags, name):
    """The value of ``name`` in ``flags``, given as ``name=v`` or as
    ``name v``; None where the flag is absent."""
    for i, f in enumerate(flags):
        if f.startswith(name + "="):
            return f[len(name) + 1:]
        if f == name:
            if i + 1 == len(flags):
                raise ValueError(f"{name} has no value")
            return flags[i + 1]
    return None


def semantics(flags) -> Semantics:
    """The check's reading of a configuration's ``flags``; raises
    ValueError for a flag it has no reference for."""
    for f in flags:
        if f.split("=", 1)[0] in UNCHECKED_FLAGS:
            raise ValueError(f"the check has no reference for {f.split('=')[0]}"
                             " (a configuration's flags may not carry "
                             + " or ".join(UNCHECKED_FLAGS) + ")")
    params = _value(flags, "--alignment-params")
    trans = ref_pairhmm.DEFAULT_TRANSITIONS
    if params is not None:
        trans = np.array([float(x) for x in params.split(",")], np.float32)
        if trans.shape != (7,):
            raise ValueError(f"--alignment-params needs 7 values: {params}")
    return Semantics(trans, "--phased-bam" in flags,
                     int(_value(flags, "--stutter-align-len") or 0) > 0)


def _gap(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    same = (a == b)
    d = np.where(same, 0.0, np.abs(a - b))
    return float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0


def _host(out) -> np.ndarray:
    if isinstance(out, list):
        out = torch.cat([torch.as_tensor(o).cpu() for o in out])
    return torch.as_tensor(out).double().cpu().numpy()


def pairhmm_gap(calls, rng, rows_per_call, device, trans):
    """(gap, rows compared) of the captured calls, each scored by the
    reference under ``trans`` whatever transitions the call was given."""
    gap, n = 0.0, 0
    for hap, hl, read, rl, fl, _trans, out in calls:
        got = _host(out)[:len(hl)]
        real = np.flatnonzero(~((hl <= 1) & (rl <= 1) & (fl <= 1)))
        sel = np.sort(rng.choice(real, size=min(rows_per_call, len(real)),
                                 replace=False))
        want = ref_pairhmm.score_arrays(
            (hap[sel], hl[sel], read[sel], rl[sel], fl[sel]), device, trans)
        gap = max(gap, _gap(got[sel], want))
        n += len(sel)
    return gap, n


def _vcf_records(path) -> dict:
    """{locus name: (FORMAT keys, [sample fields])} of a VCF, and the
    sample names in column order under the key None."""
    recs = {}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            f = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                recs[None] = f[9:]
                continue
            recs.setdefault(f[2], (f[8].split(":"), f[9:]))
    return recs


def pair_hmm_scores(gt, seqs, device, trans) -> np.ndarray:
    """(pools, candidate haplotypes) pair-HMM reference scores of one
    locus."""
    P, H = gt._request_shape
    reads = [gt._pb_pairs[p * H][1] for p in range(P)]
    trimmed = [s[HAP_CLIP: len(s) - HAP_CLIP] if len(s) > 2 * HAP_CLIP
               else "" for s in seqs]
    pairs = [(trimmed[h], r, len(seqs[h])) for r in reads
             for h in range(len(seqs))]
    scores = ref_pairhmm.score_arrays(ref_pairhmm.pack(pairs), device, trans)
    return scores.reshape(P, len(seqs))


def _blocks(haplotype):
    """Each block's option sequences, and the repeat block's index."""
    blocks = [haplotype.get_block(b) for b in range(haplotype.num_blocks())]
    options = [[b.get_seq(o) for o in range(b.num_options())] for b in blocks]
    rep = next(i for i, b in enumerate(blocks) if b.repeat_info is not None)
    return options, rep


def alleles_of(seqs, options, rep) -> list | None:
    """The repeat block's option each candidate haplotype carries, found
    by matching its sequence against every combination of the blocks'
    options (None where a sequence matches no combination or two that
    carry different alleles)."""
    found = {}
    for combo in itertools.product(*[range(len(o)) for o in options]):
        s = "".join(options[b][o] for b, o in enumerate(combo))
        if found.setdefault(s, combo[rep]) != combo[rep]:
            found[s] = None
    h2a = [found.get(s) for s in seqs]
    return None if None in h2a else h2a


def _why_unscored(name, took, route, h2a, recs, score) -> str | None:
    """Why a sampled locus cannot be scored before its scorer runs, or
    None: ``took`` is the program's route, ``route`` the flags'."""
    if h2a is None:
        return "no alleles of its candidates"
    if name not in recs:
        return "no VCF record"
    if took != route:
        return f"{took} where the flags select {route}"
    if score is None:
        return f"no scorer for {route}"
    return None


def vcf_gap(loci, vcf_paths, cat, sem, scorers, device):
    """(gap, samples compared, {why unscored: loci}).  ``cat``: the
    generator's catalog (its loci, sample names by sample index, and
    {read name: (sample index, HP tag)}); ``scorers``: {route:
    score(gt, seqs, device)} of the routes other than the pair-HMM, which
    is scored here."""
    gap, n, unscored = 0.0, 0, Counter()
    motif = {l.name: l.motif for l in cat["loci"]}
    scorers = dict(scorers, pair_hmm=lambda gt, seqs, device:
                   pair_hmm_scores(gt, seqs, device, sem.trans))
    reads_of, samples = cat["reads"], cat["samples"]
    cache = {}
    for name in sorted(loci):
        pass_i, gt = loci[name]
        if pass_i not in cache:
            cache[pass_i] = _vcf_records(vcf_paths[pass_i])
        recs = cache[pass_i]
        seqs = gt.haplotype.all_seqs()
        options, rep = _blocks(gt.haplotype)
        h2a = alleles_of(seqs, options, rep)
        route = sem.route(motif[name])
        score = scorers.get(route)
        why = _why_unscored(name, gt._pb_route, route, h2a, recs, score)
        pool_scores = None if why else score(gt, seqs, device)
        if pool_scores is None:
            unscored[why or f"the {route} scorer gave nothing"] += 1
            continue
        names = [a.name for a in gt.alns]
        label = np.array([reads_of[r][0] for r in names])
        if sem.phased:
            log_p1, log_p2 = ref_posterior.phasing_priors(
                label, np.array([reads_of[r][1] for r in names]))
        else:
            log_p1 = log_p2 = np.zeros(len(names))
        LL = pool_scores[gt.pool_index]
        for i in range(1, len(names)):
            if names[i] == names[i - 1]:        # a pair's second mate
                LL[i - 1] = LL[i] = LL[i - 1] + LL[i]
        P, totals = ref_posterior.posteriors(LL, log_p1, log_p2, label,
                                             len(samples), gt.haploid)
        V = len(options[rep])
        bp = [len(options[rep][o]) - len(options[rep][0]) for o in range(V)]
        fields = ref_posterior.genotype_fields(P, totals, h2a, V, gt.haploid)
        keys, cols = recs[name]
        for s, sample in enumerate(samples):
            col = cols[recs[None].index(sample)]
            if col.startswith("."):
                continue
            vals = dict(zip(keys, col.split(":")))
            (ga, gb), q, pq, gld = fields[s]
            d = 0.0 if vals["GB"] == f"{bp[ga]}|{bp[gb]}" else CALL_DIFFERS
            d = max(d, abs(float(vals["Q"]) - q), abs(float(vals["PQ"]) - pq))
            if vals["GLDIFF"] != ".":
                d = max(d, abs(float(vals["GLDIFF"]) - gld))
            gap = max(gap, d)
            n += 1
    return gap, n, dict(unscored)


def unwritten(probes, passes) -> dict:
    """{sampled locus: why unscored} of the sampled loci that some of the
    window's ``passes`` never wrote to its VCF (every pass runs every
    locus of the catalog)."""
    lost = {}
    for name in sorted(probes.chosen):
        k = probes.loci_seen.get(name, 0)
        if k < passes:
            lost[name] = ("never written" if k == 0 else
                          "not written by every pass")
    return lost


def run(probes, vcf_paths, cat, sample, sem, scorers, device,
        seed) -> tuple[dict, list]:
    """({number: value}, [notes]) of the window's captured output."""
    rng = np.random.default_rng([seed, 0xC4EC])
    out, notes = {}, []
    g, n = pairhmm_gap(probes.pair_calls.items, rng,
                       sample["rows_per_call"], device, sem.trans)
    notes.append(f"pairhmm: {n} rows of {len(probes.pair_calls.items)} "
                 f"calls (of {probes.pair_calls.seen})")
    out["pairhmm_gap"] = float(g) if n else None
    lost = unwritten(probes, len(vcf_paths))
    loci = {k: v for k, v in probes.loci.items() if k not in lost}
    g, n, unscored = vcf_gap(loci, vcf_paths, cat, sem, scorers, device)
    unscored = Counter(unscored) + Counter(lost.values())
    routes = dict(Counter(gt._pb_route for _p, gt in loci.values()))
    notes.append(f"vcf: {n} sample calls of {len(loci)} loci "
                 f"(routes {routes}); of {len(probes.chosen)} sampled, "
                 f"unscored {dict(unscored)}")
    out["vcf_gap"] = float(g) if n else None
    out["unscored_share"] = (sum(unscored.values()) / len(probes.chosen)
                             if probes.chosen else None)
    return out, notes
