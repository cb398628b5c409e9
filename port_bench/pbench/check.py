"""Whether what the timed path produced is correct.

Two numbers, each the widest gap between the program and the plain
reference (``pbref``) over a sample drawn from the seed:

- ``pairhmm_gap``: the pair-HMM scores the card returned for sampled rows
  of sampled ``pairhmm_batch_auto`` calls, against the reference scan of
  the same (haplotype, read) pairs.
- ``vcf_gap``: for sampled loci, Q, PQ and GLDIFF as each pass wrote them
  to its VCF, against the reference's own: its scores of the locus's reads
  and final candidate haplotypes, the phasing priors it derives from the
  generated reads' HP tags, the allele each candidate carries found from
  the candidates' sequences, and its float64 posteriors; a called allele
  pair (GB) that differs counts as a gap of 1000 (above every limit).

The reference follows the program's state where it has to: it scores the
reads as the program trimmed and pooled them, against the candidate
haplotypes the program built, and takes the samples in the order the
program grouped the locus's reads (PERF.md says so).  Everything else it
derives from the generated inputs.
"""

from __future__ import annotations

import gzip
import itertools

import numpy as np
import torch

from pbref import pairhmm as ref_pairhmm
from pbref import posterior as ref_posterior

# REF_FLANK_LEN - indel flank (5, the default the configurations keep):
# the bases the pair-HMM clips from each end of a candidate haplotype.
HAP_CLIP = 35 - 5
CALL_DIFFERS = 1000.0


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


def pairhmm_gap(calls, rng, rows_per_call, device):
    gap, n = 0.0, 0
    for hap, hl, read, rl, fl, _trans, out in calls:
        got = _host(out)[:len(hl)]
        real = np.flatnonzero(~((hl <= 1) & (rl <= 1) & (fl <= 1)))
        sel = np.sort(rng.choice(real, size=min(rows_per_call, len(real)),
                                 replace=False))
        want = ref_pairhmm.score_arrays(
            (hap[sel], hl[sel], read[sel], rl[sel], fl[sel]), device)
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


def _pool_scores(gt, seqs, device) -> np.ndarray | None:
    """(pools, candidate haplotypes) reference scores of one locus."""
    if getattr(gt, "_pb_pairs", None) is None:
        return None
    P, H = gt._request_shape
    reads = [gt._pb_pairs[p * H][1] for p in range(P)]
    trimmed = [s[HAP_CLIP: len(s) - HAP_CLIP] if len(s) > 2 * HAP_CLIP
               else "" for s in seqs]
    pairs = [(trimmed[h], r, len(seqs[h])) for r in reads
             for h in range(len(seqs))]
    scores = ref_pairhmm.score_arrays(ref_pairhmm.pack(pairs), device)
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


def vcf_gap(loci, vcf_paths, reads_of, samples, device):
    """(gap, samples compared, loci with no reference scores).
    ``reads_of``: the generator's {read name: (sample index, HP tag)};
    ``samples``: the sample names by the generator's sample index."""
    gap, n, skipped = 0.0, 0, 0
    cache = {}
    for name in sorted(loci):
        pass_i, gt = loci[name]
        if pass_i not in cache:
            cache[pass_i] = _vcf_records(vcf_paths[pass_i])
        recs = cache[pass_i]
        seqs = gt.haplotype.all_seqs()
        options, rep = _blocks(gt.haplotype)
        h2a = alleles_of(seqs, options, rep)
        pool_scores = _pool_scores(gt, seqs, device)
        if pool_scores is None or h2a is None or name not in recs:
            skipped += 1
            continue
        names = [a.name for a in gt.alns]
        label = np.array([reads_of[r][0] for r in names])
        log_p1, log_p2 = ref_posterior.phasing_priors(
            label, np.array([reads_of[r][1] for r in names]))
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
    return gap, n, skipped


def run(probes, vcf_paths, cat, sample, device, seed) -> tuple[dict, list]:
    """({number: value}, [notes]) of the window's captured output."""
    rng = np.random.default_rng([seed, 0xC4EC])
    out, notes = {}, []
    g, n = pairhmm_gap(probes.pair_calls.items, rng,
                       sample["rows_per_call"], device)
    notes.append(f"pairhmm: {n} rows of {len(probes.pair_calls.items)} "
                 f"calls (of {probes.pair_calls.seen})")
    out["pairhmm_gap"] = float(g) if n else None
    g, n, skipped = vcf_gap(probes.loci, vcf_paths, cat["reads"],
                            cat["samples"], device)
    notes.append(f"vcf: {n} sample calls of {len(probes.loci)} loci, "
                 f"{skipped} without reference scores")
    out["vcf_gap"] = float(g) if n else None
    return out, notes
