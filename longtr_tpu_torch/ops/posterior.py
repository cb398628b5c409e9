"""Diplotype posteriors: priors, the f64 oracle and the batched torch path.

Port of :mod:`longtr_tpu.ops.posterior`
(``Genotyper::calc_log_sample_posteriors``, src/genotyper.cpp:21-83):

    for each read r with sample s:
        for each diplotype (a1, a2):
            P[s, a1, a2] += log( exp(LL[r,a1] + log_p1[r] + log(1/2))
                               + exp(LL[r,a2] + log_p2[r] + log(1/2)) )
    P[s] += genotype prior;  P[s] -= logsumexp(P[s])   (normalize per sample)

with read LLs clamped at -600 first.  The default path computes this on
the host in float64 (``SeqStutterGenotyper._calc_posteriors``).
:func:`batched_posteriors` computes it for a window of loci in one float32
call on a device, or on each shard of a mesh; the pipeline uses it, under
``LONGTR_DEVICE_POSTERIOR=1`` or with a mesh, only to decide allele
pruning.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF, int_log

LL_CLAMP = -600.0
# The reference uses -DBL_MAX/2 for impossible haploid heterozygotes
# (genotyper.cpp:31); the host f64 path uses the same value (bit parity).
# It becomes -inf in float32, which is equally absorbing under exp and
# logsumexp.  Padded cells of a batched call use the f32-finite NEG_PAD.
NEG_HALF_DBL_MAX = -8.988465674311579e307
NEG_PAD = -1e30


def genotype_log_priors(num_alleles: int, haploid: bool) -> np.ndarray:
    """(A, A) log prior matrix (genotyper.cpp:21-43)."""
    A = num_alleles
    if haploid:
        homo = -int_log(A)
        het = NEG_HALF_DBL_MAX
    else:
        homo = int_log(2) - int_log(A) - int_log(A + 1)
        het = -int_log(A) - int_log(A + 1)
    prior = np.full((A, A), het, dtype=np.float64)
    np.fill_diagonal(prior, homo)
    return prior


def posteriors_oracle(log_aln_probs: np.ndarray, log_p1: np.ndarray,
                      log_p2: np.ndarray, sample_label: np.ndarray,
                      num_samples: int, haploid: bool):
    """Float64 transcription of calc_log_sample_posteriors.

    Returns (posteriors (S,A,A) normalized, sample_total_LLs (S,), total_LL).
    """
    LL = np.clip(np.asarray(log_aln_probs, dtype=np.float64), LL_CLAMP, None)
    R, A = LL.shape
    P = np.tile(genotype_log_priors(A, haploid)[None], (num_samples, 1, 1))
    for r in range(R):
        s = int(sample_label[r])
        t = np.log(np.exp(LL[r][:, None] + log_p1[r] + LOG_ONE_HALF)
                   + np.exp(LL[r][None, :] + log_p2[r] + LOG_ONE_HALF))
        P[s] += t
    totals = np.zeros(num_samples)
    for s in range(num_samples):
        m = P[s].max()
        tot = m + math.log(np.exp(P[s] - m).sum())
        totals[s] = tot
        P[s] -= tot
    return P, totals, float(totals.sum())


def calc_log_sample_posteriors(log_aln_probs, log_p1, log_p2, sample_label,
                               num_samples: int, prior, read_mask=None):
    """Posteriors of one locus, or of a batch of loci on leading axes.

    log_aln_probs (..., R, A); log_p1, log_p2, sample_label and the optional
    read_mask (False rows contribute nothing) (..., R); prior (..., A, A).
    Returns (posteriors (..., S, A, A), sample_total_LLs (..., S), total_LL
    (...)).

    The sum over reads by sample is one masked sum per sample: a reduction
    in a fixed order, so a card gives the same bits on every run
    (``index_add_`` on CUDA floats would use atomics, whose order is not).
    """
    LL = torch.clamp(log_aln_probs, min=LL_CLAMP)
    a = LL + log_p1[..., None] + LOG_ONE_HALF                   # (..., R, A)
    b = LL + log_p2[..., None] + LOG_ONE_HALF
    T = torch.logaddexp(a[..., :, :, None], b[..., None, :])    # (.., R, A, A)
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    if read_mask is not None:
        T = torch.where(read_mask[..., None, None], T, zero)
    label = sample_label[..., None, None]
    S = torch.stack([torch.where(label == s, T, zero).sum(dim=-3)
                     for s in range(num_samples)], dim=-3)     # (.., S, A, A)
    P = S + prior[..., None, :, :]
    totals = torch.logsumexp(P.flatten(-2), dim=-1)
    P = P - totals[..., None, None]
    return P, totals, totals.sum(dim=-1)


def batched_posteriors(loci, device=None, mesh=None):
    """Posteriors of a WINDOW of loci in one float32 call on ``device``, or
    one call on each shard of ``mesh``.

    ``loci``: list of dicts with keys ``log_aln_probs`` (R_i, A_i),
    ``log_p1``/``log_p2`` (R_i,), ``sample_label`` (R_i,), ``num_samples``
    S_i, ``haploid``.  Each locus is padded to (R_max, A_max, S_max); padded
    alleles get prior/LL of -1e30 (contribute nothing), padded reads are
    masked out, and each locus is reduced on its own.  With a mesh of more
    than one shard, shard k takes the k-th slice of ceil(L / shards) loci
    on its device; each locus's reduction stays on one device, so the
    results are the same for any mesh size.

    Returns a list of (posteriors (S_i, A_i, A_i), totals (S_i,)) float32
    numpy arrays.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    devices = mesh.devices if mesh is not None and mesh.size > 1 else (device,)
    L = len(loci)
    R_max = max(l["log_aln_probs"].shape[0] for l in loci)
    A_max = max(l["log_aln_probs"].shape[1] for l in loci)
    S_max = max(l["num_samples"] for l in loci)
    LL = np.full((L, R_max, A_max), NEG_PAD, dtype=np.float32)
    p1 = np.zeros((L, R_max), dtype=np.float32)
    p2 = np.zeros((L, R_max), dtype=np.float32)
    label = np.zeros((L, R_max), dtype=np.int64)
    mask = np.zeros((L, R_max), dtype=bool)
    prior = np.full((L, A_max, A_max), NEG_PAD, dtype=np.float32)
    for i, l in enumerate(loci):
        R, A = l["log_aln_probs"].shape
        LL[i, :R, :A] = l["log_aln_probs"]
        p1[i, :R] = l["log_p1"]
        p2[i, :R] = l["log_p2"]
        label[i, :R] = l["sample_label"]
        mask[i, :R] = True
        prior[i, :A, :A] = np.maximum(genotype_log_priors(A, l["haploid"]),
                                      NEG_PAD)
    step = -(-L // len(devices))
    shards = []
    for k, dev in enumerate(devices[:-(-L // step)]):
        LLk, p1k, p2k, labk, maskk, priork = (
            torch.from_numpy(x[k * step:(k + 1) * step]).to(dev)
            for x in (LL, p1, p2, label, mask, prior))
        shards.append(calc_log_sample_posteriors(
            LLk, p1k, p2k, labk, S_max, priork, read_mask=maskk)[:2])
    P_all = np.concatenate([P.cpu().numpy() for P, _t in shards])
    totals = np.concatenate([t.cpu().numpy() for _P, t in shards])
    out = []
    for i, l in enumerate(loci):
        A = l["log_aln_probs"].shape[1]
        S = l["num_samples"]
        out.append((P_all[i, :S, :A, :A], totals[i, :S]))
    return out


def map_genotypes(posteriors):
    """Per-sample argmax diplotype (genotyper.cpp:85-100).

    Returns (gt_a (S,), gt_b (S,)) with ties broken toward the smallest flat
    index, matching the reference's strict ``>`` scan order.
    """
    S, A, _ = posteriors.shape
    idx = torch.argmax(posteriors.reshape(S, -1), dim=1)
    return idx // A, idx % A
