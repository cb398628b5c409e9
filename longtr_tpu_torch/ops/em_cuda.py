"""Wrappers of the hand-written CUDA kernels of ``csrc/em.cu``: the window
posteriors (J3) and the EM stutter train loop (J4), one launch each.

- :func:`window_posteriors` computes the posteriors of a padded window of
  loci, one thread-block cluster a locus (:func:`window_plan`); the plain
  version is
  :func:`longtr_tpu_torch.ops.posterior.calc_log_sample_posteriors`.
  ``batched_posteriors`` launches it once a window on each shard's card.
- :func:`em_train` runs the whole EM train loop of one locus (E step,
  closed-form M step, convergence test, every iteration) in one launch of
  one thread-block cluster; the plain version is
  :func:`longtr_tpu_torch.parallel.mesh._em_train`, which runs it as a
  Python loop of eager launches with a host read an iteration.  Its reads
  are split into ``n_shards`` equal slices, as the mesh splits them: each
  shard's partial sums are formed apart and added in shard order.  It
  returns one packed tensor (:func:`unpack`), so the caller reads the
  result with one copy.  Its blocks keep each read's E-step terms in
  shared memory and exchange their sums over distributed shared memory
  where :func:`em_layout`'s counts fit (:func:`em_branch` "kept"), and
  recompute the terms otherwise ("recomputed"); both give the same bits.

Each wrapper validates its tensors, allocates its outputs and workspace
with ``torch.empty`` on the inputs' device, launches on the current CUDA
stream without synchronising, raises if the launch is refused, and adds
one to its ``launches`` count per launch.  Given CPU tensors
:func:`window_posteriors` runs its plain version and counts nothing;
:func:`em_train` takes CUDA tensors only (``em_train_sharded`` runs the
plain loop on a CPU mesh).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from longtr_tpu_torch.ops import _build
from longtr_tpu_torch.ops.pairhmm_cuda import (_ptr, _raise_on, _stream,
                                               max_smem_optin)
from longtr_tpu_torch.ops.posterior import calc_log_sample_posteriors
from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF

# Kernel launches; chip_smoke.py zeroes and reads this.
launches = {"window_posteriors": 0, "em_train": 0}

# The EM kernel's first E-step half sums the terms of each (shard, sample)
# in chunks of CHUNK_READS reads (in read order).  Block r of its cluster
# of CLUSTER_BLOCKS blocks (csrc/em.cu's EM_CTAS) owns chunks
# r * nch // CLUSTER_BLOCKS .. (r + 1) * nch // CLUSTER_BLOCKS - 1 of the
# nch: it adds its chunks of a (shard, sample) in order, the blocks'
# sums are added in block order, then the shards in shard order.
CHUNK_READS = 32
CLUSTER_BLOCKS = 16

# The EM kernel keeps each read's terms in shared memory from one E-step
# half to the other where its blocks' shared memory holds them and the
# posteriors (em_branch); a test may set this lower than the card's limit
# to send a train to the branch that recomputes them.
smem_limit_bytes = None

# Cluster barriers an iteration of each branch of the EM kernel.
BARRIERS = {"kept": 2, "recomputed": 3}

# The window kernel's split of a locus: a cluster of up to 8 blocks of
# WINDOW_THREADS where the locus has fewer outputs (S * A * A) than 8
# blocks have threads, block k taking every KB-th tile of CH sorted reads
# (their operands staged in WINDOW_TILE_FLOATS floats of shared memory at
# most); each block's float64 partials are added in block order.
WINDOW_THREADS = 512
WINDOW_TILE_FLOATS = 8192

_LOG_HALF = ctypes.c_float(float(np.float32(LOG_ONE_HALF)))
_I32 = 2 ** 31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(names, args, dtypes, want):
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: the kernel takes CUDA tensors")
    for name, x, dt in zip(names, args, dtypes):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {names[0]} on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{want[name]}")


def _smem_fits(need: int, dev, what: str) -> None:
    if need > max_smem_optin(dev):
        raise ValueError(f"{what}: {need} bytes of shared memory, more than "
                         f"the card's {max_smem_optin(dev)}")


WINDOW_NAMES = ("log_aln_probs", "log_p1", "log_p2", "sample_label",
                "read_mask", "prior")


def window_plan(num_samples: int, num_alleles: int):
    """(KB, CH): the window kernel's blocks a locus and reads a tile."""
    outputs = num_samples * num_alleles * num_alleles
    kb = max(1, min(8, 8 * WINDOW_THREADS // outputs))
    ch = max(1, min(128, WINDOW_TILE_FLOATS // (2 * num_alleles)))
    return kb, ch


def window_posteriors(log_aln_probs, log_p1, log_p2, sample_label, read_mask,
                      prior, num_samples: int):
    """(posteriors (L, S, A, A), totals (L, S)) of a padded window: the
    arguments of ``calc_log_sample_posteriors`` with one leading locus
    axis, log_aln_probs (L, R, A) float32, log_p1/log_p2 (L, R) float32,
    sample_label (L, R) int64, read_mask (L, R) bool, prior (L, A, A)
    float32."""
    args = (log_aln_probs, log_p1, log_p2, sample_label, read_mask, prior)
    if log_aln_probs.device.type == "cpu":
        P, totals, _ = calc_log_sample_posteriors(
            log_aln_probs, log_p1, log_p2, sample_label, num_samples, prior,
            read_mask=read_mask)
        return P, totals
    if log_aln_probs.dim() != 3:
        raise ValueError("log_aln_probs must be (L, R, A)")
    L, R, A = log_aln_probs.shape
    S = int(num_samples)
    f32 = torch.float32
    _check(WINDOW_NAMES, args, (f32, f32, f32, torch.int64, torch.bool, f32),
           {"log_aln_probs": (L, R, A), "log_p1": (L, R), "log_p2": (L, R),
            "sample_label": (L, R), "read_mask": (L, R),
            "prior": (L, A, A)})
    if S < 1 or R < 1 or A < 1:
        raise ValueError(f"R={R}, A={A}, S={S}: each must be >= 1")
    if R * A > _I32 or S * A * A > _I32:
        raise ValueError(f"R={R}, A={A}, S={S}: a locus indexes its "
                         "R * A inputs and S * A * A outputs in 32 bits")
    dev = log_aln_probs.device
    P = torch.empty((L, S, A, A), dtype=f32, device=dev)
    totals = torch.empty((L, S), dtype=f32, device=dev)
    if L == 0:
        return P, totals
    lib = _build.load_library()
    kb, ch = window_plan(S, A)
    _smem_fits(lib.window_posteriors_smem_bytes(A, S, ch), dev,
               f"A={A}, S={S}")
    order = torch.empty((L, R), dtype=torch.int32, device=dev)
    starts = torch.empty((L, S + 1), dtype=torch.int32, device=dev)
    part = torch.empty(L * kb * S * A * A, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.window_posteriors(*[_ptr(x) for x in args], L, R, A, S, kb,
                                   ch, _LOG_HALF, _ptr(order), _ptr(starts),
                                   _ptr(part), _ptr(P), _ptr(totals),
                                   _stream(dev))
    _raise_on(rc, "window_posteriors")
    launches["window_posteriors"] += 1
    return P, totals


EM_NAMES = ("rep", "eff", "in_frame", "log_p1", "log_p2", "label", "cat",
            "w_in", "w_out", "valid", "init_priors")


def packed_size(num_samples: int, num_alleles: int) -> int:
    """Floats of :func:`em_train`'s result."""
    return 8 + num_samples + num_samples * num_alleles * num_alleles


def unpack(out, num_samples: int, num_alleles: int):
    """(converged, params (6,), n_iter, posteriors (S, A, A), totals (S,))
    of :func:`em_train`'s packed result, a host array: converged, n_iter,
    the six parameters, the totals, the posteriors."""
    out = np.asarray(out)
    S, A = num_samples, num_alleles
    return (bool(out[0]), out[2:8], int(out[1]),
            out[8 + S:].reshape(S, A, A), out[8:8 + S])


def em_layout(label, valid, n_shards: int, num_samples: int):
    """(chunks, reads): the most chunks and the most reads that one block of
    the EM kernel's cluster owns.  The valid reads of each (shard, sample)
    (shard k: rows [k R / n, (k + 1) R / n)) are cut into chunks of
    CHUNK_READS in read order, the (shard, sample)s in order; block r owns
    chunks r nch // CLUSTER_BLOCKS .. (r + 1) nch // CLUSTER_BLOCKS - 1.
    The kernel lays out its shared memory by these two counts and checks
    them."""
    label = np.asarray(label, np.int64)
    valid = np.asarray(valid, bool)
    R, n, S = len(label), int(n_shards), int(num_samples)
    ok = valid & (label >= 0) & (label < S)
    key = (np.arange(R) // (R // n)) * S + label
    counts = np.bincount(key[ok], minlength=n * S)
    sizes = np.concatenate([np.zeros(0, np.int64)] + [
        np.minimum(CHUNK_READS, c - np.arange(0, c, CHUNK_READS))
        for c in counts])
    first = np.arange(CLUSTER_BLOCKS + 1) * len(sizes) // CLUSTER_BLOCKS
    ends = np.concatenate([[0], np.cumsum(sizes)])[first]
    return int(np.diff(first).max()), int(np.diff(ends).max())


def em_branch(num_alleles: int, num_samples: int, n_shards: int, layout,
              device) -> str:
    """The EM kernel's branch for a train of A alleles and S samples on
    ``n_shards`` shards whose blocks own ``layout`` (:func:`em_layout`):
    "kept" where a block's shared memory holds its reads' terms and the
    posteriors, "recomputed" otherwise."""
    need = int(_build.load_library().em_train_smem_bytes(
        num_alleles, num_samples, n_shards, CHUNK_READS, *layout, 1))
    limit = max_smem_optin(device)
    if smem_limit_bytes is not None:
        limit = min(limit, smem_limit_bytes)
    return "kept" if need <= limit else "recomputed"


def em_train(rep, eff, in_frame, log_p1, log_p2, label, cat, w_in, w_out,
             valid, init_priors, *, n_shards: int, num_samples: int,
             haploid: bool, max_iter: int, min_abs: float, min_frac: float,
             layout):
    """The EM train loop of one locus; returns the packed result
    (:func:`unpack`) on the inputs' device.

    rep, eff, cat (R, A) int32, in_frame (R, A) bool, w_in, w_out (R, A)
    float32: the diff-category tables (``em_train_sharded``'s); log_p1,
    log_p2 (R,) float32, label (R,) int64, valid (R,) bool (False rows
    contribute nothing); init_priors (A,) float32.  R is a multiple of
    ``n_shards``; shard k is rows [k R / n, (k + 1) R / n)
    (``mesh.em_tables`` makes these tables).  CUDA tensors only.
    ``layout``: :func:`em_layout` of label and valid, counted on the
    host.
    """
    args = (rep, eff, in_frame, log_p1, log_p2, label, cat, w_in, w_out,
            valid, init_priors)
    if rep.dim() != 2:
        raise ValueError("rep must be (R, A)")
    R, A = rep.shape
    n, S = int(n_shards), int(num_samples)
    if n < 1 or R < 1 or A < 1 or S < 1 or R % n:
        raise ValueError(f"R={R}, A={A}, S={S}, n_shards={n}: each must be "
                         ">= 1 and R a multiple of n_shards")
    i32, f32 = torch.int32, torch.float32
    _check(EM_NAMES, args,
           (i32, i32, torch.bool, f32, f32, torch.int64, i32, f32, f32,
            torch.bool, f32),
           {**{k: (R, A) for k in ("rep", "eff", "in_frame", "cat", "w_in",
                                   "w_out")},
            **{k: (R,) for k in ("log_p1", "log_p2", "label", "valid")},
            "init_priors": (A,)})
    lib = _build.load_library()
    dev = rep.device
    keep = int(em_branch(A, S, n, layout, dev) == "kept")
    n_ws = int(lib.em_train_workspace_floats(R, A, S, n, CHUNK_READS, keep))
    if n_ws > _I32 or R * A > _I32 or S * A * A > _I32:
        raise ValueError(f"R={R}, A={A}, S={S}: the train indexes its "
                         "workspace in 32 bits")
    _smem_fits(lib.em_train_smem_bytes(A, S, n, CHUNK_READS, *layout, keep),
               dev, f"R={R}, A={A}, S={S}, n_shards={n}")
    ws = torch.empty(n_ws, dtype=f32, device=dev)
    out = torch.empty(packed_size(S, A), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.em_train(
            *[_ptr(x) for x in (rep, eff, in_frame, log_p1, log_p2, label,
                                valid, cat, w_in, w_out, init_priors)],
            R, A, S, n, int(bool(haploid)), int(max_iter),
            ctypes.c_float(min_abs), ctypes.c_float(min_frac),
            _LOG_HALF, CHUNK_READS, *layout, keep, _ptr(ws), _ptr(out),
            _stream(dev))
    _raise_on(rc, "em_train")
    launches["em_train"] += 1
    return out
