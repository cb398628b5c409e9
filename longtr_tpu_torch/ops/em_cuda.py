"""Wrappers of the hand-written CUDA kernels of ``csrc/em.cu``: the window
posteriors (J3) and the EM stutter train loop (J4), one launch each.

- :func:`window_posteriors` computes the posteriors of a padded window of
  loci in one launch: each small locus a team of warps, each large one a
  thread-block cluster that splits its reads (:func:`window_plan`), the
  kernel mapping its blocks to loci from their counts; the plain version
  is
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
import functools
from typing import NamedTuple

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

# The window kernel's plan (csrc/em.cu::window_posteriors_kernel).  Each
# sample's A*A outputs take whole warps (S * ceil(A*A / 32) warps).  A
# locus of n reads is small where a thread of its team (those warps, at
# most WINDOW_TEAM_WARPS) walks ceil(n / S) reads for each of its outputs
# in at most WINDOW_SMALL_STEPS steps; teams of WINDOW_TEAM_WARPS warps at
# most share a block.  A larger locus takes a cluster of WINDOW_CLUSTER
# blocks (csrc/em.cu's WP_CLUSTER) of WINDOW_THREADS threads, block k
# summing the rounds of 32 reads k, k + 8, k + 16, ..., its warps in J
# sub-teams (the block's rounds j, j + J, ...) where the outputs' warps
# leave threads idle; the partials are added in sub-team order, then in
# block order.  A large block stages tiles of WINDOW_TILE_FLOATS floats of
# operands at most.  The step bound lies between the two routes'
# crossings in chip_smoke.py's sweep on an H100 (PERF.md); a test may set
# WINDOW_SMALL_STEPS to send loci to either route.
WINDOW_SMALL_STEPS = 400
WINDOW_TEAM_WARPS = 4
WINDOW_CLUSTER = 8
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


class WindowPlan(NamedTuple):
    """How the window kernel takes a window padded to A alleles and S
    samples: a locus of at most ``small_max`` reads is small, a team of
    ``sw`` warps, ``teams`` teams a block; a larger one takes a cluster of
    WINDOW_CLUSTER blocks, ``j`` sub-teams a block."""
    j: int
    sw: int
    teams: int
    small_max: int


def window_plan(num_alleles: int, num_samples: int) -> WindowPlan:
    """The window kernel's plan for a window padded to ``num_alleles`` and
    ``num_samples``.  A locus's route follows from its own count against
    ``small_max``, and j, which fixes the order of a large locus's sums,
    from (A, S) alone: a locus gets the same bits in any window."""
    A, S = int(num_alleles), int(num_samples)
    warps = S * -(-A * A // 32)     # each sample's outputs whole warps
    sw = min(WINDOW_TEAM_WARPS, warps)
    # ceil(n / S) * ceil(warps / sw) <= WINDOW_SMALL_STEPS
    small_max = S * (WINDOW_SMALL_STEPS // -(-warps // sw))
    return WindowPlan(j=max(1, WINDOW_THREADS // (32 * warps)), sw=sw,
                      teams=WINDOW_TEAM_WARPS // sw,
                      small_max=min(small_max, _I32))


def window_grid(plan: WindowPlan, counts) -> tuple[int, int]:
    """(large loci, small blocks) of the kernel's grid for loci of
    ``counts`` reads: a cluster each large locus, then blocks of ``teams``
    slots for the window's loci in order (a large locus's slot idles),
    whole clusters of them where the grid holds a cluster."""
    L = len(counts)
    n_large = int(np.count_nonzero(np.asarray(counts) > plan.small_max))
    n_small = -(-L // plan.teams) if n_large < L else 0
    if n_large:
        n_small = -(-n_small // WINDOW_CLUSTER) * WINDOW_CLUSTER
    return n_large, n_small


@functools.lru_cache(maxsize=None)
def _window_launch(R, A, S, device_index, small_steps):
    """(plan, tile of a small team, of a large block, samples of a batch of
    each) for a window padded to (R, A, S) on a card, all from the padded
    shape: so is the summation order of each locus."""
    plan = window_plan(A, S)
    lib = _build.load_library()
    ch_l = min(512, max(32, WINDOW_TILE_FLOATS // (2 * A) // 32 * 32))
    ch_s = min(ch_l, max(32, -(-min(R, plan.small_max) // 32) * 32))
    limit = max_smem_optin(torch.device("cuda", device_index))
    sb_s = int(lib.window_posteriors_batch(A, S, ch_s, 1, plan.teams, limit))
    sb_l = int(lib.window_posteriors_batch(A, S, ch_l, plan.j, 1, limit))
    if not (sb_s and sb_l):
        raise ValueError(f"A={A}: one sample's sums and a tile of 32 reads "
                         f"take more than the card's {limit} bytes of "
                         "shared memory")
    return plan, ch_s, ch_l, sb_s, sb_l


def window_posteriors(log_aln_probs, log_p1, log_p2, sample_label, read_mask,
                      prior, num_samples: int, counts):
    """(posteriors (L, S, A, A), totals (L, S)) of a padded window: the
    arguments of ``calc_log_sample_posteriors`` with one leading locus
    axis, log_aln_probs (L, R, A) float32, log_p1/log_p2 (L, R) float32,
    sample_label (L, R) int64, read_mask (L, R) bool, prior (L, A, A)
    float32.  ``counts`` (host ints, one a locus, best an int32 array,
    which is taken as it is): the kernel reads rows
    [0, counts[i]) of locus i, and every row past them must be masked
    (``pad_window`` puts locus i's R_i reads first); the plain version
    reads the mask alone."""
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
    counts = np.asarray(counts)
    if counts.dtype != np.int32:          # ints past int32 raise below
        counts = counts.astype(np.int64)
    if counts.shape != (L,) or (L and (counts.min() < 0
                                       or counts.max() > R)):
        raise ValueError(f"counts must be {L} values in [0, {R}]")
    counts = np.ascontiguousarray(counts, np.int32)
    dev = log_aln_probs.device
    P = torch.empty((L, S, A, A), dtype=f32, device=dev)
    totals = torch.empty((L, S), dtype=f32, device=dev)
    if L == 0:
        return P, totals
    plan, ch_s, ch_l, sb_s, sb_l = _window_launch(
        R, A, S, dev.index if dev.index is not None
        else torch.cuda.current_device(), WINDOW_SMALL_STEPS)
    n_large, n_small = window_grid(plan, counts)
    # pageable: the copy is staged before it returns, and waits for nothing
    counts_d = torch.from_numpy(counts).to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        rc = _build.load_library().window_posteriors(
            *[_ptr(x) for x in args], L, R, A, S, _ptr(counts_d), n_large,
            n_small, plan.small_max, plan.j, plan.sw, plan.teams, ch_s, ch_l,
            sb_s, sb_l, _LOG_HALF, _ptr(P), _ptr(totals), _stream(dev))
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
