"""Locus-sharded data parallelism over a mesh of torch devices.

Port of :mod:`longtr_tpu.parallel.mesh`.  A JAX mesh is one process
driving many devices; so is this one.  :class:`Mesh` is an ordered tuple
of ``torch.device``s on one axis, ``"locus"``:

* a shard is a slice of an array's leading dimension, placed on its
  device (:func:`shard_batch`);
* a ``psum`` adds the shards' partial tensors in shard order on
  ``mesh.devices[0]`` (:func:`_psum`), so a given mesh gives the same bits
  on every run, and copies the sum back to each shard's device where a
  shard needs it (:func:`_replicate`).

A device may repeat: the tests run eight shards on ``cpu``, the
counterpart of the JAX package's eight virtual CPU devices, and
``chip_smoke.py`` four on ``cuda:0``.  :func:`make_mesh` takes every
visible CUDA card.

The pair-HMM (:func:`pairhmm_batch_sharded`) scores each shard with
:func:`~longtr_tpu_torch.ops.pairhmm.pairhmm_batch_auto` on the shard's
device: the CUDA kernels on a card, the plain scan on the CPU.  The EM
stutter trainer (:func:`em_train_sharded`) runs the whole train loop in
float32, reads sharded, with the two psums of each E-step: on a mesh of
cards in one launch of :func:`~longtr_tpu_torch.ops.em_cuda.em_train` on
``mesh.devices[0]``, the shards' partial sums formed apart and added in
shard order inside the kernel; on CPU shards as the plain loop
:func:`_em_train`, each shard's half of the E-step on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF
from longtr_tpu_torch.ops import em_cuda
from longtr_tpu_torch.ops.pairhmm import (AlignmentParams, _check_batch,
                                          pairhmm_batch_auto)
from longtr_tpu_torch.ops.posterior import LL_CLAMP

# Device EM train loops run, by the device type of the mesh's first shard.
# chip_smoke.py reads it to show that a run trained on the card.
em_trains = {"cuda": 0, "cpu": 0}


class Mesh:
    """An ordered tuple of devices on the one axis ``"locus"``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh of the visible CUDA cards (the first ``n_devices`` of them)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh takes the visible CUDA cards and there "
                           "are none; build a Mesh from a list of devices")
    devs = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devs if n_devices is None else devs[:n_devices])


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's leading dimension into ``mesh.size`` equal
    slices, slice k on ``mesh.devices[k]``.  Returns, for each array, the
    list of its shards."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % mesh.size:
            raise ValueError(f"leading dimension {t.shape[0]} does not split "
                             f"evenly over {mesh.size} shards")
        out.append([p.to(d, non_blocking=True)
                    for p, d in zip(torch.tensor_split(t, mesh.size),
                                    mesh.devices)])
    return tuple(out)


def pad_to_multiple(arrays, multiple: int, axis: int = 0):
    """Pad leading dim to a multiple (for even sharding). Returns (arrays, n)."""
    n = arrays[0].shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arrays, n
    out = []
    for a in arrays:
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, pad)
        out.append(np.pad(a, widths))
    return tuple(out), n


def _psum(mesh: Mesh, parts):
    """The sum of one partial tensor per shard, added in shard order on
    ``mesh.devices[0]``."""
    d0 = mesh.devices[0]
    total = parts[0].to(d0)
    for p in parts[1:]:
        total = total + p.to(d0)
    return total


def _replicate(mesh: Mesh, x):
    """One copy of ``x`` on each shard's device."""
    return [x.to(d, non_blocking=True) for d in mesh.devices]


def pairhmm_batch_sharded(hap_codes, hap_lens, read_codes, read_lens,
                          full_hap_lens,
                          params: AlignmentParams = AlignmentParams(),
                          mesh: Mesh | None = None):
    """Mesh-parallel counterpart of ``pairhmm_batch_auto``: pads the pair
    batch to split evenly over the mesh (padded rows have length 1) and
    scores shard k on ``mesh.devices[k]``.

    Every shard is enqueued before any is synced.  Returns the list of
    per-shard scores in shard order, padding cut off; their concatenation
    is element-wise identical to the single-device batch.
    ``seq_genotyper._gather`` brings them to the host with one copy per
    device.
    """
    mesh = mesh or make_mesh()
    hap, hl, read, rl, fl = _check_batch(hap_codes, hap_lens, read_codes,
                                         read_lens, full_hap_lens)
    B = hap.shape[0]
    (hap, read), _ = pad_to_multiple((hap, read), mesh.size)
    hl, rl, fl = (np.pad(x, (0, hap.shape[0] - B), constant_values=1)
                  for x in (hl, rl, fl))
    step = hap.shape[0] // mesh.size
    shards = []
    for k, dev in enumerate(mesh.devices):
        sl = slice(k * step, (k + 1) * step)
        scores = pairhmm_batch_auto(hap[sl], hl[sl], read[sl], rl[sl], fl[sl],
                                    params, device=dev)
        shards.append(scores[:max(0, min(step, B - k * step))])
    return shards


# ---------------------------------------------------------------------------
# The EM stutter train loop on the mesh
# ---------------------------------------------------------------------------
#
# The JAX package runs the whole train loop (E-step, closed-form M-step,
# convergence tests; em_stutter_genotyper.cpp:170-226) as one
# lax.while_loop inside shard_map.  On a mesh of cards so does the port:
# csrc/em.cu's em_train_kernel runs every iteration in one launch on the
# mesh's first card (em_cuda.em_train).  Its plain version, _em_train, is
# a Python loop over device tensors with one host read an iteration (the
# stop flag); the per-shard halves of the E-step run on each shard's
# device and the replicated state (priors, parameters, posteriors) on the
# mesh's first device.  CPU meshes run it.  All of it is float32, like the
# reference.

_EM_TOL = 1e-10
_EM_MAX_PARAM_DIFF = 1e-4
_EM_INIT_PARAMS = (0.9, 0.1, 0.1, 0.8, 0.01, 0.01)


def _em_pmf_from_params(params, rep, eff, in_frame):
    """log_stutter_pmf over the (R, A) diff tables (stutter_model.cpp:29-53).

    params: (6,) = (in_geom, in_up, in_down, out_geom, out_up, out_down);
    rep / eff: integer repeat- / effective-bp-difference tables; in_frame:
    bool table."""
    ing, inu, ind, outg, outu, outd = params.unbind(0)
    in_log_step = torch.log(1.0 - ing)
    in_log_nostep = torch.log(ing)
    out_log_step = torch.log(1.0 - outg)
    out_log_nostep = torch.log(outg)
    log_equal = torch.log(1.0 - inu - ind - outu - outd)
    out_val = torch.where(
        eff < 0,
        torch.log(outd) + out_log_nostep + out_log_step * (-eff - 1),
        torch.log(outu) + out_log_nostep + out_log_step * (eff - 1))
    in_val = torch.where(
        rep == 0, log_equal,
        torch.where(rep < 0,
                    torch.log(ind) + in_log_nostep + in_log_step * (-rep - 1),
                    torch.log(inu) + in_log_nostep + in_log_step * (rep - 1)))
    return torch.where(in_frame, in_val, out_val)


def _em_mstep_params(stats):
    """Closed-form stutter re-estimate from the 7 category sums with the
    reference's pseudocounts (em_stutter_genotyper.cpp:63-127)."""
    s_in_eq, s_in_up, s_in_down, s_out_up, s_out_down, din, dout = (
        stats.unbind(0))
    in_tot_up = torch.log(1.0 + s_in_up)
    in_tot_down = torch.log(1.0 + s_in_down)
    in_tot_eq = torch.log(1.0 + s_in_eq)
    in_tot_diffs = torch.log(1.0 + 1.1 + din)
    out_tot_up = torch.log(1.0 + s_out_up)
    out_tot_down = torch.log(1.0 + s_out_down)
    out_tot_diffs = torch.log(1.0 + 1.1 + dout)
    out_tot = torch.logaddexp(out_tot_up, out_tot_down)
    in_pgeom = torch.clamp(
        torch.exp(torch.logaddexp(in_tot_up, in_tot_down) - in_tot_diffs),
        max=0.999)
    out_pgeom = torch.clamp(torch.exp(out_tot - out_tot_diffs), max=0.999)
    log_total = torch.logaddexp(
        torch.logsumexp(torch.stack([in_tot_up, in_tot_down, in_tot_eq]),
                        dim=0), out_tot)
    return torch.stack([
        in_pgeom, torch.exp(in_tot_up - log_total),
        torch.exp(in_tot_down - log_total), out_pgeom,
        torch.exp(out_tot_up - log_total), torch.exp(out_tot_down - log_total)])


def _em_estep_sample_sums(LL, log_p1, log_p2, sample_label, valid,
                          num_samples: int):
    """First half of the E-step on one read shard: the (S, A, A) sums by
    sample of each read's diplotype terms, the operand of the first psum.

    LL (R, A): stutter-PMF read-vs-allele log-likelihoods.  The sum by
    sample is a product with the (S, R) one-hot sample matrix: a fixed
    order on every device (a scatter-add on a card would use atomics).
    It needs every term finite, which the clamp of LL and the finite
    phase weights (log_p1, log_p2) of every read give: a zero of the
    one-hot matrix times -inf would be NaN."""
    LLc = torch.clamp(LL, min=LL_CLAMP)
    a = LLc + log_p1[:, None] + LOG_ONE_HALF
    b = LLc + log_p2[:, None] + LOG_ONE_HALF
    T = torch.logaddexp(a[:, :, None], b[:, None, :])
    T = torch.where(valid[:, None, None], T, 0.0)
    samples = torch.arange(num_samples, device=LL.device)
    onehot = (sample_label[None, :] == samples[:, None]).to(T.dtype)
    return (onehot @ T.flatten(1)).view(num_samples, *T.shape[1:])


def _em_estep_stats(LL, log_p1, log_p2, sample_label, valid, cat, w_in,
                    w_out, Pn):
    """Second half of the E-step on one read shard: read-phase posteriors
    under the normalized diplotype posteriors ``Pn`` (S, A, A) and the
    seven category-binned sufficient statistics the closed-form M step
    consumes (em_stutter_genotyper.cpp:63-168), the operand of the second
    psum.

    cat (R, A) in {0:in_eq, 1:in_up, 2:in_down, 3:out_up, 4:out_down};
    w_in/w_out (R, A): |rep| / |eff| magnitudes for the diff-weighted sums.
    """
    LLc = torch.clamp(LL, min=LL_CLAMP)
    one = LOG_ONE_HALF + log_p1[:, None, None] + LLc[:, :, None]
    two = LOG_ONE_HALF + log_p2[:, None, None] + LLc[:, None, :]
    tot2 = torch.logaddexp(one, two)
    Pr = Pn[sample_label]                                      # (R, A, A)
    f0 = torch.logsumexp(Pr + (one - tot2), dim=2)             # (R, A)
    f1 = torch.logsumexp(Pr + (two - tot2), dim=1)             # (R, A)
    lin = torch.exp(f0) + torch.exp(f1)
    lin = torch.where(valid[:, None], lin, 0.0)
    sums = [torch.where(cat == c, lin, 0.0).sum() for c in range(5)]
    return torch.stack([*sums, (lin * w_in).sum(), (lin * w_out).sum()])


def _em_train(mesh: Mesh, shards, init_priors, *, num_samples: int,
              haploid: bool, max_iter: int, min_abs: float, min_frac: float):
    """The EM train loop over read shards (dicts of per-shard tensors);
    the plain version of ``em_cuda.em_train``.

    Returns (converged, params (6,), n_iter, posteriors (S, A, A) of the
    final E-step, totals (S,)) as tensors on ``mesh.devices[0]``."""
    d0 = mesh.devices[0]
    f32 = torch.float32
    A = init_priors.shape[0]
    params = torch.tensor(_EM_INIT_PARAMS, dtype=f32, device=d0)
    priors = init_priors
    LL = torch.tensor(-np.inf, dtype=f32, device=d0)
    Pn = torch.zeros((num_samples, A, A), dtype=f32, device=d0)
    totals = torch.zeros(num_samples, dtype=f32, device=d0)

    def prior_matrix(priors):
        if haploid:
            return torch.full((A, A), -1e30, dtype=f32,
                              device=d0).diagonal_scatter(priors)
        return priors[:, None] + priors[None, :]

    it, converged = 0, False
    while it < max_iter and not converged:
        pmf = [_em_pmf_from_params(p, s["rep"], s["eff"], s["in_frame"])
               for p, s in zip(_replicate(mesh, params), shards)]
        P = _psum(mesh, [
            _em_estep_sample_sums(ll, s["log_p1"], s["log_p2"], s["label"],
                                  s["valid"], num_samples)
            for ll, s in zip(pmf, shards)]) + prior_matrix(priors)[None]
        totals = torch.logsumexp(P.flatten(1), dim=1)
        Pn = P - totals[:, None, None]
        stats = _psum(mesh, [
            _em_estep_stats(ll, s["log_p1"], s["log_p2"], s["label"],
                            s["valid"], s["cat"], s["w_in"], s["w_out"], pn)
            for ll, pn, s in zip(pmf, _replicate(mesh, Pn), shards)])
        new_LL = totals.sum()
        # M step (em_stutter_genotyper.cpp:201-216)
        c1 = torch.logsumexp(torch.logsumexp(Pn, dim=2), dim=0)
        c2 = torch.logsumexp(torch.logsumexp(Pn, dim=1), dim=0)
        combined = torch.logaddexp(c1, c2)
        new_priors = combined - torch.logsumexp(combined, dim=0)
        new_params = _em_mstep_params(stats)

        # On the first iteration LL is -inf: abs_change is +inf and
        # frac_change NaN, so only the parameter test can stop it there.
        nonmono = new_LL < LL + _EM_TOL
        abs_change = new_LL - LL
        frac_change = -(new_LL - LL) / LL
        conv_after = ((abs_change < min_abs) & (frac_change < min_frac)) | \
            torch.all((new_params - params).abs() < _EM_MAX_PARAM_DIFF)
        params = torch.where(nonmono, params, new_params)
        priors = torch.where(nonmono, priors, new_priors)
        LL = new_LL
        it += 1
        converged = bool(nonmono | conv_after)   # the iteration's host read
    return converged, params, it, Pn, totals


def em_tables(rep, eff, in_frame, log_p1, log_p2, sample_label, cat, w_in,
              w_out, n_shards: int):
    """The train's tables as the EM kernel and its plain version take
    them: (rep, eff, in_frame, log_p1, log_p2, label, cat, w_in, w_out,
    valid), reads padded to a multiple of ``n_shards``; padded reads are
    not valid."""
    R = np.shape(rep)[0]
    arrays, _ = pad_to_multiple(
        (np.asarray(rep, np.int32), np.asarray(eff, np.int32),
         np.asarray(in_frame, bool), np.asarray(log_p1, np.float32),
         np.asarray(log_p2, np.float32), np.asarray(sample_label, np.int64),
         np.asarray(cat, np.int32), np.asarray(w_in, np.float32),
         np.asarray(w_out, np.float32), np.ones(R, bool)), n_shards)
    return arrays


def em_train_plain(mesh: Mesh, tables, init_priors, *, num_samples: int,
                   haploid: bool, max_iter: int, min_abs: float,
                   min_frac: float):
    """The plain train loop (:func:`_em_train`) over :func:`em_tables`'
    tables, read shard k on ``mesh.devices[k]``; its result packed as
    ``em_cuda.em_train`` packs the kernel's, on the host."""
    shards = [dict(zip(em_cuda.EM_NAMES[:-1], parts))
              for parts in zip(*shard_batch(mesh, *tables))]
    converged, params, it, Pn, totals = _em_train(
        mesh, shards, torch.as_tensor(init_priors).to(mesh.devices[0]),
        num_samples=num_samples, haploid=haploid, max_iter=int(max_iter),
        min_abs=float(min_abs), min_frac=float(min_frac))
    return torch.cat([torch.tensor([float(converged), float(it)]),
                      params.cpu(), totals.cpu(), Pn.cpu().flatten()])


def em_result(out, num_samples: int, num_alleles: int):
    """(converged, params (6,), n_iter, posteriors (S, A, A), totals (S,))
    of a packed train result, as float64 host values."""
    converged, params, it, Pn, totals = em_cuda.unpack(
        torch.as_tensor(out).cpu().numpy(), num_samples, num_alleles)
    if it < 0:
        raise RuntimeError("em_train: a block of the kernel owns more chunks "
                           "or reads than em_cuda.em_layout counted")
    return (converged, params.astype(np.float64), it, Pn.astype(np.float64),
            totals.astype(np.float64))


def em_train_sharded(mesh: Mesh, rep, eff, in_frame, log_p1, log_p2,
                     sample_label, cat, w_in, w_out, init_priors,
                     num_samples: int, haploid: bool, max_iter: int,
                     min_abs: float, min_frac: float):
    """Run the whole EM train loop on the mesh, reads sharded.

    rep/eff/in_frame/cat/w_in/w_out: (R, A) diff-category tables from
    EMStutterGenotyper (constant across iterations); init_priors: (A,)
    initial population log-frequencies (computed host-side, tiny).
    Returns (converged, params (6,), n_iter, posteriors (S,A,A) from the
    final E-step, totals (S,)) as host values.

    Reads are padded to split evenly over the mesh; padded reads are
    masked and contribute to no posterior, statistic or LL.

    On a mesh whose first device is a card the whole train runs there in
    one kernel launch, after one copy of the padded tables, and the host
    reads its result once.  Its numbers follow the mesh's shard count, as
    the plain version's do: the kernel forms each shard's partial sums
    apart and adds them in shard order.  The JAX package spreads the
    E-step over the mesh's devices instead; a single-launch loop cannot
    add across cards, and at R * A^2 ~ 3e5 terms a locus there is nothing
    to gain from spreading it.
    """
    A = np.shape(rep)[1]
    tables = em_tables(rep, eff, in_frame, log_p1, log_p2, sample_label, cat,
                       w_in, w_out, mesh.size)
    init = np.asarray(init_priors, np.float32)
    kw = dict(num_samples=num_samples, haploid=haploid, max_iter=max_iter,
              min_abs=min_abs, min_frac=min_frac)
    d0 = mesh.devices[0]
    em_trains[d0.type] += 1
    if d0.type == "cuda":
        out = em_cuda.em_train(
            *(torch.from_numpy(a).to(d0) for a in (*tables, init)),
            n_shards=mesh.size, layout=em_cuda.em_layout(
                tables[5], tables[9], mesh.size, num_samples), **kw)
    else:
        out = em_train_plain(mesh, tables, torch.from_numpy(init), **kw)
    return em_result(out, num_samples, A)          # the one host read
