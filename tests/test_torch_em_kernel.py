"""A numpy model of the EM train kernel (csrc/em.cu::em_train_kernel, J4)
against the plain train loop and the JAX package, on the CPU.

The kernel cannot run here, so its arithmetic is held through a model
that does its work in its order, in float32: the valid reads sorted by
(shard, sample) stably; the first E-step half summed in chunks of
``em_cuda.CHUNK_READS`` reads in read order, the chunks of a shard in
order, then the shards in shard order (``mesh._psum``'s order), then the
prior; a sample's total a warp's logsumexp (lane-strided sums, then a
butterfly); the statistics summed by a warp over each 32 consecutive
(read, allele) entries of a shard (a butterfly, in float64), a shard's
chunks lane-strided then by a butterfly, the shards in shard order; the
prior update's logsumexps over the samples a warp's; the M step and the
convergence test as the kernel's thread 0 takes them, with torch's
logaddexp and logsumexp.

The model meets tests/test_torch_mesh.py's tolerances against the plain
``_em_train`` on CPU shards and against ``longtr_tpu``'s
``em_train_sharded``: (converged, n_iter) equal, parameters within 1e-5,
log-posteriors within rtol 1e-6 / atol 1e-4, posterior probabilities
within 1e-5 (float32 programs that sum in other orders), on 1, 3 and 8
shards.  Its elementwise functions are torch's on the CPU, as the plain
loop's are (the card's libm differs from the CPU's in last bits); each
shard's sums accumulate in float64 and round once, as the kernel's do.
Its shard combine equals ``mesh._psum`` bit for bit, and an allele whose
prior is -inf stays -inf through the logaddexp of two -inf.
"""

import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu.parallel import mesh as jax_mesh
from longtr_tpu_torch.ops import em_cuda
from longtr_tpu_torch.parallel import mesh as port_mesh
from longtr_tpu_torch.parallel.mesh import Mesh
from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import assert_em_close, em_case  # noqa: E402

F32 = np.float32
F64 = np.float64
LOG_HALF = F32(LOG_ONE_HALF)
INIT_PARAMS = F32([0.9, 0.1, 0.1, 0.8, 0.01, 0.01])


def _fn(op):
    """A float32 function of torch on the CPU, on numpy arrays: the card's
    libm is not the CPU's, and torch's is what the plain loop calls."""
    return lambda x: op(torch.from_numpy(np.array(x, F32))).numpy()


exp, log, log1p = _fn(torch.exp), _fn(torch.log), _fn(torch.log1p)


def lae(a, b):
    """torch.logaddexp in float32: equal infinities return themselves."""
    a, b = np.broadcast_arrays(np.asarray(a, F32), np.asarray(b, F32))
    with np.errstate(invalid="ignore"):
        out = np.fmax(a, b) + log1p(exp(-np.abs(a - b)))
    return np.where(np.isinf(a) & (a == b), a, out).astype(F32)


def lse(x, axis=-1):
    """torch.logsumexp over ``axis`` as the kernel takes it: the max (an
    infinite max counts as 0), exp(x - max) summed in order, log, plus the
    max."""
    x = np.moveaxis(np.asarray(x, F32), axis, -1)
    m = np.fmax.reduce(x, axis=-1)
    m = np.where(np.isinf(m), F32(0), m).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.cumsum(exp(x - m[..., None]), axis=-1, dtype=F32)[..., -1]
        return (log(s) + m).astype(F32)


def warp_sum(v):
    """The kernel's warp_sum over the last axis (32 lanes): lane l adds
    lane l + off's value, off = 16, 8, 4, 2, 1; lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def warp_lse(x):
    """The kernel's warp_lse over the last axis: lane l takes values l,
    l + 32, ...; the max (an infinite max counts as 0); each lane's sum of
    exp(x - max) in order; warp_sum; log, plus the max."""
    x = np.asarray(x, F32)
    n = x.shape[-1]
    m = np.fmax.reduce(x, axis=-1)
    m = np.where(np.isinf(m), F32(0), m).astype(F32)
    pad = np.full(x.shape[:-1] + (-n % 32,), -np.inf, F32)
    lanes = np.concatenate([x, pad], axis=-1)
    lanes = lanes.reshape(x.shape[:-1] + (-1, 32))
    with np.errstate(invalid="ignore", divide="ignore"):
        e = exp(lanes - m[..., None, None])
        s = seqsum(e, axis=-2)
        return (log(warp_sum(s)) + m).astype(F32)


def seqsum(x, axis=0, dtype=F32):
    """The sum of ``x`` along ``axis`` in order, from 0, accumulated in
    ``dtype``."""
    x = np.asarray(x)
    if x.shape[axis] == 0:
        return np.zeros(np.delete(x.shape, axis), dtype)
    return np.cumsum(x, axis=axis, dtype=dtype).take(-1, axis=axis)


def combine_shards(parts):
    """The shards' partial sums added in shard order (``mesh._psum``)."""
    total = parts[0]
    for p in parts[1:]:
        total = (total + p).astype(F32)
    return total


def pmf_consts(p):
    in_log_step, in_log_nostep = log(F32(1) - p[0]), log(p[0])
    out_log_step, out_log_nostep = log(F32(1) - p[3]), log(p[3])
    return (log(p[5]) + out_log_nostep, log(p[4]) + out_log_nostep,
            out_log_step, log(p[2]) + in_log_nostep,
            log(p[1]) + in_log_nostep, in_log_step,
            log((((F32(1) - p[1]) - p[2]) - p[4]) - p[5]))


def pmf_table(c, rep, eff, in_frame):
    """The stutter PMF of every (read, allele), clamped at -600."""
    cd, cu, ols, cid, ciu, ils, leq = c
    out_val = np.where(eff < 0, cd + ols * (-eff - 1).astype(F32),
                       cu + ols * (eff - 1).astype(F32))
    in_val = np.where(rep == 0, leq,
                      np.where(rep < 0, cid + ils * (-rep - 1).astype(F32),
                               ciu + ils * (rep - 1).astype(F32)))
    v = np.where(in_frame, in_val, out_val).astype(F32)
    return np.where(v < F32(-600), F32(-600), v).astype(F32)


def mstep(st):
    in_up, in_down, in_eq = (log(F32(1) + st[i]) for i in (1, 2, 0))
    in_diffs = log(F32(2.1) + st[5])                # (1.0 + 1.1) + din
    out_up, out_down = log(F32(1) + st[3]), log(F32(1) + st[4])
    out_diffs = log(F32(2.1) + st[6])
    out_tot = lae(out_up, out_down)
    in_pgeom = exp(lae(in_up, in_down) - in_diffs)
    out_pgeom = exp(out_tot - out_diffs)
    log_total = lae(lse(F32([in_up, in_down, in_eq])), out_tot)
    clamp = lambda x: F32(0.999) if x > F32(0.999) else x
    return F32([clamp(in_pgeom), exp(in_up - log_total),
                exp(in_down - log_total), clamp(out_pgeom),
                exp(out_up - log_total), exp(out_down - log_total)])


def em_train_model(rep, eff, in_frame, log_p1, log_p2, label, cat, w_in,
                   w_out, valid, init_priors, *, n_shards, num_samples,
                   haploid, max_iter, min_abs, min_frac,
                   chunk=em_cuda.CHUNK_READS, trace=None):
    """The kernel's train, on the padded tables of ``em_train_sharded``.
    Returns its packed result (``em_cuda.unpack``'s layout); ``trace``, a
    dict, receives each iteration's per-shard partial sums."""
    R, A = rep.shape
    n, S = n_shards, num_samples
    Rs = R // n
    p1, p2 = np.asarray(log_p1, F32), np.asarray(log_p2, F32)
    ok = valid & (label >= 0) & (label < S)
    key = np.where(ok, (np.arange(R) // Rs) * S + label, -1)
    reads = [[np.flatnonzero(key == k * S + s) for s in range(S)]
             for k in range(n)]
    params = INIT_PARAMS.copy()
    priors = np.asarray(init_priors, F32)
    LL = F32(-np.inf)
    it, converged = 0, False
    P = totals = None
    while it < max_iter and not converged:
        LLc = pmf_table(pmf_consts(params), rep, eff, in_frame)
        a_tab = (LLc + p1[:, None]) + LOG_HALF
        b_tab = (LLc + p2[:, None]) + LOG_HALF
        # B, C: chunks of reads in read order, shards in shard order
        parts = []
        for k in range(n):
            part = np.zeros((S, A, A), F32)
            for s in range(S):
                idx = reads[k][s]
                chunks = [seqsum(lae(a_tab[c][:, :, None],
                                     b_tab[c][:, None, :]), dtype=F64)
                          for c in (idx[j:j + chunk]
                                    for j in range(0, len(idx), chunk))]
                part[s] = seqsum(np.stack(chunks), dtype=F64) if chunks \
                    else 0.0
            parts.append(part)
        if haploid:
            prior = np.full((A, A), F32(-1e30), F32)
            np.fill_diagonal(prior, priors)
        else:
            prior = priors[:, None] + priors[None, :]
        P = combine_shards(parts) + prior
        totals = warp_lse(P.reshape(S, -1))
        Pn = P - totals[:, None, None]
        # F: each read's phase posteriors
        one = (LOG_HALF + p1[:, None]) + LLc
        two = (LOG_HALF + p2[:, None]) + LLc
        tot2 = lae(one[:, :, None], two[:, None, :])
        Pr = Pn[np.where(valid, label, 0)]
        f0 = lse(Pr + (one[:, :, None] - tot2), axis=2)
        f1 = lse(Pr + (two[:, None, :] - tot2), axis=1)
        lin = np.where(valid[:, None], exp(f0) + exp(f1),
                       F32(0)).astype(F32)
        # G, H: a warp's seven sums over each 32 entries of a shard; a
        # shard's chunks lane-strided, then a butterfly; shards in order
        stat_parts = []
        for k in range(n):
            v = lin[k * Rs:(k + 1) * Rs].ravel()
            c = cat[k * Rs:(k + 1) * Rs].ravel()
            terms = [np.where(c == q, v, F32(0)) for q in range(5)]
            terms += [v * w_in[k * Rs:(k + 1) * Rs].ravel(),
                      v * w_out[k * Rs:(k + 1) * Rs].ravel()]
            terms = np.stack(terms).astype(F64)            # (7, Rs * A)
            ncs = -(-terms.shape[1] // 32)
            terms = np.pad(terms, ((0, 0), (0, ncs * 32 - terms.shape[1])))
            chunks = warp_sum(terms.reshape(7, ncs, 32))   # (7, ncs)
            lanes = np.pad(chunks, ((0, 0), (0, -ncs % 32)))
            lanes = seqsum(lanes.reshape(7, -1, 32), axis=1, dtype=F64)
            stat_parts.append(warp_sum(lanes).astype(F32))
        if trace is not None:
            trace.setdefault("parts", []).append(parts)
            trace.setdefault("stats", []).append(stat_parts)
        stats = combine_shards(stat_parts)
        comb = lae(warp_lse(lse(Pn, axis=2).T), warp_lse(lse(Pn, axis=1).T))
        new_LL = seqsum(totals)
        new_params = mstep(stats)
        with np.errstate(invalid="ignore"):
            nonmono = new_LL < LL + F32(1e-10)
            abs_change = new_LL - LL
            frac_change = -(new_LL - LL) / LL
            conv_after = ((abs_change < F32(min_abs))
                          and (frac_change < F32(min_frac))) \
                or bool(np.all(np.abs(new_params - params) < F32(1e-4)))
        if not nonmono:
            params = new_params
            priors = (comb - lse(comb)).astype(F32)
        LL = new_LL
        it += 1
        converged = bool(nonmono or conv_after)
    if it == 0:
        P = np.zeros((S, A, A), F32)
        totals = np.zeros(S, F32)
        Pn = P
    return np.concatenate([F32([converged, it]), params, totals,
                           Pn.ravel()]).astype(F32)


def padded_tables(tables, n_shards):
    """``em_train_sharded``'s padded tables and the initial priors."""
    return (port_mesh.em_tables(*tables[:9], n_shards),
            np.asarray(tables[9], np.float32))


def run_model(tables, n_shards, max_iter, min_abs, min_frac, trace=None):
    arrays, init = padded_tables(tables, n_shards)
    S, A, haploid = tables[10], np.shape(tables[0])[1], tables[11]
    out = em_train_model(*arrays, init, n_shards=n_shards, num_samples=S,
                         haploid=haploid, max_iter=max_iter, min_abs=min_abs,
                         min_frac=min_frac, trace=trace)
    converged, params, it, Pn, totals = em_cuda.unpack(out, S, A)
    return (converged, params.astype(np.float64), it, Pn.astype(np.float64),
            totals.astype(np.float64))


@pytest.fixture(scope="module")
def cases():
    return {name: em_case(name) for name in ("diploid", "haploid",
                                             "max_iter")}


@pytest.fixture(scope="module")
def jax_results(cases):
    return {name: jax_mesh.em_train_sharded(jax_mesh.make_mesh(8), *tables,
                                            max_iter, 0.01, 0.001)
            for name, (tables, max_iter) in cases.items()}


@pytest.fixture(scope="module")
def plain_results(cases):
    return {(name, n): port_mesh.em_train_sharded(Mesh(["cpu"] * n), *tables,
                                                  max_iter, 0.01, 0.001)
            for name, (tables, max_iter) in cases.items() for n in (1, 3, 8)}


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("name", ["diploid", "haploid", "max_iter"])
def test_model_matches_plain_and_jax(cases, jax_results, plain_results, name,
                                     shards):
    """tests/test_torch_mesh.py's two criteria: the full tolerances
    against the plain loop on 8 CPU shards and longtr_tpu on its 8
    devices, which that file holds to each other; against the plain loop
    on as many shards, the criterion it holds two shard counts to
    ((converged, n_iter) equal, parameters within 1e-5).  The plain loop
    on 1 and 3 shards is itself outside the full tolerances against
    longtr_tpu in the max_iter case (log-posteriors 1.09 times the bound):
    the log-posteriors of an unconverged train follow the parameters'
    last float32 steps."""
    tables, max_iter = cases[name]
    got = run_model(tables, shards, max_iter, 0.01, 0.001)
    assert got[0] == (name != "max_iter")
    if name == "max_iter":
        assert got[2] == 3
    assert_em_close(got, plain_results[name, 8])
    assert_em_close(got, jax_results[name])
    same = plain_results[name, shards]
    assert (got[0], got[2]) == (same[0], same[2])
    np.testing.assert_allclose(got[1], same[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shards", [1, 3])
def test_model_first_iteration_does_not_stop_on_nan(cases, shards):
    """LL starts at -inf, so frac_change is NaN on the first iteration and
    only the parameter test may stop it: a one-step budget ends
    unconverged, as the plain loop does; no budget runs nothing."""
    tables, _ = cases["diploid"]
    got = run_model(tables, shards, 1, 1e9, 1e9)
    assert (got[0], got[2]) == (False, 1)
    assert_em_close(got, port_mesh.em_train_sharded(Mesh(["cpu"] * 8),
                                                 *tables, 1, 1e9, 1e9))
    zero = run_model(tables, shards, 0, 0.01, 0.001)
    assert zero[:1] == (False,) and zero[2] == 0 and not zero[3].any()
    np.testing.assert_array_equal(zero[1], INIT_PARAMS.astype(np.float64))


@pytest.mark.parametrize("shards", [3, 8])
def test_model_adds_shards_in_psum_order(cases, shards):
    """Every iteration's shard combine equals ``mesh._psum`` on the same
    partials bit for bit, the posterior sums and the statistics; the
    partials are such that the reversed order would differ."""
    tables, max_iter = cases["diploid"]
    trace = {}
    run_model(tables, shards, max_iter, 0.01, 0.001, trace=trace)
    mesh = Mesh(["cpu"] * shards)
    reversed_differs = False
    for parts, stats in zip(trace["parts"], trace["stats"]):
        for p in (parts, stats):
            want = port_mesh._psum(mesh, [torch.from_numpy(x) for x in p])
            got = combine_shards(p)
            np.testing.assert_array_equal(got, want.numpy())
            reversed_differs |= not np.array_equal(got,
                                                   combine_shards(p[::-1]))
    assert reversed_differs


def test_model_keeps_an_impossible_allele_impossible(cases):
    """An allele with a -inf initial prior: its posteriors, and its
    prior's update through logaddexp(-inf, -inf), stay -inf in the plain
    loop, in longtr_tpu and in the model, which meets the same
    tolerances."""
    tables, _ = cases["diploid"]
    init = np.array(tables[9], np.float64)
    init[1] = -np.inf
    tables = (*tables[:9], init, *tables[10:])
    got = run_model(tables, 3, 100, 0.01, 0.001)
    plain = port_mesh.em_train_sharded(Mesh(["cpu"] * 8), *tables, 100, 0.01,
                                       0.001)
    want = jax_mesh.em_train_sharded(jax_mesh.make_mesh(8), *tables, 100,
                                     0.01, 0.001)
    assert np.isneginf(plain[3][:, 1, :]).all()
    assert np.isneginf(got[3][:, 1, :]).all()
    assert np.isfinite(got[1]).all() and np.isfinite(got[4]).all()
    assert_em_close(got, plain)
    assert_em_close(got, want)


@pytest.mark.parametrize("shards", [1, 3])
def test_cpu_tensors_take_the_plain_loop(cases, shards):
    """em_train_sharded on CPU shards runs the plain loop, counts no
    launch, and returns what em_train_plain packs; em_cuda.em_train
    refuses CPU tensors (it launches the kernel or raises)."""
    tables, max_iter = cases["haploid"]
    arrays, init = padded_tables(tables, shards)
    S, A = tables[10], np.shape(tables[0])[1]
    kw = dict(num_samples=S, haploid=tables[11], max_iter=max_iter,
              min_abs=0.01, min_frac=0.001)
    em_cuda.reset_launches()
    out = port_mesh.em_train_plain(Mesh(["cpu"] * shards), arrays,
                                   torch.from_numpy(init), **kw)
    want = port_mesh.em_train_sharded(Mesh(["cpu"] * shards), *tables,
                                      max_iter, 0.01, 0.001)
    assert not any(em_cuda.launches.values())
    assert out.dtype == torch.float32
    assert out.shape == (em_cuda.packed_size(S, A),)
    got = em_cuda.unpack(out.numpy(), S, A)
    assert (got[0], got[2]) == (want[0], want[2])
    for g, w in zip((got[1], got[3], got[4]), (want[1], want[3], want[4])):
        np.testing.assert_array_equal(g.astype(np.float64), w)
    cpu = [torch.from_numpy(a) for a in (*arrays, init)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        em_cuda.em_train(*cpu, n_shards=shards, **kw)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        em_cuda.em_train(*cpu, n_shards=len(arrays[0]) - 1, **kw)
    assert not any(em_cuda.launches.values())
