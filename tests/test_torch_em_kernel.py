"""A numpy model of the EM train kernel (csrc/em.cu::em_train_kernel, J4)
against the plain train loop and the JAX package, on the CPU.

The kernel cannot run here, so its arithmetic is held through a model
that does its work in its order, in float32: the valid reads sorted by
(shard, sample) stably and cut into chunks of ``em_cuda.CHUNK_READS``
reads, block r of the cluster owning chunks r nch // 16 .. (r + 1) nch //
16 - 1; each read's A * A terms of the first E-step half formed once and
used again by the second; a chunk's terms summed in read order in float64,
a block's chunks of one (shard, sample) in order (a segment), the
segments in block order, rounded once, then the shards in shard order
(``mesh._psum``'s order), then the prior; a sample's total a warp's
logsumexp (lane-strided sums, then a butterfly); each chunk's seven
statistics summed by a warp over its (read, allele) entries (lane-strided
in float64, then a butterfly), a shard's chunks lane-strided then by a
butterfly, the shards in shard order; the prior update's logsumexps over
the samples a warp's; the M step and the convergence test as each block's
thread 0 takes them, with torch's logaddexp and logsumexp.  Both of the
kernel's branches (the terms kept in shared memory, or recomputed) do
this arithmetic.

The model meets tests/test_torch_mesh.py's tolerances against the plain
``_em_train`` on CPU shards and against ``longtr_tpu``'s
``em_train_sharded``: (converged, n_iter) equal, parameters within 1e-5,
log-posteriors within rtol 1e-6 / atol 1e-4, posterior probabilities
within 1e-5 (float32 programs that sum in other orders), on 1, 3 and 8
shards.  Its elementwise functions are torch's on the CPU, as the plain
loop's are (the card's libm differs from the CPU's in last bits); each
shard's sums accumulate in float64 and round once, as the kernel's do.
Its shard combine equals ``mesh._psum`` bit for bit, and an allele whose
prior is -inf stays -inf through the logaddexp of two -inf.  At the
realistic locus (R=2000) no two float32 orders meet the log-posterior
bound, and the test there holds every train to the stop and parameters
of ``longtr_tpu`` on 8 devices and of the host float64 EM.
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
from _torch_cases import (assert_em_close, em_case,  # noqa: E402
                          realistic_em_locus)

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


def chunk_layout(key, n_keys, chunk):
    """The kernel's read chunks: the valid reads sorted by key (stably),
    each key's reads cut into chunks of ``chunk`` in read order.  Returns
    (the reads of each chunk, each chunk's key, chunk_base): the chunks of
    key k are chunk_base[k] .. chunk_base[k + 1] - 1."""
    reads, keys, base = [], [], [0]
    for k in range(n_keys):
        idx = np.flatnonzero(key == k)
        for j in range(0, len(idx), chunk):
            reads.append(idx[j:j + chunk])
            keys.append(k)
        base.append(len(reads))
    return reads, np.asarray(keys, int), base


def owned(nch, blocks=em_cuda.CLUSTER_BLOCKS):
    """Block r of the cluster owns chunks first[r] .. first[r + 1] - 1."""
    return [r * nch // blocks for r in range(blocks + 1)]


def key_sums(cpart, ch_key, n_keys, first):
    """Each key's float64 sum of its chunks' partials: a block adds its own
    chunks of the key in order (a segment), the segments are added in block
    order; rounded once to float32."""
    out = np.zeros((n_keys,) + cpart.shape[1:], F64)
    for r in range(len(first) - 1):
        lo, hi = first[r], first[r + 1]
        for k in np.unique(ch_key[lo:hi]):
            mine = np.arange(lo, hi)[ch_key[lo:hi] == k]
            out[k] = out[k] + seqsum(cpart[mine], dtype=F64)
    return out.astype(F32)


def chunk_stats(lin, cat, w_in, w_out, reads):
    """A warp's seven sums over one chunk's (read, allele) entries, read
    major: lane l adds entries l, l + 32, ... in float64, then a
    butterfly."""
    v, c = lin[reads].ravel(), cat[reads].ravel()
    terms = [np.where(c == q, v, F32(0)) for q in range(5)]
    terms += [v * w_in[reads].ravel(), v * w_out[reads].ravel()]
    terms = np.stack(terms).astype(F64)                    # (7, cnt * A)
    terms = np.pad(terms, ((0, 0), (0, -terms.shape[1] % 32)))
    return warp_sum(seqsum(terms.reshape(7, -1, 32), axis=1, dtype=F64))


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
    reads, ch_key, base = chunk_layout(key, n * S, chunk)
    first = owned(len(reads))
    params = INIT_PARAMS.copy()
    priors = np.asarray(init_priors, F32)
    LL = F32(-np.inf)
    it, converged = 0, False
    P = totals = None
    while it < max_iter and not converged:
        LLc = pmf_table(pmf_consts(params), rep, eff, in_frame)
        a_tab = (LLc + p1[:, None]) + LOG_HALF
        b_tab = (LLc + p2[:, None]) + LOG_HALF
        # B: each read's A * A terms (F reads them again); each chunk's
        # sums in read order
        T = lae(a_tab[:, :, None], b_tab[:, None, :])
        cpart = np.stack([seqsum(T[c], dtype=F64) for c in reads]) \
            if reads else np.zeros((0, A, A), F64)
        # C: each key's segments in block order, then the shards in shard
        # order, then the prior
        parts = list(key_sums(cpart, ch_key, n * S, first).reshape(
            n, S, A, A))
        if haploid:
            prior = np.full((A, A), F32(-1e30), F32)
            np.fill_diagonal(prior, priors)
        else:
            prior = priors[:, None] + priors[None, :]
        P = combine_shards(parts) + prior
        totals = warp_lse(P.reshape(S, -1))
        Pn = P - totals[:, None, None]
        # F: each read's phase posteriors from B's terms
        Pr = Pn[np.where(valid, label, 0)]
        f0 = lse(Pr + (a_tab[:, :, None] - T), axis=2)
        f1 = lse(Pr + (b_tab[:, None, :] - T), axis=1)
        lin = np.where(valid[:, None], exp(f0) + exp(f1),
                       F32(0)).astype(F32)
        # G: each chunk's seven sums; H: a shard's chunks lane-strided,
        # then a butterfly; the shards in shard order
        cstat = [chunk_stats(lin, cat, w_in, w_out, c) for c in reads]
        stat_parts = []
        for k in range(n):
            st = np.stack(cstat[base[k * S]:base[(k + 1) * S]]
                          or [np.zeros(7, F64)], axis=1)      # (7, chunks)
            st = np.pad(st, ((0, 0), (0, -st.shape[1] % 32)))
            lanes = seqsum(st.reshape(7, -1, 32), axis=1, dtype=F64)
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


@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("name", ["diploid", "haploid", "realistic"])
def test_em_layout_counts_the_models_blocks(cases, name, shards):
    """em_cuda.em_layout, which sizes the kernel's shared memory, counts
    the most chunks and reads a block owns as the model lays them out."""
    tables = (realistic_em_locus()().mesh_inputs() if name == "realistic"
              else cases[name][0])
    arrays, _init = padded_tables(tables, shards)
    label, valid, S = arrays[5], arrays[9], tables[10]
    R = len(label)
    key = np.where(valid & (label >= 0) & (label < S),
                   (np.arange(R) // (R // shards)) * S + label, -1)
    reads, _keys, _base = chunk_layout(key, shards * S,
                                       em_cuda.CHUNK_READS)
    first = owned(len(reads))
    blocks = [reads[first[r]:first[r + 1]]
              for r in range(em_cuda.CLUSTER_BLOCKS)]
    assert em_cuda.em_layout(label, valid, shards, S) == (
        max(map(len, blocks)), max(sum(map(len, b)) for b in blocks))


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
    layout = em_cuda.em_layout(arrays[5], arrays[9], shards, S)
    with pytest.raises(ValueError, match="CUDA tensors"):
        em_cuda.em_train(*cpu, n_shards=shards, layout=layout, **kw)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        em_cuda.em_train(*cpu, n_shards=len(arrays[0]) - 1, layout=layout,
                         **kw)
    assert not any(em_cuda.launches.values())


# How far the host's float64 EM may lie from a float32 train of the
# realistic locus, in each parameter.  Measured on the CPU: every train
# that stops after 7 iterations (the port's plain loop and the kernel's
# model on 1 and 4 shards, longtr_tpu on 8 devices) lies within 6.5e-5 of
# the host's parameters, and longtr_tpu on 1, 2 and 4 devices, whose
# float32 orders stop after 8, lies 5.1e-4 from them.  1e-4 takes the
# first spread and refuses one iteration more.
HOST_F64_PARAM_TOL = 1e-4

REALISTIC_TRAINS = ("plain loop, 1 CPU shard", "plain loop, 4 CPU shards",
                    "model, 1 shard", "model, 4 shards",
                    "longtr_tpu, 8 CPU devices")


@pytest.fixture(scope="module")
def realistic_trains():
    """The realistic locus (R=2000, A=12, S=3) trained at the default
    convergence settings by every train of REALISTIC_TRAINS, and the host
    float64 EM's parameters."""
    locus = realistic_em_locus()
    tables = locus().mesh_inputs()
    conv = (100, 0.01, 0.001)
    trains = dict(zip(REALISTIC_TRAINS, (
        port_mesh.em_train_sharded(Mesh(["cpu"]), *tables, *conv),
        port_mesh.em_train_sharded(Mesh(["cpu"] * 4), *tables, *conv),
        run_model(tables, 1, *conv), run_model(tables, 4, *conv),
        jax_mesh.em_train_sharded(jax_mesh.make_mesh(8), *tables, *conv))))
    host = locus()
    assert host.train(*conv)
    m = host.stutter_model
    return trains, np.array([m.in_geom, m.in_up, m.in_down, m.out_geom,
                             m.out_up, m.out_down])


@pytest.mark.parametrize("name", REALISTIC_TRAINS)
def test_realistic_locus_stops_where_the_reference_does(realistic_trains,
                                                        name):
    """At R=2000 the log-posteriors (|value| up to ~2e4) cannot meet rtol
    1e-6 / atol 1e-4 between two float32 orders of the same sums, and the
    stop itself is decided within that noise (the LL change at iteration 7
    reads 0.0056-0.0144 across orders against min_abs 0.01): longtr_tpu
    stops after 8 iterations on 1, 2 or 4 devices and after 7 on 8.  What
    every train of the port must hold to: (converged, n_iter) = (True, 7)
    as longtr_tpu on 8 devices, parameters within 1e-5 of every other
    such train, and within HOST_F64_PARAM_TOL of the host's float64 EM."""
    trains, host = realistic_trains
    got = trains[name]
    assert (got[0], got[2]) == (True, 7)
    for other in trains.values():
        assert (other[0], other[2]) == (True, 7)
        np.testing.assert_allclose(got[1], other[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], host, rtol=0, atol=HOST_F64_PARAM_TOL)
