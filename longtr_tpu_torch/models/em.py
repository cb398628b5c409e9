"""Length-based EM stutter-model fitter.

Reference: src/em_stutter_genotyper.{h,cpp}.  Alleles are the distinct
read-vs-reference bp differences; the E step fills read×allele LLs from the
stutter PMF and computes diplotype + read-phase posteriors; the M step
re-estimates genotype priors and the six stutter parameters in closed form
with pseudocounts (em_stutter_genotyper.cpp:63-127).

Vectorized numpy implementation (the arrays are tiny — A is the number of
distinct lengths); log-sum-exps are exact where the reference uses the
term-dropping fast approximation (mathops.cpp:98-107) — a precision upgrade
with no behavioural effect beyond float noise.
"""

from __future__ import annotations

import math

import numpy as np

from longtr_tpu_torch.models.stutter import StutterModel, _c_div
from longtr_tpu_torch.utils import mathops
from longtr_tpu_torch.utils.mathops import LOG_ONE_HALF, fast_log_sum_exp, \
    fast_log_sum_exp2, fast_log_sum_exp2_arr, int_log, \
    streaming_lse_finish, streaming_lse_update

TOLERANCE = 1e-10

# Haploid heterozygote prior in the reference's EM initialization
# (em_stutter_genotyper.cpp:142: -DBL_MAX/2)
_NEG_HALF_DBL_MAX = -np.finfo(np.float64).max / 2


def _lse_seq(vals) -> float:
    """Exact LSE with the reference's strict-sequential accumulation order
    (mathops.cpp:44-49); numpy's pairwise np.sum can differ in the last ulp
    for longer vectors, which matters in fidelity mode."""
    m = float(np.max(vals))
    if not np.isfinite(m):
        return m
    total = 0.0
    for v in np.asarray(vals, dtype=np.float64).ravel():
        total += math.exp(v - m)
    return m + math.log(total)


def _lse(arr, axis=None):
    arr = np.asarray(arr, dtype=np.float64)
    m = arr.max(axis=axis, keepdims=True)
    out = m + np.log(np.exp(arr - m).sum(axis=axis, keepdims=True))
    if axis is None:
        return float(out.reshape(()))
    return np.squeeze(out, axis=axis)


class EMStutterGenotyper:
    def __init__(self, haploid: bool, motif: str, num_bps, log_p1s, log_p2s,
                 sample_names, ref_allele: int = 0):
        self.haploid = haploid
        self.motif = motif
        self.motif_len = len(motif)
        self.sample_names = list(sample_names)
        self.num_samples = len(sample_names)

        sizes = sorted({d for sample in num_bps for d in sample} - {ref_allele})
        self.bps_per_allele = np.array([ref_allele] + sizes, dtype=np.int64)
        self.num_alleles = len(self.bps_per_allele)
        size_index = {v: i for i, v in enumerate(self.bps_per_allele)}

        self.allele_index = np.array(
            [size_index[d] for sample in num_bps for d in sample], dtype=np.int64)
        self.sample_label = np.array(
            [i for i, sample in enumerate(num_bps) for _ in sample], dtype=np.int64)
        self.log_p1 = np.array([p for s in log_p1s for p in s])
        self.log_p2 = np.array([p for s in log_p2s for p in s])
        self.reads_per_sample = np.array([len(s) for s in num_bps], dtype=np.int64)
        self.num_reads = len(self.allele_index)
        self.stutter_model = None
        self.log_gt_priors = None
        self.posteriors = None

    # -- initialization -----------------------------------------------------
    def _init_log_gt_priors(self):
        """1-sample pseudocount + per-sample-normalized counts
        (em_stutter_genotyper.cpp:10-19)."""
        counts = np.ones(self.num_alleles)
        np.add.at(counts, self.allele_index,
                  1.0 / self.reads_per_sample[self.sample_label])
        if mathops.ref_fidelity():
            total = 0.0
            for c in counts:            # reference `sum` is sequential
                total += float(c)
            log_total = math.log(total)
            self.log_gt_priors = np.array(
                [math.log(float(c)) - log_total for c in counts])
        else:
            self.log_gt_priors = np.log(counts) - np.log(counts.sum())

    # -- E step -------------------------------------------------------------
    def _pmf_matrix(self):
        """(R, A): log P(read diff | allele diff)."""
        diffs = (self.bps_per_allele[self.allele_index][:, None]
                 - self.bps_per_allele[None, :])
        return self.stutter_model.log_pmf_table(diffs)

    def _calc_posteriors(self, LL):
        """Diplotype posteriors with population-frequency priors
        (em_stutter_genotyper.cpp:129-144 + genotyper.cpp:45-83)."""
        A, S = self.num_alleles, self.num_samples
        if self.haploid:
            prior = np.full((A, A), -1e30)
            np.fill_diagonal(prior, self.log_gt_priors)
        else:
            prior = self.log_gt_priors[:, None] + self.log_gt_priors[None, :]
        LLc = np.clip(LL, -600.0, None)
        a = LLc + self.log_p1[:, None] + LOG_ONE_HALF
        b = LLc + self.log_p2[:, None] + LOG_ONE_HALF
        T = np.logaddexp(a[:, :, None], b[:, None, :])
        P = np.tile(prior[None], (S, 1, 1))
        np.add.at(P, self.sample_label, T)
        totals = _lse(P.reshape(S, -1), axis=1)
        P -= totals[:, None, None]
        self.posteriors = P
        self.sample_total_lls = totals
        return float(totals.sum())

    def _calc_read_phase_posteriors(self, LL):
        """(R, A, A, 2) read-phase posteriors (em_stutter_genotyper.cpp:152-168)."""
        # log_phase_one depends on allele 1; phase two on allele 2
        one = LOG_ONE_HALF + self.log_p1[:, None, None] + LL[:, :, None]
        two = LOG_ONE_HALF + self.log_p2[:, None, None] + LL[:, None, :]
        # fast_log_sum_exp in the reference (em_stutter_genotyper.cpp:161)
        total = fast_log_sum_exp2_arr(one, two)
        return np.stack([one - total, two - total], axis=-1)

    # -- M step -------------------------------------------------------------
    def _recalc_log_gt_priors(self):
        """em_stutter_genotyper.cpp:21-56."""
        P = self.posteriors
        first = _lse(P, axis=2)        # (S, A): lse over second allele
        c1 = _lse(first, axis=0)       # (A,)
        c2 = _lse(_lse(P, axis=1), axis=0)
        combined = np.logaddexp(c1, c2)
        self.log_gt_priors = combined - _lse(combined)

    def _recalc_stutter_model(self, phase_post):
        """Closed-form re-estimates with pseudocounts (cpp:63-127)."""
        R, A = self.num_reads, self.num_alleles
        P = self.posteriors[self.sample_label]          # (R, A, A)
        # factor[r, a1, a2, phase] = gt posterior + phase posterior
        factor = P[..., None] + phase_post              # (R, A, A, 2)
        # bp_diff depends on the phase-selected allele only
        d1 = (self.bps_per_allele[self.allele_index][:, None]
              - self.bps_per_allele[None, :])           # (R, A)
        f_phase0 = _lse(factor[..., 0], axis=2)          # (R, A) sum over a2
        f_phase1 = _lse(factor[..., 1], axis=1)          # (R, A) sum over a1
        flat_f = np.concatenate([f_phase0.ravel(), f_phase1.ravel()])
        flat_d = np.concatenate([d1.ravel(), d1.ravel()])

        p = self.motif_len
        in_frame = (flat_d % p) == 0
        rep = _c_div(flat_d, p)
        eff = flat_d - rep

        in_up = [0.0]
        in_down = [0.0]
        in_eq = [0.0]
        in_diffs = [0.0, np.log(1.1)]
        out_up = [0.0]
        out_down = [0.0]
        out_diffs = [0.0, np.log(1.1)]

        m = in_frame & (rep == 0)
        if m.any():
            in_eq.append(_lse(flat_f[m]))
        m = in_frame & (rep > 0)
        if m.any():
            in_up.append(_lse(flat_f[m]))
            in_diffs.append(_lse(flat_f[m] + np.log(np.abs(rep[m]))))
        m = in_frame & (rep < 0)
        if m.any():
            in_down.append(_lse(flat_f[m]))
            in_diffs.append(_lse(flat_f[m] + np.log(np.abs(rep[m]))))
        m = ~in_frame & (flat_d > 0)
        if m.any():
            out_up.append(_lse(flat_f[m]))
            out_diffs.append(_lse(flat_f[m] + np.log(np.abs(eff[m]))))
        m = ~in_frame & (flat_d < 0)
        if m.any():
            out_down.append(_lse(flat_f[m]))
            out_diffs.append(_lse(flat_f[m] + np.log(np.abs(eff[m]))))

        # Reference M-step totals use fast_log_sum_exp over the flat factor
        # vectors (em_stutter_genotyper.cpp:109-116).  Our accumulation is
        # two-stage (exact inner category LSEs), so fidelity here is
        # approximate rather than bit-exact — acceptable: EM runs only when
        # no default stutter model is installed.
        in_tot_up = fast_log_sum_exp(in_up)
        in_tot_down = fast_log_sum_exp(in_down)
        in_tot_eq = fast_log_sum_exp(in_eq)
        in_tot_diffs = fast_log_sum_exp(in_diffs)
        out_tot_up = fast_log_sum_exp(out_up)
        out_tot_down = fast_log_sum_exp(out_down)
        out_tot_diffs = fast_log_sum_exp(out_diffs)
        out_tot = fast_log_sum_exp2(out_tot_up, out_tot_down)
        in_pgeom = min(0.999, np.exp(np.logaddexp(in_tot_up, in_tot_down) - in_tot_diffs))
        out_pgeom = min(0.999, np.exp(out_tot - out_tot_diffs))
        log_total = np.logaddexp(_lse([in_tot_up, in_tot_down, in_tot_eq]), out_tot)
        in_pup = np.exp(in_tot_up - log_total)
        in_pdown = np.exp(in_tot_down - log_total)
        out_pup = np.exp(out_tot_up - log_total)
        out_pdown = np.exp(out_tot_down - log_total)
        self.stutter_model = StutterModel(in_pgeom, in_pup, in_pdown,
                                          out_pgeom, out_pup, out_pdown, self.motif)

    # -- reference-fidelity step variants ----------------------------------
    # Bit-exact mirrors of the reference's floating-point operation ORDER,
    # active under mathops.set_ref_fidelity(True); asserted bit-identical to
    # the compiled em_stutter_genotyper.cpp by tests/test_record_parity.py's
    # sibling EM suite.  The default (vectorized-exact) paths above remain
    # the production math.

    def _calc_posteriors_fid(self, LL):
        """calc_log_sample_posteriors with reference accumulation order
        (genotyper.cpp:45-83): raw log(exp+exp) per read accumulated in read
        order, per-sample exact LSE, sequential total."""
        A, S = self.num_alleles, self.num_samples
        if self.haploid:
            prior = np.full((A, A), _NEG_HALF_DBL_MAX)
            np.fill_diagonal(prior, self.log_gt_priors)
        else:
            prior = self.log_gt_priors[:, None] + self.log_gt_priors[None, :]
        LLc = np.clip(LL, -600.0, None)
        a = LLc + self.log_p1[:, None] + LOG_ONE_HALF
        b = LLc + self.log_p2[:, None] + LOG_ONE_HALF
        # scalar libm exp/log: numpy's SIMD array ufuncs can differ from the
        # reference's libm calls in the last ulp.  log(0) must yield -inf
        # (C libm semantics) rather than raise, for double-underflow reads.
        ea = np.array([[math.exp(v) for v in row] for row in a])
        eb = np.array([[math.exp(v) for v in row] for row in b])
        Tsum = ea[:, :, None] + eb[:, None, :]
        T = np.array([[[math.log(v) if v > 0.0 else -math.inf for v in row]
                       for row in mat] for mat in Tsum])
        P = np.tile(prior[None], (S, 1, 1))
        np.add.at(P, self.sample_label, T)
        totals = np.array([_lse_seq(P[s]) for s in range(S)])
        P -= totals[:, None, None]
        self.posteriors = P
        self.sample_total_lls = totals
        total = 0.0
        for t in totals:          # reference `sum` is strictly sequential
            total += float(t)
        return total

    def _recalc_log_gt_priors_fid(self):
        """Streaming-LSE prior recount in reference order
        (em_stutter_genotyper.cpp:21-56)."""
        A, S = self.num_alleles, self.num_samples
        P = self.posteriors
        maxv = np.full(A, _NEG_HALF_DBL_MAX)
        tot = np.zeros(A)
        for s in range(S):
            for i1 in range(A):
                maxv[i1], tot[i1] = streaming_lse_update(
                    _lse_seq(P[s, i1, :]), maxv[i1], tot[i1])
        for s in range(S):
            flat = P[s].ravel()
            k = 0
            for _i1 in range(A):
                for i2 in range(A):
                    maxv[i2], tot[i2] = streaming_lse_update(
                        float(flat[k]), maxv[i2], tot[i2])
                    k += 1
        pri = np.array([streaming_lse_finish(maxv[i], tot[i])
                        for i in range(A)])
        self.log_gt_priors = pri - _lse_seq(pri)

    def _recalc_stutter_model_fid(self, phase_post):
        """M-step with the reference's category-list push order and exact/
        fast LSE split (em_stutter_genotyper.cpp:63-127)."""
        R, A = self.num_reads, self.num_alleles
        P = self.posteriors[self.sample_label]          # (R, A, A)
        factor = P[..., None] + phase_post              # (R, A, A, 2)
        d1 = (self.bps_per_allele[self.allele_index][:, None]
              - self.bps_per_allele[None, :])           # (R, A)
        D = np.empty((R, A, A, 2), dtype=np.int64)
        D[..., 0] = d1[:, :, None]
        D[..., 1] = d1[:, None, :]
        flat_f = factor.ravel()                         # reference push order
        flat_d = D.ravel()

        p = self.motif_len
        in_frame = (flat_d % p) == 0
        rep = _c_div(flat_d, p)
        eff = flat_d - rep

        log11 = math.log(1.1)
        in_up = [0.0]
        in_down = [0.0]
        in_eq = [0.0]
        in_diffs = [0.0, log11]
        out_up = [0.0]
        out_down = [0.0]
        out_diffs = [0.0, log11]
        # int_log lookups over the few distinct magnitudes
        mag_log = {}

        def ilog(v):
            v = int(v)
            if v not in mag_log:
                mag_log[v] = int_log(v)
            return mag_log[v]

        m = flat_d == 0
        in_eq.extend(flat_f[m].tolist())
        m_inf = in_frame & (flat_d != 0)
        for f, r, d in zip(flat_f[m_inf].tolist(), rep[m_inf].tolist(),
                           flat_d[m_inf].tolist()):
            in_diffs.append(f + ilog(abs(r)))
            if d > 0:
                in_up.append(f)
            else:
                in_down.append(f)
        m_out = ~in_frame
        for f, e, d in zip(flat_f[m_out].tolist(), eff[m_out].tolist(),
                           flat_d[m_out].tolist()):
            out_diffs.append(f + ilog(abs(e)))
            if d > 0:
                out_up.append(f)
            else:
                out_down.append(f)

        in_tot_up = fast_log_sum_exp(in_up)
        in_tot_down = fast_log_sum_exp(in_down)
        in_tot_eq = fast_log_sum_exp(in_eq)
        in_tot_diffs = fast_log_sum_exp(in_diffs)
        out_tot_up = fast_log_sum_exp(out_up)
        out_tot_down = fast_log_sum_exp(out_down)
        out_tot_diffs = fast_log_sum_exp(out_diffs)
        out_tot = fast_log_sum_exp2(out_tot_up, out_tot_down)
        in_pgeom = min(0.999, math.exp(
            mathops.log_sum_exp2(in_tot_up, in_tot_down) - in_tot_diffs))
        out_pgeom = min(0.999, math.exp(out_tot - out_tot_diffs))
        log_total = mathops.log_sum_exp2(
            mathops.log_sum_exp3(in_tot_up, in_tot_down, in_tot_eq), out_tot)
        self.stutter_model = StutterModel(
            in_pgeom, math.exp(in_tot_up - log_total),
            math.exp(in_tot_down - log_total), out_pgeom,
            math.exp(out_tot_up - log_total),
            math.exp(out_tot_down - log_total), self.motif)

    # -- device (mesh) E-step ----------------------------------------------
    def _estep_category_tables(self):
        """(cat, w_in, w_out) (R, A) arrays for the device E-step: category
        id in {in_eq, in_up, in_down, out_up, out_down} plus the |rep|/|eff|
        magnitudes for the diff-weighted sums."""
        d1 = (self.bps_per_allele[self.allele_index][:, None]
              - self.bps_per_allele[None, :])
        p = self.motif_len
        in_frame = (d1 % p) == 0
        rep = _c_div(d1, p)
        eff = d1 - rep
        cat = np.where(in_frame,
                       np.where(rep == 0, 0, np.where(rep > 0, 1, 2)),
                       np.where(d1 > 0, 3, 4)).astype(np.int32)
        w_in = np.where(in_frame & (rep != 0), np.abs(rep), 0).astype(np.float64)
        w_out = np.where(~in_frame, np.abs(eff), 0).astype(np.float64)
        return cat, w_in, w_out

    def mesh_inputs(self) -> tuple:
        """The arguments of ``em_train_sharded`` after the mesh and before
        the convergence settings: the (R, A) diff-category tables, the
        reads' phase weights and samples, the initial allele log-priors,
        the sample count and ploidy."""
        cat, w_in, w_out = self._estep_category_tables()
        d1 = (self.bps_per_allele[self.allele_index][:, None]
              - self.bps_per_allele[None, :])
        p = self.motif_len
        rep = _c_div(d1, p)
        self._init_log_gt_priors()
        return (rep, d1 - rep, (d1 % p) == 0, self.log_p1, self.log_p2,
                self.sample_label, cat, w_in, w_out, self.log_gt_priors,
                self.num_samples, self.haploid)

    def _train_mesh(self, mesh, max_iter, min_ll_abs, min_ll_frac) -> bool:
        """The whole EM train loop on ``mesh`` (a
        :class:`longtr_tpu_torch.parallel.mesh.Mesh`): reads sharded, the
        posterior sums and sufficient statistics added across shards, the
        closed-form M step on the mesh's first device."""
        from longtr_tpu_torch.parallel.mesh import em_train_sharded
        converged, params, n_iter, posteriors, totals = em_train_sharded(
            mesh, *self.mesh_inputs(), max_iter, min_ll_abs, min_ll_frac)
        self.posteriors = posteriors
        self.sample_total_lls = totals
        if converged:
            self.stutter_model = StutterModel(*(float(v) for v in params),
                                              motif=self.motif)
        return converged

    # -- training loop ------------------------------------------------------
    def train(self, max_iter=100, min_ll_abs=0.01, min_ll_frac=0.001,
              logger=None, mesh=None) -> bool:
        """em_stutter_genotyper.cpp:170-226.

        With ``mesh`` the whole train loop runs on the mesh's devices
        (parallel/mesh.em_train_sharded): reads sharded, posterior
        accumulation + sufficient statistics added across shards,
        closed-form M step on the first device.
        """
        if mesh is not None:
            return self._train_mesh(mesh, max_iter, min_ll_abs, min_ll_frac)
        max_param_diff = 0.0001
        fid = mathops.ref_fidelity()
        self._init_log_gt_priors()
        self.stutter_model = StutterModel(0.9, 0.1, 0.1, 0.8, 0.01, 0.01, self.motif)
        LL = -np.inf
        for it in range(1, max_iter + 1):
            aln_LL = self._pmf_matrix()
            if fid:
                new_LL = self._calc_posteriors_fid(aln_LL)
            else:
                new_LL = self._calc_posteriors(aln_LL)
            phase_post = self._calc_read_phase_posteriors(aln_LL)
            if logger:
                logger(f"EM iteration {it}: LL = {new_LL}")
            assert new_LL <= TOLERANCE
            if new_LL < LL + TOLERANCE:
                return True  # non-monotonic due to pseudocounts: accept
            if fid:
                self._recalc_log_gt_priors_fid()
            else:
                self._recalc_log_gt_priors()
            prev = self.stutter_model
            if fid:
                self._recalc_stutter_model_fid(phase_post)
            else:
                self._recalc_stutter_model(phase_post)
            abs_change = new_LL - LL
            frac_change = -(new_LL - LL) / LL if LL != -np.inf else np.inf
            if abs_change < min_ll_abs and frac_change < min_ll_frac:
                return True
            if self.stutter_model.parameters_within_threshold(prev, max_param_diff):
                return True
            LL = new_LL
        return False
