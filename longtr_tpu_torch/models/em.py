"""Length-based EM stutter-model fitter with the train loop on a mesh.

:class:`longtr_tpu.models.em.EMStutterGenotyper` trains on the host (it
imports no JAX), and with a mesh it hands the whole train loop to the JAX
package's ``em_train_sharded``.  This subclass hands it to the port's
:func:`longtr_tpu_torch.parallel.mesh.em_train_sharded` instead and reuses
everything else as it is.
"""

from __future__ import annotations

from longtr_tpu.models import em as _host
from longtr_tpu.models.stutter import StutterModel, _c_div


class EMStutterGenotyper(_host.EMStutterGenotyper):
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
