"""Genotype priors and the constants of the diplotype posterior.

Port of the host part of :mod:`longtr_tpu.ops.posterior`
(``Genotyper::calc_log_sample_posteriors``, src/genotyper.cpp:21-83).  The
default path computes the posterior itself on the host in float64
(``SeqStutterGenotyper._calc_posteriors``); it needs only the priors and
the constants below.
"""

from __future__ import annotations

import numpy as np

from longtr_tpu.utils.mathops import int_log

LL_CLAMP = -600.0
# The reference uses -DBL_MAX/2 for impossible haploid heterozygotes
# (genotyper.cpp:31); the host f64 path uses the same value (bit parity).
NEG_HALF_DBL_MAX = -8.988465674311579e307


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
