"""Log-space math helpers mirroring the reference semantics.

Reference: src/mathops.{h,cpp}.  The reference mixes exact log-sum-exp with a
"fast" variant that drops terms smaller than ``max + log(0.001)`` and uses the
Mineiro fastlog/fastexp approximations (src/mathops.cpp:87-107).

Two math modes:

* default — exact f64 math with the reference's term-dropping *selection*
  behaviour preserved (PARITY.md "conscious fixes": better numerics).
* reference-fidelity (``set_ref_fidelity(True)`` or env
  ``LONGTR_REF_FIDELITY=1``) — the Mineiro bit patterns evaluated exactly as
  the compiled reference does (utils/fastapprox.py, verified bit-identical
  against the compiled reference header by tests/test_ref_oracle.py).  This
  is the path to bit-identical VCF output.
"""

from __future__ import annotations

import math
import os

import numpy as np

LOG_ONE_HALF = math.log(0.5)
TOLERANCE = 1e-10
LOG_E_BASE_10 = 0.4342944819
# Reference: src/mathops.h:36 — fast LSE drops terms < max + log(0.001).
LOG_THRESH = math.log(0.001)
# Reference: src/mathops.cpp:17 — int_log(0) is defined as -1000.
INT_LOG_ZERO = -1000.0


def int_log(val: int) -> float:
    """log(val) with the reference's convention that int_log(0) == -1000."""
    if val <= 0:
        return INT_LOG_ZERO
    return math.log(val)


def log_sum_exp(vals) -> float:
    """Exact log-sum-exp over a 1-D array/list (reference: mathops.cpp:45-71)."""
    arr = np.asarray(vals, dtype=np.float64)
    if arr.size == 0:
        return -np.inf
    m = arr.max()
    if not np.isfinite(m):
        return float(m)
    return float(m + np.log(np.exp(arr - m).sum()))


def log_sum_exp2(a: float, b: float) -> float:
    """Two-argument exact LSE with the reference's exact float expression
    (mathops.cpp:53-58: hi + log(1 + exp(lo - hi)), strict >)."""
    if a > b:
        return a + math.log(1.0 + math.exp(b - a))
    return b + math.log(1.0 + math.exp(a - b))


def log_sum_exp3(a: float, b: float, c: float) -> float:
    """Three-argument exact LSE with the reference's exact float expression
    (mathops.cpp:59-62)."""
    m = max(max(a, b), c)
    return m + math.log(math.exp(a - m) + math.exp(b - m) + math.exp(c - m))


_ref_fidelity = os.environ.get("LONGTR_REF_FIDELITY", "") == "1"


def set_ref_fidelity(on: bool) -> None:
    """Switch between exact math (default) and the reference's Mineiro
    fastapprox bit patterns for all fast-LSE call sites."""
    global _ref_fidelity
    _ref_fidelity = bool(on)


def ref_fidelity() -> bool:
    return _ref_fidelity


def fast_log_sum_exp(vals) -> float:
    """Log-sum-exp that drops terms below max+LOG_THRESH (mathops.cpp:98-107).

    Exact math by default; the Mineiro fasterexp/fasterlog bit patterns in
    reference-fidelity mode.
    """
    if _ref_fidelity:
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp_vec(vals)
    arr = np.asarray(vals, dtype=np.float64)
    if arr.size == 0:
        return -np.inf
    m = arr.max()
    if not np.isfinite(m):
        return float(m)
    d = arr - m
    kept = d[d > LOG_THRESH]
    return float(m + np.log(np.exp(kept).sum()))


def fast_log_sum_exp2(log_v1: float, log_v2: float) -> float:
    """Two-argument fast LSE (mathops.cpp:87-96).

    The reference keeps only the max when the difference is below LOG_THRESH
    (strict <); fidelity mode additionally reproduces its fastlog/fastexp
    float arithmetic.
    """
    if _ref_fidelity:
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp2(log_v1, log_v2)
    hi, lo = (log_v1, log_v2) if log_v1 > log_v2 else (log_v2, log_v1)
    diff = lo - hi
    if diff < LOG_THRESH:
        return hi
    return hi + math.log1p(math.exp(diff))


def fast_log_sum_exp2_arr(a, b):
    """Elementwise two-argument fast LSE over arrays."""
    if _ref_fidelity:
        from longtr_tpu_torch.utils import fastapprox
        return fastapprox.fast_log_sum_exp2_arr(a, b)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    hi = np.maximum(a, b)
    diff = np.minimum(a, b) - hi
    return np.where(diff < LOG_THRESH, hi, hi + np.log1p(np.exp(diff)))


def streaming_lse_update(log_val: float, max_val: float, total: float):
    """One step of the streaming log-sum-exp (mathops.cpp:73-81)."""
    if log_val <= max_val:
        return max_val, total + math.exp(log_val - max_val)
    return log_val, total * math.exp(max_val - log_val) + 1.0


def streaming_lse_finish(max_val: float, total: float) -> float:
    return max_val + math.log(total)
