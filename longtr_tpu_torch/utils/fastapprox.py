"""Mineiro fastapprox float bit patterns (reference-fidelity math mode).

The reference's "fast" log-sum-exp routines (src/mathops.cpp:87-107) are
built on Paul Mineiro's published fastapprox approximations
(src/fastonebigheader.h: fastpow2/fastexp/fastlog2/fastlog and the
faster* variants).  Every output float of the reference flows through these,
so bit-identical VCF output requires evaluating the *same* bit patterns.

This module reimplements the published algorithm in NumPy with
f32 semantics matched operation-for-operation:

* ``fastpow2``: truncating int cast of the clipped input, f32 polynomial,
  float->uint32 truncation, bit reinterpretation (fastonebigheader.h:188-197)
* ``fastlog2``: uint32 reinterpretation, mantissa mask to [1,2), f32
  rational correction (fastonebigheader.h:320-331)
* ``faster*``: the linear-only variants (fastonebigheader.h:206-219,339-358)

and the double/float conversion boundaries of ``fast_log_sum_exp``
(mathops.cpp:87-107): C usual-arithmetic-conversion makes ``1 + fastexp(d)``
*float* arithmetic, while accumulation (`total +=`) happens in double.

Verified bit-identical against the compiled reference header by
tests/test_ref_oracle.py (grid + random sweeps).
"""

from __future__ import annotations

import numpy as np

_F = np.float32
_LOG_THRESH = float(np.log(0.001))  # mathops.h:36 (double)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def fastpow2(p):
    """fastonebigheader.h:188-197 (f32, elementwise)."""
    p = _f32(p)
    offset = np.where(p < 0, _F(1.0), _F(0.0))
    clipp = np.where(p < _F(-126.0), _F(-126.0), p)
    w = clipp.astype(np.int32)               # C int cast: truncate toward 0
    z = (clipp - w.astype(np.float32)) + offset
    t = (clipp + _F(121.2740575)
         + _F(27.7280233) / (_F(4.84252568) - z)
         - _F(1.49012907) * z)
    bits = (_F(1 << 23) * t).astype(np.uint32)   # (uint32_t) cast: truncate
    return bits.view(np.float32)


def fastexp(p):
    """fastexp(p) = fastpow2(1.442695040f * p)."""
    return fastpow2(_F(1.442695040) * _f32(p))


def fasterpow2(p):
    """fastonebigheader.h:206-212."""
    p = _f32(p)
    clipp = np.where(p < _F(-126.0), _F(-126.0), p)
    bits = (_F(1 << 23) * (clipp + _F(126.94269504))).astype(np.uint32)
    return bits.view(np.float32)


def fasterexp(p):
    return fasterpow2(_F(1.442695040) * _f32(p))


def fastlog2(x):
    """fastonebigheader.h:320-331."""
    x = _f32(x)
    vx = x.view(np.uint32) if isinstance(x, np.ndarray) else \
        np.asarray(x, np.float32).view(np.uint32)
    mx = ((vx & np.uint32(0x007FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    y = vx.astype(np.float32) * _F(1.1920928955078125e-7)
    return (y - _F(124.22551499)
            - _F(1.498030302) * mx
            - _F(1.72587999) / (_F(0.3520887068) + mx))


def fastlog(x):
    return _F(0.69314718) * fastlog2(x)


def fasterlog2(x):
    x = _f32(x)
    vx = x.view(np.uint32)
    y = vx.astype(np.float32) * _F(1.1920928955078125e-7)
    return y - _F(126.94269504)


def fasterlog(x):
    """fastonebigheader.h:348-358 (the direct-ln variant, not via log2)."""
    x = _f32(x)
    vx = x.view(np.uint32)
    y = vx.astype(np.float32) * _F(8.2629582881927490e-8)
    return y - _F(87.989971088)


# ---------------------------------------------------------------------------
# fast_log_sum_exp with the reference's exact conversion boundaries
# (mathops.cpp:87-107).  Inputs/outputs are doubles; the approximation calls
# take floats; ``1 + fastexp(diff)`` is *float* arithmetic (C promotion).
# ---------------------------------------------------------------------------

def fast_log_sum_exp2(log_v1: float, log_v2: float) -> float:
    """mathops.cpp:87-96 (two-argument form, fastlog/fastexp)."""
    if log_v1 > log_v2:
        hi, lo = log_v1, log_v2
    else:
        hi, lo = log_v2, log_v1
    diff = lo - hi
    if diff < _LOG_THRESH:
        return hi
    fe = fastexp(np.float32(diff))           # double -> float argument
    t = np.float32(1.0) + fe                 # float arithmetic (C promotion)
    return hi + float(fastlog(t))


def fast_log_sum_exp2_arr(a, b):
    """Elementwise fast_log_sum_exp2 over arrays (same op boundaries)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    hi = np.maximum(a, b)
    lo = np.minimum(a, b)
    diff = lo - hi
    fe = fastexp(diff.astype(np.float32))
    t = np.float32(1.0) + fe
    return np.where(diff < _LOG_THRESH, hi, hi + fastlog(t).astype(np.float64))


def fast_log_sum_exp_vec(log_vals) -> float:
    """mathops.cpp:98-107 (vector form, fasterexp/fasterlog)."""
    arr = np.asarray(log_vals, dtype=np.float64)
    max_val = float(arr.max())
    if not np.isfinite(max_val):
        # all-(-inf): the reference computes max + fasterlog(0) = -inf; the
        # numpy subtraction would emit a NaN invalid warning first.
        return max_val
    diffs = arr - max_val
    keep = diffs > _LOG_THRESH
    # total accumulates the float results in double, in element order
    total = 0.0
    fe = fasterexp(diffs[keep].astype(np.float32))
    fe = np.atleast_1d(fe)
    for v in fe:
        total += float(v)
    return max_val + float(fasterlog(np.float32(total)))


def fast_log_sum_exp_cols(E) -> np.ndarray:
    """Column-wise :func:`fast_log_sum_exp_vec` over an (n_entries, N)
    matrix — bit-identical per column (same elementwise Mineiro ops, same
    sequential f64 accumulation in entry order; dropped terms add exact
    +0.0)."""
    E = np.asarray(E, dtype=np.float64)
    m = E.max(axis=0)
    # All-(-inf) column guard (mirrors the exact-mode twin): -inf - -inf is
    # NaN, and a NaN reaching fasterexp's int32 cast raises a numpy invalid
    # RuntimeWarning.  Subtracting 0 instead gives diffs of -inf, which
    # fasterexp clips safely and `keep` drops; the column result is m itself.
    finite = np.isfinite(m)
    diffs = E - np.where(finite, m, 0.0)
    keep = diffs > _LOG_THRESH
    fe = fasterexp(diffs.astype(np.float32))
    fe = np.atleast_2d(fe)
    total = np.zeros(E.shape[1])
    for r in range(E.shape[0]):
        total = total + np.where(keep[r], fe[r].astype(np.float64), 0.0)
    out = m + fasterlog(total.astype(np.float32)).astype(np.float64)
    return np.where(finite, out, m)
