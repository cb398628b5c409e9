"""Base-quality log-probability tables (reference: src/base_quality.{h,cpp}).

Phred+33 over '!'..'J'; out-of-range clamps to the boundary values.  Note the
reference's error model divides the exponent by 5 (base_quality.h:36).
"""

from __future__ import annotations

import math

MIN_BASE_QUALITY = "!"
MAX_BASE_QUALITY = "J"
_MAX_INDEX = ord(MAX_BASE_QUALITY) - ord(MIN_BASE_QUALITY)

_LOG_CORRECT = [0.0] * (_MAX_INDEX + 1)
_LOG_ERROR = [0.0] * (_MAX_INDEX + 1)
_LOG_CORRECT[0] = -100.0
_LOG_ERROR[0] = 0.0
for _i in range(1, _MAX_INDEX + 1):
    _LOG_CORRECT[_i] = math.log(1.0 - 10.0 ** (_i / -10.0))
    _LOG_ERROR[_i] = math.log(10.0 ** (_i / (-10.0) / 5.0))


def log_prob_correct(quality: str) -> float:
    idx = ord(quality) - ord(MIN_BASE_QUALITY)
    if idx < 0:
        return _LOG_CORRECT[0]
    if idx > _MAX_INDEX:
        return _LOG_CORRECT[_MAX_INDEX]
    return _LOG_CORRECT[idx]


def log_prob_error(quality: str) -> float:
    idx = ord(quality) - ord(MIN_BASE_QUALITY)
    if idx < 0:
        return _LOG_ERROR[0]
    if idx > _MAX_INDEX:
        return _LOG_ERROR[_MAX_INDEX]
    return _LOG_ERROR[idx]
