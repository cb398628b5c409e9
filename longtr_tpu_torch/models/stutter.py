"""PCR stutter model.

Reference: src/stutter_model.{h,cpp}.  The PMF over the bp difference
``d = read_bps - sample_bps`` (stutter_model.cpp:29-53):

* d == 0:            log(1 - in_up - in_down - out_up - out_down)
* d % period == 0:   geometric over repeat units with up/down asymmetry
* otherwise:         geometric over the *effective* bp difference
                     eff = d - d/period  (C++ truncating division!)

Serialization matches the reference text format so ``--stutter-in`` /
``--stutter-out`` files interoperate (stutter_model.cpp:55-91).

``log_pmf_table`` vectorizes the PMF over integer difference grids for the
device-side EM fitter and the legacy stutter HMM.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np


def _c_div(a: int | np.ndarray, b: int):
    """C++ truncating integer division (toward zero)."""
    if isinstance(a, np.ndarray):
        return (np.sign(a) * (np.abs(a) // b)).astype(a.dtype)
    q = abs(a) // b
    return q if a >= 0 else -q


@dataclass
class StutterModel:
    in_geom: float
    in_up: float
    in_down: float
    out_geom: float
    out_up: float
    out_down: float
    motif: str = "A"

    def __post_init__(self):
        assert 0.0 < self.in_geom < 1.0 and 0.0 < self.out_geom < 1.0
        assert self.in_up > 0 and self.in_down > 0
        assert self.out_up > 0 and self.out_down > 0
        assert self.in_up + self.in_down + self.out_up + self.out_down < 1.0
        self._recompute_logs()

    def _recompute_logs(self):
        self.in_log_step = math.log(1 - self.in_geom)
        self.in_log_nostep = math.log(self.in_geom)
        self.in_log_up = math.log(self.in_up)
        self.in_log_down = math.log(self.in_down)
        self.out_log_step = math.log(1 - self.out_geom)
        self.out_log_nostep = math.log(self.out_geom)
        self.out_log_up = math.log(self.out_up)
        self.out_log_down = math.log(self.out_down)
        self.log_equal = math.log(
            1 - self.in_up - self.in_down - self.out_up - self.out_down)

    @property
    def period(self) -> int:
        return len(self.motif)

    def with_period(self, period: int) -> "StutterModel":
        """Copy with the motif length replaced (set_period analog)."""
        return StutterModel(self.in_geom, self.in_up, self.in_down,
                            self.out_geom, self.out_up, self.out_down,
                            "N" * period)

    def copy(self) -> "StutterModel":
        return StutterModel(self.in_geom, self.in_up, self.in_down,
                            self.out_geom, self.out_up, self.out_down, self.motif)

    def log_stutter_pmf(self, sample_bps: int, read_bps: int) -> float:
        """Scalar PMF (stutter_model.cpp:29-53)."""
        d = read_bps - sample_bps
        p = self.period
        if d % p != 0:  # Python % differs from C++ for negatives, but
            # "d % p != 0" agrees for positive p.
            eff = d - _c_div(d, p)
            if eff < 0:
                return self.out_log_down + self.out_log_nostep + self.out_log_step * (-eff - 1)
            return self.out_log_up + self.out_log_nostep + self.out_log_step * (eff - 1)
        rep = _c_div(d, p)
        if rep == 0:
            return self.log_equal
        if rep < 0:
            return self.in_log_down + self.in_log_nostep + self.in_log_step * (-rep - 1)
        return self.in_log_up + self.in_log_nostep + self.in_log_step * (rep - 1)

    def log_pmf_table(self, diffs: np.ndarray) -> np.ndarray:
        """Vectorized PMF over an integer array of bp differences."""
        d = np.asarray(diffs, dtype=np.int64)
        p = self.period
        out_of_frame = (d % p) != 0
        eff = d - _c_div(d, p)
        out_val = np.where(
            eff < 0,
            self.out_log_down + self.out_log_nostep + self.out_log_step * (-eff - 1),
            self.out_log_up + self.out_log_nostep + self.out_log_step * (eff - 1))
        rep = _c_div(d, p)
        in_val = np.where(
            rep == 0, self.log_equal,
            np.where(rep < 0,
                     self.in_log_down + self.in_log_nostep + self.in_log_step * (-rep - 1),
                     self.in_log_up + self.in_log_nostep + self.in_log_step * (rep - 1)))
        return np.where(out_of_frame, out_val, in_val).astype(np.float64)

    # -- serialization (reference text format) ------------------------------

    def write_line(self) -> str:
        """The 7 whitespace-separated fields (stutter_model.cpp:55-58)."""
        return (f"{self.in_geom:g}\t{self.in_down:g}\t{self.in_up:g}\t"
                f"{self.out_geom:g}\t{self.out_down:g}\t{self.out_up:g}\t{self.motif}")

    def write_model_line(self, chrom: str, start: int, end: int) -> str:
        return f"{chrom}\t{start}\t{end}\t{self.write_line()}"

    @staticmethod
    def parse_line(line: str) -> "StutterModel":
        f = line.split()
        if len(f) < 7:
            raise ValueError("Improperly formatted stutter model file")
        return StutterModel(float(f[0]), float(f[2]), float(f[1]),
                            float(f[3]), float(f[5]), float(f[4]), f[6])

    @staticmethod
    def read_models(path: str) -> dict:
        """Read a --stutter-in file keyed by (chrom, start, end)."""
        models = {}
        with open(path) as fh:
            for line in fh:
                f = line.split()
                if len(f) < 10:
                    continue
                chrom, start, end = f[0], int(f[1]), int(f[2])
                models[(chrom, start, end)] = StutterModel(
                    float(f[3]), float(f[5]), float(f[4]),
                    float(f[6]), float(f[8]), float(f[7]), f[9])
        return models

    def parameters_within_threshold(self, other: "StutterModel", max_diff: float) -> bool:
        return (abs(other.in_geom - self.in_geom) < max_diff
                and abs(other.in_up - self.in_up) < max_diff
                and abs(other.in_down - self.in_down) < max_diff
                and abs(other.out_geom - self.out_geom) < max_diff
                and abs(other.out_up - self.out_up) < max_diff
                and abs(other.out_down - self.out_down) < max_diff)

    def __str__(self):
        return (f"IN_FRAME [P_GEOM(rep)={self.in_geom}, P_DOWN={self.in_down}, "
                f"P_UP={self.in_up}] OUT_FRAME[P_GEOM(bp)={self.out_geom}, "
                f"P_DOWN={self.out_down}, P_UP={self.out_up}]")


# The CLI's --def-stutter-model values (hipstr_main.cpp:362-363); installed by
# default because def_stutter_model defaults to 1 (hipstr_main.cpp:140).
def default_stutter_model() -> StutterModel:
    return StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, "A")
