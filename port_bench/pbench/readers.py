"""The arithmetic that the per-layer metric readers share.

A reader takes the :class:`Window` of a traced run and returns a number,
or None where the run holds nothing for it to read (a stage no pass
entered, a kernel family that never ran); the harness then leaves the
metric out of the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Window:
    loci: int                    # loci the window's passes processed
    stage_s: dict                # --metrics-out stage seconds, summed
    launches: int                # the port's kernel launch counters
    bound_s: dict                # summed roofline bounds by kernel family
    trace: dict | None = None    # trace.summarize() of the traced window
    # --metrics-out's integer counters, summed over the passes
    counters: dict = field(default_factory=dict)


def stage_ms(w: Window, stages):
    """Milliseconds of the named stages a locus."""
    hit = [w.stage_s[s] for s in stages if s in w.stage_s]
    if not hit or not w.loci:
        return None
    return 1e3 * sum(hit) / w.loci


def roofline_pct(w: Window, family: str, kernel_name: str):
    """The family's summed bound time over its kernels' device time, %."""
    from pbench.trace import family_s
    if w.trace is None or not w.bound_s.get(family):
        return None
    dev = family_s(w.trace, kernel_name)
    if not dev:
        return None
    return 100.0 * w.bound_s[family] / dev
