"""The traced run's device record: ``torch.profiler`` over the window,
reduced to busy time, device time by operation, idle gaps named by the
host span they fell in, and each kernel family's device time.

The profiler's clock and the benchmark's (``time.perf_counter``) are tied
by a marker: a one-element fill launched right after the profiler starts,
whose device start is taken as the host time of its launch.
"""

from __future__ import annotations

import time

import torch

MARKER_NUMEL = 7919          # a size nothing else in a run fills


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_marker = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_marker = time.perf_counter()
        torch.full((MARKER_NUMEL,), 7.0, device=self.device)
        torch.cuda.synchronize(self.device)

    def stop(self) -> list:
        """Device operations [(name, start s, end s)] on the host clock."""
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        evs = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
               for e in evs]
        ops.sort(key=lambda o: o[1])
        marker = next((o for o in ops if "fill" in o[0].lower()), None)
        if marker is None:
            return []
        shift = self.t_marker - marker[1]
        return [(n, a + shift, b + shift) for n, a, b in ops]


def busy_intervals(ops, t0, t1):
    """Union of the device operations' intervals, clipped to [t0, t1]."""
    out = []
    for _n, a, b in ops:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def innermost(spans, t):
    """Name of the innermost host span holding time t, with its parents."""
    holding = [s for s in spans if s[1] <= t < s[2]]
    if not holding:
        return "between passes"
    holding.sort(key=lambda s: s[3])
    return "/".join(s[0] for s in holding)


def summarize(ops, spans, t0, t1, top=10) -> dict:
    """Busy seconds, device seconds by operation, the longest idle gaps
    named by span, over the window [t0, t1]."""
    ops = [o for o in ops if o[2] > t0 and o[1] < t1]
    busy = busy_intervals(ops, t0, t1)
    busy_s = sum(b - a for a, b in busy)
    by_name = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = []
    edge = t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = [(innermost(spans, (a + b) / 2), b - a) for a, b in gaps[:top]]
    return {
        "window_s": t1 - t0,
        "busy_s": busy_s,
        "device_s": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": gaps,
    }


def family_s(summary, needle: str):
    """Device seconds of the operations whose name holds ``needle``, or None
    where the trace holds none."""
    hits = [s for n, s in summary["device_s"].items() if needle in n]
    return sum(hits) if hits else None
