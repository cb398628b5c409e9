"""Named wall-time accumulator (reference: src/process_timer.h)."""

from __future__ import annotations


class ProcessTimer:
    def __init__(self):
        self.totals = {}

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def get_total_time(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def summary(self) -> str:
        lines = ["Approximate timing breakdown:"]
        for name, t in self.totals.items():
            lines.append(f" {name:24s} = {t:.3f} seconds")
        return "\n".join(lines)
