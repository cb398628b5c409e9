"""Thread-level parallelism coordination.

The pipeline parallelizes haplotype generation ACROSS loci (one worker
per locus window slot).  The generation internals (per-sample rescue
clustering, per-cluster POA, batched edit distances) have their own
thread pools for the serial path; running those nested inside a locus
worker oversubscribes the host 4x4x4 and thrashes.  A thread-local flag
marks locus-worker context so inner layers fall back to serial loops.
"""

from __future__ import annotations

import os
import threading

_tl = threading.local()
_lock = threading.Lock()
_active_builds = 0


def _cgroup_quota_cores() -> int | None:
    """CPU budget from a cgroup quota (cpu.max / CFS), if any.

    A container can be limited by quota without any cpuset restriction —
    sched_getaffinity then reports the whole machine."""
    try:
        with open("/sys/fs/cgroup/cpu.max") as fh:      # cgroup v2
            quota, period = fh.read().split()
            if quota != "max":
                return max(1, int(quota) // int(period))
    except (OSError, ValueError):
        pass
    try:                                                 # cgroup v1
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as fh:
            quota = int(fh.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as fh:
            period = int(fh.read())
        if quota > 0:
            return max(1, quota // period)
    except (OSError, ValueError):
        pass
    return None


_cores_cache = None


def available_cores() -> int:
    """Cores this process may actually run on: min of the scheduling-
    affinity set (taskset/cpuset — e.g. emulated multi-host shards) and
    any cgroup CPU quota, falling back to os.cpu_count().

    Cached: this is called per locus build and the cgroup probe reads
    /sys files (~1ms each — measured 2.4s over a 1000-locus run)."""
    global _cores_cache
    if _cores_cache is not None:
        return _cores_cache
    try:
        n = len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        n = os.cpu_count() or 4
    q = _cgroup_quota_cores()
    _cores_cache = min(n, q) if q else n
    return _cores_cache


def in_locus_worker() -> bool:
    return getattr(_tl, "flag", False)


def spare_workers() -> int:
    """Cores per active locus build: middle-layer pools (per-sample
    rescue) size themselves to this so one dominant locus fans out across
    idle cores, while a window of uniformly heavy loci stays one-thread-
    per-locus instead of oversubscribing.  A thread-local budget (set by
    an outer fan-out via ``locus_worker_scope(budget=...)``) takes
    precedence, so nested layers split — not multiply — the core count."""
    b = getattr(_tl, "budget", None)
    if b is not None:
        return max(1, b)
    with _lock:
        act = max(1, _active_builds)
    return max(1, available_cores() // act)


class locus_worker_scope:
    """Marks locus-build context; counts concurrent builds.

    ``nested=True`` re-enters the flag in a child thread without counting
    a new build (used when a build fans work to its own helper threads).
    ``budget`` caps what :func:`spare_workers` reports inside the scope —
    an outer fan-out of width W passes budget = spare // W so the inner
    layers divide its cores instead of each claiming all of them.
    """

    def __init__(self, nested: bool = False, budget: int | None = None):
        self._nested = nested
        self._budget = budget

    def __enter__(self):
        global _active_builds
        self._prev = getattr(_tl, "flag", False)
        self._prev_budget = getattr(_tl, "budget", None)
        _tl.flag = True
        if self._budget is not None:
            _tl.budget = self._budget
        if not self._nested:
            with _lock:
                _active_builds += 1
        return self

    def __exit__(self, *exc):
        global _active_builds
        _tl.flag = self._prev
        _tl.budget = self._prev_budget
        if not self._nested:
            with _lock:
                _active_builds -= 1
        return False
