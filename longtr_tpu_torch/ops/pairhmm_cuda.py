"""Wrappers of the hand-written CUDA pair-HMM kernels (``csrc/pairhmm.cu``).

Port of :mod:`longtr_tpu.ops.pairhmm_pallas`:

* K1 replaces ``_kernel`` (``_pallas_call``) with two variants:
  :func:`pairhmm_resident_warp` (one warp a pair, the rows in registers;
  up to ``WARP_MAX_WIDTH`` columns) and :func:`pairhmm_resident_block`
  (one block of warps a pair, the rows in registers; up to
  ``BLOCK_MAX_WIDTH``).  :func:`pairhmm_resident` picks one by width.
* K2 replaces ``_kernel_chunked`` (``_pallas_call_chunked``) with two
  kernels: :func:`pairhmm_streamed_cluster` (one thread-block cluster a
  pair, the rows in the registers of its CTAs; up to
  ``CLUSTER_MAX_WIDTH`` columns) and :func:`pairhmm_streamed` (the rows in
  a device-memory workspace, the read axis walked in tiles; any width, so
  no pair is sent to the host for being long).

:func:`pairhmm_batch` routes a batch by its read width M: warp up to
``WARP_MAX_WIDTH``, block up to ``BLOCK_MAX_WIDTH``, cluster up to
``CLUSTER_MAX_WIDTH``, the workspace kernel beyond.  The thresholds are module
attributes, so that a test can send a width to any kernel.

Each wrapper validates its tensors, allocates the output (and workspace)
with ``torch.empty`` on the inputs' device, launches on the current CUDA
stream without synchronising, raises if the launch is refused, and adds
one to ``launches[name]``.  Given CPU tensors it runs the plain version,
:func:`longtr_tpu_torch.ops.pairhmm.pairhmm_scan`, and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from longtr_tpu_torch.ops import _build
from longtr_tpu_torch.ops.pairhmm import pairhmm_scan

# Kernel launches per variant; chip_smoke.py zeroes and reads these.
launches = {"pairhmm_resident_warp": 0, "pairhmm_resident_block": 0,
            "pairhmm_streamed_cluster": 0, "pairhmm_streamed": 0}

# The widest reads the register variants take (csrc/pairhmm.cu: 32 lanes
# of at most 32 columns; 512 threads of at most 16), whose C entries refuse
# wider ones.  Module attributes, so that a test can lower them to send a
# width to the next variant.
WARP_MAX_WIDTH = 32 * 32
BLOCK_MAX_WIDTH = 512 * 16

# The cluster kernel: a CTA holds at most 512 threads of 16 columns, a
# portable cluster 8 CTAs.  MIN_CTA_COLUMNS is the narrowest CTA that
# cluster_shape makes when it spreads a small batch over more SMs.
CTA_MAX_WIDTH = 512 * 16
CLUSTER_MAX = 8
CLUSTER_MAX_WIDTH = CLUSTER_MAX * CTA_MAX_WIDTH
MIN_CTA_COLUMNS = 1024

# Bound on the streamed kernel's workspace per launch; larger batches are
# split.  At an 8 kb read width this is about 11k pairs per launch.
STREAMED_WORKSPACE_BYTES = 1 << 30
STREAMED_THREADS = 512


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(hap, hap_len, read, read_len, full_len, trans, threads):
    dev = hap.device
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: the kernels take CUDA tensors")
    for name, x, dt in (("hap", hap, torch.uint8), ("read", read, torch.uint8),
                        ("hap_len", hap_len, torch.int32),
                        ("read_len", read_len, torch.int32),
                        ("full_len", full_len, torch.int32),
                        ("trans", trans, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, hap on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hap.dim() != 2 or read.dim() != 2 or hap.shape[0] != read.shape[0]:
        raise ValueError(f"hap {tuple(hap.shape)} and read "
                         f"{tuple(read.shape)} must be (B, N) and (B, M)")
    B, N = hap.shape
    M = read.shape[1]
    if N < 1 or M < 1:
        raise ValueError("hap and read widths must be at least 1")
    for name, x in (("hap_len", hap_len), ("read_len", read_len),
                    ("full_len", full_len)):
        if tuple(x.shape) != (B,):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected ({B},)")
    if tuple(trans.shape) != (7,):
        raise ValueError(f"trans has shape {tuple(trans.shape)}, expected (7,)")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads={threads}: a multiple of 32 in [32, 1024]")
    return B, N, M


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def max_smem_optin(device) -> int:
    dev = torch.device(device)
    val = ctypes.c_int(0)
    _raise_on(_build.load_library().pairhmm_max_smem_optin(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.byref(val)), "cudaDeviceGetAttribute")
    return val.value


def _launch(name, fn, hap, hap_len, read, read_len, full_len, trans,
            extra=()):
    """Check the batch, launch ``lib.<fn>`` on it (``extra``: the kernel's
    shape arguments after the widths), count the launch."""
    B, N, M = _check(hap, hap_len, read, read_len, full_len, trans, 32)
    out = torch.empty(B, dtype=torch.float32, device=hap.device)
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(hap.device):
        rc = getattr(lib, fn)(
            _ptr(hap), _ptr(read), _ptr(hap_len), _ptr(read_len),
            _ptr(full_len), _ptr(trans), B, N, M, *extra, _ptr(out),
            _stream(hap.device))
    _raise_on(rc, name)
    launches[name] += 1
    return out


def pairhmm_resident_warp(hap, hap_len, read, read_len, full_len, trans):
    """K1, warp variant: one warp a pair, up to ``WARP_MAX_WIDTH`` columns."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    if read.shape[1] > WARP_MAX_WIDTH:
        raise ValueError(f"read width {read.shape[1]} exceeds the warp "
                         f"variant's {WARP_MAX_WIDTH} columns")
    return _launch("pairhmm_resident_warp", "pairhmm_resident_warp", hap,
                   hap_len, read, read_len, full_len, trans)


def pairhmm_resident_block(hap, hap_len, read, read_len, full_len, trans):
    """K1, block variant: one block of warps a pair, up to
    ``BLOCK_MAX_WIDTH`` columns."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    if read.shape[1] > BLOCK_MAX_WIDTH:
        raise ValueError(f"read width {read.shape[1]} exceeds the block "
                         f"variant's {BLOCK_MAX_WIDTH} columns")
    return _launch("pairhmm_resident_block", "pairhmm_resident_block", hap,
                   hap_len, read, read_len, full_len, trans)


def pairhmm_resident(hap, hap_len, read, read_len, full_len, trans):
    """Mode-A scores of a (B, N) x (B, M) batch of at most
    ``BLOCK_MAX_WIDTH`` columns; K1's warp or block variant, chosen by the
    read width M.  Wider batches go through :func:`pairhmm_batch`."""
    if read.shape[1] <= WARP_MAX_WIDTH:
        return pairhmm_resident_warp(hap, hap_len, read, read_len, full_len,
                                     trans)
    return pairhmm_resident_block(hap, hap_len, read, read_len, full_len,
                                  trans)


def cluster_shape(M: int, B: int, sms: int) -> int:
    """C, the CTAs a pair of the cluster kernel, for B pairs of read width
    M on a card of ``sms`` SMs: the least C whose CTAs hold M (at most
    ``CTA_MAX_WIDTH`` columns a CTA), raised while the batch leaves SMs
    idle (B * C <= sms) and the CTAs stay at least ``MIN_CTA_COLUMNS``
    wide, up to ``CLUSTER_MAX``."""
    C = max(1, -(-M // CTA_MAX_WIDTH))
    while (C < CLUSTER_MAX and B * (C + 1) <= sms
           and -(-M // (C + 1)) >= MIN_CTA_COLUMNS):
        C += 1
    return C


def pairhmm_streamed_cluster(hap, hap_len, read, read_len, full_len, trans,
                             cluster: int | None = None):
    """K2, cluster kernel: one thread-block cluster of ``cluster`` CTAs a
    pair (default: :func:`cluster_shape`), 16 columns a thread, up to
    ``CLUSTER_MAX_WIDTH`` columns.  A shape the card cannot launch
    raises."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    B, _N, M = _check(hap, hap_len, read, read_len, full_len, trans, 32)
    if cluster is None:
        if M > CLUSTER_MAX_WIDTH:
            raise ValueError(f"read width {M} exceeds the cluster kernel's "
                             f"{CLUSTER_MAX_WIDTH} columns")
        props = torch.cuda.get_device_properties(hap.device)
        cluster = cluster_shape(M, B, props.multi_processor_count)
    return _launch("pairhmm_streamed_cluster", "pairhmm_streamed_cluster",
                   hap, hap_len, read, read_len, full_len, trans, (cluster,))


def pairhmm_streamed(hap, hap_len, read, read_len, full_len, trans,
                     threads: int | None = None):
    """Mode-A scores of a (B, N) x (B, M) batch; the streamed kernel.

    The batch is split so that each launch's (b, 3, M) float32 workspace
    stays within ``STREAMED_WORKSPACE_BYTES``.
    """
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    threads = threads or STREAMED_THREADS
    B, N, M = _check(hap, hap_len, read, read_len, full_len, trans, threads)
    out = torch.empty(B, dtype=torch.float32, device=hap.device)
    step = max(1, STREAMED_WORKSPACE_BYTES // (12 * M))
    ws = torch.empty((min(B, step), 3, M), dtype=torch.float32,
                     device=hap.device)
    lib = _build.load_library()
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        with torch.cuda.device(hap.device):
            rc = lib.pairhmm_streamed(
                _ptr(hap[lo:hi]), _ptr(read[lo:hi]), _ptr(hap_len[lo:hi]),
                _ptr(read_len[lo:hi]), _ptr(full_len[lo:hi]), _ptr(trans),
                hi - lo, N, M, threads, _ptr(ws), _ptr(out[lo:hi]),
                _stream(hap.device))
        _raise_on(rc, "pairhmm_streamed")
        launches["pairhmm_streamed"] += 1
    return out


def pairhmm_batch(hap, hap_len, read, read_len, full_len, trans):
    """Route a batch by its read width M: K1's warp or block variant
    (:func:`pairhmm_resident`) up to ``BLOCK_MAX_WIDTH``, the cluster kernel
    up to ``CLUSTER_MAX_WIDTH``, the workspace kernel beyond.  CPU tensors take
    the plain scan."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    M = read.shape[1]
    args = (hap, hap_len, read, read_len, full_len, trans)
    if M <= BLOCK_MAX_WIDTH:
        return pairhmm_resident(*args)
    if M <= CLUSTER_MAX_WIDTH:
        return pairhmm_streamed_cluster(*args)
    return pairhmm_streamed(*args)
