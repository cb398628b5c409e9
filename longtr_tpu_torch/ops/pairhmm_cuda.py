"""Wrappers of the hand-written CUDA pair-HMM kernels (``csrc/pairhmm.cu``).

Port of :mod:`longtr_tpu.ops.pairhmm_pallas`:

* :func:`pairhmm_resident` replaces ``_kernel`` (``_pallas_call``): one
  block per pair, the previous row's M, I and fused predecessor in shared
  memory.  It takes a batch whose read width fits one block's shared
  memory (about 17k columns on an H100).
* :func:`pairhmm_streamed` replaces ``_kernel_chunked``
  (``_pallas_call_chunked``): the rows live in a device-memory workspace
  and the read axis is walked in tiles.  It takes any width, so no pair is
  sent to the host for being long.

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

# Kernel launches per wrapper; chip_smoke.py zeroes and reads these.
launches = {"pairhmm_resident": 0, "pairhmm_streamed": 0}

# Bound on the streamed kernel's workspace per launch; larger batches are
# split.  At an 8 kb read width this is about 11k pairs per launch.
STREAMED_WORKSPACE_BYTES = 1 << 30
STREAMED_THREADS = 512

# Test hook: when set, batches whose resident shared-memory footprint
# exceeds this many bytes go to the streamed kernel even if they would fit.
resident_limit_bytes = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _resident_threads(Mdim: int) -> int:
    """About four columns per thread, in whole warps, at most 1024."""
    per = -(-Mdim // 4)
    return min(1024, max(32, -(-per // 32) * 32))


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


def resident_smem_bytes(Mdim: int) -> int:
    return int(_build.load_library().pairhmm_resident_smem_bytes(Mdim))


def max_smem_optin(device) -> int:
    dev = torch.device(device)
    val = ctypes.c_int(0)
    _raise_on(_build.load_library().pairhmm_max_smem_optin(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.byref(val)), "cudaDeviceGetAttribute")
    return val.value


def resident_fits(Mdim: int, device) -> bool:
    """Whether a read width fits the resident kernel's shared memory."""
    need = resident_smem_bytes(Mdim)
    if resident_limit_bytes is not None and need > resident_limit_bytes:
        return False
    return need <= max_smem_optin(device)


def pairhmm_resident(hap, hap_len, read, read_len, full_len, trans,
                     threads: int | None = None):
    """Mode-A scores of a (B, N) x (B, M) batch; the resident kernel."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    threads = threads or _resident_threads(read.shape[1])
    B, N, M = _check(hap, hap_len, read, read_len, full_len, trans, threads)
    out = torch.empty(B, dtype=torch.float32, device=hap.device)
    if B == 0:
        return out
    if not resident_fits(M, hap.device):
        raise ValueError(f"read width {M} does not fit the resident "
                         "kernel's shared memory; use pairhmm_streamed")
    lib = _build.load_library()
    with torch.cuda.device(hap.device):
        rc = lib.pairhmm_resident(
            _ptr(hap), _ptr(read), _ptr(hap_len), _ptr(read_len),
            _ptr(full_len), _ptr(trans), B, N, M, threads, _ptr(out),
            _stream(hap.device))
    _raise_on(rc, "pairhmm_resident")
    launches["pairhmm_resident"] += 1
    return out


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
    """Route a batch: the resident kernel when its read width fits one
    block's shared memory, the streamed kernel otherwise.  CPU tensors take
    the plain scan."""
    if hap.device.type == "cpu":
        return pairhmm_scan(hap, hap_len, read, read_len, full_len, trans)
    if not resident_fits(read.shape[1], hap.device):
        return pairhmm_streamed(hap, hap_len, read, read_len, full_len, trans)
    return pairhmm_resident(hap, hap_len, read, read_len, full_len, trans)
