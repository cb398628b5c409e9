"""Wrapper of the hand-written CUDA mode-B kernel (``csrc/mode_b.cu``).

Port of :func:`longtr_tpu.ops.mode_b_device.mode_b_cols`, the jnp row scan
of the stutter HMM: one block per element, the rows looped inside the
block.  A batch whose three rows of width L fit one block's opt-in shared
memory (L up to about 19.3k on an H100) keeps them on chip; a wider one
runs the same kernel on a device-memory workspace, so no width goes to the
host.

:func:`mode_b_cols` validates its tensors, allocates the output (and
workspace) with ``torch.empty`` on the inputs' device, launches on the
current CUDA stream without synchronising, raises if the launch is
refused, and adds one to ``launches["mode_b_cols"]`` per launch.  Given
CPU tensors it runs the plain version,
:func:`longtr_tpu_torch.ops.mode_b_device.mode_b_cols_plain`, and counts
nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from longtr_tpu.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu.utils.mathops import LOG_THRESH
from longtr_tpu_torch.ops import _build
from longtr_tpu_torch.ops.mode_b_device import mode_b_cols_plain
from longtr_tpu_torch.ops.pairhmm_cuda import (_ptr, _raise_on, _stream,
                                               max_smem_optin)

# Kernel launches; chip_smoke.py zeroes and reads this.
launches = {"mode_b_cols": 0}

# Bound on the workspace of one launch; wider batches are split.
WORKSPACE_BYTES = 1 << 30

# Test hook: when set, batches whose shared-memory footprint exceeds this
# many bytes run on the workspace even if they would fit on chip.
smem_limit_bytes = None

# The plain version's float32 constants, passed to the kernel as they are.
_IMPOSSIBLE = ctypes.c_float(float(np.float32(IMPOSSIBLE)))
_THRESH = ctypes.c_float(float(np.float32(LOG_THRESH)))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def threads_for(L: int) -> int:
    """One column per thread, in whole warps, at most 1024."""
    return min(1024, max(32, -(-L // 32) * 32))


def smem_bytes(L: int) -> int:
    return int(_build.load_library().mode_b_smem_bytes(L))


def fits_on_chip(L: int, device) -> bool:
    """Whether rows of width L fit one block's shared memory."""
    need = smem_bytes(L)
    if smem_limit_bytes is not None and need > smem_limit_bytes:
        return False
    return need <= max_smem_optin(device)


def _check(args, n_d, threads):
    (codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind, stut_ord, A,
     bl, d0, dstep, params) = args
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: the kernel takes CUDA tensors")
    u8, i32, f32 = torch.uint8, torch.int32, torch.float32
    names = ("codes", "quals", "lw_tab", "lc_tab", "prefix", "last",
             "hapchar", "kind", "stut_ord", "A", "bl", "d0", "dstep", "params")
    dtypes = (u8, u8, f32, f32, f32, i32, u8, u8, u8, f32, i32, i32, i32, f32)
    for name, x, dt in zip(names, args, dtypes):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, codes on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dim() != 2 or hapchar.dim() != 2 or A.dim() != 4:
        raise ValueError("codes, hapchar and A must be (B, L), (B, R) and "
                         "(B, S, n_d, L)")
    B, L = codes.shape
    R = hapchar.shape[1]
    S = A.shape[1]
    want = {"quals": (B, L), "prefix": (B, L), "last": (B,),
            "hapchar": (B, R), "kind": (B, R), "stut_ord": (B, R),
            "A": (B, S, n_d, L), "bl": (B, S), "d0": (B, S), "dstep": (B, S),
            "lw_tab": (256,), "lc_tab": (256,), "params": (7,)}
    for name, x in zip(names, args):
        if name in want and tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{want[name]}")
    if L < 1 or R < 1 or S < 1 or n_d < 1:
        raise ValueError(f"L={L}, R={R}, S={S}, n_d={n_d}: each must be >= 1")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads={threads}: a multiple of 32 in [32, 1024]")
    return B, L, R, S


def mode_b_cols(codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
                stut_ord, A, bl, d0, dstep, params, *, n_d,
                threads: int | None = None):
    """(B, R) float32 M[row, last] of a mode-B batch; the CUDA kernel.

    Arguments as :func:`~longtr_tpu_torch.ops.mode_b_device.mode_b_cols_plain`,
    float32 tables only.
    """
    args = (codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
            stut_ord, A, bl, d0, dstep, params)
    if codes.device.type == "cpu":
        return mode_b_cols_plain(*args, n_d=n_d)
    threads = threads or threads_for(codes.shape[1])
    B, L, R, S = _check(args, n_d, threads)
    out = torch.empty((B, R), dtype=torch.float32, device=codes.device)
    if B == 0:
        return out
    on_chip = fits_on_chip(L, codes.device)
    step = B if on_chip else max(1, WORKSPACE_BYTES // (12 * L))
    ws = None if on_chip else torch.empty((min(B, step), 3, L),
                                          dtype=torch.float32,
                                          device=codes.device)
    lib = _build.load_library()
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        part = [x[lo:hi] for x in args[:2]] + list(args[2:4]) \
            + [x[lo:hi] for x in args[4:13]] + [params]
        with torch.cuda.device(codes.device):
            rc = lib.mode_b_cols(
                *[_ptr(x) for x in part], hi - lo, L, R, S, n_d,
                _IMPOSSIBLE, _THRESH, threads,
                None if ws is None else _ptr(ws), _ptr(out[lo:hi]),
                _stream(codes.device))
        _raise_on(rc, "mode_b_cols")
        launches["mode_b_cols"] += 1
    return out
