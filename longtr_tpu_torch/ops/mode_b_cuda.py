"""Wrappers of the hand-written CUDA mode-B kernels (``csrc/mode_b.cu``,
``csrc/mode_b_artifacts.cu``).

- :func:`mode_b_artifacts` builds the artifact tables on the card; the
  plain version is
  :func:`longtr_tpu_torch.ops.mode_b_artifacts.mode_b_artifacts_plain`.
  Its warp kernel takes one block a table and up to 16 read segments of
  its side, their bytes and prefix sums staged in shared memory (or, one
  segment a block, in a device-memory workspace past about 1.7k columns
  at 13 artifact sizes), and its threads over (artifact size, valid
  column), so that a warp walks one shared descent.
- :func:`mode_b_cols` runs the row DP, the port of
  :func:`longtr_tpu.ops.mode_b_device.mode_b_cols` (the jnp row scan), on
  the tables the artifact kernel wrote.  Rows up to
  :data:`WARP_MAX_WIDTH` columns with at most 16 artifact sizes take the
  warp kernel (one element a warp); wider ones the block kernel (one
  element a block), whose three rows of width L live in shared memory (L
  up to about 19.3k on an H100) or in a device-memory workspace, so no
  width goes to the host.

Each wrapper validates its tensors, allocates its output (and workspace)
with ``torch.empty`` on the inputs' device, launches on the current CUDA
stream without synchronising, raises if the launch is refused, and adds
one to its ``launches`` count per launch.  Given CPU tensors it runs the
plain version and counts nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from longtr_tpu_torch.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu_torch.utils.mathops import LOG_THRESH
from longtr_tpu_torch.ops import _build
from longtr_tpu_torch.ops.mode_b_artifacts import (mode_b_artifacts_plain,
                                                   prefix_doubles)
from longtr_tpu_torch.ops.mode_b_device import mode_b_cols_plain
from longtr_tpu_torch.ops.pairhmm_cuda import (_ptr, _raise_on, _stream,
                                               max_smem_optin)

# Kernel launches; chip_smoke.py zeroes and reads this.
# "mode_b_artifacts" is the artifact tables' warp kernel; "mode_b_cols" is
# the row DP's warp kernel, "mode_b_cols_block" its block kernel.
launches = {"mode_b_artifacts": 0, "mode_b_cols": 0, "mode_b_cols_block": 0}

# Widest rows the router sends to the warp kernel (at most its own limit,
# mode_b_warp_max_width in csrc/mode_b.cu).  A test may lower it to send
# narrower rows to the block kernel.
WARP_MAX_WIDTH = 1024

# Bound on the workspace of one launch; wider batches are split.
WORKSPACE_BYTES = 1 << 30

# Test hook: when set, launches whose shared-memory footprint exceeds this
# many bytes run on the workspace even if they would fit on chip.
smem_limit_bytes = None

# Columns a block of the artifact warp kernel aims at (its 128 threads
# take one each in the prefix phase, n_d each in the walks): it takes
# ceil(ARTIFACT_BLOCK_COLUMNS / Lp) segments, at most 16.  A test may set it
# to vary the segments a block.
ARTIFACT_BLOCK_COLUMNS = 128

# The plain versions' constants, passed to the kernels as they are.
_IMPOSSIBLE = ctypes.c_float(float(np.float32(IMPOSSIBLE)))
_THRESH = ctypes.c_float(float(np.float32(LOG_THRESH)))

ROW_NAMES = ("codes", "quals", "lw_tab", "lc_tab", "prefix", "last",
             "hapchar", "kind", "stut_ord", "A", "tab", "bl", "d0", "dstep",
             "params")
ARTIFACT_NAMES = ("seg_codes", "seg_quals", "seg_len", "lw64", "lc64",
                  "tdesc", "blk_bytes", "upstream", "priors", "int_log")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def threads_for(L: int) -> int:
    """One column per thread, in whole warps, at most 1024."""
    return min(1024, max(32, -(-L // 32) * 32))


def smem_bytes(L: int) -> int:
    """Shared memory of a block-kernel launch of width L on chip."""
    return int(_build.load_library().mode_b_smem_bytes(L))


def _fits(need: int, device) -> bool:
    if smem_limit_bytes is not None and need > smem_limit_bytes:
        return False
    return need <= max_smem_optin(device)


def fits_on_chip(L: int, device) -> bool:
    """Whether the block kernel's rows of width L fit its shared memory."""
    return _fits(smem_bytes(L), device)


def takes_warp(L: int, n_d: int) -> bool:
    """Whether the row DP of width L and n_d artifact sizes takes the warp
    kernel (else the block kernel)."""
    return (L <= WARP_MAX_WIDTH
            and n_d <= _build.load_library().mode_b_warp_max_nd())


def _check(names, args, dtypes, want):
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: the kernel takes CUDA tensors")
    for name, x, dt in zip(names, args, dtypes):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {names[0]} on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{want[name]}")


def _check_rows(args, n_d):
    codes, hapchar, A, tab = args[0], args[6], args[9], args[10]
    if codes.dim() != 2 or hapchar.dim() != 2 or A.dim() != 3 \
            or tab.dim() != 2:
        raise ValueError("codes, hapchar, A and tab must be (B, L), (B, R), "
                         "(NT, n_d, L) and (B, S)")
    B, L = codes.shape
    R = hapchar.shape[1]
    S = tab.shape[1]
    NT = A.shape[0]
    u8, i32, f32 = torch.uint8, torch.int32, torch.float32
    _check(ROW_NAMES, args,
           (u8, u8, f32, f32, f32, i32, u8, u8, u8, f32, i32, i32, i32, i32,
            f32),
           {"quals": (B, L), "prefix": (B, L), "last": (B,),
            "hapchar": (B, R), "kind": (B, R), "stut_ord": (B, R),
            "A": (NT, n_d, L), "tab": (B, S), "bl": (B, S), "d0": (B, S),
            "dstep": (B, S), "lw_tab": (256,), "lc_tab": (256,),
            "params": (7,)})
    if L < 1 or R < 1 or S < 1 or NT < 1 or n_d < 1:
        raise ValueError(f"L={L}, R={R}, S={S}, NT={NT}, n_d={n_d}: each "
                         "must be >= 1")
    return B, L, R, S, NT


def mode_b_cols(codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
                stut_ord, A, tab, bl, d0, dstep, params, *, n_d,
                variant: str | None = None, threads: int | None = None):
    """(B, R) float32 M[row, last] of a mode-B batch; the CUDA kernels.

    Arguments as :func:`~longtr_tpu_torch.ops.mode_b_device.mode_b_cols_plain`,
    float32 tables only.  ``variant`` ("warp" or "block") overrides the
    route by width; ``threads`` sets the block kernel's threads.
    """
    args = (codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
            stut_ord, A, tab, bl, d0, dstep, params)
    if codes.device.type == "cpu":
        return mode_b_cols_plain(*args, n_d=n_d)
    B, L, R, S, NT = _check_rows(args, n_d)
    variant = variant or ("warp" if takes_warp(L, n_d) else "block")
    out = torch.empty((B, R), dtype=torch.float32, device=codes.device)
    if B == 0:
        return out
    lib = _build.load_library()
    dims = (R, S, NT, n_d, _IMPOSSIBLE, _THRESH)
    if variant == "warp":
        if L > lib.mode_b_warp_max_width() or n_d > lib.mode_b_warp_max_nd():
            raise ValueError(f"L={L}, n_d={n_d}: the warp kernel takes at "
                             f"most {lib.mode_b_warp_max_width()} columns "
                             f"and {lib.mode_b_warp_max_nd()} artifact sizes")
        with torch.cuda.device(codes.device):
            rc = lib.mode_b_cols_warp(*[_ptr(x) for x in args], B, L, *dims,
                                      _ptr(out), _stream(codes.device))
        _raise_on(rc, "mode_b_cols_warp")
        launches["mode_b_cols"] += 1
        return out
    if variant != "block":
        raise ValueError(f"variant {variant!r}: warp or block")
    threads = threads or threads_for(L)
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads={threads}: a multiple of 32 in [32, 1024]")
    on_chip = fits_on_chip(L, codes.device)
    step = B if on_chip else max(1, WORKSPACE_BYTES // (12 * L))
    ws = None if on_chip else torch.empty((min(B, step), 3, L),
                                          dtype=torch.float32,
                                          device=codes.device)
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        part = [x if name in ("lw_tab", "lc_tab", "A", "params") else x[lo:hi]
                for name, x in zip(ROW_NAMES, args)]
        with torch.cuda.device(codes.device):
            rc = lib.mode_b_cols_block(
                *[_ptr(x) for x in part], hi - lo, L, *dims, threads,
                None if ws is None else _ptr(ws), _ptr(out[lo:hi]),
                _stream(codes.device))
        _raise_on(rc, "mode_b_cols_block")
        launches["mode_b_cols_block"] += 1
    return out


def artifact_plan(Lp: int, n_d: int, P: int, n_log: int, device):
    """(segments a block, region on chip) of an artifact warp-kernel
    launch over P segments of width Lp, with ``n_log`` int_log entries:
    the segments that hold about :data:`ARTIFACT_BLOCK_COLUMNS` columns,
    lowered until the block's region fits in shared memory; else one
    segment a block on the workspace."""
    if n_d * Lp >= 2 ** 31:
        raise ValueError(f"n_d={n_d}, Lp={Lp}: the warp kernel indexes a "
                         "segment's n_d * Lp outputs in 32 bits")
    lib = _build.load_library()
    G = min(-(-ARTIFACT_BLOCK_COLUMNS // Lp), P,
            lib.mode_b_artifacts_max_segments(), (2 ** 31 - 1) // (n_d * Lp))
    pre_n = prefix_doubles(n_d)
    for g in range(max(G, 1), 0, -1):
        if _fits(lib.mode_b_artifacts_warp_smem_bytes(Lp, n_d, pre_n, n_log,
                                                      g), device):
            return g, True
    return 1, False


def _check_artifacts(args, n_d, dtype):
    seg_codes, tdesc = args[0], args[5]
    if seg_codes.dim() != 3 or seg_codes.shape[0] != 2 or tdesc.dim() != 2:
        raise ValueError("seg_codes and tdesc must be (2, P, Lp) and (T, 9)")
    _, P, Lp = seg_codes.shape
    T = tdesc.shape[0]
    u8, i32, f64 = torch.uint8, torch.int32, torch.float64
    _check(ARTIFACT_NAMES, args, (u8, u8, i32, f64, f64, i32, u8, i32, f64,
                                  f64),
           {"seg_quals": (2, P, Lp), "seg_len": (2, P), "lw64": (256,),
            "lc64": (256,), "tdesc": (T, 9), "priors": (T, n_d)})
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: float32 or float64")
    if P < 1 or Lp < 1 or T < 1 or n_d < 1:
        raise ValueError(f"P={P}, Lp={Lp}, T={T}, n_d={n_d}: each must be "
                         ">= 1")
    return P, Lp, T


def mode_b_artifacts(seg_codes, seg_quals, seg_len, lw64, lc64, tdesc,
                     blk_bytes, upstream, priors, int_log, *, n_d,
                     dtype=torch.float32):
    """(T * P, n_d, Lp) artifact tables in ``dtype`` (float32, or float64
    to see the card's values before the cast); the CUDA warp kernel
    (:func:`artifact_plan` sets its segments a block).  Arguments as
    :func:`~longtr_tpu_torch.ops.mode_b_artifacts.mode_b_artifacts_plain`.
    """
    args = (seg_codes, seg_quals, seg_len, lw64, lc64, tdesc, blk_bytes,
            upstream, priors, int_log)
    if seg_codes.device.type == "cpu":
        return mode_b_artifacts_plain(*args, n_d=n_d, dtype=dtype)
    P, Lp, T = _check_artifacts(args, n_d, dtype)
    dev = seg_codes.device
    out = torch.empty((T * P, n_d, Lp), dtype=dtype, device=dev)
    pre_n = prefix_doubles(n_d)
    out64 = int(dtype == torch.float64)
    lib = _build.load_library()
    consts = (float(IMPOSSIBLE), LOG_THRESH)
    n_log = int_log.shape[0]
    G, on_chip = artifact_plan(Lp, n_d, P, n_log, dev)
    nblk = T * -(-P // G)
    ws_doubles = lib.mode_b_artifacts_warp_ws_doubles(Lp, pre_n)
    step = nblk if on_chip else max(1, WORKSPACE_BYTES // (8 * ws_doubles))
    ws = None if on_chip else torch.empty((min(nblk, step), ws_doubles),
                                          dtype=torch.float64, device=dev)
    for lo in range(0, nblk, step):
        hi = min(nblk, lo + step)
        with torch.cuda.device(dev):
            rc = lib.mode_b_artifacts_warp(
                *[_ptr(x) for x in args], P, Lp, n_d, pre_n, n_log, G,
                *consts, lo, hi - lo,
                None if ws is None else _ptr(ws), out64, _ptr(out),
                _stream(dev))
        _raise_on(rc, "mode_b_artifacts_warp")
        launches["mode_b_artifacts"] += 1
    return out
