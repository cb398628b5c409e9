"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (the pair-HMM kernels and the mode-B row DP) exposes a
plain C interface, so ``nvcc`` compiles each into an object, all at once,
and links them into one shared library, bound with ``ctypes``: no torch
headers, no ``ninja``.  The build
runs at first use, into ``longtr_tpu_torch/_build/``, and is keyed by a
hash of every source and the flags, so an edited source rebuilds and an
unchanged tree loads at once.  Any failure (no ``nvcc``, a compile error,
a library that does not load) raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")

# --fmad=false: a fused multiply-add would round `m2d + (j-1)*d2d`, the
# mode-B `j*i2i` terms and the other products once instead of twice, which
# breaks bit identity with the plain torch versions and the native scorer
# (built with -ffp-contract=off for the same reason).
NVCC_FLAGS = ("-O3", "-std=c++17",
              "-gencode", "arch=compute_90a,code=sm_90a",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_info = {}   # path, seconds, compiler report of the loaded library


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(default /usr/local/cuda); the CUDA kernels cannot "
                       "be built")


def _run(cmds):
    """Run the commands at once; raise with the first failure's output.
    Returns their standard error, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (_o, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(c[0])} failed "
                               f"({p.returncode}):\n{err}")
    return [err for _o, err in outs]


def _build(out_path: str) -> None:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in SOURCES]
        reports = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for src, obj in zip(SOURCES, objs)])
        so = os.path.join(tmp, "lib.so")
        _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", so, *objs]])
        os.replace(so, out_path)   # atomic: concurrent builders agree
    build_info.update(seconds=time.time() - t0, report="".join(reports))


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pairhmm_resident_smem_bytes.argtypes = [i]
    lib.pairhmm_resident_smem_bytes.restype = ctypes.c_long
    lib.pairhmm_max_smem_optin.argtypes = [i, ctypes.POINTER(i)]
    lib.pairhmm_max_smem_optin.restype = i
    lib.pairhmm_resident.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p]
    lib.pairhmm_resident.restype = i
    for name in ("pairhmm_resident_warp", "pairhmm_resident_block"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p, p]
        fn.restype = i
    lib.pairhmm_streamed.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p]
    lib.pairhmm_streamed.restype = i
    lib.mode_b_smem_bytes.argtypes = [i]
    lib.mode_b_smem_bytes.restype = ctypes.c_long
    lib.mode_b_cols.argtypes = ([p] * 14 + [i] * 5
                                + [ctypes.c_float, ctypes.c_float, i, p, p, p])
    lib.mode_b_cols.restype = i


def load_library():
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            with open(src, "rb") as fh:
                key.update(os.path.basename(src).encode() + b"\0"
                           + fh.read())
        out = os.path.join(BUILD_DIR, f"libkernels_{key.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            _build(out)
        else:
            build_info.update(seconds=0.0, report="")
        lib = ctypes.CDLL(out)
        _bind(lib)
        build_info["path"] = out
        _lib = lib
        return _lib
