"""ctypes bindings for the native I/O library (with auto-build + fallback).

The reference's I/O layer is native C (htslib); this module provides the
equivalent native fast paths for our BAM/BGZF implementation.  If the shared
library is absent it is built on first import (g++ is baked into the image);
if that fails, callers fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
# Built beside the CUDA kernels, in the package's git-ignored _build/.
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "liblongtr_native.so")
_lib = None


def _build():
    src = os.path.join(_DIR, "longtr_native.cc")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Built under a temporary name and renamed, so that processes building
    # at once never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    # -ffp-contract=off: the pair-HMM mirrors the plain scan's f32
    # expression order; FMA contraction would change last-ulp results and
    # break the bit-identity invariant with the device paths.
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-o", tmp, src, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library or None if unavailable (or LONGTR_NO_NATIVE set)."""
    global _lib
    if os.environ.get("LONGTR_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    src = os.path.join(_DIR, "longtr_native.cc")
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
    if stale:
        try:
            _build()
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.ltr_bgzf_total_isize.restype = ctypes.c_int64
    lib.ltr_bgzf_total_isize.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ltr_bgzf_inflate_all.restype = ctypes.c_int64
    lib.ltr_bgzf_inflate_all.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    if hasattr(lib, "ltr_bgzf_inflate_mt"):
        lib.ltr_bgzf_inflate_mt.restype = ctypes.c_int64
        lib.ltr_bgzf_inflate_mt.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int]
    lib.ltr_bam_count_records.restype = ctypes.c_int64
    lib.ltr_bam_count_records.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    if hasattr(lib, "ltr_edit_distance_banded"):
        lib.ltr_edit_distance_banded.restype = ctypes.c_long
        lib.ltr_edit_distance_banded.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    if hasattr(lib, "ltr_edit_distance_banded_scalar"):
        lib.ltr_edit_distance_banded_scalar.restype = ctypes.c_long
        lib.ltr_edit_distance_banded_scalar.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    if hasattr(lib, "ltr_edit_distance_batch"):
        lib.ltr_edit_distance_batch.restype = ctypes.c_long
        lib.ltr_edit_distance_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long]
    lib.ltr_rans_decode.restype = ctypes.c_int
    lib.ltr_rans_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.c_char_p, ctypes.c_long]
    lib.ltr_pairhmm_batch.restype = None
    lib.ltr_pairhmm_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]
    lib.ltr_pairhmm_batch_f64.restype = None
    lib.ltr_pairhmm_batch_f64.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double)]
    lib.ltr_poa_consensus.restype = ctypes.c_long
    lib.ltr_poa_consensus.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.c_long, ctypes.c_char_p,
                                      ctypes.c_long]
    lib.ltr_bam_decode.restype = ctypes.c_int64
    if hasattr(lib, "ltr_trim_expand_batch"):
        I64P = ctypes.POINTER(ctypes.c_int64)
        lib.ltr_trim_expand_batch.restype = ctypes.c_int64
        lib.ltr_trim_expand_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,    # chrom window
            ctypes.c_char_p, I64P,                              # seqs
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), I64P,               # cigars
            I64P, I64P, ctypes.c_int64,                         # pos/end/R
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # trim bounds
            ctypes.c_int64, ctypes.c_int64,                     # region
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,     # out cigar
            ctypes.c_char_p, ctypes.c_int64,                    # out aln
            I64P, I64P,                                         # out offsets
            I64P]                                               # meta
    _lib = lib
    return _lib


def pairhmm_batch_native(hap, hap_len, read, read_len, full_hap_len,
                         trans) -> "np.ndarray | None":
    """Native batch pair-HMM; None if the library is unavailable.
    Bit-identical to the jnp scan (same f32 op order, no FMA)."""
    lib = get_lib()
    if lib is None:
        return None
    hap = np.ascontiguousarray(hap, dtype=np.uint8)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    hl = np.ascontiguousarray(hap_len, dtype=np.int32)
    rl = np.ascontiguousarray(read_len, dtype=np.int32)
    fl = np.ascontiguousarray(full_hap_len, dtype=np.int32)
    tr = np.ascontiguousarray(trans, dtype=np.float32)
    B, N = hap.shape
    M = read.shape[1]
    out = np.empty(B, dtype=np.float32)
    lib.ltr_pairhmm_batch(
        hap.ctypes.data_as(ctypes.c_char_p),
        read.ctypes.data_as(ctypes.c_char_p),
        hl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        B, N, M,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def pairhmm_batch_native_f64(hap, hap_len, read, read_len, full_hap_len,
                             trans) -> "np.ndarray | None":
    """Reference-fidelity f64 batch pair-HMM (double DP, float constants;
    bit-identical to the compiled reference align_seq_to_hap).  None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    hap = np.ascontiguousarray(hap, dtype=np.uint8)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    hl = np.ascontiguousarray(hap_len, dtype=np.int32)
    rl = np.ascontiguousarray(read_len, dtype=np.int32)
    fl = np.ascontiguousarray(full_hap_len, dtype=np.int32)
    tr = np.ascontiguousarray(trans, dtype=np.float32)
    B, N = hap.shape
    M = read.shape[1]
    out = np.empty(B, dtype=np.float64)
    lib.ltr_pairhmm_batch_f64(
        hap.ctypes.data_as(ctypes.c_char_p),
        read.ctypes.data_as(ctypes.c_char_p),
        hl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        B, N, M,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def poa_consensus(seqs) -> str | None:
    """Native POA consensus; None if the library is unavailable (caller
    falls back to the Python implementation)."""
    lib = get_lib()
    if lib is None:
        return None
    blobs = [s.encode() for s in seqs]
    cat = b"".join(blobs)
    lens = (ctypes.c_long * len(blobs))(*[len(b) for b in blobs])
    cap = sum(len(b) for b in blobs) + 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.ltr_poa_consensus(cat, lens, len(blobs), out, cap)
    if n < 0:
        return None
    return out.raw[:n].decode()


def edit_distance_banded(a: str, b: str, threshold: int) -> int | None:
    """Native unit-cost NW edit distance with threshold early-abort;
    value-identical to haplotype.cluster.edit_distance_banded.  None if the
    library is unavailable (caller falls back to the numpy implementation)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ltr_edit_distance_banded"):
        return None
    return int(lib.ltr_edit_distance_banded(a.encode(), len(a),
                                            b.encode(), len(b), threshold))


def edit_distance_banded_scalar(a: str, b: str, threshold: int) -> int | None:
    """The pre-round-4 scalar band DP, kept exported purely as a
    differential-fuzz oracle for the bit-parallel path."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ltr_edit_distance_banded_scalar"):
        return None
    return int(lib.ltr_edit_distance_banded_scalar(
        a.encode(), len(a), b.encode(), len(b), threshold))


def edit_distance_batch(a: str, bs: list, threshold: int,
                        nthreads: int = 0) -> list | None:
    """Distances from ``a`` to every sequence in ``bs`` (one native call,
    threaded over candidates; ``nthreads`` caps the worker count, 0 =
    hardware).  Value-identical to per-pair edit_distance_banded.  None
    if the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ltr_edit_distance_batch"):
        return None
    blobs = [b.encode() for b in bs]
    lens = (ctypes.c_long * len(blobs))(*[len(b) for b in blobs])
    out = (ctypes.c_long * len(blobs))()
    lib.ltr_edit_distance_batch(a.encode(), len(a), b"".join(blobs), lens,
                                len(blobs), threshold, out, nthreads)
    return list(out)


def rans_decode(data: bytes, out_sz: int) -> bytes | None:
    """Native rANS-4x8 block decode; None if the library is unavailable
    or the input is malformed (caller falls back to the Python decoder)."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(out_sz)
    rc = lib.ltr_rans_decode(data, len(data), out, out_sz)
    if rc != 0:
        return None
    return out.raw


def bgzf_inflate_all(data: bytes) -> bytes | None:
    """Native whole-buffer BGZF inflation; None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    total = lib.ltr_bgzf_total_isize(data, len(data))
    if total < 0:
        return None
    out = np.empty(total, dtype=np.uint8)
    dst = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if hasattr(lib, "ltr_bgzf_inflate_mt"):
        from longtr_tpu_torch.utils.workers import available_cores
        n = lib.ltr_bgzf_inflate_mt(data, len(data), dst, total,
                                    min(available_cores(), 8))
    else:
        n = lib.ltr_bgzf_inflate_all(data, len(data), dst, total)
    if n < 0:
        return None
    return out[:n].tobytes()


class DecodedBatch:
    """Columnar decode of a BAM record region."""

    __slots__ = ("n", "fixed", "offsets", "names", "cigar_ops", "cigar_lens",
                 "seqs", "quals", "tags", "ref_lens")

    def __init__(self, n, fixed, offsets, names, cigar_ops, cigar_lens,
                 seqs, quals, tags, ref_lens=None):
        self.n = n
        self.fixed = fixed
        self.offsets = offsets
        self.names = names
        self.cigar_ops = cigar_ops
        self.cigar_lens = cigar_lens
        self.seqs = seqs
        self.quals = quals
        self.tags = tags
        self.ref_lens = ref_lens

    def record_fields(self, i):
        """(ref_id, pos, mapq, flag, mate_ref, mate_pos, tlen, l_seq)."""
        return tuple(self.fixed[i].tolist())

    def name(self, i):
        o, ln = self.offsets[i, 0], self.offsets[i, 1]
        return self.names[o: o + ln].tobytes().decode()

    def cigar(self, i):
        o, cn = self.offsets[i, 2], self.offsets[i, 3]
        ops = self.cigar_ops[o: o + cn].tobytes().decode()
        return list(zip(ops, self.cigar_lens[o: o + cn].tolist()))

    def seq(self, i):
        o, l = self.offsets[i, 4], self.fixed[i, 7]
        return self.seqs[o: o + l].tobytes().decode()

    def qual(self, i):
        o, l = self.offsets[i, 5], self.fixed[i, 7]
        return self.quals[o: o + l].tobytes().decode()

    def tag_blob(self, i):
        o, ln = self.offsets[i, 6], self.offsets[i, 7]
        return self.tags[o: o + ln].tobytes()


def bam_decode(buf: bytes, max_records: int | None = None):
    """Columnar decode of records in an uncompressed BAM region; None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(buf, dtype=np.uint8)
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n_rec = lib.ltr_bam_count_records(ptr, len(buf))
    if max_records is not None:
        n_rec = min(n_rec, max_records)
    if n_rec <= 0:
        z8 = np.zeros(0, np.uint8)
        return DecodedBatch(0, np.zeros((0, 8), np.int32),
                            np.zeros((0, 8), np.int64),
                            z8, z8, np.zeros(0, np.int32), z8, z8, z8,
                            np.zeros(0, np.int32))
    fixed = np.zeros((n_rec, 8), dtype=np.int32)
    offsets = np.zeros((n_rec, 8), dtype=np.int64)
    names = np.zeros(len(buf), dtype=np.uint8)
    cigar_ops = np.zeros(len(buf) // 4 + 16, dtype=np.uint8)
    cigar_lens = np.zeros(len(buf) // 4 + 16, dtype=np.int32)
    seqs = np.zeros(2 * len(buf) + 16, dtype=np.uint8)
    quals = np.zeros(2 * len(buf) + 16, dtype=np.uint8)
    tags = np.zeros(len(buf), dtype=np.uint8)
    ref_lens = np.zeros(n_rec, dtype=np.int32)

    def P(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    got = lib.ltr_bam_decode(
        ptr, ctypes.c_int64(len(buf)), ctypes.c_int64(n_rec),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        P(names), ctypes.c_int64(len(names)),
        P(cigar_ops), cigar_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(cigar_ops)),
        P(seqs), P(quals), ctypes.c_int64(len(seqs)),
        P(tags), ctypes.c_int64(len(tags)),
        ref_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if got < 0:
        return None
    return DecodedBatch(int(got), fixed, offsets, names, cigar_ops,
                        cigar_lens, seqs, quals, tags, ref_lens)


def trim_expand_batch(chrom_window: bytes, chrom_off: int, recs,
                      min_read_start: int, max_read_stop: int,
                      flank_size: int, region_start: int, region_stop: int):
    """Batched trim + CIGAR expansion for one locus's reads (native).

    Returns (meta, out_ops, out_lens, cig_offs, aln_bytes, aln_offs) or
    None if the library is unavailable (caller falls back to the Python
    trim_alignment + expand_cigar_vs_ref pair, which this transcribes).
    meta is (R, 8) int64: [status, new_pos, new_end, ltrim, rtrim,
    n_cigar, aln_len, deleted]; status 0=keep 1=overlap_fail
    2=softclip_fail 3=del_alignment 4=bad_cigar.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "ltr_trim_expand_batch"):
        return None
    R = len(recs)
    seq_off = np.zeros(R + 1, np.int64)
    cig_off = np.zeros(R + 1, np.int64)
    pos = np.zeros(R, np.int64)
    endp = np.zeros(R, np.int64)
    seq_parts = []
    ops_parts = []
    lens_parts = []
    tot_s = tot_c = 0
    for i, rec in enumerate(recs):
        b = rec.seq.encode()
        seq_parts.append(b)
        tot_s += len(b)
        seq_off[i + 1] = tot_s
        cols = None
        if "cigar" not in rec.__dict__:
            cols = rec.__dict__.get("_cig_cols")
        if cols is not None:            # columnar fast path (no tuple list)
            ops_parts.append(cols[0].tobytes())
            lens_parts.append(cols[1])
            tot_c += len(cols[1])
        else:
            cig = rec.cigar
            ops_parts.append("".join(op for op, _ in cig).encode())
            lens_parts.append(np.fromiter((n for _, n in cig),
                                          np.int32, len(cig)))
            tot_c += len(cig)
        cig_off[i + 1] = tot_c
        pos[i] = rec.pos
        endp[i] = rec.end_pos
    seqs = b"".join(seq_parts)
    ops_arr = np.frombuffer(b"".join(ops_parts), np.uint8).copy()
    lens_arr = (np.concatenate(lens_parts) if lens_parts
                else np.zeros(0, np.int32))
    if ops_arr.size == 0:
        ops_arr = np.zeros(1, np.uint8)
        lens_arr = np.zeros(1, np.int32)
    cig_cap = tot_c + tot_s + 16
    aln_cap = tot_s + R * max(max_read_stop - min_read_start + 2, 2) + 16
    out_ops = np.empty(cig_cap, np.uint8)
    out_lens = np.empty(cig_cap, np.int32)
    out_aln = np.empty(aln_cap, np.uint8)
    cig_offs = np.zeros(R + 1, np.int64)
    aln_offs = np.zeros(R + 1, np.int64)
    meta = np.zeros(R * 8, np.int64)
    I64P = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ltr_trim_expand_batch(
        chrom_window, chrom_off, len(chrom_window),
        seqs, seq_off.ctypes.data_as(I64P),
        ops_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig_off.ctypes.data_as(I64P),
        pos.ctypes.data_as(I64P), endp.ctypes.data_as(I64P), R,
        min_read_start, max_read_stop, flank_size,
        region_start, region_stop,
        out_ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cig_cap,
        out_aln.ctypes.data_as(ctypes.c_char_p), aln_cap,
        cig_offs.ctypes.data_as(I64P), aln_offs.ctypes.data_as(I64P),
        meta.ctypes.data_as(I64P))
    if rc != 0:
        return None
    return (meta.reshape(R, 8), out_ops, out_lens, cig_offs,
            out_aln, aln_offs)
