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
    U8P = ctypes.POINTER(ctypes.c_uint8)
    I32P = ctypes.POINTER(ctypes.c_int32)
    I64P = ctypes.POINTER(ctypes.c_int64)
    lib.ltr_bam_decode.argtypes = [
        U8P, ctypes.c_int64, ctypes.c_int64,            # buffer, records
        I32P, I64P,                                     # fixed, offsets
        U8P, ctypes.c_int64,                            # names
        U8P, I32P, ctypes.c_int64,                      # cigars
        U8P, U8P, ctypes.c_int64,                       # seqs, quals
        U8P, ctypes.c_int64,                            # tags
        I32P, I64P, U8P]                                # ref_lens, columns
    if hasattr(lib, "ltr_trim_expand_batch"):
        # Buffers go as plain addresses (``arr.ctypes.data``): data_as()
        # costs microseconds a buffer, and this runs once a locus.
        VP = ctypes.c_void_p
        I64 = ctypes.c_int64
        lib.ltr_trim_expand_batch.restype = I64
        lib.ltr_trim_expand_batch.argtypes = [
            ctypes.c_char_p, I64, I64,                  # chrom window
            VP, I64,                                    # read rows
            I64, I64, I64,                              # trim bounds
            I64, I64,                                   # region
            VP, VP, I64,                                # out cigar
            VP, I64,                                    # out aln
            VP, VP, I64,                                # out seq/qual
            VP, VP, VP,                                 # out offsets
            VP]                                         # meta
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
    """Columnar decode of a BAM record region.

    Beside the records' fields and pools, the decode leaves what the read
    filter asks of every record at each locus it overlaps: ``qual_sums``
    (each record's summed phred+33 quality bytes) and ``facts`` ((n, 3)
    uint8: has an 'N', first and last CIGAR op character, 0 without a
    CIGAR).  A record built from row i carries ``(batch, i)`` as its
    ``_src`` (io/bam.py), and is read through it at every locus."""

    __slots__ = ("n", "fixed", "offsets", "names", "cigar_ops", "cigar_lens",
                 "seqs", "quals", "tags", "ref_lens", "qual_sums", "facts",
                 "_gates", "_trim_rows")

    def __init__(self, n, fixed, offsets, names, cigar_ops, cigar_lens,
                 seqs, quals, tags, ref_lens, qual_sums, facts):
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
        self.qual_sums = qual_sums
        self.facts = facts
        self._gates = None
        self._trim_rows = None

    def read_gates(self):
        """Per record, ``(has an 'N', mean base quality, hard-clipped at
        an edge)``: ``"N" in rec.seq``, ``filters.mean_phred(rec.qual)``
        and ``rec.starts_with_hard_clip() or rec.ends_with_hard_clip()``
        of the record built from that row.  Built once a batch."""
        if self._gates is None:
            n = self.n
            l_seq = self.fixed[:n, 7].astype(np.int64)
            facts = self.facts[:n]
            # Sums and lengths below 2**53 are exact as float64, so the
            # quotient is mean_phred's int / int bit for bit (0.0 empty).
            mean = (self.qual_sums[:n] - 33 * l_seq) / np.maximum(l_seq, 1)
            hard = (facts[:, 1] == ord("H")) | (facts[:, 2] == ord("H"))
            self._gates = list(zip(facts[:, 0].astype(bool).tolist(),
                                   mean.tolist(), hard.tolist()))
        return self._gates

    def trim_rows(self):
        """Per record, its row of :func:`trim_expand_batch`'s read table:
        the addresses of its sequence, qualities, CIGAR ops and CIGAR
        lengths in this batch's columns, its length, CIGAR count, pos and
        end.  Built once a batch."""
        if self._trim_rows is None:
            n = self.n
            o = self.offsets[:n]
            rows = np.empty((n, 8), np.int64)
            rows[:, 0] = self.seqs.ctypes.data + o[:, 4]
            rows[:, 1] = self.quals.ctypes.data + o[:, 5]
            rows[:, 2] = self.fixed[:n, 7]
            rows[:, 3] = self.cigar_ops.ctypes.data + o[:, 2]
            rows[:, 4] = self.cigar_lens.ctypes.data + 4 * o[:, 2]
            rows[:, 5] = o[:, 3]
            rows[:, 6] = self.fixed[:n, 1]
            rows[:, 7] = rows[:, 6] + self.ref_lens[:n]
            self._trim_rows = rows.tolist()
        return self._trim_rows

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
                            np.zeros(0, np.int32), np.zeros(0, np.int64),
                            np.zeros((0, 3), np.uint8))
    fixed = np.zeros((n_rec, 8), dtype=np.int32)
    offsets = np.zeros((n_rec, 8), dtype=np.int64)
    names = np.zeros(len(buf), dtype=np.uint8)
    cigar_ops = np.zeros(len(buf) // 4 + 16, dtype=np.uint8)
    cigar_lens = np.zeros(len(buf) // 4 + 16, dtype=np.int32)
    seqs = np.zeros(2 * len(buf) + 16, dtype=np.uint8)
    quals = np.zeros(2 * len(buf) + 16, dtype=np.uint8)
    tags = np.zeros(len(buf), dtype=np.uint8)
    ref_lens = np.zeros(n_rec, dtype=np.int32)
    qual_sums = np.zeros(n_rec, dtype=np.int64)
    facts = np.zeros((n_rec, 3), dtype=np.uint8)

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
        ref_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qual_sums.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), P(facts))
    if got < 0:
        return None
    return DecodedBatch(int(got), fixed, offsets, names, cigar_ops,
                        cigar_lens, seqs, quals, tags, ref_lens, qual_sums,
                        facts)


def _copied_rows(recs):
    """Read-table rows (see :meth:`DecodedBatch.trim_rows`) of records
    that carry no decode batch, over buffers made from their sequence,
    qualities and CIGAR, or None where a record's qualities are not as
    long as its sequence.  Returns (rows, buffers to keep alive)."""
    seqs = [rec.seq.encode() for rec in recs]
    quals = [rec.qual.encode() for rec in recs]
    if any(len(s) != len(q) for s, q in zip(seqs, quals)):
        return None
    cigars = [rec.cigar for rec in recs]
    ops = np.frombuffer(
        "".join(op for cig in cigars for op, _ in cig).encode(), np.uint8)
    lens = np.fromiter((n for cig in cigars for _, n in cig), np.int32,
                       len(ops))
    sbuf = np.frombuffer(b"".join(seqs), np.uint8)
    qbuf = np.frombuffer(b"".join(quals), np.uint8)
    rows = []
    s_off = c_off = 0
    for rec, s, cig in zip(recs, seqs, cigars):
        rows.append([sbuf.ctypes.data + s_off, qbuf.ctypes.data + s_off,
                     len(s), ops.ctypes.data + c_off,
                     lens.ctypes.data + 4 * c_off, len(cig), rec.pos,
                     rec.end_pos])
        s_off += len(s)
        c_off += len(cig)
    return rows, (sbuf, qbuf, ops, lens)


def trim_expand_batch(chrom_window: bytes, chrom_off: int, recs,
                      min_read_start: int, max_read_stop: int,
                      flank_size: int, region_start: int, region_stop: int):
    """Batched trim + CIGAR expansion for one locus's reads (native).

    A read from a decoded BAM window (one whose ``_src`` names its batch
    and row) is handed over as the addresses of its row in the batch's
    columns; the others' sequences, qualities and CIGARs are copied into
    buffers for the call.  Returns (meta, ops, lens, cig_offs, aln,
    aln_offs, seq, qual, seq_offs) or None if the library is unavailable
    (caller falls back to the Python trim_alignment + expand_cigar_vs_ref
    pair, which this transcribes).  meta holds one list a read: [status,
    new_pos, new_end, ltrim, rtrim, n_cigar, aln_len, deleted]; status
    0=keep 1=overlap_fail 2=softclip_fail 3=del_alignment 4=bad_cigar.
    A kept read k's expanded CIGAR is ``zip(ops, lens)[cig_offs[k]:
    cig_offs[k + 1]]``, its alignment string, trimmed upper-cased
    sequence and trimmed qualities the same slices of ``aln``, ``seq``
    and ``qual`` by ``aln_offs`` and ``seq_offs``.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "ltr_trim_expand_batch"):
        return None
    R = len(recs)
    rows = []
    copied = []
    for k, rec in enumerate(recs):
        src = rec.__dict__.get("_src")
        if src is not None:
            rows.append(src[0].trim_rows()[src[1]])
        else:
            rows.append(None)
            copied.append(k)
    buffers = None
    if copied:
        got = _copied_rows([recs[k] for k in copied])
        if got is None:
            return None
        rows_copied, buffers = got
        for k, row in zip(copied, rows_copied):
            rows[k] = row
    table = np.array(rows, np.int64).reshape(R, 8)
    tot_s = int(table[:, 2].sum())
    tot_c = int(table[:, 5].sum())
    cig_cap = tot_c + tot_s + 16
    aln_cap = tot_s + R * max(max_read_stop - min_read_start + 2, 2) + 16
    seq_cap = tot_s + 16
    out_ops = np.empty(cig_cap, np.uint8)
    out_lens = np.empty(cig_cap, np.int32)
    out_aln = np.empty(aln_cap, np.uint8)
    out_seq = np.empty(seq_cap, np.uint8)
    out_qual = np.empty(seq_cap, np.uint8)
    cig_offs = np.zeros(R + 1, np.int64)
    aln_offs = np.zeros(R + 1, np.int64)
    seq_offs = np.zeros(R + 1, np.int64)
    meta = np.zeros(R * 8, np.int64)
    rc = lib.ltr_trim_expand_batch(
        chrom_window, chrom_off, len(chrom_window), table.ctypes.data, R,
        min_read_start, max_read_stop, flank_size, region_start, region_stop,
        out_ops.ctypes.data, out_lens.ctypes.data, cig_cap,
        out_aln.ctypes.data, aln_cap,
        out_seq.ctypes.data, out_qual.ctypes.data, seq_cap,
        cig_offs.ctypes.data, aln_offs.ctypes.data, seq_offs.ctypes.data,
        meta.ctypes.data)
    del buffers              # the copied rows' buffers: alive through the call
    if rc != 0:
        return None
    n_c, n_a, n_s = int(cig_offs[-1]), int(aln_offs[-1]), int(seq_offs[-1])
    return (meta.reshape(R, 8).tolist(),
            out_ops[:n_c].tobytes().decode(), out_lens[:n_c].tolist(),
            cig_offs.tolist(), out_aln[:n_a].tobytes().decode(),
            aln_offs.tolist(), out_seq[:n_s].tobytes().decode(),
            out_qual[:n_s].tobytes().decode(), seq_offs.tolist())
