"""BAM reading: records, headers, BAI region queries, multi-file merge.

The reference wraps htslib (src/bam_io.{h,cpp}); this is a from-scratch
implementation of the BAM binary format + BAI index on top of our BGZF
reader.  Semantics mirrored from the reference:

* ``end_pos`` is the exclusive reference end (htslib ``bam_endpos``,
  bam_io.cpp:190),
* ``TrimAlignment(min_read_start, max_read_stop)`` trims the read to a
  reference window and flags whole-repeat deletions
  (bam_io.cpp:267-372, incl. the FLANK_SIZE-based deleted_ detection),
* ``BamMultiReader`` merges several files with ORDER_ALNS_BY_FILE, the
  mode the read filter asserts on (bam_processor.cpp:193),
* read-group parsing of @RG ID/SM/LB (bam_io.cpp:43-64).

A native C++ decode path (longtr_tpu_torch/native) can batch-decode records into
columnar arrays; this module is the reference implementation.
"""

from __future__ import annotations

import os
import struct

import numpy as np
from dataclasses import dataclass, field

from longtr_tpu_torch.io.bgzf import BgzfReader
from longtr_tpu_torch.utils.timers import span

FLANK_SIZE = 200  # bam_io.h:28

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"

# SAM flags
FPAIRED = 0x1
FPROPER = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


def cigar_ref_len(cigar) -> int:
    return sum(n for op, n in cigar if op in "MDN=X")


def build_cigar_string(cigar) -> str:
    return "".join(f"{n}{op}" for op, n in cigar)


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int                      # 0-based leftmost
    mapq: int
    cigar: list                   # list of [op_char, length]
    mate_ref_id: int
    mate_pos: int
    tlen: int
    seq: str
    qual: str                     # phred+33 string
    tags: dict
    filename: str = ""
    ref_name: str = ""
    mate_ref_name: str = ""
    deleted: bool = field(default=False)

    def __post_init__(self):
        self.end_pos = self.pos + cigar_ref_len(self.cigar)

    def __getattr__(self, attr):
        # Lazy CIGAR: window-cache records carry columnar (ops, lens) views
        # of the decode batch and only materialize the tuple list when a
        # consumer actually iterates it (the native left-align path never
        # does).
        if attr == "cigar":
            cols = self.__dict__.get("_cig_cols")
            if cols is not None:
                c = list(zip(cols[0].tobytes().decode(), cols[1].tolist()))
                self.cigar = c
                return c
        raise AttributeError(attr)

    @property
    def n_cigar(self) -> int:
        """CIGAR op count without materializing the tuple list."""
        if "cigar" not in self.__dict__:
            cols = self.__dict__.get("_cig_cols")
            if cols is not None:
                return len(cols[1])
        return len(self.cigar)

    def _edge_op(self, last: bool) -> str:
        if "cigar" not in self.__dict__:
            cols = self.__dict__.get("_cig_cols")
            if cols is not None:
                ops = cols[0]
                if not len(ops):
                    return ""
                return chr(ops[-1] if last else ops[0])
        c = self.cigar
        if not c:
            return ""
        return c[-1][0] if last else c[0][0]

    @classmethod
    def raw(cls, name, flag, ref_id, pos, mapq, cigar, mate_ref_id, mate_pos,
            tlen, seq, qual, tags, filename, ref_name, mate_ref_name,
            end_pos):
        """Fast constructor with a precomputed end_pos (no CIGAR walk).

        ``cigar=None`` defers to a columnar ``_cig_cols = (ops, lens)``
        attribute the caller must set (see ``__getattr__``)."""
        rec = object.__new__(cls)
        rec.name = name
        rec.flag = flag
        rec.ref_id = ref_id
        rec.pos = pos
        rec.mapq = mapq
        if cigar is not None:
            rec.cigar = cigar
        rec.mate_ref_id = mate_ref_id
        rec.mate_pos = mate_pos
        rec.tlen = tlen
        rec.seq = seq
        rec.qual = qual
        rec.tags = tags
        rec.filename = filename
        rec.ref_name = ref_name
        rec.mate_ref_name = mate_ref_name
        rec.deleted = False
        rec.end_pos = end_pos
        return rec

    def clone(self):
        """Fresh copy safe to hand downstream (trims mutate in place).

        The CIGAR list is shallow-copied: trim_alignment deep-copies it
        before any element mutation.  An unmaterialized columnar CIGAR is
        shared (the decode-batch views are never mutated).
        """
        lazy = "cigar" not in self.__dict__ and \
            self.__dict__.get("_cig_cols") is not None
        rec = BamRecord.raw(
            self.name, self.flag, self.ref_id, self.pos, self.mapq,
            None if lazy else list(self.cigar), self.mate_ref_id,
            self.mate_pos, self.tlen,
            self.seq, self.qual, dict(self.tags), self.filename,
            self.ref_name, self.mate_ref_name, self.end_pos)
        if lazy:
            rec._cig_cols = self._cig_cols
        return rec

    # -- flag helpers (bam_io.h) -------------------------------------------
    @property
    def is_mapped(self):
        return not (self.flag & FUNMAP)

    @property
    def is_paired(self):
        return bool(self.flag & FPAIRED)

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)

    @property
    def is_first_mate(self):
        return bool(self.flag & FREAD1)

    @property
    def is_duplicate(self):
        return bool(self.flag & FDUP)

    @property
    def is_secondary(self):
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def length(self):
        return len(self.seq)

    def has_tag(self, tag):
        return tag in self.tags

    def get_tag(self, tag, default=None):
        return self.tags.get(tag, default)

    def starts_with_hard_clip(self):
        return self._edge_op(False) == "H"

    def ends_with_hard_clip(self):
        return self._edge_op(True) == "H"

    def starts_with_soft_clip(self):
        return self._edge_op(False) == "S"

    def ends_with_soft_clip(self):
        return self._edge_op(True) == "S"

    def trim_alignment(self, min_read_start: int, max_read_stop: int):
        """In-place trim to a reference window (bam_io.cpp:267-372).

        Also sets ``deleted`` when the repeat body (the window minus
        FLANK_SIZE padding on each side) is entirely deleted in this read.
        Run-level arithmetic (no per-base loop) — equivalent to the
        reference's base-at-a-time walk; see tests/test_trim_oracle.py.
        """
        cigar = [list(c) for c in self.cigar]
        ltrim = 0
        start_pos = self.pos
        ci = 0
        while start_pos < min_read_start and ci < len(cigar):
            op, n = cigar[ci]
            if op in "M=X":
                take = min(n, min_read_start - start_pos)
                ltrim += take
                start_pos += take
            elif op == "D":
                take = min(n, min_read_start - start_pos)
                start_pos += take
            elif op in "IS":
                take = n
                ltrim += n
            elif op == "H":
                take = n
            else:
                raise ValueError("Invalid CIGAR op in trim_alignment: " + op)
            if take == n:
                ci += 1
            else:
                cigar[ci][1] = n - take
        cigar = cigar[ci:]

        # Whole-repeat deletion detection (bam_io.cpp:304-337)
        repeat_pointer = start_pos
        repeat_start = min_read_start + FLANK_SIZE
        repeat_end = max_read_stop - FLANK_SIZE
        deletion_size = 0
        if repeat_pointer >= min_read_start:
            for op, n in cigar:
                if repeat_pointer >= repeat_end:
                    break
                if op in "M=X":
                    repeat_pointer += min(n, repeat_end - repeat_pointer)
                elif op == "D":
                    take = min(n, repeat_end - repeat_pointer)
                    lo = max(repeat_pointer, repeat_start)
                    hi = repeat_pointer + take
                    if hi > lo:
                        deletion_size += hi - lo
                    repeat_pointer += take
                # I, S, H: no pointer movement; run consumed
        if deletion_size >= (repeat_end - repeat_start):
            self.deleted = True

        rtrim = 0
        end_pos = self.end_pos
        ci = len(cigar)
        while end_pos > max_read_stop and ci > 0:
            op, n = cigar[ci - 1]
            if op in "M=X":
                take = min(n, end_pos - max_read_stop)
                rtrim += take
                end_pos -= take
            elif op == "D":
                take = min(n, end_pos - max_read_stop)
                end_pos -= take
            elif op in "IS":
                take = n
                rtrim += n
            elif op == "H":
                take = n
            else:
                raise ValueError("Invalid CIGAR op in trim_alignment: " + op)
            if take == n:
                ci -= 1
            else:
                cigar[ci - 1][1] = n - take
        cigar = cigar[:ci]

        assert ltrim + rtrim <= len(self.seq)
        self.seq = self.seq[ltrim: len(self.seq) - rtrim]
        self.qual = self.qual[ltrim: len(self.qual) - rtrim]
        self.pos = start_pos
        self.end_pos = end_pos
        self.cigar = [tuple(c) for c in cigar]


@dataclass
class ReadGroup:
    id: str = ""
    sample: str = ""
    library: str = ""


class BamHeader:
    def __init__(self, text: str, ref_names, ref_lengths):
        self.text = text
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self._indices = {n: i for i, n in enumerate(self.ref_names)}
        self.read_groups = []
        for line in text.splitlines():
            if line.startswith("@RG"):
                rg = ReadGroup()
                for tok in line.split("\t")[1:]:
                    if tok.startswith("ID:"):
                        rg.id = tok[3:]
                    elif tok.startswith("SM:"):
                        rg.sample = tok[3:]
                    elif tok.startswith("LB:"):
                        rg.library = tok[3:]
                self.read_groups.append(rg)

    def ref_id(self, name: str) -> int:
        return self._indices.get(name, -1)

    def ref_name(self, rid: int) -> str:
        return self.ref_names[rid] if 0 <= rid < len(self.ref_names) else "*"

    @property
    def num_seqs(self):
        return len(self.ref_names)


# ---------------------------------------------------------------------------
# BAI index
# ---------------------------------------------------------------------------

def _reg2bins(beg: int, end: int):
    """All bins overlapping [beg, end) for the standard 5-level scheme."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise IOError("Not a BAI file: " + path)
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = list(struct.iter_unpack("<QQ", data[off: off + 16 * n_chunk]))
                off += 16 * n_chunk
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            intervals = struct.unpack_from("<%dQ" % n_intv, data, off)
            off += 8 * n_intv
            self.refs.append((bins, intervals))

    def chunks_for(self, ref_id: int, beg: int, end: int):
        """Merged chunk list overlapping [beg, end)."""
        if ref_id < 0 or ref_id >= len(self.refs):
            return []
        bins, intervals = self.refs[ref_id]
        min_off = 0
        win = beg >> 14
        if win < len(intervals):
            min_off = intervals[win]
        chunks = []
        for b in _reg2bins(beg, end):
            if b == 37450:  # pseudo-bin with metadata
                continue
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


# ---------------------------------------------------------------------------
# BAM reader
# ---------------------------------------------------------------------------

def _decode_record(data: bytes, filename: str, header: BamHeader) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    name = data[off: off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", data, off)
        cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
        off += 4
    nseq_bytes = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = data[off + (i >> 1)]
        code = (b >> 4) if i % 2 == 0 else (b & 0xF)
        seq_chars.append(SEQ_NT16[code])
    seq = "".join(seq_chars)
    off += nseq_bytes
    qual = bytes(min(q + 33, 126) for q in data[off: off + l_seq]).decode("ascii") \
        if l_seq else ""
    off += l_seq
    tags = _decode_tags(data, off)
    rec = BamRecord(name, flag, ref_id, pos, mapq, cigar, next_ref, next_pos,
                    tlen, seq, qual, tags, filename,
                    header.ref_name(ref_id), header.ref_name(next_ref))
    return rec


_TAG_FMT = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2), "S": ("<H", 2),
            "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4)}


def _decode_tags(data: bytes, off: int) -> dict:
    tags = {}
    n = len(data)
    while off + 3 <= n:
        tag = data[off: off + 2].decode()
        typ = chr(data[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(data[off])
            off += 1
        elif typ in _TAG_FMT:
            fmt, sz = _TAG_FMT[typ]
            tags[tag] = struct.unpack_from(fmt, data, off)[0]
            off += sz
        elif typ in ("Z", "H"):
            end = data.index(b"\x00", off)
            tags[tag] = data[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(data[off])
            (cnt,) = struct.unpack_from("<I", data, off + 1)
            fmt, sz = _TAG_FMT[sub]
            vals = list(struct.unpack_from("<%d%s" % (cnt, fmt[-1]), data, off + 5))
            tags[tag] = vals
            off += 5 + cnt * sz
        else:
            break
    return tags


class BamReader:
    """Single-file BAM reader with BAI-backed region fetch.

    Mirrors BamCramReader (bam_io.h:441-515) including the forward-seek
    ``min_offset`` optimization for sorted locus processing
    (bam_io.cpp:143-199): successive SetRegion calls on the same chromosome
    reuse the previous stopping offset to narrow the first chunk.
    """

    def __init__(self, path: str, fasta_path: str = ""):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise IOError("Not a BAM file: " + path)
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        text = self._bgzf.read(l_text).decode(errors="replace").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        names, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            names.append(self._bgzf.read(l_name)[:-1].decode())
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            lengths.append(l_ref)
        self.header = BamHeader(text, names, lengths)
        self._data_start = self._bgzf.virtual_offset
        idx_path = path + ".bai"
        if not os.path.exists(idx_path):
            alt = os.path.splitext(path)[0] + ".bai"
            idx_path = alt if os.path.exists(alt) else None
        self.index = BaiIndex(idx_path) if idx_path else None
        # region state
        self._chunks = []
        self._chunk_i = 0
        self._chunk_end = 0
        self._region = None
        self._cur_chrom = ""
        self._min_offset = 0
        self._first_aln_span = None

    def close(self):
        self._bgzf.close()

    def _read_record(self) -> BamRecord | None:
        hdr = self._bgzf.read(4)
        if len(hdr) < 4:
            return None
        (block_size,) = struct.unpack("<i", hdr)
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            return None
        return _decode_record(data, self.path, self.header)

    def set_region(self, chrom: str, start: int, end: int) -> bool:
        """Position the reader to iterate records overlapping [start, end)."""
        rid = self.header.ref_id(chrom)
        if rid < 0:
            return False
        fast = self.fetch_fast(chrom, start, end)
        if fast is not None:
            self._prefetched = fast
            self._prefetch_i = 0
            return True
        self._prefetched = None
        if self.index is None:
            # Sequential fallback for unindexed (coordinate-sorted) BAMs.
            self._cur_chrom = chrom
            self._chunks = [(self._data_start, 1 << 62)]
            self._chunk_i = -1
            self._region = (rid, start, end)
            self._advance_chunk()
            return True
        chunks = self.index.chunks_for(rid, start, end)
        # Forward-seek optimization (bam_io.cpp:143-199): if the previous
        # region's first record doesn't overlap the new region, start the
        # (single) chunk at the offset just past it.
        can_reuse = (self._min_offset != 0 and chrom == self._cur_chrom
                     and self._region is not None and start >= self._region[1])
        if can_reuse and self._first_aln_span is not None:
            fpos, fend = self._first_aln_span
            if fend > start and fpos < end:
                can_reuse = False
        if can_reuse and len(chunks) == 1 and \
                chunks[0][0] <= self._min_offset <= chunks[0][1]:
            chunks = [(self._min_offset, chunks[0][1])]
        self._min_offset = 0
        self._first_aln_span = None
        self._cur_chrom = chrom
        self._chunks = chunks
        self._chunk_i = -1
        self._region = (rid, start, end)
        self._advance_chunk()
        return True

    def _advance_chunk(self) -> bool:
        self._chunk_i += 1
        if self._chunk_i >= len(self._chunks):
            return False
        cb, ce = self._chunks[self._chunk_i]
        self._bgzf.seek_virtual(cb)
        self._chunk_end = ce
        return True

    def get_next_alignment(self) -> BamRecord | None:
        if getattr(self, "_prefetched", None) is not None:
            if self._prefetch_i >= len(self._prefetched):
                return None
            rec = self._prefetched[self._prefetch_i]
            self._prefetch_i += 1
            return rec
        if self._region is None:
            return self._read_record()
        rid, start, end = self._region
        seq_scan = self.index is None
        while self._chunk_i < len(self._chunks):
            while self._bgzf.virtual_offset < self._chunk_end:
                rec = self._read_record()
                if rec is None:
                    break
                if seq_scan and rec.ref_id != rid and (rec.ref_id < rid
                                                       and rec.ref_id >= 0):
                    continue
                if rec.ref_id != rid or rec.pos >= end:
                    self._chunk_i = len(self._chunks)
                    return None
                if rec.end_pos > start:
                    if self._min_offset == 0:
                        # Cache the first returned record (bam_io.cpp:190-196)
                        self._min_offset = self._bgzf.virtual_offset
                        self._first_aln_span = (rec.pos, rec.end_pos)
                    return rec
            if not self._advance_chunk():
                break
        return None

    def fetch(self, chrom: str, start: int, end: int):
        """Convenience: list of records overlapping [start, end)."""
        fast = self.fetch_fast(chrom, start, end)
        if fast is not None:
            return fast
        out = []
        if not self.set_region(chrom, start, end):
            return out
        while True:
            rec = self.get_next_alignment()
            if rec is None:
                break
            out.append(rec)
        return out

    #: Compressed bytes decoded per cache window. Sorted-locus access then
    #: pays one BGZF-inflate + batch-decode per window instead of per locus.
    WINDOW_BYTES = 4 << 20

    def fetch_fast(self, chrom: str, start: int, end: int):
        """Native-accelerated region fetch (C++ BGZF inflate + batch decode).

        Decodes sliding windows of the BAM (``WINDOW_BYTES`` compressed) and
        serves any locus whose BAI chunk is contained in a cached window —
        the TPU-side analog of the reference's forward-seek min_offset cache
        (bam_io.cpp:143-199), but amortized over whole decode windows.
        Returns None when the native library or index is unavailable so the
        caller falls back to the streaming path.
        """
        if self.index is None:
            return None
        native = getattr(self, "_native_mod", None)
        if native is None:
            try:
                from longtr_tpu_torch import native
                if native.get_lib() is None:
                    return None
            except Exception:
                return None
            self._native_mod = native
        rid = self.header.ref_id(chrom)
        if rid < 0:
            return None
        import os
        from bisect import bisect_left
        file_size = getattr(self, "_file_size", None)
        if file_size is None:
            file_size = os.fstat(self._bgzf._fh.fileno()).st_size
            self._file_size = file_size
        if not hasattr(self, "_win_cache"):
            # each entry: [lo, within, hi, batch, positions, runs, max_span,
            #             templates]; at most two windows (current + previous)
            self._win_cache = []
        chunks = self.index.chunks_for(rid, start, end)
        if not chunks:
            return []
        # Serve the query from ONE decode window covering the union of its
        # BAI chunks; scanning that window once by position yields exactly
        # the overlapping records (chunks are a superset filter), with no
        # duplicates across chunks.
        c_start = min(cb >> 16 for cb, _ in chunks)
        within = min((cb & 0xFFFF for cb, _ in chunks
                      if cb >> 16 == c_start), default=0)
        # ce>>16 is the start of the block holding the chunk end; BGZF
        # blocks are <=64KiB compressed, so +0x10000 covers that block.
        c_end = min(max(ce >> 16 for _, ce in chunks) + 0x10000, file_size)
        cached = None
        for w in self._win_cache:
            # Containment: a window decoded from (lo, lo_within) holds
            # every record of any chunk starting at or after that point.
            if w[0] <= c_start and c_end <= w[2] and \
                    (w[0] < c_start or w[1] <= within):
                cached = w
                break
        if cached is None:
            with span("BAM window decode"):
                lo = c_start
                # adaptive window: one-off fetches pay a small decode; sorted
                # scans quickly grow to the full window size
                grow = getattr(self, "_window_bytes", self.WINDOW_BYTES >> 4)
                self._window_bytes = min(grow * 2, self.WINDOW_BYTES)
                hi = min(max(c_end, lo + grow), file_size)
                self._bgzf._fh.seek(lo)
                comp = self._bgzf._fh.read(hi - lo)
                # A partial trailing block is dropped by the inflater; hi
                # still covers the chunk-end block in full (see c_end).
                data = native.bgzf_inflate_all(comp)
                if data is None:
                    return None
                batch = native.bam_decode(data[within:])
                if batch is None:
                    return None
                # positions reset at chromosome boundaries, so record the
                # contiguous index run of each ref_id for a valid bisect
                ref_ids = batch.fixed[:, 0]
                positions = batch.fixed[:, 1].tolist()
                runs = {}
                bounds = np.flatnonzero(np.diff(ref_ids)) + 1 \
                    if batch.n else np.zeros(0, np.int64)
                starts_idx = [0] + list(bounds)
                ends_idx = list(bounds) + [batch.n]
                for lo2, hi2 in zip(starts_idx, ends_idx):
                    if lo2 < hi2:
                        runs[int(ref_ids[lo2])] = [lo2, hi2]
                max_span = int(batch.ref_lens.max()) if batch.n else 1
                max_span = max(max_span, 1)
                cached = [lo, within, hi, batch, positions, runs, max_span, {}]
                self._win_cache.append(cached)
                if len(self._win_cache) > 2:
                    self._win_cache.pop(0)
        _, _, _, batch, positions, runs, max_span, templates = cached
        run = runs.get(rid)
        if run is None:
            return []
        with span("BAM record build"):
            out = []
            i0 = bisect_left(positions, start - max_span, run[0], run[1])
            for i in range(i0, run[1]):
                tmpl = templates.get(i)
                if tmpl is None:
                    ref_id, pos, mapq, flag, mref, mpos, tlen, l_seq = \
                        batch.record_fields(i)
                    if ref_id != rid or pos >= end:
                        break
                    ref_len = int(batch.ref_lens[i])
                    if pos + ref_len <= start:
                        continue
                    tmpl = BamRecord.raw(
                        batch.name(i), flag, ref_id, pos, mapq,
                        None, mref, mpos, tlen, batch.seq(i),
                        batch.qual(i), _decode_tags(batch.tag_blob(i), 0),
                        self.path, self.header.ref_name(ref_id),
                        self.header.ref_name(mref), pos + ref_len)
                    co = batch.offsets[i, 2]
                    cn = batch.offsets[i, 3]
                    tmpl._cig_cols = (batch.cigar_ops[co: co + cn],
                                      batch.cigar_lens[co: co + cn])
                    templates[i] = tmpl
                elif tmpl.ref_id != rid or tmpl.pos >= end:
                    break
                if tmpl.end_pos <= start:
                    continue
                # fresh copy: downstream trims mutate records in place
                out.append(tmpl.clone())
        return out


class BamMultiReader:
    """Merging multi-file reader, ORDER_ALNS_BY_FILE (bam_io.h:516-579)."""

    def __init__(self, paths, fasta_path: str = ""):
        if not paths:
            raise ValueError("No BAM files provided")
        self.readers = []
        for p in paths:
            if p.endswith(".cram"):
                # CRAM decode needs the reference (bam_io.cpp faidx path)
                from longtr_tpu_torch.io.cram import CramReader
                self.readers.append(CramReader(p, fasta_path))
            else:
                self.readers.append(BamReader(p, fasta_path))
        h0 = self.readers[0].header
        for r in self.readers[1:]:
            if (r.header.ref_names != h0.ref_names
                    or r.header.ref_lengths != h0.ref_lengths):
                raise IOError("BAM headers disagree between input files")
        self.header = h0

    def close(self):
        for r in self.readers:
            r.close()

    def set_region(self, chrom: str, start: int, end: int) -> bool:
        ok = True
        for r in self.readers:
            ok &= r.set_region(chrom, start, end)
        self._order = list(range(len(self.readers)))
        self._cur = 0
        return ok

    def get_next_alignment(self) -> BamRecord | None:
        while self._cur < len(self.readers):
            rec = self.readers[self._cur].get_next_alignment()
            if rec is not None:
                return rec
            self._cur += 1
        return None

    def read_groups(self, file_index: int):
        return self.readers[file_index].header.read_groups
