"""BAM writing (reference: BamWriter in src/bam_io.h:580+).

Used for --pass-bam / --filt-bam outputs and for building test fixtures.
Also provides a BAI index builder so written BAMs support region queries.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from longtr_tpu_torch.io.bam import BamRecord, CIGAR_OPS, SEQ_NT16
from longtr_tpu_torch.io.bgzf import BgzfWriter

_NT16_CODE = {ch: i for i, ch in enumerate(SEQ_NT16)}
_QUAL_XLAT = bytes(min(max(i - 33, 0), 93) for i in range(256))
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _ch, _i in _NT16_CODE.items():
    _NT16_LUT[ord(_ch)] = _i
_CIGAR_CODE = {ch: i for i, ch in enumerate(CIGAR_OPS)}


def encode_record(rec: BamRecord) -> bytes:
    name = rec.name.encode() + b"\x00"
    parts = [struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(name),
                         rec.mapq, 0, len(rec.cigar), rec.flag, len(rec.seq),
                         rec.mate_ref_id, rec.mate_pos, rec.tlen)]
    parts.append(name)
    for op, n in rec.cigar:
        parts.append(struct.pack("<I", (n << 4) | _CIGAR_CODE[op]))
    seq = rec.seq
    codes = np.frombuffer(seq.upper().encode(), np.uint8)
    codes = _NT16_LUT[codes]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    packed = (codes[0::2] << 4) | codes[1::2]
    parts.append(packed.astype(np.uint8).tobytes())
    parts.append(rec.qual.encode().translate(_QUAL_XLAT))
    for tag, val in rec.tags.items():
        if isinstance(val, str) and len(val) == 1 and tag in ("XT",):
            parts.append(tag.encode() + b"A" + val.encode())
        elif isinstance(val, str):
            parts.append(tag.encode() + b"Z" + val.encode() + b"\x00")
        elif isinstance(val, int):
            parts.append(tag.encode() + b"i" + struct.pack("<i", val))
        elif isinstance(val, float):
            parts.append(tag.encode() + b"f" + struct.pack("<f", val))
        elif isinstance(val, list):
            parts.append(tag.encode() + b"B" + b"i"
                         + struct.pack("<I", len(val))
                         + struct.pack("<%di" % len(val), *val))
    body = b"".join(parts)
    return struct.pack("<i", len(body)) + body


class BamWriter:
    def __init__(self, path: str, header_text: str, ref_names, ref_lengths):
        self._bgzf = BgzfWriter(path)
        self.path = path
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        text = header_text.encode()
        self._bgzf.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        self._bgzf.write(struct.pack("<i", len(ref_names)))
        for name, length in zip(ref_names, ref_lengths):
            nb = name.encode() + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)) + nb
                             + struct.pack("<i", length))

    def save_alignment(self, rec: BamRecord):
        self._bgzf.write(encode_record(rec))

    def close(self):
        self._bgzf.close()


def build_bai(bam_path: str, out_path: str | None = None):
    """Build a .bai (binning + linear index) for a coordinate-sorted BAM."""
    from longtr_tpu_torch.io.bam import BamReader

    out_path = out_path or bam_path + ".bai"
    r = BamReader.__new__(BamReader)
    from longtr_tpu_torch.io.bgzf import BgzfReader
    r._bgzf = BgzfReader(bam_path)
    magic = r._bgzf.read(4)
    assert magic == b"BAM\x01"
    (l_text,) = struct.unpack("<i", r._bgzf.read(4))
    r._bgzf.read(l_text)
    (n_ref,) = struct.unpack("<i", r._bgzf.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", r._bgzf.read(4))
        r._bgzf.read(l_name + 4)

    # per-ref: bins dict, linear intervals
    refs = [[{}, []] for _ in range(n_ref)]

    def reg2bin(beg, end):
        end -= 1
        if beg >> 14 == end >> 14:
            return ((1 << 15) - 1) // 7 + (beg >> 14)
        if beg >> 17 == end >> 17:
            return ((1 << 12) - 1) // 7 + (beg >> 17)
        if beg >> 20 == end >> 20:
            return ((1 << 9) - 1) // 7 + (beg >> 20)
        if beg >> 23 == end >> 23:
            return ((1 << 6) - 1) // 7 + (beg >> 23)
        if beg >> 26 == end >> 26:
            return ((1 << 3) - 1) // 7 + (beg >> 26)
        return 0

    while True:
        v_start = r._bgzf.virtual_offset
        hdr = r._bgzf.read(4)
        if len(hdr) < 4:
            break
        (block_size,) = struct.unpack("<i", hdr)
        data = r._bgzf.read(block_size)
        if len(data) < block_size:
            break
        v_end = r._bgzf.virtual_offset
        ref_id, pos = struct.unpack_from("<ii", data, 0)
        if ref_id < 0:
            continue
        n_cigar, = struct.unpack_from("<H", data, 12)
        l_read_name = data[8]
        ref_len = 0
        off = 32 + l_read_name
        for k in range(n_cigar):
            (v,) = struct.unpack_from("<I", data, off + 4 * k)
            if CIGAR_OPS[v & 0xF] in "MDN=X":
                ref_len += v >> 4
        end = pos + max(ref_len, 1)
        b = reg2bin(pos, end)
        bins, intervals = refs[ref_id]
        bins.setdefault(b, []).append((v_start, v_end))
        for win in range(pos >> 14, ((end - 1) >> 14) + 1):
            while len(intervals) <= win:
                intervals.append(0)
            if intervals[win] == 0 or v_start < intervals[win]:
                intervals[win] = v_start
    r._bgzf.close()

    with open(out_path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for bins, intervals in refs:
            fh.write(struct.pack("<i", len(bins)))
            for b, chunks in bins.items():
                # merge adjacent chunks
                merged = []
                for cb, ce in sorted(chunks):
                    if merged and cb <= merged[-1][1]:
                        merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
                    else:
                        merged.append((cb, ce))
                fh.write(struct.pack("<Ii", b, len(merged)))
                for cb, ce in merged:
                    fh.write(struct.pack("<QQ", cb, ce))
            # fill linear index gaps with previous offsets
            filled = []
            prev = 0
            for v in intervals:
                prev = v if v else prev
                filled.append(prev if prev else 0)
            fh.write(struct.pack("<i", len(filled)))
            for v in filled:
                fh.write(struct.pack("<Q", v))
    return out_path


def _coord_key(rec):
    # unmapped records (ref_id -1) sort last, matching samtools convention
    rid = rec.ref_id if rec.ref_id >= 0 else 1 << 30
    return (rid, rec.pos)


def merge_bams(paths, out_path: str):
    """Merge per-shard BAMs (sorted or not) into one coordinate-sorted BAM.

    Used by the ``--workers`` fan-out to combine per-shard --pass-bam /
    --filt-bam outputs.  Inputs need NOT be sorted — shard files are
    only NEAR-sorted: a rescued mate
    is written after its higher-pos partner (filters.py pairing path) and
    padded locus windows can interleave positions, so each shard is first
    stably sorted in memory (write order kept at equal coordinates; peak
    RSS = one shard's records) into a temp file, then the sorted shards
    stream through a k-way heap merge.  Ties on (ref_id, pos) break by
    shard order, so the merge is deterministic."""
    import heapq

    from longtr_tpu_torch.io.bam import BamReader

    if not paths:
        raise ValueError("merge_bams: no input BAM paths given")
    hdr = None
    tmp_paths = []
    try:
        for p in paths:
            r = BamReader(p)
            if hdr is None:
                hdr = r.header
            recs = []
            while (rec := r.get_next_alignment()) is not None:
                recs.append(rec)
            r.close()
            recs.sort(key=_coord_key)
            tp = p + ".sorttmp"
            w = BamWriter(tp, hdr.text, hdr.ref_names, hdr.ref_lengths)
            for rec in recs:
                w.save_alignment(rec)
            w.close()
            tmp_paths.append(tp)
            del recs

        readers = [BamReader(tp) for tp in tmp_paths]
        out = BamWriter(out_path, hdr.text, hdr.ref_names, hdr.ref_lengths)
        heap = []
        for i, r in enumerate(readers):
            rec = r.get_next_alignment()
            if rec is not None:
                # (key, i) is unique among live heap entries (one record
                # per reader), so records themselves are never compared
                heapq.heappush(heap, (_coord_key(rec), i, rec))
        while heap:
            (_, i, rec) = heapq.heappop(heap)
            out.save_alignment(rec)
            nxt = readers[i].get_next_alignment()
            if nxt is not None:
                heapq.heappush(heap, (_coord_key(nxt), i, nxt))
        out.close()
        for r in readers:
            r.close()
    finally:
        for tp in tmp_paths:
            try:
                os.remove(tp)
            except OSError:
                pass
    return out_path
