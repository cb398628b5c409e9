"""Tabix (.tbi) index support for bgzipped VCFs.

The reference streams SNP/reference VCFs through htslib's tabix iterators
(vcf_reader.h:22-120); this module provides the same capability for our
stack: a .tbi parser + chunk query (the binning scheme is identical to BAI),
and a .tbi builder used for fixtures and for indexing our own output.

The builder writes a plain-gzip index (readable by any gzip decoder,
including this module); htslib also accepts gzip-wrapped indexes.
"""

from __future__ import annotations

import gzip
import struct

from longtr_tpu_torch.io.bgzf import BgzfReader


def _reg2bins(beg: int, end: int):
    end = min(end, 1 << 29)  # standard tabix binning covers 512Mbp
    beg = min(beg, (1 << 29) - 1)
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


class TbiIndex:
    def __init__(self, path: str):
        raw = gzip.decompress(open(path, "rb").read())
        if raw[:4] != b"TBI\x01":
            raise IOError("Not a tabix index: " + path)
        pos = 4
        (n_ref, self.fmt, self.col_seq, self.col_beg, self.col_end,
         self.meta, self.skip, l_nm) = struct.unpack_from("<8i", raw, pos)
        pos += 32
        names = raw[pos:pos + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        self._ids = {n: i for i, n in enumerate(self.names)}
        pos += l_nm
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, pos)
                    pos += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", raw, pos))
            pos += 8 * n_intv
            self.refs.append((bins, intervals))

    def ref_id(self, name: str) -> int:
        return self._ids.get(name, -1)

    def chunks_for(self, rid: int, beg: int, end: int):
        """Merged chunk list of virtual-offset ranges overlapping [beg, end)."""
        if rid < 0 or rid >= len(self.refs):
            return []
        bins, intervals = self.refs[rid]
        min_off = 0
        win = beg >> 14
        if intervals:
            min_off = intervals[min(win, len(intervals) - 1)]
        chunks = []
        for b in _reg2bins(beg, end):
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


def build_tbi(vcf_gz_path: str, out_path: str | None = None) -> str:
    """Index a coordinate-sorted bgzipped VCF (tabix -p vcf equivalent)."""
    out_path = out_path or vcf_gz_path + ".tbi"
    names = []
    ids = {}
    refs = []  # per ref: [bins dict, intervals list]
    # Stream lines, tracking a block-accurate virtual offset for each line
    # start (coarse offsets are fine: queries seek to the offset and then
    # filter forward by position).
    bz = BgzfReader(vcf_gz_path)
    pending = b""
    line_offsets = []   # (voffset_of_line_start, line_bytes)
    off = bz.virtual_offset
    while True:
        chunk_off = bz.virtual_offset
        chunk = bz.read(65536)
        if not chunk:
            break
        data = pending + chunk
        # offset of data[0] is: if pending, previous 'off'; else chunk_off
        base_off = off if pending else chunk_off
        pos0 = 0
        while True:
            nl = data.find(b"\n", pos0)
            if nl < 0:
                break
            # NOTE: virtual offsets within a block are (coffset<<16)|within;
            # we can only cheaply track block-accurate offsets, which is
            # sufficient for chunk seeks (we re-scan within the block).
            line_offsets.append((base_off, data[pos0:nl]))
            pos0 = nl + 1
        pending = data[pos0:]
        off = base_off
    bz.close()

    for voff_line, line in line_offsets:
        if line.startswith(b"#"):
            continue
        f = line.split(b"\t", 4)
        chrom = f[0].decode()
        pos1 = int(f[1])
        ref_len = len(f[3])
        if chrom not in ids:
            ids[chrom] = len(names)
            names.append(chrom)
            refs.append([{}, []])
        rid = ids[chrom]
        beg, end = pos1 - 1, pos1 - 1 + max(ref_len, 1)
        b = _bin_of(beg, end)
        bins, intervals = refs[rid]
        bins.setdefault(b, []).append((voff_line, voff_line + (1 << 16)))
        for win in range(beg >> 14, ((end - 1) >> 14) + 1):
            while len(intervals) <= win:
                intervals.append(0)
            if intervals[win] == 0 or voff_line < intervals[win]:
                intervals[win] = voff_line

    out = bytearray()
    out += b"TBI\x01"
    nm = b"".join(n.encode() + b"\x00" for n in names)
    out += struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm))
    out += nm
    for bins, intervals in refs:
        out += struct.pack("<i", len(bins))
        for b, chunks in sorted(bins.items()):
            merged = []
            for cb, ce in sorted(chunks):
                if merged and cb <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
                else:
                    merged.append((cb, ce))
            out += struct.pack("<Ii", b, len(merged))
            for cb, ce in merged:
                out += struct.pack("<QQ", cb, ce)
        filled = []
        prev = 0
        for v in intervals:
            prev = v if v else prev
            filled.append(prev)
        out += struct.pack("<i", len(filled))
        for v in filled:
            out += struct.pack("<Q", v)
    with open(out_path, "wb") as fh:
        fh.write(gzip.compress(bytes(out)))
    return out_path


def _bin_of(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return 4681 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return 585 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return 73 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return 9 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return 1 + (beg >> 26)
    return 0
