"""BGZF (blocked gzip) reader/writer.

The reference wraps htslib's BGZF (src/bgzf_streams.h); here the format is
implemented directly on Python's zlib.  BGZF files are sequences of gzip
members, each carrying a BC extra field with the total block size; virtual
file offsets are ``(compressed_block_offset << 16) | within_block_offset``,
the addressing scheme used by BAI/TBI indexes.

A C++ fast path for block inflation lives in longtr_tpu_torch/native; this module
is the always-available implementation and the writer.
"""

from __future__ import annotations

import io
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_HEADER = struct.Struct("<4BI2BH")  # magic..mtime..xfl os xlen


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seek."""

    def __init__(self, path_or_handle):
        if isinstance(path_or_handle, (str, bytes)):
            self._fh = open(path_or_handle, "rb")
        else:
            self._fh = path_or_handle
        self._block_start = 0        # compressed offset of current block
        self._block_data = b""
        self._block_len_comp = 0
        self._within = 0
        self._load_block(0)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_block_at(self, coffset: int):
        """Read one BGZF block; returns (decompressed, compressed_len)."""
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) == 0:
            return b"", 0
        if len(header) < 12:
            raise IOError("Truncated BGZF block header")
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = _HEADER.unpack(header)
        if magic1 != 0x1F or magic2 != 0x8B or method != 8 or not flags & 4:
            raise IOError("Not a BGZF/gzip block at offset %d" % coffset)
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise IOError("gzip block lacks BGZF BC extra field")
        # block = 12-byte gzip header + xlen extra + cdata + 8-byte trailer
        cdata_len = bsize - 12 - xlen - 8
        if cdata_len < 0:
            raise IOError("Corrupt BGZF block at offset %d: declared size %d "
                          "smaller than its header" % (coffset, bsize))
        cdata = self._fh.read(cdata_len)
        if len(cdata) < cdata_len:
            raise IOError("Truncated BGZF block at offset %d" % coffset)
        self._fh.read(8)  # crc32 + isize
        data = zlib.decompress(cdata, -15)
        return data, bsize

    def _load_block(self, coffset: int):
        data, bsize = self._read_block_at(coffset)
        self._block_start = coffset
        self._block_data = data
        self._block_len_comp = bsize
        self._within = 0

    @property
    def virtual_offset(self) -> int:
        if self._within >= len(self._block_data) and self._block_len_comp:
            return (self._block_start + self._block_len_comp) << 16
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int):
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        if coffset != self._block_start or not self._block_data:
            self._load_block(coffset)
        self._within = within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block_data) - self._within
            if avail == 0:
                nxt = self._block_start + self._block_len_comp
                data, bsize = self._read_block_at(nxt)
                if bsize == 0:
                    break  # physical end of file
                # Empty blocks (incl. the EOF marker) are skipped, matching
                # htslib: readers must tolerate them anywhere in the stream.
                self._block_start = nxt
                self._block_data = data
                self._block_len_comp = bsize
                self._within = 0
                continue
            take = min(n, avail)
            out += self._block_data[self._within: self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        """Decompress the whole stream from the beginning."""
        self.seek_virtual(0)
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)


class BgzfWriter:
    """Streaming BGZF writer (bgzfostream analog, vcf_writer.h usage)."""

    MAX_BLOCK = 0xFF00

    def __init__(self, path_or_handle, level: int = 6):
        if isinstance(path_or_handle, (str, bytes)):
            self._fh = open(path_or_handle, "wb")
            self._own = True
        else:
            self._fh = path_or_handle
            self._own = False
        self._level = level
        self._buf = bytearray()
        self._closed = False

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[: self.MAX_BLOCK])
            del self._buf[: self.MAX_BLOCK]
        return len(data)

    def _flush_block(self, chunk: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(chunk)) + co.flush()
        crc = zlib.crc32(bytes(chunk)) & 0xFFFFFFFF
        bsize = len(cdata) + 12 + 6 + 8 - 1  # total block size minus one
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<H", 6)
                 + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize)
                 + cdata + struct.pack("<II", crc, len(chunk) & 0xFFFFFFFF))
        self._fh.write(block)

    def flush(self):
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.flush()

    def close(self):
        if self._closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._own:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzf_open_text(path: str) -> io.TextIOWrapper:
    """Read a bgzipped text file (VCF etc.) as a text stream."""
    data = BgzfReader(path).read_all()
    return io.TextIOWrapper(io.BytesIO(data), encoding="utf-8")


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(4)
    return head[:2] == b"\x1f\x8b" and len(head) == 4 and head[3] & 4 != 0
