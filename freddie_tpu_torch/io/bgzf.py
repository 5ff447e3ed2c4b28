"""BGZF (blocked gzip) reader/writer.

BGZF is a sequence of standard gzip members, each at most 64 KiB of
uncompressed payload, carrying the compressed block size in a 'BC' extra
subfield, terminated by a fixed 28-byte empty EOF block (SAM spec section 4).

Reading: every BGZF file is a valid multi-member gzip stream, so decoding
uses zlib directly, member by member (this also lets the C++ fast path slot
in later per block). Writing produces spec-compliant blocks so output BAMs
are readable by htslib-based tools.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator

# Fixed empty BGZF block marking end-of-file (SAM spec 4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 65280  # max uncompressed payload per block htslib uses


def _read_block(f: BinaryIO) -> bytes | None:
    """Read one BGZF/gzip member from *f*; None at clean EOF."""
    header = f.read(12)
    if len(header) == 0:
        return None
    if len(header) < 12:
        raise ValueError("truncated BGZF block header")
    magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = struct.unpack(
        "<BBBBIBBH", header
    )
    if (magic1, magic2) != (0x1F, 0x8B) or method != 8:
        raise ValueError("not a gzip/BGZF stream")
    if not flags & 4:  # FEXTRA absent: plain gzip member; inflate streaming
        raise ValueError("gzip member without FEXTRA: not BGZF")
    extra = f.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = struct.unpack_from("<BBH", extra, off)
        if (si1, si2) == (66, 67) and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, off + 4)[0]
        off += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC subfield")
    cdata_len = bsize + 1 - 12 - xlen - 8
    cdata = f.read(cdata_len)
    tail = f.read(8)
    if len(cdata) < cdata_len or len(tail) < 8:
        raise ValueError("truncated BGZF block")
    crc, isize = struct.unpack("<II", tail)
    data = zlib.decompress(cdata, wbits=-15)
    if len(data) != isize:
        raise ValueError("BGZF block ISIZE mismatch")
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise ValueError("BGZF block CRC mismatch")
    return data


def iter_blocks(f: BinaryIO) -> Iterator[bytes]:
    """Yield uncompressed payloads of successive BGZF blocks (skips the
    empty EOF block)."""
    while True:
        data = _read_block(f)
        if data is None:
            return
        if len(data):
            yield data


class BgzfReader:
    """Buffered sequential reader over the concatenated block payloads."""

    def __init__(self, f: BinaryIO):
        self._blocks = iter_blocks(f)
        self._buf = b""
        self._pos = 0

    def read(self, n: int) -> bytes:
        """Read exactly n bytes; fewer only at EOF."""
        out = []
        need = n
        while need > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                try:
                    self._buf = next(self._blocks)
                except StopIteration:
                    break
                self._pos = 0
                continue
            take = min(avail, need)
            out.append(self._buf[self._pos : self._pos + take])
            self._pos += take
            need -= take
        return b"".join(out)


class BgzfWriter:
    def __init__(self, f: BinaryIO, level: int = 6):
        self._f = f
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(bytes(self._buf[:_MAX_BLOCK]))
            del self._buf[:_MAX_BLOCK]

    def _flush_block(self, data: bytes) -> None:
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(data) + comp.flush()
        bsize = len(cdata) + 25  # 12 header + 6 extra + 8 footer - 1
        block = (
            struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
            + struct.pack("<BBHH", 66, 67, 2, bsize)
            + cdata
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
        )
        self._f.write(block)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf = bytearray()
        self._f.write(BGZF_EOF)
        self._f.flush()
