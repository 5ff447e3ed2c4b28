"""BGZF blocks, BAM records and FASTQ, as far as the simulator and the
reference need them.

Frozen copy of ``freddie_tpu_torch/io/bgzf.py``, ``io/bam.py`` and
``io/fastx.py:write_fastq``. The writer is byte-for-byte the program's
(``tests/test_portbench_frozen.py`` holds it so); the reader decodes what
the reference needs of each record: name, flag, position, CIGAR and the
sequence length.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

# CIGAR op codes (SAM spec order).
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

# Fixed empty BGZF block marking end-of-file (SAM spec 4.1.2).
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 65280  # max uncompressed payload per block htslib uses

_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_TABLE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(_SEQ_NIBBLE):
    _NIBBLE_TABLE[ord(_c)] = _i
    _NIBBLE_TABLE[ord(_c.lower())] = _i


class BgzfWriter:
    def __init__(self, f, level: int = 6):
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
        self._f.write(
            struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
            + struct.pack("<BBHH", 66, 67, 2, bsize)
            + cdata
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
        )

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf = bytearray()
        self._f.write(BGZF_EOF)
        self._f.flush()


def read_bgzf(path: str) -> bytes:
    """The whole uncompressed payload of a BGZF file (checked block by
    block: BC size, CRC and ISIZE)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        _m1, _m2, _cm, flags, _mt, _xfl, _os, xlen = struct.unpack_from("<BBBBIBBH", data, off)
        if not flags & 4:
            raise ValueError(f"{path}: gzip member without FEXTRA: not BGZF")
        extra = data[off + 12 : off + 12 + xlen]
        si1, si2, _slen, bsize = struct.unpack_from("<BBHH", extra, 0)
        if (si1, si2) != (66, 67):
            raise ValueError(f"{path}: BGZF block without its BC subfield")
        cstart = off + 12 + xlen
        cend = off + bsize + 1 - 8
        crc, isize = struct.unpack_from("<II", data, cend)
        block = zlib.decompress(data[cstart:cend], wbits=-15)
        if len(block) != isize or zlib.crc32(block) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: damaged BGZF block at byte {off}")
        out.append(block)
        off += bsize + 1
    return b"".join(out)


@dataclass
class BamRecord:
    query_name: str
    flag: int
    reference_id: int
    reference_start: int
    mapq: int
    cigartuples: list
    query_sequence: str = ""
    query_length: int = 0


def _reg2bin(beg: int, end: int) -> int:
    if end > 1 << 29:
        return 0
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


class BamWriter:
    def __init__(self, path: str, references: list, lengths: list):
        self._fh = open(path, "wb")
        self._w = BgzfWriter(self._fh)
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(references, lengths)
        )
        hb = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(hb)) + hb)
        self._w.write(struct.pack("<i", len(references)))
        for n, ln in zip(references, lengths):
            nb = n.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))

    def write(self, rec: BamRecord) -> None:
        name = rec.query_name.encode() + b"\x00"
        cigar = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in rec.cigartuples)
        l_seq = len(rec.query_sequence)
        nibs = _NIBBLE_TABLE[np.frombuffer(rec.query_sequence.encode(), dtype=np.uint8)]
        if l_seq % 2:
            nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
        seq_bytes = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
        ref_len = sum(ln for op, ln in rec.cigartuples
                      if op in (CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF))
        body = (
            struct.pack(
                "<iiBBHHHiiii", rec.reference_id, rec.reference_start, len(name), rec.mapq,
                _reg2bin(rec.reference_start, rec.reference_start + max(ref_len, 1)),
                len(rec.cigartuples), rec.flag, l_seq, -1, -1, 0,
            )
            + name + cigar + seq_bytes + b"\xff" * l_seq
        )
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bam(path: str) -> tuple[list[str], list[BamRecord]]:
    """(reference names, every record in file order), the sequence left
    undecoded: ``query_length`` holds its length."""
    buf = read_bgzf(path)
    if buf[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, off)
        refs.append(buf[off + 4 : off + 4 + l_name - 1].decode())
        off += 4 + l_name + 4
    core = struct.Struct("<iiiBBHHHiiii")
    records = []
    while off < len(buf):
        (block, ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
         _nr, _np, _tl) = core.unpack_from(buf, off)
        p = off + 36
        name = buf[p : p + l_name - 1].decode()
        p += l_name
        ops = struct.unpack_from(f"<{n_cigar}I", buf, p)
        records.append(BamRecord(name, flag, ref_id, pos, mapq,
                                 [(v & 0xF, v >> 4) for v in ops], "", l_seq))
        off += 4 + block
    return refs, records


def write_fastq(path: str, reads: list) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
