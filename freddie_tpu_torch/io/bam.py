"""Minimal BAM codec (read + write) on top of the BGZF layer.

Implements the subset of the BAM spec the pipeline needs: header contigs,
and per-record name / flag / refID / pos / CIGAR / sequence. Tags are
skipped on read and omitted on write. CIGAR op codes use the standard
encoding (0=M 1=I 2=D 3=N 4=S 5=H 6=P 7== 8=X), identical to the pysam
constants the reference relies on (py/freddie_split.py:65-112).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

# CIGAR op codes (SAM spec order).
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_OPS = "MIDNSHP=XB"
CIGAR_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_OF = {c: i for i, c in enumerate(_SEQ_NIBBLE)}
# byte value -> nibble code, unknown/lowercase folded like the dict path
# (uppercase first, then .get(..., 15)); used by the writer's packer.
_NIBBLE_TABLE = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NIBBLE_OF.items():
    _NIBBLE_TABLE[ord(_c)] = _i
    _NIBBLE_TABLE[ord(_c.lower())] = _i

# Byte -> two-character expansion table for fast 4-bit seq decoding.
_SEQ_PAIRS = [
    (a + b).encode() for a in _SEQ_NIBBLE for b in _SEQ_NIBBLE
]
_SEQ_TABLE = b"".join(_SEQ_PAIRS)


def _decode_seq(seq_bytes: bytes, l_seq: int) -> str:
    """Expand packed 4-bit bases via a 256-entry pair table (numpy)."""
    if l_seq == 0:
        return ""
    import numpy as np

    idx = np.frombuffer(seq_bytes, dtype=np.uint8)
    pairs = np.frombuffer(_SEQ_TABLE, dtype=np.uint16)  # 256 two-char cells
    out = pairs[idx].tobytes()[:l_seq]
    return out.decode()

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    query_name: str
    flag: int
    reference_id: int
    reference_start: int
    mapq: int
    cigartuples: list[tuple[int, int]]  # [(op, length)]
    query_sequence: str
    reference_name: str | None = None

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)


class BamReader:
    """Sequential BAM reader.

    For a position-sorted BAM, records come out grouped by contig in header
    order with ascending positions within a contig -- the same order
    pysam's indexed fetch(contig) produces per contig, which is all the
    split stage needs (py/freddie_split.py:210-242).
    """

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._r = BgzfReader(self._fh)
        magic = self._r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        self.header_text = self._r.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        self.references: list[str] = []
        self.lengths: list[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            name = self._r.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._r.read(4))
            self.references.append(name)
            self.lengths.append(l_ref)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[BamRecord]:
        unpack_core = struct.Struct("<iiBBHHHiiii").unpack
        while True:
            head = self._r.read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            buf = self._r.read(block_size)
            if len(buf) < block_size:
                raise ValueError("truncated BAM record")
            (
                ref_id,
                pos,
                l_read_name,
                mapq,
                _bin,
                n_cigar,
                flag,
                l_seq,
                _next_ref,
                _next_pos,
                _tlen,
            ) = unpack_core(buf[:32])
            off = 32
            name = buf[off : off + l_read_name - 1].decode()
            off += l_read_name
            cigar = []
            for i in range(n_cigar):
                (v,) = struct.unpack_from("<I", buf, off + 4 * i)
                cigar.append((v & 0xF, v >> 4))
            off += 4 * n_cigar
            n_seq_bytes = (l_seq + 1) // 2
            seq_bytes = buf[off : off + n_seq_bytes]
            seq = _decode_seq(seq_bytes, l_seq)
            yield BamRecord(
                query_name=name,
                flag=flag,
                reference_id=ref_id,
                reference_start=pos,
                mapq=mapq,
                cigartuples=cigar,
                query_sequence=seq,
                reference_name=self.references[ref_id] if 0 <= ref_id < len(self.references) else None,
            )


def _reg2bin(beg: int, end: int) -> int:
    """Compute the BAM bin for [beg, end) (SAM spec 5.3).

    The BAI binning scheme only covers coordinates below 2^29; beyond
    that the bin field (uint16) cannot represent the index (the spec's
    answer is CSI indexing). Emit bin 0 there instead of overflowing --
    no consumer in this codebase reads the field, and htslib recomputes
    bins when it indexes."""
    if end > 1 << 29:
        return 0
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


class BamWriter:
    """Writes BAM files (used by tests/fixtures and the simulator)."""

    def __init__(self, path: str, references: list[str], lengths: list[int], header_text: str = ""):
        self._fh = open(path, "wb")
        self._w = BgzfWriter(self._fh)
        self.references = list(references)
        self._ref_id = {n: i for i, n in enumerate(references)}
        if not header_text:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(references, lengths)
            )
        hb = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(hb)) + hb)
        self._w.write(struct.pack("<i", len(references)))
        for n, l in zip(references, lengths):
            nb = n.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", l))

    def write(self, rec: BamRecord) -> None:
        name = rec.query_name.encode() + b"\x00"
        cigar = b"".join(
            struct.pack("<I", (length << 4) | op) for op, length in rec.cigartuples
        )
        l_seq = len(rec.query_sequence)
        # Vectorized 4-bit packing (the per-char Python loop dominated
        # large corpus generation): map bytes -> nibbles via a 256-entry
        # table, pad to even length, fold pairs.
        codes = np.frombuffer(rec.query_sequence.encode(), dtype=np.uint8)
        nibs = _NIBBLE_TABLE[codes]
        if l_seq % 2:
            nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
        seq_bytes = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
        qual = b"\xff" * l_seq
        ref_len = sum(l for op, l in rec.cigartuples if op in (CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF))
        body = (
            struct.pack(
                "<iiBBHHHiiii",
                rec.reference_id,
                rec.reference_start,
                len(name),
                rec.mapq,
                _reg2bin(rec.reference_start, rec.reference_start + max(ref_len, 1)),
                len(rec.cigartuples),
                rec.flag,
                l_seq,
                -1,
                -1,
                0,
            )
            + name
            + cigar
            + bytes(seq_bytes)
            + qual
        )
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
