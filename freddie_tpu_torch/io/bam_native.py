"""ctypes bindings for the native BAM decoder (native/bamdec.cpp).

NativeBamReader yields the same BamRecord objects as the pure-Python
BamReader (asserted by tests) with inflation, record parsing and sequence
expansion done in C++. Falls back transparently when no toolchain exists.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .bam import BamRecord

_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        from ..ops._build import load_native

        lib = load_native("bamdec", "libbamdec.so", ["bamdec.cpp", "split_core.cpp"],
                          ["g++", "-O2", "-shared", "-fPIC", "-pthread"], ctypes.CDLL,
                          deps=("bam_io.h",), libs=("-lz",))
        lib.bamdec_open.restype = ctypes.c_void_p
        lib.bamdec_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.bamdec_n_refs.argtypes = [ctypes.c_void_p]
        lib.bamdec_ref.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        P = ctypes.POINTER
        lib.bamdec_next_batch.restype = ctypes.c_longlong
        lib.bamdec_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            P(ctypes.c_int32), P(ctypes.c_int64), P(ctypes.c_uint16), P(ctypes.c_uint8),
            P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_char), ctypes.c_longlong,
            P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_uint32), ctypes.c_longlong,
            P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_char), ctypes.c_longlong,
        ]
        lib.bamdec_next_batch_iv.restype = ctypes.c_longlong
        lib.bamdec_next_batch_iv.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            P(ctypes.c_int32), P(ctypes.c_int64), P(ctypes.c_uint16),
            P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_char), ctypes.c_longlong,
            P(ctypes.c_int64), P(ctypes.c_int32),
            P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_int64),
            P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_char), ctypes.c_longlong,
            ctypes.c_longlong,
        ]
        lib.bamdec_close.argtypes = [ctypes.c_void_p]
        lib.splitc_run.restype = ctypes.c_longlong
        lib.splitc_run.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lib
    except Exception:
        _build_failed = True
    return _lib


def native_bam_available() -> bool:
    return _load() is not None


class NativeBamReader:
    """Drop-in for io.bam.BamReader backed by the C++ decoder."""

    BATCH = 4096
    NAME_CAP = BATCH * 256
    CIGAR_CAP = BATCH * 512
    SEQ_CAP = BATCH * 8192

    def __init__(self, path: str):
        lib = _load()
        assert lib is not None, "native BAM decoder unavailable"
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.bamdec_open(path.encode(), err, 256)
        if not self._h:
            raise ValueError(f"{path}: {err.value.decode()}")
        self.references = []
        self.lengths = []
        name = ctypes.create_string_buffer(1024)
        ln = ctypes.c_longlong(0)
        for i in range(lib.bamdec_n_refs(self._h)):
            lib.bamdec_ref(self._h, i, name, 1024, ctypes.byref(ln))
            self.references.append(name.value.decode())
            self.lengths.append(int(ln.value))

    def close(self) -> None:
        if self._h:
            self._lib.bamdec_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        B = self.BATCH
        ref_id = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int64)
        flag = np.zeros(B, np.uint16)
        mapq = np.zeros(B, np.uint8)
        name_off = np.zeros(B, np.int64)
        name_len = np.zeros(B, np.int32)
        name_buf = np.zeros(self.NAME_CAP, np.uint8)
        cigar_off = np.zeros(B, np.int64)
        cigar_len = np.zeros(B, np.int32)
        cigar_buf = np.zeros(self.CIGAR_CAP, np.uint32)
        seq_off = np.zeros(B, np.int64)
        seq_len = np.zeros(B, np.int64)
        seq_buf = np.zeros(self.SEQ_CAP, np.uint8)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        while True:
            n = self._lib.bamdec_next_batch(
                self._h, B,
                ptr(ref_id, ctypes.c_int32), ptr(pos, ctypes.c_int64),
                ptr(flag, ctypes.c_uint16), ptr(mapq, ctypes.c_uint8),
                ptr(name_off, ctypes.c_int64), ptr(name_len, ctypes.c_int32),
                ptr(name_buf, ctypes.c_char), ctypes.c_longlong(self.NAME_CAP),
                ptr(cigar_off, ctypes.c_int64), ptr(cigar_len, ctypes.c_int32),
                ptr(cigar_buf, ctypes.c_uint32), ctypes.c_longlong(self.CIGAR_CAP),
                ptr(seq_off, ctypes.c_int64), ptr(seq_len, ctypes.c_int64),
                ptr(seq_buf, ctypes.c_char), ctypes.c_longlong(self.SEQ_CAP),
            )
            if n < 0:
                raise ValueError(f"native BAM decode error (code {n})")
            if n == 0:
                return
            # Copy only the used prefixes out of the ctypes buffers.
            names_raw = name_buf[: int(name_off[n - 1] + name_len[n - 1])].tobytes()
            seqs_raw = seq_buf[: int(seq_off[n - 1] + seq_len[n - 1])].tobytes()
            for i in range(n):
                co, cl = int(cigar_off[i]), int(cigar_len[i])
                ops = cigar_buf[co : co + cl]
                cigar = [(int(v) & 0xF, int(v) >> 4) for v in ops]
                no, nl = int(name_off[i]), int(name_len[i])
                so, sl = int(seq_off[i]), int(seq_len[i])
                yield BamRecord(
                    query_name=names_raw[no : no + nl].decode(),
                    flag=int(flag[i]),
                    reference_id=int(ref_id[i]),
                    reference_start=int(pos[i]),
                    mapq=int(mapq[i]),
                    cigartuples=cigar,
                    query_sequence=seqs_raw[so : so + sl].decode(),
                    reference_name=(
                        self.references[ref_id[i]]
                        if 0 <= ref_id[i] < len(self.references)
                        else None
                    ),
                )


class IngestRecord:
    """Array-native split-stage record: alignment intervals pre-extracted
    by the C++ CIGAR walk (native/bamdec.cpp bamdec_next_batch_iv), the
    per-interval cigar already rendered as text, and no sequence (split
    takes sequences from the FASTQ pass). Duck-types the BamRecord fields
    the split stage reads."""

    __slots__ = ("query_name", "reference_name", "flag", "intervals")

    def __init__(self, query_name, reference_name, flag, intervals):
        self.query_name = query_name
        self.reference_name = reference_name
        self.flag = flag
        self.intervals = intervals

    @property
    def is_unmapped(self):
        return bool(self.flag & 4)

    @property
    def is_reverse(self):
        return bool(self.flag & 16)

    @property
    def is_secondary(self):
        return bool(self.flag & 256)

    @property
    def is_supplementary(self):
        return bool(self.flag & 2048)


def iter_interval_records(reader: "NativeBamReader", max_del_size: int):
    """Stream IngestRecords from an open NativeBamReader: BGZF inflation,
    record parsing AND the per-alignment CIGAR walk all happen in C++;
    Python only slices flat arrays (SURVEY hard part 5: host I/O at
    1M-read scale). Interval tuples are (ts, te, qs, qe, cigar_str) --
    identical values to core.cigar.alignment_intervals after the
    empty-interval filter (tests/test_native_bam.py)."""
    lib = reader._lib
    B = 8192
    NAME_CAP = B * 256
    IV_CAP = B * 64
    CIG_CAP = IV_CAP * 24
    ref_id = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int64)
    flag = np.zeros(B, np.uint16)
    name_off = np.zeros(B, np.int64)
    name_len = np.zeros(B, np.int32)
    name_buf = np.zeros(NAME_CAP, np.uint8)
    iv_off = np.zeros(B, np.int64)
    iv_n = np.zeros(B, np.int32)
    iv_ts = np.zeros(IV_CAP, np.int64)
    iv_te = np.zeros(IV_CAP, np.int64)
    iv_qs = np.zeros(IV_CAP, np.int64)
    iv_qe = np.zeros(IV_CAP, np.int64)
    cig_off = np.zeros(IV_CAP, np.int64)
    cig_len = np.zeros(IV_CAP, np.int32)
    cig_buf = np.zeros(CIG_CAP, np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    refs = reader.references
    n_refs = len(refs)
    while True:
        n = lib.bamdec_next_batch_iv(
            reader._h, B, max_del_size,
            ptr(ref_id, ctypes.c_int32), ptr(pos, ctypes.c_int64),
            ptr(flag, ctypes.c_uint16),
            ptr(name_off, ctypes.c_int64), ptr(name_len, ctypes.c_int32),
            ptr(name_buf, ctypes.c_char), ctypes.c_longlong(NAME_CAP),
            ptr(iv_off, ctypes.c_int64), ptr(iv_n, ctypes.c_int32),
            ptr(iv_ts, ctypes.c_int64), ptr(iv_te, ctypes.c_int64),
            ptr(iv_qs, ctypes.c_int64), ptr(iv_qe, ctypes.c_int64),
            ptr(cig_off, ctypes.c_int64), ptr(cig_len, ctypes.c_int32),
            ptr(cig_buf, ctypes.c_char), ctypes.c_longlong(CIG_CAP),
            ctypes.c_longlong(IV_CAP),
        )
        if n == -3:
            raise AssertionError("CIGAR/query length mismatch in BAM record")
        if n < 0:
            raise ValueError(f"native BAM interval decode error (code {n})")
        if n == 0:
            return
        total_iv = int(iv_off[n - 1] + iv_n[n - 1])
        names_raw = name_buf[: int(name_off[n - 1] + name_len[n - 1])].tobytes()
        cig_raw = cig_buf[
            : int(cig_off[total_iv - 1] + cig_len[total_iv - 1]) if total_iv else 0
        ].tobytes()
        ts_l = iv_ts[:total_iv].tolist()
        te_l = iv_te[:total_iv].tolist()
        qs_l = iv_qs[:total_iv].tolist()
        qe_l = iv_qe[:total_iv].tolist()
        co_l = cig_off[:total_iv].tolist()
        cl_l = cig_len[:total_iv].tolist()
        no_l = name_off[:n].tolist()
        nl_l = name_len[:n].tolist()
        io_l = iv_off[:n].tolist()
        in_l = iv_n[:n].tolist()
        rid_l = ref_id[:n].tolist()
        fl_l = flag[:n].tolist()
        for i in range(n):
            o, k = io_l[i], in_l[i]
            intervals = [
                (
                    ts_l[j],
                    te_l[j],
                    qs_l[j],
                    qe_l[j],
                    cig_raw[co_l[j] : co_l[j] + cl_l[j]].decode(),
                )
                for j in range(o, o + k)
            ]
            rid = rid_l[i]
            yield IngestRecord(
                query_name=names_raw[no_l[i] : no_l[i] + nl_l[i]].decode(),
                reference_name=refs[rid] if 0 <= rid < n_refs else None,
                flag=fl_l[i],
                intervals=intervals,
            )


def run_split_native(
    bam_path: str, read_files: list[str], outdir: str, cfg
) -> dict[str, int]:
    """Run the entire split stage in C++ (native/split_core.cpp): decode,
    CIGAR walk, loci batching, tint building + oversize breaking, TSV
    writing and FASTQ routing -- byte-identical to stages/split.py's
    Python path (tests/test_native_split.py). Returns {contig: n_tints}."""
    lib = _load()
    assert lib is not None, "native split core unavailable"
    counts_buf = ctypes.create_string_buffer(1 << 20)
    err = ctypes.create_string_buffer(512)
    rc = lib.splitc_run(
        bam_path.encode(),
        ";".join(read_files).encode(),
        outdir.encode(),
        cfg.max_del_size,
        1 if cfg.consider_nonspliced else 0,
        cfg.min_reads_per_tint,
        cfg.max_tint_intervals,
        cfg.max_tint_reads,
        cfg.contig_min_size,
        512,
        counts_buf,
        ctypes.c_longlong(len(counts_buf)),
        err,
        512,
    )
    if rc == -3 or rc == -4:
        raise AssertionError(err.value.decode())
    if rc < 0:
        raise ValueError(f"native split failed (code {rc}): {err.value.decode()}")
    counts: dict[str, int] = {}
    for line in counts_buf.value.decode().splitlines():
        contig, n = line.split("\t")
        counts[contig] = int(n)
    return counts


def native_split_available() -> bool:
    return _load() is not None


def open_bam(path: str):
    """Best decoder available: native C++ when buildable, else Python."""
    if native_bam_available():
        return NativeBamReader(path)
    from .bam import BamReader

    return BamReader(path)
