"""FASTA/FASTQ streaming reader.

Format detection mirrors the reference's line-modulus scheme
(py/freddie_split.py:376-399): the first character of the file selects
FASTQ ('@', 4 lines/record) or FASTA ('>', 2 lines/record); the read name
is the first whitespace-separated token of the header without the leading
character. .gz inputs are handled transparently.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def read_fastx(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) pairs."""
    if path.endswith(".gz"):
        fh = gzip.open(path, "rt")
    else:
        fh = open(path, "r")
    try:
        mod = None
        name = None
        for idx, line in enumerate(fh):
            if idx == 0:
                if line[0] == "@":
                    mod = 4
                elif line[0] == ">":
                    mod = 2
                else:
                    raise ValueError(f"Invalid fasta/q file {path}")
            if idx % mod == 0:
                name = line.rstrip().split()[0][1:]
            elif idx % mod == 1:
                yield name, line.rstrip()
    finally:
        fh.close()


def write_fastq(path: str, reads: list[tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def read_fasta_dict(path: str) -> dict[str, str]:
    """Load a (small) FASTA into a dict, supporting multi-line sequences."""
    seqs: dict[str, list[str]] = {}
    cur = None
    fh = gzip.open(path, "rt") if path.endswith(".gz") else open(path)
    with fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line[0] == ">":
                cur = line[1:].split()[0]
                seqs[cur] = []
            else:
                seqs[cur].append(line)
    return {k: "".join(v) for k, v in seqs.items()}
