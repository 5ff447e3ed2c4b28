"""Host-side genomic I/O: BGZF/BAM/FASTA/FASTQ codecs and the TSV/GTF wire
formats shared by all pipeline stages.

The reference delegates BAM decoding to pysam/htslib (C); here we ship our own
codec (pure-Python reference implementation, with an optional C++ fast path in
native/) so the engine has no dependency beyond the standard library for
ingest. Unlike the reference -- which re-implements TSV parsing with large
per-stage regexes (py/freddie_segment.py:17-38, py/freddie_cluster.py:15-34,
py/freddie_isoforms.py:143-200) -- every wire format lives once in
freddie_tpu_torch.io.tsv.
"""

from .bam import BamReader, BamWriter, BamRecord  # noqa: F401
from .fastx import read_fastx  # noqa: F401
