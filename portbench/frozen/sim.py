"""The read simulator: a random genome, multi-exon genes with isoforms,
and splice-aligned noisy ONT cDNA reads written as a BAM and a FASTQ.

Frozen copy of ``freddie_tpu_torch/utils/sim.py`` (``simulate`` and what
it calls), rewritten to import nothing of the program. It stands in for
NanoSim in the reference workflow (vpc-ccg/freddie, ``OUTPUT.md``).
``tests/test_portbench_frozen.py`` holds it to the program's simulator
byte for byte: a later change there does not move the benchmark's
inputs. Read names encode the true transcript (``<transcript>_<i>``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from .bamio import (
    CDEL,
    CINS,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
    FLAG_REVERSE,
    BamRecord,
    BamWriter,
    write_fastq,
)

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


@dataclass
class SimTranscript:
    name: str
    contig: str
    exons: list[tuple[int, int]]  # 0-based half-open genomic intervals
    strand: str = "+"  # the gene's strand (decides polyA placement)


@dataclass
class SimRead:
    name: str
    transcript: str
    contig: str
    strand: str  # alignment strand of this read
    exons: list[tuple[int, int]]  # covered (possibly truncated) exons
    fastq_seq: str  # in read orientation
    aligned_seq: str  # in genome orientation
    cigar: list[tuple[int, int]]
    pos: int


@dataclass
class Simulation:
    contig: str
    contig_len: int
    genome: str
    transcripts: list[SimTranscript]
    reads: list[SimRead] = field(default_factory=list)

    def write_bam(self, path: str) -> None:
        order = sorted(range(len(self.reads)), key=lambda i: self.reads[i].pos)
        with BamWriter(path, [self.contig], [self.contig_len]) as w:
            for i in order:
                r = self.reads[i]
                w.write(
                    BamRecord(
                        query_name=r.name,
                        flag=FLAG_REVERSE if r.strand == "-" else 0,
                        reference_id=0,
                        reference_start=r.pos,
                        mapq=60,
                        cigartuples=r.cigar,
                        query_sequence=r.aligned_seq,
                    )
                )

    def write_fastq(self, path: str) -> None:
        write_fastq(path, [(r.name, r.fastq_seq) for r in self.reads])


def random_genome(n: int, rng: random.Random) -> str:
    arr = np.frombuffer(rng.randbytes(n), dtype=np.uint8) & 3
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return lut[arr].tobytes().decode()


def make_gene(
    rng: random.Random,
    contig: str,
    start: int,
    n_exons: int,
    exon_len: tuple[int, int] = (80, 250),
    intron_len: tuple[int, int] = (300, 1500),
) -> list[tuple[int, int]]:
    exons = []
    pos = start
    for _ in range(n_exons):
        el = rng.randint(*exon_len)
        exons.append((pos, pos + el))
        pos += el + rng.randint(*intron_len)
    return exons


def make_isoforms(
    rng: random.Random,
    gene_exons: list[tuple[int, int]],
    n_isoforms: int,
    contig: str,
    gene_id: int,
    strand: str = "+",
    alt_splice: bool = False,
) -> list[SimTranscript]:
    """Isoforms of a gene: the first keeps all exons; later ones skip
    internal exons, and (with alt_splice) use alternative 5'/3' splice
    sites or retain an intron. Alternative sites put splice positions in
    the *interior* of merged coverage intervals, which is what makes the
    segmentation DP non-trivial."""
    out = [
        SimTranscript(
            name=f"ENST{gene_id:05d}T0", contig=contig, exons=list(gene_exons), strand=strand
        )
    ]
    internal = list(range(1, len(gene_exons) - 1))
    seen = {tuple(gene_exons)}
    for t in range(1, n_isoforms):
        if not internal:
            break
        for _attempt in range(10):
            kinds = ["skip"] + (["alt", "retain"] if alt_splice else [])
            kind = rng.choice(kinds)
            exons = list(gene_exons)
            if kind == "skip":
                skip = set(rng.sample(internal, k=min(len(internal), rng.randint(1, 2))))
                exons = [e for i, e in enumerate(gene_exons) if i not in skip]
            elif kind == "alt":
                i = rng.choice(internal)
                s, e = exons[i]
                delta = rng.randint(30, min(100, (e - s) - 30))
                if rng.random() < 0.5:
                    exons[i] = (s + delta, e)  # alternative acceptor
                else:
                    exons[i] = (s, e - delta)  # alternative donor
            else:  # retain: merge an intron into one exon
                i = rng.choice(internal[:-1]) if len(internal) > 1 else internal[0]
                if i + 1 < len(exons):
                    exons = exons[:i] + [(exons[i][0], exons[i + 1][1])] + exons[i + 2:]
            key = tuple(exons)
            if key not in seen:
                seen.add(key)
                out.append(
                    SimTranscript(
                        name=f"ENST{gene_id:05d}T{t}", contig=contig,
                        exons=list(exons), strand=strand,
                    )
                )
                break
    return out


def _exon_body_with_errors(rng, sim, exons, indel_rate, big_del_rate=0.0):
    """Aligned exon-body sequence + its CIGAR (M/I/D runs, N introns).

    With indel_rate > 0, small (1-3 bp) insertions/deletions are sprinkled
    between match chunks; deletions stay below the D->N threshold so they
    remain intra-exon. With big_del_rate > 0, occasional 21-45 bp deletions
    are emitted -- the split stage rewrites D>20 as introns
    (py/freddie_split.py:159-161), so these fragment read intervals at
    random genomic positions, the dominant noise source that makes real
    segmentation problems dense."""
    ops: list[tuple[int, int]] = []
    seq_parts: list[str] = []

    def emit(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + ln)
        else:
            ops.append((op, ln))

    for i, (s, e) in enumerate(exons):
        pos = s
        while pos < e:
            chunk = min(e - pos, rng.randint(20, 80))
            seq_parts.append(sim.genome[pos : pos + chunk])
            emit(CMATCH, chunk)
            pos += chunk
            if pos < e - 50 and big_del_rate and rng.random() < big_del_rate:
                ln = rng.randint(21, 45)
                emit(CDEL, ln)  # becomes an intron downstream (D>20)
                pos += ln
            elif pos < e - 10 and indel_rate and rng.random() < indel_rate:
                if rng.random() < 0.5:
                    ln = rng.randint(1, 3)
                    seq_parts.append("".join(rng.choice("ACGT") for _ in range(ln)))
                    emit(CINS, ln)
                else:
                    ln = rng.randint(1, 3)
                    emit(CDEL, ln)
                    pos += ln
        if i + 1 < len(exons):
            emit(CREF_SKIP, exons[i + 1][0] - e)
    return "".join(seq_parts), ops


def simulate_read(
    rng: random.Random,
    sim: Simulation,
    tr: SimTranscript,
    idx: int,
    polya_len: int = 30,
    adapter_len: int = 12,
    reverse_prob: float = 0.5,
    truncate_prob: float = 0.0,
    tail_prob: float = 1.0,
    end_jitter: int = 0,
    indel_rate: float = 0.0,
    junction_jitter: int = 0,
    big_del_rate: float = 0.0,
) -> SimRead:
    """One cDNA-style read of a transcript.

    Gene strand decides where the tail lands in *genome-forward* (aligned)
    orientation: a '+' gene's polyA trails the body; a '-' gene's appears
    as a leading polyT. Sequencing orientation (reverse_prob) only flips
    the FASTQ sequence + the BAM REVERSE flag -- the aligned sequence and
    CIGAR are orientation-invariant, as a real aligner produces them.
    With truncate_prob, the 5' end of the molecule is degraded (leading
    exons dropped for '+' genes, trailing for '-'), the classic Nanopore
    artifact the reference's FL/gap machinery models.
    """
    exons = list(tr.exons)
    if rng.random() < truncate_prob and len(exons) > 2:
        drop = rng.randint(1, len(exons) - 2)
        if tr.strand == "+":
            exons = exons[drop:]  # 5' of a + gene = genomic left
        else:
            exons = exons[:-drop]
    if junction_jitter and len(exons) > 1:
        # splice-junction wobble: internal boundaries shift by a few bp per
        # read (aligner noise); spreads the splice signal so segmentation
        # sees wide peaks and real DP problems.
        jit = []
        for i, (s, e) in enumerate(exons):
            if i > 0:
                s = s + rng.randint(-junction_jitter, junction_jitter)
            if i < len(exons) - 1:
                e = e + rng.randint(-junction_jitter, junction_jitter)
            if e - s < 20:
                e = s + 20
            jit.append((s, e))
        # keep introns positive
        ok = all(a[1] < b[0] for a, b in zip(jit[:-1], jit[1:]))
        if ok:
            exons = jit
    if end_jitter:
        # alignment-end wobble: the outermost exons start late / end early
        s0, e0 = exons[0]
        s0 = min(s0 + rng.randint(0, end_jitter), e0 - 20)
        sl, el = exons[-1]
        el = max(el - rng.randint(0, end_jitter), sl + 20)
        if len(exons) == 1:
            exons = [(s0, el)]
        else:
            exons = [(s0, e0)] + exons[1:-1] + [(sl, el)]
    body, body_cigar = _exon_body_with_errors(rng, sim, exons, indel_rate, big_del_rate)
    adapter = "".join(rng.choice("CG") for _ in range(adapter_len))
    has_tail = rng.random() < tail_prob
    tail = "A" * polya_len if has_tail else ""
    end_adapter = "".join(rng.choice("CG") for _ in range(4))
    if tr.strand == "+":
        # molecule (genome fwd) = adapter + body + polyA + end_adapter
        lead, trail = adapter, tail + end_adapter
    else:
        # '-' gene: aligned view = revcomp(end_adapter) + polyT + body + revcomp(adapter)
        lead, trail = revcomp(tail + end_adapter), revcomp(adapter)
    aligned = lead + body + trail
    cigar = [(CSOFT_CLIP, len(lead))] if lead else []
    cigar.extend(body_cigar)
    if trail:
        cigar.append((CSOFT_CLIP, len(trail)))
    flag_reverse = rng.random() < reverse_prob
    strand = "-" if flag_reverse else "+"
    fastq_seq = revcomp(aligned) if flag_reverse else aligned
    return SimRead(
        name=f"{tr.name}_{idx}",
        transcript=tr.name,
        contig=tr.contig,
        strand=strand,
        exons=exons,
        fastq_seq=fastq_seq,
        aligned_seq=aligned,
        cigar=cigar,
        pos=exons[0][0],
    )


def simulate(
    seed: int = 7,
    contig: str = "chr1",
    contig_len: int = 2_000_000,
    n_genes: int = 2,
    isoforms_per_gene: int = 2,
    reads_per_isoform: int = 10,
    exons_per_gene: int = 5,
    gene_spacing: int = 50_000,
    minus_strand_genes: bool = False,
    truncate_prob: float = 0.0,
    tail_prob: float = 1.0,
    end_jitter: int = 0,
    indel_rate: float = 0.0,
    alt_splice: bool = False,
    junction_jitter: int = 0,
    big_del_rate: float = 0.0,
) -> Simulation:
    rng = random.Random(seed)
    genome = random_genome(contig_len, rng)
    sim = Simulation(
        contig=contig, contig_len=contig_len, genome=genome, transcripts=[]
    )
    # Genome growth for many-gene layouts uses a SEPARATE rng stream so
    # that the read/gene stream (and thus every existing fixture) is
    # byte-stable regardless of whether an extension happens.
    ext_rng = random.Random(seed ^ 0x5EED)
    max_gene_span = exons_per_gene * (250 + 1500)
    pos = 10_000
    for g in range(n_genes):
        if pos + max_gene_span + 10_000 > len(sim.genome):
            grow = max(contig_len, pos + max_gene_span + 10_000 - len(sim.genome))
            sim.genome += random_genome(grow, ext_rng)
            sim.contig_len = len(sim.genome)
        strand = "-" if (minus_strand_genes and g % 2 == 1) else "+"
        gene_exons = make_gene(rng, contig, pos, exons_per_gene)
        isoforms = make_isoforms(
            rng, gene_exons, isoforms_per_gene, contig, g, strand=strand,
            alt_splice=alt_splice,
        )
        sim.transcripts.extend(isoforms)
        for tr in isoforms:
            for i in range(reads_per_isoform):
                sim.reads.append(
                    simulate_read(
                        rng, sim, tr, i,
                        truncate_prob=truncate_prob, tail_prob=tail_prob,
                        end_jitter=end_jitter, indel_rate=indel_rate,
                        junction_jitter=junction_jitter,
                        big_del_rate=big_del_rate,
                    )
                )
        pos = gene_exons[-1][1] + gene_spacing
    # Invariant: each read's CIGAR query length matches its sequence (a
    # gene laid out past the genome end would break this silently).
    for r in sim.reads:
        qlen = sum(n for op, n in r.cigar if op in (CMATCH, CINS, CSOFT_CLIP))
        assert qlen == len(r.aligned_seq), (r.name, qlen, len(r.aligned_seq))
    return sim
