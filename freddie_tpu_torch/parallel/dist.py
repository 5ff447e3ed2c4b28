"""Multi-process execution on ``torch.distributed``: locus sharding and the
collective GTF merge.

Port of ``freddie_tpu/parallel/dist.py``, which runs on
``jax.distributed``. Every process runs the same pipeline over the loci
whose (contig, tint_id) hash lands on it (``owns_tint``, as in the JAX
module); rank 0 splits once, a barrier hands the split to the others,
segment and cluster process only owned loci, and the isoforms stage
all-gathers the GTF records (lengths first, then padded uint8 payloads)
and sorts them on every rank, so each rank holds the same GTF and rank 0
writes it -- the single sort of py/freddie_isoforms.py:281-287, made
collective. The collectives run on gloo over TCP (host memory: the
payload is a few bytes per transcript); nothing here needs NCCL.

Nothing tells a process of its peers: ``initialize`` takes the
coordinator's ``host:port``, the world size and the rank. With one
process every collective degenerates to the identity.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import IsoformsConfig, PipelineConfig
from ..stages.cluster import run_cluster
from ..stages.isoforms import tint_isoforms
from ..stages.segment import run_segment
from ..stages.split import run_split


def owns_tint(contig: str, tint_id: int, process_index: int, process_count: int) -> bool:
    """Deterministic round-robin-by-hash locus assignment (stable across
    runs and platforms; not Python's salted hash)."""
    if process_count <= 1:
        return True
    digest = hashlib.blake2b(
        f"{contig}:{tint_id}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little") % process_count == process_index


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = 1800.0) -> tuple[int, int]:
    """Join the process group at ``coordinator`` ("host:port") as rank
    ``process_id`` of ``num_processes`` when a coordinator is given;
    returns (rank, world size), (0, 1) for a lone process. ``timeout``
    (seconds) bounds the rendezvous and every later collective, so a lost
    peer fails the run instead of hanging it."""
    if coordinator is not None and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout),
        )
    return _world()


def merge_gtf_records(local_records: list[tuple[tuple, str]]) -> list[tuple[tuple, str]]:
    """All-gather every rank's GTF records and return the globally sorted
    list (the same on every rank). A lone process just sorts."""
    _rank, world = _world()
    if world <= 1:
        return sorted(local_records)
    # Keys are re-derived from the text after transport (chrom = first
    # field, start0 = transcript start - 1).
    payload = "\x00".join(text for _key, text in local_records).encode()
    n = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    max_n = max(1, max(int(x) for x in lens))  # gloo wants non-empty buffers
    buf = torch.from_numpy(np.frombuffer(payload.ljust(max_n, b"\x00"), dtype=np.uint8).copy())
    bufs = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    merged: list[tuple[tuple, str]] = []
    for b, ln in zip(bufs, lens):
        raw = np.asarray(b[: int(ln)]).tobytes().decode()
        if not raw:
            continue
        for text in raw.split("\x00"):
            first = text.split("\n")[0].split("\t")
            merged.append(((first[0], int(first[3]) - 1), text))
    return sorted(merged)


def rank_device(device, rank: int) -> str:
    """The device a rank runs on: for the bare "cuda", card
    ``rank % device_count`` (ranks of one host share its cards); any
    other name as given."""
    if str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        return f"cuda:{rank % torch.cuda.device_count()}"
    return str(device)


def run_pipeline_distributed(
    bam: str,
    reads: list[str],
    outdir: str,
    cfg: PipelineConfig | None = None,
    process_index: int | None = None,
    process_count: int | None = None,
    log=print,
    device="cuda",
) -> list[tuple[tuple, str]]:
    """Multi-process pipeline into a directory every rank shares: rank 0
    runs split (deterministic, so a rerun finds it done), a barrier hands
    it on, then each rank runs this package's segment and cluster stages
    on its own loci, on ``rank_device(device, rank)``, and the isoforms
    stage merges collectively. Returns the merged records; rank 0 writes
    the GTF."""
    cfg = cfg or PipelineConfig()
    rank, world = _world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    dev = rank_device(device, pi)
    split_dir = os.path.join(outdir, "split")
    segment_dir = os.path.join(outdir, "segment")
    cluster_dir = os.path.join(outdir, "cluster")

    def owns(contig, tint_id):
        return owns_tint(contig, tint_id, pi, pc)

    if not os.path.isdir(split_dir) and pi == 0:
        run_split(bam, reads, split_dir, cfg.split)
    if world > 1:
        dist.barrier()
    log(f"[dist p{pi}/{pc}] split ready")
    run_segment(split_dir, segment_dir, cfg.segment, owns=owns, device=dev)
    log(f"[dist p{pi}/{pc}] segment shard done on {dev}")
    run_cluster(segment_dir, cluster_dir, cfg.cluster, owns=owns, device=dev)
    log(f"[dist p{pi}/{pc}] cluster shard done on {dev}")
    return run_isoforms_distributed(
        split_dir, cluster_dir, os.path.join(outdir, "isoforms.gtf"), cfg.isoforms,
        process_index=pi, process_count=pc,
    )


def run_isoforms_distributed(
    split_dir: str,
    cluster_dir: str,
    output: str,
    cfg: IsoformsConfig | None = None,
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[tuple[tuple, str]]:
    """Shard-aware isoforms stage: consensus on owned tints only, then the
    collective merge; every rank returns the merged records and rank 0 (or
    a lone process) writes the GTF."""
    cfg = cfg or IsoformsConfig()
    rank, world = _world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    local: list[tuple[tuple, str]] = []
    for contig in sorted(os.listdir(cluster_dir)):
        cdir = os.path.join(cluster_dir, contig)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("cluster_") and fn.endswith(".tsv")):
                continue
            tint_id = int(fn[:-4].split("_")[-1])
            if not owns_tint(contig, tint_id, pi, pc):
                continue
            split_tsv = os.path.join(split_dir, contig, f"split_{contig}_{tint_id}.tsv")
            local.extend(tint_isoforms(os.path.join(cdir, fn), split_tsv, cfg))

    merged = merge_gtf_records(local)
    if pi == 0:
        with open(output, "w") as f:
            for _key, text in merged:
                f.write(text)
                f.write("\n")
    return merged
