"""The segmentation breakpoint DP on PyTorch: plain twin and batch dispatch.

Port of ``freddie_tpu/ops/segdp.py`` (see its docstring for the DP's
derivation). The problem definition, the host oracle ``solve_host``, the
bucketing (``bucket_shape``) and the batch sizing
(``suggested_batch_size``) are that module's numpy code as it is; in
place of what reached ``jax`` there this module has:

- ``_solve_batch_torch``: the plain PyTorch twin of ``_solve_batch_jax``
  (same contract, same values bit for bit). It is the CPU route and the
  oracle the CUDA kernel (``ops.segdp_cuda``) is held against on the card.
- ``_walk_chains``: the backpointer walk, on the tensors' device.
- ``dispatch_batch_device`` / ``collect_batch_device`` /
  ``solve_batch_device``: padding, transfer, launch and readback, over
  one device or split over several cards (``parallel.mesh``).

The route is set by the device the batch is sent to: CUDA tensors run the
hand-written kernel, CPU tensors the plain twin. There is no fallback from
one to the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .thresholds import ScaledThresholds

_NEG = float("-inf")
NEG = np.float32(-np.inf)
MIN_SEG_LEN = 5  # py/freddie_segment.py:540


@dataclass
class DPProblem:
    """One segmentation problem: candidates [start..end] of one tint interval.

    C: (P, R) int64 -- cumulative coverage rows at the problem's candidates.
    y: (P,) int64   -- candidate positions (y-space) for lengths/min-seg rules.
    W: (R,) int64   -- read-rep weights (multiplicities).
    """

    C: np.ndarray
    y: np.ndarray
    W: np.ndarray
    read_support: int
    # Optional (K, 3) int32 [ys, ye, rep]: the read-rep intervals
    # overlapping this problem's candidate range. When every problem in
    # a dispatch chunk carries them (and the exactness gates pass), the
    # device builds C itself from these lists (ops.coverage.
    # build_coverage_device) instead of receiving the dense (B, P, R)
    # matrix -- identical kernel results, ~10x fewer host->device bytes.
    iv: "np.ndarray | None" = None


def _pair_tensors(C, y, W, thr: ScaledThresholds):
    """inside (P,P) and outside (P,P,P) tensors, f32 with -inf gates."""
    P = len(y)
    scale = thr.scale
    diff = (C[None, :, :] - C[:, None, :]).astype(np.int64)  # [i,j,r]
    seg_len = (y[None, :] - y[:, None] + 1).astype(np.int64)  # [i,j]
    h = thr.high_scaled(np.maximum(seg_len, 0)).astype(np.int64)
    eq = thr.nay_eq_scaled(np.maximum(seg_len, 0)).astype(np.int64)
    yea = scale * diff > (h * seg_len)[:, :, None]
    nay = scale * diff < ((scale - h) * seg_len + eq)[:, :, None]
    Wf = W.astype(np.float32)
    yeaW = yea.astype(np.float32) * Wf[None, None, :]
    nayW = nay.astype(np.float32) * Wf[None, None, :]
    w_sum = np.float32(Wf.sum())
    inside = -(w_sum - yeaW.sum(axis=2) - nayW.sum(axis=2))  # (P,P)
    outside = np.einsum("ijr,jkr->ijk", yeaW, nay.astype(np.float32)) + np.einsum(
        "ijr,jkr->ijk", nayW, yea.astype(np.float32)
    )
    return inside.astype(np.float32), outside.astype(np.float32), seg_len


def solve_host(problem: DPProblem, thr: ScaledThresholds) -> list[int]:
    """Solve one problem on the host; returns chosen breakpoints (local
    indices in (0, P-1), exclusive of the fixed endpoints)."""
    P = len(problem.y)
    if P <= 2:
        return []
    inside, outside, seg_len = _pair_tensors(problem.C, problem.y, problem.W, thr)
    outside = np.where(outside < problem.read_support, NEG, outside)
    small = (problem.y[None, :] - problem.y[:, None]) < MIN_SEG_LEN  # [a,b] a<b

    end = P - 1
    H = np.full((P, P), NEG, dtype=np.float32)
    K = np.full((P, P), -1, dtype=np.int64)
    H[:end, end] = inside[:end, end]
    for j in range(end - 2, -1, -1):
        # candidates k in (j, end), k_ in (k, end]
        for k in range(j + 1, end):
            if small[j, k]:
                continue
            vals = outside[j, k, k + 1 : end + 1] + H[k, k + 1 : end + 1]
            vals = np.where(small[k, k + 1 : end + 1], NEG, vals)
            best = int(np.argmax(vals))
            if vals[best] == NEG:
                continue
            H[j, k] = inside[j, k] + vals[best]
            K[j, k] = k + 1 + best

    # Top-level selection (first row-major argmax, strict vs no-segmentation).
    D0 = np.full((P, P), NEG, dtype=np.float32)
    for j in range(1, end):
        if small[0, j]:
            continue
        row = inside[0, j] + outside[0, j, j + 1 : end + 1] + H[j, j + 1 : end + 1]
        row = np.where(small[j, j + 1 : end + 1], NEG, row)
        D0[j, j + 1 : end + 1] = row
    baseline = inside[0, end]
    flat = int(np.argmax(D0))
    best_j, best_k = divmod(flat, P)
    if not (D0[best_j, best_k] > baseline):
        return []
    out = [best_j, best_k]
    j, k = best_j, best_k
    while K[j, k] >= 0:
        k_ = int(K[j, k])
        out.append(k_)
        j, k = k, k_
    return out


def bucket_shape(n_cand: int, n_reps: int) -> tuple[int, int]:
    """The padded (P, R) bucket a problem lands in. ONE definition shared
    by the batch helper and the streaming stage loop, so the set of
    kernel shapes cannot silently diverge between them (the edges are the
    JAX package's, so both packages chunk a corpus alike). Coarse edges
    keep the shape count small; past the last edge, round up by the
    step."""

    def edge(x, edges, step):
        for e in edges:
            if x <= e:
                return e
        return ((x + step - 1) // step) * step

    # R edges are 128-multiples spaced so the rep-padding waste stays
    # under ~50%: both the kernel's passes over the reps and the
    # host->device transfer scale with R.
    return (
        edge(n_cand, (16, 32, 64), 32),
        edge(n_reps, (128, 256, 384, 512, 768, 1024, 1536), 512),
    )


def suggested_batch_size(P: int, R: int, budget_bytes: int = 4 << 30) -> int:
    """Batch size keeping the (B,P,P,R) intermediates within budget."""
    per_problem = P * P * R * 4 * 6 + P * P * P * 4
    return max(1, min(4096, budget_bytes // max(per_problem, 1)))


def threshold_products(y: torch.Tensor, lookup: torch.Tensor, scale: int):
    """Scaled threshold products (B, P, P) int32 for every candidate pair.

    ``[b, i, j]`` belongs to the pair (i, j) with length y[j] - y[i] + 1:
    yea(i, j, r) is ``scale*(C[j]-C[i]) > T_hi`` and nay(i, j, r) is
    ``scale*(C[j]-C[i]) < T_lo`` (ops/thresholds.py: the packed lookup
    holds h_scaled*2 + the nay-equality bit). Same prologue as
    ``solve_batch_pallas`` (segdp_pallas.py:633-640)."""
    L = lookup.shape[0] - 1
    seg_len = y[:, None, :] - y[:, :, None] + 1
    hp = lookup[seg_len.clamp(0, L).long()]
    h, eq = hp >> 1, hp & 1
    return h * seg_len, (scale - h) * seg_len + eq


def _weight_limbs(W: torch.Tensor) -> list[torch.Tensor]:
    """Split integer-valued f32 weights into 7-bit limbs (float, 0..127).

    Every limb operand of the pair contraction is then exact in TF32 and
    bf16, so the f32 matmuls are exact whatever
    ``torch.backends.cuda.matmul.allow_tf32`` or the float32 matmul
    precision say (products accumulate exactly in f32 below 2^24). One
    limb covers weights <= 127, two cover <= 16383, and so on."""
    Wi = W.to(torch.int64)
    top = int(Wi.max()) if Wi.numel() else 0
    limbs = [(Wi & 127).to(torch.float32)]
    shift = 7
    while (top >> shift) > 0:
        limbs.append(((Wi >> shift) & 127).to(torch.float32))
        shift += 7
    return limbs


def _solve_batch_torch(C, y, W, n_cand, read_support, lookup, scale):
    """Batched DP over padded problems -- plain PyTorch twin of
    ``freddie_tpu.ops.segdp._solve_batch_jax`` (same contract).

    C: (B, P, R) int32 cumulative coverage (padded reps have W=0)
    y: (B, P) int32 candidate positions (padding replicates y[n-1])
    W: (B, R) f32 integer-valued rep weights
    n_cand: (B,) int32 valid candidate count per problem
    lookup: (L+1,) int32 packed threshold table (ops/thresholds.py)
    Returns (K, best_j, best_k): backpointers (B, P, P) int32 (row P-1 all
    -1) and the top pair per problem (-1 when no segmentation wins).

    Loops over the middle index k as the JAX scan does, so the live
    intermediates stay (B, P, R) and only the gated outside tensor is
    (B, P, P, P)."""
    B, P, R = C.shape
    dev = C.device
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    T_hi, T_lo = threshold_products(y, lookup, scale)
    Cs = C.to(torch.int32) * scale  # pre-scaled, as the kernels take it
    limbs = _weight_limbs(W)
    w_sum = W.sum(dim=1)[:, None]  # (B, 1), exact: integers below 2^24

    outside = torch.empty((B, P, P, P), dtype=torch.float32, device=dev)
    inside = torch.empty((B, P, P), dtype=torch.float32, device=dev)
    for k in range(P):
        d_to = Cs[:, k : k + 1, :] - Cs  # (B, P, R): scale*(C[k]-C[p])
        yea_to = d_to > T_hi[:, :, k, None]  # pair (p, k)
        nay_to = d_to < T_lo[:, :, k, None]
        yea_from = (-d_to > T_hi[:, k, :, None]).to(torch.float32)  # (k, p)
        nay_from = (-d_to < T_lo[:, k, :, None]).to(torch.float32)
        yea_to_f = yea_to.to(torch.float32)
        nay_to_f = nay_to.to(torch.float32)
        # inside(p, k) = -(w_sum - sum_r W*yea - sum_r W*nay)
        inside[:, :, k] = -(
            w_sum - (yea_to_f * W[:, None, :]).sum(2)
            - (nay_to_f * W[:, None, :]).sum(2)
        )
        # outside(j, k, k_) = sum_r W*yea(j,k)*nay(k,k_) + W*nay(j,k)*yea(k,k_)
        # as ONE bmm per weight limb over the concatenated rep axis.
        rhs = torch.cat([nay_from, yea_from], dim=2).transpose(1, 2)
        out_k = None
        for i, limb in enumerate(limbs):
            lhs = torch.cat([yea_to_f * limb[:, None, :],
                             nay_to_f * limb[:, None, :]], dim=2)
            part = torch.bmm(lhs, rhs)  # (B, P_j, P_k_)
            out_k = part if out_k is None else out_k + float(128 ** i) * part
        outside[:, :, k, :] = out_k
    outside = torch.where(outside < read_support, neg, outside)

    end = (n_cand.to(torch.int64) - 1)[:, None]  # (B, 1)
    kk = torch.arange(P, device=dev)
    small = (y[:, None, :] - y[:, :, None]) < MIN_SEG_LEN  # (B, a, b)
    inside_end = inside.gather(2, end[:, :, None].expand(B, P, 1))  # (B,j,1)

    # H init: column `end` holds inside(j, end) for j < end.
    H = torch.where(
        (kk[None, None, :] == end[:, :, None]) & (kk[None, :, None] < end[:, :, None]),
        inside_end, neg,
    )
    K = torch.full((B, P, P), -1, dtype=torch.int32, device=dev)
    kmask = (
        (kk[:, None] < kk[None, :])[None]  # k_ > k
        & (kk[None, None, :] <= end[:, :, None])  # k_ <= end
        & ~small  # small(k, k_)
    )
    for j in range(P - 2, -1, -1):
        vals = torch.where(kmask, outside[:, j] + H, neg)  # (B, k, k_)
        row_max = vals.amax(dim=2)  # (B, k)
        # First index attaining the max (the reference's strict ascending
        # scan), spelled out so it does not rest on the backend's argmax.
        row_arg = torch.where(vals == row_max[:, :, None], kk, P).amin(dim=2)
        valid_k = (kk > j) & (kk < end) & ~small[:, j, :] & (row_max > neg)
        row_H = torch.where(valid_k, inside[:, j, :] + row_max, neg)
        keep = (kk == end) & (j < end)
        row_H = torch.where(keep, inside_end[:, j, :], row_H)
        H[:, j] = row_H
        K[:, j] = torch.where(valid_k, row_arg, -1).to(torch.int32)

    # Top level: D0[j,k] = inside[0,j] + outside[0,j,k] + H[j,k], masked.
    jmask = (
        (kk[None, :, None] > 0) & (kk[None, :, None] < end[:, :, None])
        & (kk[None, None, :] > kk[None, :, None])
        & (kk[None, None, :] <= end[:, :, None])
        & ~small[:, 0, :, None] & ~small
    )
    D0 = torch.where(jmask, inside[:, 0, :, None] + outside[:, 0] + H, neg)
    D0 = D0.reshape(B, P * P)
    best = D0.amax(dim=1)
    flat = torch.where(
        D0 == best[:, None], torch.arange(P * P, device=dev), P * P
    ).amin(dim=1)
    baseline = inside[:, 0, :].gather(1, end)[:, 0]  # inside(0, end)
    ok = best > baseline
    best_j = torch.where(ok, flat // P, -1).to(torch.int32)
    best_k = torch.where(ok, flat % P, -1).to(torch.int32)
    return K, best_j, best_k


def _walk_chains(K, best_j, best_k):
    """Walk every problem's backpointer chain on the tensors' device.

    Reproduces collect's loop -- out = [j, k], then k_ = K[b, j, k] while
    >= 0 -- and returns (B, P+2) int32 chains, -1-terminated (all -1 when
    no segmentation won), so readback moves (B, P+2) ints instead of the
    (B, P, P) table. Twin of ``freddie_tpu.ops.segdp._walk_chains``."""
    B, P, _ = K.shape
    Kf = K.reshape(B, P * P)
    j, k = best_j.long(), best_k.long()
    alive = best_j >= 0
    rest = []
    for _ in range(P):
        idx = (j * P + k).clamp(0, P * P - 1)
        nxt = Kf.gather(1, idx[:, None])[:, 0]
        alive = alive & (nxt >= 0)
        rest.append(torch.where(alive, nxt, -1))
        j = torch.where(alive, k, j)
        k = torch.where(alive, nxt.long(), k)
    first = torch.stack([best_j, torch.where(best_j >= 0, best_k, -1)], dim=1)
    return torch.cat([first.to(torch.int32), torch.stack(rest, 1).to(torch.int32)], 1)


def to_device(arrays: dict, device) -> dict:
    """The padded numpy batch -> tensors on ``device``.

    Integer arrays become int32 (C may travel as int16 and is widened
    after the copy: half the bytes, identical values), float arrays
    float32. The one conversion between the host batch and the kernels,
    so the JAX and torch paths read byte-identical inputs."""
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        out[name] = t.to(torch.float32) if a.dtype.kind == "f" else t.to(torch.int32)
    return out


class _Launch:
    """Device results on their way to the host, read as one array.

    ``add(t)`` queues one part (a shard's rows, in batch order): for a
    CUDA tensor a copy into pinned memory on the CURRENT stream -- the one
    its producer ran on, so call it under that device and stream -- then
    an event. ``np.asarray(launch)`` waits on every part's event and
    concatenates the parts, so a readback thread never touches a stream
    and cannot copy before a launch has finished."""

    def __init__(self, tensor: torch.Tensor | None = None):
        self._parts: list = []  # (device tensor, host tensor, event or None)
        if tensor is not None:
            self.add(tensor)

    def add(self, t: torch.Tensor) -> None:
        host, done = t, None
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self._parts.append((t, host, done))

    def __array__(self, dtype=None, copy=None):
        arrays = []
        for _t, host, done in self._parts:
            if done is not None:
                done.synchronize()
            arrays.append(host.numpy())
        a = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
        return a if dtype is None else a.astype(dtype)


def dispatch_batch_device(
    problems: list[DPProblem],
    thr: ScaledThresholds,
    pad_p_to: int = 8,
    pad_r_to: int = 128,
    pad_b_to: int = 0,
    dev_cov: bool | None = None,
    device="cuda",
    devices=None,
):
    """Launch a padded batch on ``device`` WITHOUT waiting for it.

    Returns (handles, work, results) as ``freddie_tpu``'s twin does:
    ``handles`` is a ``_Launch`` of the (B, P+2) chains (None when every
    problem was solved inline on the host), ``work`` the indices
    launched, ``results`` the partially-filled output list.
    collect_batch_device() finishes the job.

    The bare "cuda" splits the batch over every visible card (the loci
    mesh, ``parallel.mesh``), as the JAX dispatch shards over its local
    devices, once each card's share passes ``mesh.MESH_MIN_WORK`` (by
    default never: then it is the current card); "cuda:N" and "cpu" name
    one device. ``devices``, a list of devices, overrides both: the batch is
    split over exactly those, whatever its size (one device may be listed
    several times).

    A batch for a CUDA device whose padded P is wider than K1 holds
    (``segdp_cuda.K1_MAX_P``) is solved here with ``solve_host``, problem
    by problem, and returned as (None, [], results), like the
    int32-overflow batch below: the JAX dispatch's XLA route and this
    package's CPU route solve such a batch, so the CUDA route must too.
    ``segdp_cuda.WIDE_HOST_BATCHES`` and ``WIDE_HOST_PROBLEMS`` count them;
    the pipeline writes their growth into the segment stage's metrics."""
    from ..parallel import mesh
    from . import segdp_cuda

    if not problems:
        return None, [], []
    results: list[list[int] | None] = [None] * len(problems)
    work = [i for i, pr in enumerate(problems) if len(pr.y) > 2]
    for i, pr in enumerate(problems):
        if len(pr.y) <= 2:
            results[i] = []
    if not work:
        return None, [], results

    def rnd(x, m):
        return ((x + m - 1) // m) * m

    P = rnd(max(len(problems[i].y) for i in work), pad_p_to)
    R = rnd(max(problems[i].C.shape[1] for i in work), pad_r_to)
    # Power-of-two batch (and pad_b_to for a bucket's final partial
    # chunk): the same small, stable set of batch shapes as the JAX
    # path. Padding rows replicate problem 0; their outputs are unused.
    B = len(work)
    B_pad = 8
    while B_pad < B:
        B_pad <<= 1
    B_pad = max(B_pad, pad_b_to)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    on_card = (devices[0] if devices else torch.device(device)).type == "cuda"
    if on_card and P > segdp_cuda.K1_MAX_P:
        for i in work:
            results[i] = solve_host(problems[i], thr)
        segdp_cuda.WIDE_HOST_BATCHES += 1
        segdp_cuda.WIDE_HOST_PROBLEMS += len(work)
        return None, [], results
    if devices is None:
        devices = mesh.devices_for(device, B_pad * P**3 * R)
    y = np.zeros((B_pad, P), dtype=np.int32)
    W = np.zeros((B_pad, R), dtype=np.float32)
    n_cand = np.zeros((B_pad,), dtype=np.int32)
    rs = {problems[i].read_support for i in work}
    if len(rs) != 1:
        raise ValueError("mixed read_support in one batch")
    for b, i in enumerate(work):
        pr = problems[i]
        p = len(pr.y)
        y[b, :p] = pr.y
        y[b, p:] = pr.y[-1]
        W[b, : len(pr.W)] = pr.W
        n_cand[b] = p
    if B_pad > B:
        y[B:] = y[0]
        W[B:] = W[0]
        n_cand[B:] = n_cand[0]

    # Device coverage build from interval lists (ops.coverage): same
    # content gates as the JAX dispatch, including its bound on the mesh
    # (shards pad only on the dense route); FREDDIE_DEVICE_COVERAGE=0/1
    # overrides. Value-neutral either way.
    env_cov = os.environ.get("FREDDIE_DEVICE_COVERAGE")
    want_cov = (
        env_cov != "0"
        if env_cov is not None
        else (True if dev_cov is None else dev_cov)
    )
    use_dev_cov = (
        want_cov
        and (-B_pad) % len(devices) == 0
        and all(problems[i].iv is not None for i in work)
        and thr.scale * (int(y.max(initial=0)) + 1) < 2**31
    )
    if use_dev_cov:
        I_max = max(len(problems[i].iv) for i in work)
        if I_max > 4096:
            use_dev_cov = False
    if use_dev_cov:
        I_pad = 512 if I_max <= 512 else (2048 if I_max <= 2048 else 4096)
        iv = np.zeros((B_pad, I_pad, 3), dtype=np.int32)
        iv[:, :, 1] = -1  # padding: empty interval
        iv[:, :, 2] = R  # padding rep -> dropped row of the segment sum
        for b, i in enumerate(work):
            pv = problems[i].iv
            iv[b, : len(pv)] = pv
        if B_pad > B:
            iv[B:] = iv[0]
        arrays = dict(iv=iv, y=y, W=W, n_cand=n_cand)
    else:
        C = np.zeros((B_pad, P, R), dtype=np.int32)
        for b, i in enumerate(work):
            pr = problems[i]
            p, r = pr.C.shape
            C[b, :p, :r] = pr.C
            C[b, p:, :r] = pr.C[-1]  # replicate last row; padded y too
        if B_pad > B:
            C[B:] = C[0]
        # The kernels compare thresholds in int32 (C pre-multiplied by
        # scale); the host oracle in int64. Where scale * operand could
        # overflow int32, solve on the host: bit-identical results.
        max_operand = max(int(C.max(initial=0)), int(y.max(initial=0)) + 1)
        if thr.scale * max_operand >= 2**31:
            for i in work:
                results[i] = solve_host(problems[i], thr)
            return None, [], results
        # Ship C as int16 when every coverage fits (the common case).
        if int(C.max(initial=0)) < 2**15:
            C = C.astype(np.int16)
        arrays = dict(C=C, y=y, W=W, n_cand=n_cand)

    # Several devices: pad B to a multiple of their count by replicating
    # the last row (outputs unused), as the JAX dispatch pads for its mesh.
    pad = (-B_pad) % len(devices)
    if pad:
        arrays = {k: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                  for k, a in arrays.items()}
    (chains,) = mesh.launch_sharded(arrays, next(iter(rs)), thr.lookup, thr.scale,
                                    devices, return_chains=True)
    return chains, work, results


def collect_batch_device(handles, work, results) -> list[list[int]]:
    """Read back a dispatch_batch_device launch: ``np.asarray`` on the
    handle is the synchronization point and moves only (B, P+2) int32."""
    if handles is not None:
        chains = np.asarray(handles)
        for b, i in enumerate(work):
            row = chains[b]
            if row[0] < 0:
                results[i] = []
                continue
            stop = np.flatnonzero(row < 0)
            results[i] = row[: stop[0] if len(stop) else len(row)].tolist()
    return [r for r in results]  # type: ignore


def solve_batch_device(
    problems: list[DPProblem],
    thr: ScaledThresholds,
    pad_p_to: int = 8,
    pad_r_to: int = 128,
    device="cuda",
    devices=None,
) -> list[list[int]]:
    """Solve a batch of problems on ``device`` (or split over the list
    ``devices``); identical results to solve_host, bit for bit.
    dispatch_batch_device/collect_batch_device are the async halves for
    callers overlapping several launches."""
    handles, work, results = dispatch_batch_device(
        problems, thr, pad_p_to=pad_p_to, pad_r_to=pad_r_to, device=device, devices=devices
    )
    return collect_batch_device(handles, work, results)
