"""The segmentation breakpoint DP on PyTorch: plain twin and batch dispatch.

Port of ``freddie_tpu/ops/segdp.py``. The problem definition, the host
oracle ``solve_host``, the bucketing (``bucket_shape``) and the batch
sizing (``suggested_batch_size``) are imported from the JAX package
unchanged (they are numpy); this module owns what reached ``jax`` there:

- ``_solve_batch_torch``: the plain PyTorch twin of ``_solve_batch_jax``
  (same contract, same values bit for bit). It is the CPU route and the
  oracle the CUDA kernel (``ops.segdp_cuda``) is held against on the card.
- ``_walk_chains``: the backpointer walk, on the tensors' device.
- ``dispatch_batch_device`` / ``collect_batch_device`` /
  ``solve_batch_device``: padding, transfer, launch and readback.

The route is set by the device the batch is sent to: CUDA tensors run the
hand-written kernel, CPU tensors the plain twin. There is no fallback from
one to the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from freddie_tpu.ops.segdp import (  # noqa: F401  (re-exported for callers)
    MIN_SEG_LEN,
    DPProblem,
    bucket_shape,
    solve_host,
    suggested_batch_size,
)
from freddie_tpu.ops.thresholds import ScaledThresholds

from ..device import resolve_device

_NEG = float("-inf")


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
    """A dispatched batch's (B, P+2) chains on their way to the host.

    On CUDA the kernel and the chain walk were enqueued on the current
    stream; the device-to-host copy goes into pinned memory on the SAME
    stream, then an event. Reading the result waits on that event only,
    so a readback thread never touches a stream and cannot copy before
    the launch has finished. ``np.asarray(launch)`` reads it."""

    def __init__(self, chains: torch.Tensor):
        self._chains = chains
        self._done = None
        if chains.is_cuda:
            self.host = torch.empty(
                chains.shape, dtype=chains.dtype, pin_memory=True
            )
            self.host.copy_(chains, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self.host = chains

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype)


def dispatch_batch_device(
    problems: list[DPProblem],
    thr: ScaledThresholds,
    pad_p_to: int = 8,
    pad_r_to: int = 128,
    pad_b_to: int = 0,
    dev_cov: bool | None = None,
    device="cuda",
):
    """Launch a padded batch on ``device`` WITHOUT waiting for it.

    Returns (handles, work, results) as ``freddie_tpu``'s twin does:
    ``handles`` is a ``_Launch`` of the (B, P+2) chains (None when every
    problem was solved inline on the host), ``work`` the indices
    launched, ``results`` the partially-filled output list.
    collect_batch_device() finishes the job."""
    from .segdp_cuda import solve_batch_cuda

    dev = resolve_device(device)
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
    # content gates as the JAX dispatch; FREDDIE_DEVICE_COVERAGE=0/1
    # overrides. Value-neutral either way.
    env_cov = os.environ.get("FREDDIE_DEVICE_COVERAGE")
    want_cov = (
        env_cov != "0"
        if env_cov is not None
        else (True if dev_cov is None else dev_cov)
    )
    use_dev_cov = (
        want_cov
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
        from .coverage import build_coverage_device

        t = to_device(dict(iv=iv, y=y, W=W, n_cand=n_cand), dev)
        C = build_coverage_device(t["iv"], t["y"], R)  # (B, P, R) int32
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
        t = to_device(dict(C=C, y=y, W=W, n_cand=n_cand), dev)
        C = t["C"]

    lookup = torch.from_numpy(np.asarray(thr.lookup, dtype=np.int32)).to(dev)
    K, best_j, best_k = solve_batch_cuda(
        C, t["y"], t["W"], t["n_cand"], next(iter(rs)), lookup, thr.scale,
        wide_weights=bool(W.max(initial=0.0) > 127),
    )
    return _Launch(_walk_chains(K, best_j, best_k)), work, results


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
) -> list[list[int]]:
    """Solve a batch of problems on ``device``; identical results to
    solve_host, bit for bit. dispatch_batch_device/collect_batch_device
    are the async halves for callers overlapping several launches."""
    handles, work, results = dispatch_batch_device(
        problems, thr, pad_p_to=pad_p_to, pad_r_to=pad_r_to, device=device
    )
    return collect_batch_device(handles, work, results)
