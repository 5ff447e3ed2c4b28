"""The segmentation breakpoint DP, plain PyTorch, float64 scores.

The problem as the original freddie states it (py/freddie_segment.py's
DP, which the program's ``solve_host`` docstring derives): for
candidates 0..end with positions y, cumulative coverage C (P, R) and
rep weights W,

    yes(i, j, r) = (C[j, r] - C[i, r]) / (y[j] - y[i] + 1) > h
    no(i, j, r)  = (C[j, r] - C[i, r]) / (y[j] - y[i] + 1) < 1 - h
    inside(i, j) = -(sum W - sum_r W yes(i, j, r) - sum_r W no(i, j, r))
    outside(i, j, k) = sum_r W (yes(i, j) no(j, k) + no(i, j) yes(j, k)),
                       -inf below the read support
    H(j, end) = inside(j, end);  H(j, k) = inside(j, k) + max over k_ of
                outside(j, k, k_) + H(k, k_),  k_ in (k, end]

with every segment shorter than 5 bp masked, the first index taking each
maximum, and the top pair (j, k) the first row-major maximum of
inside(0, j) + outside(0, j, k) + H(j, k), kept only where it beats
inside(0, end). The answer is [j, k, k_, ...] by the backpointers.

The thresholds are compared and the scores summed in ``dtype``: float64
by default, as the original computes them, in which every score is an
exact integer. ``dtype=torch.float32`` is the control: the same problem
in the precision below float64, where a ratio exactly at 1 - h can read
the other way (``thresholds``).
Problems are solved in groups of one candidate count, vectorised over the
group and over k.
"""

from __future__ import annotations

import numpy as np
import torch

from .thresholds import verdicts

MIN_SEG_LEN = 5
NEG = float("-inf")


def solve_group(C, y, W, read_support: int, rate: float, dtype=torch.float64):
    """Solve B problems of one candidate count P. C (B, P, R) int64, y (B,
    P) int64, W (B, R) int64 (zero for padded reps). Returns a list of B
    answers ([] where no segmentation wins)."""
    B, P, R = C.shape
    if P <= 2:
        return [[] for _ in range(B)]
    dev = C.device
    seg_len = y[:, None, :] - y[:, :, None] + 1  # [b, i, j]
    diff = C[:, None, :, :] - C[:, :, None, :]  # [b, i, j, r] = C[j] - C[i]
    yes, no = verdicts(diff, seg_len[..., None], rate, dtype)
    Wd = W.to(dtype)
    yesW = yes.to(dtype) * Wd[:, None, None, :]
    noW = no.to(dtype) * Wd[:, None, None, :]
    w_sum = Wd.sum(dim=1)[:, None, None]
    inside = -(w_sum - yesW.sum(dim=3) - noW.sum(dim=3))  # (B, P, P)
    outside = torch.empty((B, P, P, P), dtype=dtype, device=dev)
    yes_d, no_d = yes.to(dtype), no.to(dtype)
    for j in range(P):
        # outside[:, i, j, k] = sum_r W yes(i,j) no(j,k) + W no(i,j) yes(j,k)
        outside[:, :, j, :] = (torch.bmm(yesW[:, :, j, :], no_d[:, j].transpose(1, 2))
                               + torch.bmm(noW[:, :, j, :], yes_d[:, j].transpose(1, 2)))
    del diff, yes, no, yesW, noW, yes_d, no_d
    neg = torch.tensor(NEG, dtype=dtype, device=dev)
    outside = torch.where(outside < read_support, neg, outside)
    small = (y[:, None, :] - y[:, :, None]) < MIN_SEG_LEN  # [b, a, c]: y[c] - y[a] < 5
    end = P - 1
    kk = torch.arange(P, device=dev)
    H = torch.full((B, P, P), NEG, dtype=dtype, device=dev)
    H[:, :end, end] = inside[:, :end, end]
    K = torch.full((B, P, P), -1, dtype=torch.int64, device=dev)
    # kmask[b, k, k_]: k_ in (k, end] and the segment k..k_ long enough
    kmask = (kk[:, None] < kk[None, :])[None] & ~small
    for j in range(end - 2, -1, -1):
        vals = torch.where(kmask, outside[:, j] + H, neg)  # (B, k, k_)
        best = vals.amax(dim=2)
        arg = torch.where(vals == best[:, :, None], kk, P).amin(dim=2)
        ok = (kk > j) & (kk < end) & ~small[:, j, :] & (best > neg)
        H[:, j, :end] = torch.where(ok, inside[:, j, :] + best, neg)[:, :end]
        K[:, j] = torch.where(ok, arg, -1)
    jmask = ((kk[:, None] > 0) & (kk[:, None] < end) & (kk[None, :] > kk[:, None]))[None]
    jmask = jmask & ~small[:, 0, :, None] & ~small
    D0 = torch.where(jmask, inside[:, 0, :, None] + outside[:, 0] + H, neg).reshape(B, P * P)
    top = D0.amax(dim=1)
    flat = torch.where(D0 == top[:, None], torch.arange(P * P, device=dev), P * P).amin(dim=1)
    wins = (top > inside[:, 0, end]).tolist()
    flat, K = flat.tolist(), K.cpu().numpy()
    out = []
    for b in range(B):
        if not wins[b]:
            out.append([])
            continue
        j, k = divmod(flat[b], P)
        chain = [j, k]
        while K[b, j, k] >= 0:
            j, k = k, int(K[b, j, k])
            chain.append(k)
        out.append(chain)
    return out


def solve_all(problems, read_support: int, rate: float, device="cpu",
              dtype=torch.float64, max_elems: int = 1 << 27) -> list[list[int]]:
    """Answers to ``problems``, a list of (C (P, R), y (P,), W (R,)) numpy
    int arrays, grouped by P and cut into blocks of at most ``max_elems``
    entries of the (B, P, P, R) verdicts."""
    out: list = [None] * len(problems)
    by_p: dict[int, list[int]] = {}
    for i, (_C, y, _W) in enumerate(problems):
        by_p.setdefault(len(y), []).append(i)
    for P, idxs in sorted(by_p.items()):
        R = max(problems[i][0].shape[1] for i in idxs)
        per = max(1, max_elems // max(1, P * P * R))
        for lo in range(0, len(idxs), per):
            part = idxs[lo : lo + per]
            C = np.zeros((len(part), P, R), dtype=np.int64)
            W = np.zeros((len(part), R), dtype=np.int64)
            y = np.zeros((len(part), P), dtype=np.int64)
            for b, i in enumerate(part):
                Ci, yi, Wi = problems[i]
                C[b, :, : Ci.shape[1]] = Ci
                W[b, : len(Wi)] = Wi
                y[b] = yi
            ans = solve_group(torch.from_numpy(C).to(device), torch.from_numpy(y).to(device),
                              torch.from_numpy(W).to(device), read_support, rate, dtype)
            for i, a in zip(part, ans):
                out[i] = a
    return out
