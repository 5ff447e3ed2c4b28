"""Coverage built on the device by PyTorch against JAX's and the host
cumulative_coverage (the pattern of tests/test_device_coverage.py).
Integer arithmetic throughout: equality is exact."""

import numpy as np
import pytest
import torch

from freddie_tpu.ops.coverage import build_coverage_device as jax_build
from freddie_tpu.ops.coverage import cumulative_coverage
from freddie_tpu_torch.ops.coverage import build_coverage_device


def _random_lists(rng, B, I, P, R):
    iv = np.zeros((B, I, 3), dtype=np.int32)
    y = np.sort(rng.integers(1, 5000, size=(B, P)).astype(np.int32), axis=1)
    for b in range(B):
        s = rng.integers(0, 4800, size=I)
        iv[b, :, 0] = s
        iv[b, :, 1] = s + rng.integers(0, 300, size=I)
        iv[b, :, 2] = rng.integers(0, R, size=I)
    return iv, y


@pytest.mark.parametrize("seed", [3, 8])
def test_coverage_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    B, I, P, R = 5, 37, 9, 12
    iv, y = _random_lists(rng, B, I, P, R)
    # Padding rows as the dispatch writes them: empty interval, rep == R.
    iv[:, -4:, 0] = 0
    iv[:, -4:, 1] = -1
    iv[:, -4:, 2] = R
    got = build_coverage_device(torch.from_numpy(iv), torch.from_numpy(y), R)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, P, R)
    got = got.numpy().astype(np.int64)
    want = np.asarray(jax_build(iv, y, R)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        real = iv[b, :-4].astype(np.int64)
        host = cumulative_coverage(real[:, 0], real[:, 1], real[:, 2], R,
                                   y[b].astype(np.int64), validate=True)[:P]
        # every interval shipped -> equal to the host rows, and so are
        # the differences C[k] - C[p] the kernels consume
        np.testing.assert_array_equal(got[b], host)
        np.testing.assert_array_equal(got[b][None] - got[b][:, None],
                                      host[None] - host[:, None])


def test_coverage_offset_invariance():
    """Dropping intervals entirely below the candidate range shifts C by a
    per-rep constant only."""
    rng = np.random.default_rng(4)
    I, P, R = 20, 6, 5
    s = rng.integers(0, 1000, size=I)
    e = s + rng.integers(0, 100, size=I)
    r = rng.integers(0, R, size=I)
    y = np.sort(rng.integers(1500, 4000, size=P).astype(np.int32))[None]
    below = e < int(y[0, 0])
    full = np.stack([s, e, r], axis=1).astype(np.int32)[None]
    C_full = build_coverage_device(torch.from_numpy(full), torch.from_numpy(y), R)
    C_sub = build_coverage_device(torch.from_numpy(full[:, ~below]), torch.from_numpy(y), R)
    diff = (C_full - C_sub)[0].numpy()
    assert below.any()
    assert np.all(diff == diff[0:1, :])
