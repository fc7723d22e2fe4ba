"""Segment histogram of the PyTorch port (``lightgbm_tpu_torch/ops/
histogram.py``, the plain twin of the CUDA kernel) against the JAX
package, on the CPU.

References: the XLA planes histogram ``hist16_segment_planes``, the Pallas
kernel ``hist_pallas_segment_planes`` under the interpreter, and the f64
numpy oracle ``build_histogram_np``.

Tolerances, per bin, with S = sum |x| over the bin's rows:
- count channel: exact, always;
- port vs JAX: |diff| <= 2^-18 S. Both round every row identically (bf16
  hi/lo pairs, or bf16); the f32 sums run in another order;
- port vs the f64 oracle: |diff| <= 2^-16 S in exact (hi/lo) mode, where
  a row keeps 16 significant bits, and 2^-8 S in bf16 mode (8 bits).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu.ops.partition as P
from lightgbm_tpu.ops.histogram import (hist16_segment_planes,
                                        hist_pallas_segment_planes)

from lightgbm_tpu_torch.ops.histogram import (build_histogram_np, channels,
                                              segment_histogram)

F, NUM_BIN, N, GUARD = 20, 32, 1500, 512


def _data(seed, num_bin=NUM_BIN, n=N):
    rng = np.random.RandomState(seed)
    npad = ((n + 2 * GUARD + 127) // 128) * 128
    bins = np.zeros((npad, F), np.uint8)
    bins[GUARD:GUARD + n] = rng.randint(0, num_bin, (n, F))
    ghc = np.zeros((npad, 3), np.float32)
    ghc[GUARD:GUARD + n, 0] = rng.randn(n) * 3
    ghc[GUARD:GUARD + n, 1] = np.abs(rng.randn(n)) + 0.01
    ghc[GUARD:GUARD + n, 2] = 1.0
    w0 = np.asarray(P.pack_planes(jnp.asarray(bins), jnp.asarray(ghc)))
    return np.stack([np.zeros_like(w0), w0]), bins, ghc


def _bound(bins, ghc, s0, s1, num_bin, rel):
    absum = build_histogram_np(bins[s0:s1], np.abs(ghc[s0:s1]).astype(
        np.float64), num_bin).astype(np.float64)
    return rel * absum + 1e-12


@pytest.mark.parametrize("exact,start,cnt", [
    (True, 0, N), (True, 137, 700), (True, 333, 1), (False, 137, 700),
    (False, 900, 0)])
def test_segment_histogram_matches_jax(exact, start, cnt, monkeypatch):
    work, bins, ghc = _data(start + cnt)
    s0, s1 = GUARD + start, GUARD + start + cnt
    got = segment_histogram(torch.as_tensor(work),
                            torch.tensor([1, s0, cnt], dtype=torch.int32),
                            num_bins=NUM_BIN, num_feat=F, exact=exact,
                            cnt_bound=cnt).numpy()
    args = (jnp.asarray(work), jnp.int32(1), jnp.int32(s0), jnp.int32(cnt))
    xla = np.asarray(hist16_segment_planes(*args, num_bins=NUM_BIN,
                                           num_feat=F, exact=exact,
                                           chunk=256))
    monkeypatch.setattr(P, "_INTERPRET", True)
    pal, _ = hist_pallas_segment_planes(*args, num_bins=NUM_BIN, num_feat=F,
                                        exact=exact, chunk=256)
    pal = np.asarray(pal)
    oracle = build_histogram_np(bins[s0:s1], ghc[s0:s1].astype(np.float64),
                                NUM_BIN)
    assert got.shape == (F, NUM_BIN, 3)
    for ref in (xla, pal, oracle):
        assert np.array_equal(got[..., 2], ref[..., 2])      # counts exact
    near = _bound(bins, ghc, s0, s1, NUM_BIN, 2.0 ** -18)
    for ref in (xla, pal):
        assert (np.abs(got - ref) <= near).all()
    if cnt == 1:
        # one row: its contribution is the same number in both packages
        assert np.array_equal(got.view(np.uint32), xla.view(np.uint32))
    far = _bound(bins, ghc, s0, s1, NUM_BIN,
                 2.0 ** -16 if exact else 2.0 ** -8)
    assert (np.abs(got - oracle) <= far).all()


def test_channels_round_like_jax():
    """Per-row channel values: bf16 round to nearest even, hi/lo pair."""
    from lightgbm_tpu.ops.histogram import _split_bf16

    x = np.random.RandomState(5).randn(4096).astype(np.float32) * 7
    x[:4] = [1.00390625, 1.01171875, -3.0078125, 1e-30]    # ties and tiny
    ghc = torch.as_tensor(np.stack([x, -x, np.ones_like(x)]))
    ch = channels(ghc, exact=True).numpy()
    hi, lo = _split_bf16(jnp.asarray(x))
    assert np.array_equal(ch[0], np.asarray(hi, np.float32))
    assert np.array_equal(ch[1], np.asarray(lo, np.float32))
    bf = channels(ghc, exact=False).numpy()
    assert np.array_equal(bf[0], np.asarray(jnp.asarray(x).astype(
        jnp.bfloat16), np.float32))


def test_full_width_bins():
    """256 bins (u8 codes 0..255) and a bundle-wide column count."""
    work, bins, ghc = _data(9, num_bin=256, n=700)
    got = segment_histogram(torch.as_tensor(work),
                            torch.tensor([1, GUARD, 700], dtype=torch.int32),
                            num_bins=256, num_feat=F, cnt_bound=700).numpy()
    oracle = build_histogram_np(bins[GUARD:GUARD + 700],
                                ghc[GUARD:GUARD + 700].astype(np.float64), 256)
    assert np.array_equal(got[..., 2], oracle[..., 2])
    assert (np.abs(got - oracle) <= _bound(bins, ghc, GUARD, GUARD + 700,
                                           256, 2.0 ** -16)).all()


def test_segment_histogram_validates_inputs():
    work = torch.zeros((2, 20, 256), dtype=torch.uint8)
    seg = torch.tensor([0, 0, 10], dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_histogram(work, seg, num_bins=16, num_feat=9, cnt_bound=10)
    with pytest.raises(ValueError):
        segment_histogram(work, seg[:2], num_bins=16, num_feat=8,
                          cnt_bound=10)
    with pytest.raises(ValueError):
        segment_histogram(work, seg, num_bins=300, num_feat=8, cnt_bound=10)
