"""Segment partition of the PyTorch port (``lightgbm_tpu_torch/ops/
partition.py``, the plain twin of the CUDA kernel) against the JAX
package, on the CPU.

The JAX references are the XLA planes partition and the Pallas kernel
``partition_segment_planes_fused`` run under the interpreter (cases of
tests/test_work_layout.py). The JAX kernel leaves the order within a side
unspecified and the XLA path writes right rows chunk-reversed, so against
them: ``lt`` equal, left rows byte-equal in order, right rows equal as a
set, lanes outside the segment untouched. The port's order is stable on
both sides, which a numpy oracle pins byte for byte.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu.ops.partition as P

from lightgbm_tpu_torch.ops.partition import (GH_BYTES, pack_planes,
                                              pack_planes_fold_root,
                                              partition_segment, planes_npad,
                                              unpack_ghc_planes, work_spec)

N, F, NUM_BIN = 1500, 20, 32


def _work(rng, guard):
    npad = ((N + 2 * guard + 127) // 128) * 128
    bins = np.zeros((npad, F), np.uint8)
    bins[guard:guard + N] = rng.randint(0, NUM_BIN, (N, F))
    ghc = np.zeros((npad, 3), np.float32)
    ghc[guard:guard + N] = rng.randn(N, 3)
    ghc[guard:guard + N, 2] = 1.0
    w0 = np.asarray(P.pack_planes(jnp.asarray(bins), jnp.asarray(ghc)))
    sib = rng.randint(0, 256, w0.shape).astype(np.uint8)   # junk dst plane
    return np.stack([w0, sib])


@pytest.mark.parametrize("start,cnt,ch", [(137, 700, 256), (0, 1500, 256),
                                          (513, 100, 256), (333, 1400, 512)])
def test_partition_matches_jax(start, cnt, ch, monkeypatch):
    rng = np.random.RandomState(start + cnt)
    guard = ch + 2 * P.PLANE_ALIGN
    work = _work(rng, guard)
    table = rng.rand(NUM_BIN) < 0.45
    s0, s1 = guard + start, guard + start + cnt
    args = (jnp.int32(0), jnp.int32(s0), jnp.int32(cnt), jnp.int32(3),
            jnp.asarray(table))
    out_x, lt_x = P.partition_segment_planes(jnp.asarray(work), *args, ch=ch)
    monkeypatch.setattr(P, "_INTERPRET", True)
    out_p, lt_p = P.partition_segment_planes_fused(jnp.asarray(work), *args,
                                                   ch=ch)
    mine = torch.as_tensor(work.copy())
    seg = torch.tensor([0, s0, cnt, 3], dtype=torch.int32)
    lt = partition_segment(mine, seg, torch.as_tensor(table), cnt)
    got = mine.numpy()
    assert lt.dtype == torch.int32 and lt.shape == (1,)
    lt = int(lt)
    assert lt == int(lt_x) == int(lt_p)
    for ref in (np.asarray(out_x), np.asarray(out_p)):
        assert np.array_equal(got[1, :, s0:s0 + lt], ref[1, :, s0:s0 + lt])
        assert sorted(map(bytes, got[1, :, s0 + lt:s1].T)) == \
            sorted(map(bytes, ref[1, :, s0 + lt:s1].T))
    # neighbours and the source plane are untouched
    assert np.array_equal(got[1, :, :s0], work[1, :, :s0])
    assert np.array_equal(got[1, :, s1:], work[1, :, s1:])
    assert np.array_equal(got[0], work[0])
    # stable on both sides: numpy oracle
    cols = work[0, :, s0:s1]
    go = table[cols[3]]
    want = np.concatenate([cols[:, go], cols[:, ~go]], axis=1)
    assert np.array_equal(got[1, :, s0:s1], want)


@pytest.mark.parametrize("which", ["all_left", "all_right", "empty",
                                   "one_row"])
def test_partition_edge_segments(which):
    rng = np.random.RandomState(1)
    work = _work(rng, 128)
    table = np.zeros(NUM_BIN, bool)
    start, cnt = 300, 257
    if which == "all_left":
        table[:] = True
    elif which == "empty":
        cnt = 0
    elif which == "one_row":
        cnt, table[:] = 1, True
    mine = torch.as_tensor(work.copy())
    lt = partition_segment(mine, torch.tensor([0, start, cnt, 5],
                                              dtype=torch.int32),
                           torch.as_tensor(table), max(cnt, 1))
    assert int(lt) == (cnt if table.all() else 0)
    got = mine.numpy()
    assert np.array_equal(got[1, :, start:start + cnt],
                          work[0, :, start:start + cnt])
    assert np.array_equal(got[1, :, start + cnt:], work[1, :, start + cnt:])


def test_pack_planes_matches_jax():
    rng = np.random.RandomState(2)
    bins = rng.randint(0, 256, (777, 6)).astype(np.uint8)
    ghc = rng.randn(777, 3).astype(np.float32)
    want = np.asarray(P.pack_planes(jnp.asarray(bins), jnp.asarray(ghc)))
    got = pack_planes(torch.as_tensor(bins), torch.as_tensor(ghc))
    assert np.array_equal(got.numpy(), want)
    back = unpack_ghc_planes(got, 6).numpy()
    assert np.array_equal(back, np.asarray(
        P.unpack_ghc_planes(jnp.asarray(want), 6)))
    assert back.view(np.uint32).tobytes() == ghc.T.copy().tobytes()


def test_work_spec_has_no_sublane_padding():
    guard, width = work_spec(28)
    assert width == 28 + GH_BYTES == 40       # the TPU pads this to 64
    assert planes_npad(1000, guard) % 128 == 0
    assert planes_npad(1000, guard) >= 1000 + 2 * guard


def test_fold_root_packs_and_histograms():
    from lightgbm_tpu_torch.ops.histogram import build_histogram_np

    rng = np.random.RandomState(3)
    n = 900
    bins = rng.randint(0, NUM_BIN, (n, 5)).astype(np.uint8)
    ghc = np.stack([rng.randn(n), np.abs(rng.randn(n)), np.ones(n)],
                   axis=1).astype(np.float32)
    guard, width = work_spec(5)
    work = torch.zeros((2, width, planes_npad(n, guard)), dtype=torch.uint8)
    root = pack_planes_fold_root(work, torch.as_tensor(bins),
                                 torch.as_tensor(ghc), guard,
                                 num_bins=NUM_BIN, exact=True)
    packed = np.asarray(P.pack_planes(jnp.asarray(bins), jnp.asarray(ghc)))
    assert np.array_equal(work[0, :, guard:guard + n].numpy(), packed)
    oracle = build_histogram_np(bins, ghc.astype(np.float64), NUM_BIN)
    assert np.array_equal(root[..., 2].numpy(), oracle[..., 2])
    # hi/lo rows keep 16 significant bits: 2^-16 of the bin's sum of |x|
    absum = build_histogram_np(bins, np.abs(ghc).astype(np.float64), NUM_BIN)
    assert (np.abs(root.numpy() - oracle) <= 2.0 ** -16 * absum).all()


def test_partition_validates_inputs():
    work = torch.zeros((2, 8, 256), dtype=torch.uint8)
    seg = torch.tensor([0, 0, 10, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        partition_segment(work[0], seg, torch.zeros(4, dtype=torch.bool), 10)
    with pytest.raises(ValueError):
        partition_segment(work, seg[:3], torch.zeros(4, dtype=torch.bool), 10)
    with pytest.raises(ValueError):
        partition_segment(work, seg, torch.zeros(4, dtype=torch.int32), 10)
