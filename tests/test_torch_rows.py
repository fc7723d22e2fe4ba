"""The rows work layout of the PyTorch port (``lightgbm_tpu_torch/ops/
partition.py`` and ``ops/histogram.py``: the plain twins of the rows
partition, the rows histogram and the int8 histogram kernels) against the
JAX package, on the CPU.

The bars:
- the rows pack and the int8 quantized pack are byte-equal to the JAX
  package's ``pack_rows`` / ``pack_rows_quantized`` over its guard-padded
  buffer (the dither drawn at the guard offset);
- the rows partition gives JAX's left count, its left rows byte-equal in
  order and its right rows as a set (the XLA rows partition writes them
  chunk-reversed); the port's own order, stable on both sides, is pinned by
  a numpy oracle and equals the planes layout's;
- the rows histogram is within 2^-18 of the bin's sum of |x| of
  ``hist16_segment`` (same per-row rounding, f32 sums in another order),
  counts exact, and equal to the port's planes histogram on the same rows;
- the int8 histogram is byte-equal to ``hist16_segment_q`` and to the
  Pallas kernel ``hist_mxu_segment`` run under the interpreter.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu.ops.partition as P
from lightgbm_tpu.ops.histogram import (hist16_segment, hist16_segment_q,
                                        hist_mxu_segment)

from lightgbm_tpu_torch.ops.histogram import (build_histogram_np,
                                              dequant_scale, segment_histogram,
                                              segment_histogram_q,
                                              segment_histogram_rows)
from lightgbm_tpu_torch.ops.partition import (GH_BYTES_Q, dither_offset,
                                              pack_planes, pack_rows,
                                              pack_rows_quantized,
                                              partition_segment_rows,
                                              quantize_scales, unpack_ghc,
                                              unpack_ghq, work_buffer,
                                              work_spec)
from lightgbm_tpu_torch.prng import PRNGKey, fold_in

N, F, NUM_BIN, GUARD = 1500, 12, 48, 256


def _channels(rng, n):
    ghc = np.zeros((n, 3), np.float32)
    m = rng.rand(n) < 0.8
    ghc[:, 0] = rng.randn(n) * 3 * m
    ghc[:, 1] = (np.abs(rng.randn(n)) + 0.01) * m
    ghc[:, 2] = m
    return ghc


def _jax_scales(ghc):
    g = jnp.asarray(ghc)
    return (127.0 / (jnp.max(jnp.abs(g[:, 0])) + 1e-12),
            127.0 / (jnp.max(jnp.abs(g[:, 1])) + 1e-12))


def _jax_rows(bins, ghc, guard, quantized, seed=7):
    """The JAX builder's plane 0: guard-padded rows, packed."""
    pad = ((guard, guard), (0, 0))
    if quantized:
        gs, hs = _jax_scales(ghc)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 987123)
        w = P.pack_rows_quantized(jnp.pad(jnp.asarray(bins), pad),
                                  jnp.pad(jnp.asarray(ghc), pad), key, gs, hs)
    else:
        w = P.pack_rows(jnp.pad(jnp.asarray(bins), pad),
                        jnp.pad(jnp.asarray(ghc), pad))
    return np.asarray(w)


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("seed,n", [(0, 1500), (1, 37), (2, 5000)])
def test_quantized_pack_is_jax_bytes(seed, n):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, NUM_BIN, (n, F)).astype(np.uint8)
    ghc = _channels(rng, n)
    guard = dither_offset(F)
    want = _jax_rows(bins, ghc, guard, True, seed)[guard:guard + n]
    scales = quantize_scales(torch.as_tensor(ghc))
    gs, hs = _jax_scales(ghc)
    assert np.array_equal(scales.numpy().view(np.uint32),
                          np.array([gs, hs], np.float32).view(np.uint32))
    got = pack_rows_quantized(torch.as_tensor(bins), torch.as_tensor(ghc),
                              fold_in(PRNGKey(seed), 987123), scales,
                              offset=guard)
    assert got.shape == (n, F + GH_BYTES_Q)
    assert np.array_equal(got.numpy(), want)
    gq, hq, cq = unpack_ghq(got, F)
    jg, jh, jc = P.unpack_ghq(jnp.asarray(want), F)
    for a, b in ((gq, jg), (hq, jh), (cq, jc)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_dither_offset_follows_the_chunk_knobs():
    assert dither_offset(28) == 4096              # G <= 64: hist chunk 4096
    assert dither_offset(100) == 2048             # else the part chunk
    assert dither_offset(28, part_chunk=8192) == 8192
    assert dither_offset(100, hist_chunk=512, part_chunk=256) == 512
    guard, _ = P.work_spec(28, True, "xla", 2048, 4096, layout="rows")
    assert guard == dither_offset(28)


def test_rows_pack_is_jax_bytes():
    rng = np.random.RandomState(3)
    bins = rng.randint(0, 256, (777, F)).astype(np.uint8)
    ghc = rng.randn(777, 3).astype(np.float32)
    want = np.asarray(P.pack_rows(jnp.asarray(bins), jnp.asarray(ghc)))
    got = pack_rows(torch.as_tensor(bins), torch.as_tensor(ghc))
    assert np.array_equal(got.numpy(), want)
    # the planes layout holds the same bytes transposed
    assert np.array_equal(pack_planes(torch.as_tensor(bins),
                                      torch.as_tensor(ghc)).numpy(), want.T)
    back = unpack_ghc(got, F).numpy()
    assert np.array_equal(back, np.asarray(P.unpack_ghc(jnp.asarray(want),
                                                        F)))
    assert back.tobytes() == ghc.tobytes()


def test_work_buffer_shapes():
    guard, w = work_spec(28, quantized=True)
    assert w == 31
    rows = work_buffer(1000, 28, "rows", True, "cpu")
    planes = work_buffer(1000, 28, "planes", False, "cpu")
    assert rows.shape[0] == planes.shape[0] == 2
    assert rows.shape[2] == 31 and planes.shape[1] == 40
    assert rows.shape[1] == planes.shape[2] >= 1000 + 2 * guard


# ---------------------------------------------------------------- partition

def _rows_pair(rng, quantized):
    bins = np.zeros((N + 2 * GUARD, F), np.uint8)
    bins[GUARD:GUARD + N] = rng.randint(0, NUM_BIN, (N, F))
    ghc = np.zeros((N + 2 * GUARD, 3), np.float32)
    ghc[GUARD:GUARD + N] = _channels(rng, N)
    w0 = _jax_rows(bins, ghc, 0, quantized)
    junk = rng.randint(0, 256, w0.shape).astype(np.uint8)
    return np.stack([w0, junk])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("start,cnt", [(137, 700), (0, 1500), (513, 1),
                                       (333, 1163), (7, 31), (1, 1023),
                                       (0, 1025), (13, 1487)])
def test_rows_partition_matches_jax(quantized, start, cnt):
    rng = np.random.RandomState(start + cnt)
    work = _rows_pair(rng, quantized)
    table = rng.rand(NUM_BIN) < 0.45
    s0, s1 = GUARD + start, GUARD + start + cnt
    ref, lt_ref = P.partition_segment(jnp.asarray(work), jnp.int32(0),
                                      jnp.int32(s0), jnp.int32(cnt),
                                      jnp.int32(5), jnp.asarray(table),
                                      ch=256)
    ref = np.asarray(ref)
    mine = torch.as_tensor(work.copy())
    lt = partition_segment_rows(mine, torch.tensor([0, s0, cnt, 5],
                                                   dtype=torch.int32),
                                torch.as_tensor(table), cnt)
    got = mine.numpy()
    assert lt.dtype == torch.int32 and lt.shape == (1,)
    lt = int(lt)
    assert lt == int(lt_ref)
    assert np.array_equal(got[1, s0:s0 + lt], ref[1, s0:s0 + lt])
    assert sorted(map(bytes, got[1, s0 + lt:s1])) == \
        sorted(map(bytes, ref[1, s0 + lt:s1]))
    assert np.array_equal(got[1, :s0], work[1, :s0])
    assert np.array_equal(got[1, s1:], work[1, s1:])
    assert np.array_equal(got[0], work[0])
    rows = work[0, s0:s1]
    go = table[rows[:, 5]]
    assert np.array_equal(got[1, s0:s1],
                          np.concatenate([rows[go], rows[~go]]))


@pytest.mark.parametrize("which", ["all_left", "all_right", "empty"])
def test_rows_partition_edge_segments(which):
    rng = np.random.RandomState(4)
    work = _rows_pair(rng, False)
    table = np.full(NUM_BIN, which == "all_left")
    start, cnt = 300, 0 if which == "empty" else 257
    mine = torch.as_tensor(work.copy())
    lt = partition_segment_rows(mine, torch.tensor([0, start, cnt, 2],
                                                   dtype=torch.int32),
                                torch.as_tensor(table), max(cnt, 1))
    assert int(lt) == (cnt if which == "all_left" else 0)
    got = mine.numpy()
    assert np.array_equal(got[1, start:start + cnt],
                          work[0, start:start + cnt])
    assert np.array_equal(got[1, start + cnt:], work[1, start + cnt:])


def test_rows_and_planes_partition_alike():
    """The same split on both layouts leaves the same rows in the same
    order (the planes buffer is the rows buffer transposed)."""
    from lightgbm_tpu_torch.ops.partition import partition_segment

    rng = np.random.RandomState(8)
    work = _rows_pair(rng, False)
    table = torch.as_tensor(rng.rand(NUM_BIN) < 0.3)
    rows = torch.as_tensor(work.copy())
    planes = rows.transpose(1, 2).contiguous()
    seg = torch.tensor([0, GUARD + 11, 1200, 7], dtype=torch.int32)
    a = partition_segment_rows(rows, seg, table, 1200)
    b = partition_segment(planes, seg, table, 1200)
    assert int(a) == int(b)
    assert torch.equal(rows.transpose(1, 2), planes)


# ---------------------------------------------------------------- histogram

@pytest.mark.parametrize("exact,start,cnt", [
    (True, 0, N), (True, 137, 700), (True, 333, 1), (False, 137, 700),
    (False, 900, 0)])
def test_rows_histogram_matches_jax(exact, start, cnt):
    rng = np.random.RandomState(start + cnt + 11)
    work = _rows_pair(rng, False)
    s0, s1 = GUARD + start, GUARD + start + cnt
    seg = torch.tensor([0, s0, cnt], dtype=torch.int32)
    kw = dict(num_bins=NUM_BIN, num_feat=F, exact=exact)
    got = segment_histogram_rows(torch.as_tensor(work), seg, cnt_bound=cnt,
                                 **kw).numpy()
    ref = np.asarray(hist16_segment(jnp.asarray(work), jnp.int32(0),
                                    jnp.int32(s0), jnp.int32(cnt),
                                    chunk=256, **kw))
    rows = work[0, s0:s1]
    ghc = np.asarray(P.unpack_ghc(jnp.asarray(rows), F)).reshape(-1, 3)
    absum = build_histogram_np(rows[:, :F], np.abs(ghc).astype(np.float64),
                               NUM_BIN).astype(np.float64)
    assert got.shape == (F, NUM_BIN, 3)
    assert np.array_equal(got[..., 2], ref[..., 2])
    assert (np.abs(got - ref) <= 2.0 ** -18 * absum + 1e-12).all()
    # the planes twin on the transposed buffer: the same sums
    planes = torch.as_tensor(work).transpose(1, 2).contiguous()
    same = segment_histogram(planes, seg, cnt_bound=cnt, **kw).numpy()
    assert np.array_equal(got.view(np.uint32), same.view(np.uint32))


@pytest.mark.parametrize("start,cnt", [(0, N), (37, 411), (3, 130), (900, 0),
                                       (1499, 1), (5, 31), (11, 33),
                                       (13, 1025)])
def test_int8_histogram_is_jax_bytes(start, cnt, monkeypatch):
    rng = np.random.RandomState(start + cnt + 5)
    work = _rows_pair(rng, True)
    gs, hs = _jax_scales(_channels(rng, N))
    s0 = GUARD + start
    scale = dequant_scale(torch.tensor([float(gs), float(hs)],
                                       dtype=torch.float32))
    got = segment_histogram_q(torch.as_tensor(work),
                              torch.tensor([0, s0, cnt], dtype=torch.int32),
                              scale, num_bins=NUM_BIN, num_feat=F,
                              cnt_bound=cnt).numpy()
    args = (jnp.asarray(work), jnp.int32(0), jnp.int32(s0), jnp.int32(cnt))
    ref = np.asarray(hist16_segment_q(*args, gs, hs, num_bins=NUM_BIN,
                                      num_feat=F, chunk=256))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))
    # the Pallas kernel wants 128-lane rows: the same rows, padded wider
    wide = np.zeros((2, work.shape[1], 128), np.uint8)
    wide[:, :, :F + GH_BYTES_Q] = work
    monkeypatch.setattr(P, "_INTERPRET", True)
    pal, _ = hist_mxu_segment(jnp.asarray(wide), *args[1:], num_bins=NUM_BIN,
                              num_feat=F, quantized=True, gscale=gs,
                              hscale=hs, chunk=256)
    assert np.array_equal(got.view(np.uint8), np.asarray(pal).view(np.uint8))


def test_int8_histogram_refuses_overflowing_segments():
    from lightgbm_tpu_torch.ops.histogram import HIST_Q_MAX_ROWS

    work = torch.zeros((2, 64, F + GH_BYTES_Q), dtype=torch.uint8)
    seg = torch.tensor([0, 0, 10], dtype=torch.int32)
    scale = torch.ones(3)
    with pytest.raises(ValueError, match="overflow"):
        segment_histogram_q(work, seg, scale, num_bins=16, num_feat=F,
                            cnt_bound=HIST_Q_MAX_ROWS + 1)
    with pytest.raises(ValueError):
        segment_histogram_q(work, seg, scale[:2], num_bins=16, num_feat=F,
                            cnt_bound=10)
    with pytest.raises(ValueError):
        segment_histogram_q(work, seg, scale, num_bins=16, num_feat=F + 1,
                            cnt_bound=10)
    assert HIST_Q_MAX_ROWS * 127 < 2 ** 31
