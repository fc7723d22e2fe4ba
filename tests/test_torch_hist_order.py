"""The summation order of the port's f32 segment histograms, on the CPU.

K4 (planes, rows, resident) and phase B of the one-kernel split sum a
segment's per-row contributions in an order fixed by the segment's rows
alone (``lightgbm_tpu_torch/csrc/segment_hist.cuh``): 2048-row chunks,
four interleaved slices of 32-row steps per chunk, rows one by one in a
slice, slices then chunks added in order. ``torch_port_cases.
hist_order_np`` emulates that order in float32 numpy; here it must stay
within ``ops.histogram.sum_error_bound`` (times the bin's sum of |x|) of
the plain twin's float64 sum, which the card's kernels are held to by
``chip_smoke.py``, on seeded and adversarial inputs. Also: the host-side
sizing is a function of the row count alone, the one-kernel split's
scratch covers a child of every parent row (bagging), and the ctypes
``OneKernelArgs`` declares the C struct's fields in its order.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from torch_port_cases import combine_np, hist_order_np

from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import partition as P
from lightgbm_tpu_torch.ops.kernels import CSRC_DIR


def _case(kind, n, rng, nb=32, nf=3):
    """(bins (n, F), ghc (n, 3) f32) of one adversarial input."""
    bins = rng.randint(0, nb, (n, nf))
    g = rng.randn(n) * 3
    h = np.abs(rng.randn(n)) + 0.01
    if kind == "mixed_signs":
        # large values of both signs that cancel within a bin, and tiny ones
        g = np.where(rng.rand(n) < 0.5, 1e4, -1e4) + rng.randn(n) * 1e-3
        h = np.where(rng.rand(n) < 0.5, 1e-6, 1e3)
    elif kind == "one_bin":
        bins[:, :] = 7
    elif kind == "huge_one_bin":
        bins[:, 0] = 0      # every row in one bin of feature 0
    return bins, np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)


def _check_order(bins, ghc, nb, exact):
    cols = torch.as_tensor(bins.T.copy())
    ghc_t = torch.as_tensor(ghc.T.copy())
    ch = H.channels(ghc_t, exact).t().numpy()                   # (n, NCH)
    got = combine_np(hist_order_np(bins, ch, nb), exact)
    twin = H._histogram_plain(cols, ghc_t, num_bins=nb, exact=exact).numpy()
    absum = H._histogram_plain(cols, ghc_t.abs(), num_bins=nb,
                               exact=exact).numpy().astype(np.float64)
    n = bins.shape[0]
    assert np.array_equal(got[..., 2], twin[..., 2])          # counts exact
    diff = np.abs(got.astype(np.float64) - twin)
    bound = H.sum_error_bound(n) * absum
    assert (diff <= bound).all(), float((diff - bound).max())
    return diff


@pytest.mark.parametrize("kind,n", [
    ("seeded", 20000), ("seeded", 8192), ("seeded", 8193),
    ("mixed_signs", 30000), ("one_bin", 17000), ("empty", 0), ("one_row", 1)])
@pytest.mark.parametrize("exact", [True, False])
def test_order_within_bound_of_twin(kind, n, exact):
    rng = np.random.RandomState(n + 7 * exact)
    bins, ghc = _case(kind, n, rng)
    diff = _check_order(bins, ghc, 32, exact)
    if n <= 1:
        assert not diff.any()


def test_order_within_bound_2_20_rows_in_one_bin():
    """2^20 rows in one bin: the longest chain of adds the order makes."""
    rng = np.random.RandomState(11)
    bins, ghc = _case("huge_one_bin", 2 ** 20, rng, nb=4, nf=1)
    _check_order(bins, ghc, 4, True)


def test_order_counts_exact_and_chunked():
    """The count channel is exact and a chunk's rows never mix with the
    next chunk's: summing the chunks' emulations in order gives the
    segment's emulation bit for bit."""
    rng = np.random.RandomState(3)
    n = 3 * H.HIST_CHUNK + 100
    bins = rng.randint(0, 16, (n, 2))
    ch = rng.randn(n, 3).astype(np.float32)
    whole = hist_order_np(bins, ch, 16)
    acc = np.zeros_like(whole)
    for c0 in range(0, n, H.HIST_CHUNK):
        acc = acc + hist_order_np(bins[c0:c0 + H.HIST_CHUNK],
                                  ch[c0:c0 + H.HIST_CHUNK], 16)
    assert np.array_equal(whole.view(np.uint32), acc.view(np.uint32))


@pytest.mark.parametrize("cnt", [0, 1, 2047, 2048, 2049, 900_085, 2_000_000])
def test_sizing_is_a_function_of_the_count(cnt):
    assert H.hist_chunks(cnt) == -(-cnt // H.HIST_CHUNK)
    m = min(cnt, H.HIST_CHUNK // H.HIST_SLICES)
    assert H.sum_error_bound(cnt) == \
        (m + H.HIST_SLICES + H.hist_chunks(cnt) + 2) * 2.0 ** -24
    work = torch.zeros((2, 6 + P.GH_BYTES, 256), dtype=torch.uint8)
    for bound in (cnt, 2 * cnt, 8 * cnt):
        chunks, partial, out = H._hist_scratch(work, 16, 6, True, bound)
        assert chunks == max(1, H.hist_chunks(bound)) >= H.hist_chunks(cnt)
        assert partial.shape == (chunks, 6, 16, 5) and out.shape == (6, 16, 3)


@pytest.mark.parametrize("cnt_max", [1, 2048, 5000, 100_000, 2_000_000])
def test_one_kernel_scratch_covers_largest_child(cnt_max):
    """Under bagging the smaller child by the count channel may hold every
    parent row: the scratch's chunk partials cover all cnt_max of them,
    and its tile counts the partition's tiles."""
    chunks, tiles = P.one_kernel_scratch_rows(cnt_max)
    for child in (0, 1, cnt_max // 2, cnt_max):
        assert H.hist_chunks(child) <= chunks
    assert tiles * P.PART_TILE >= cnt_max and tiles >= 1


def test_one_kernel_args_match_c_struct():
    src = (CSRC_DIR / "one_kernel_split.cu").read_text()
    body = re.search(r"struct OneKernelArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(?:const\s+)?(\w+)\s*(\*?)\s*(.*)$", decl, re.S)
        ctype = ctypes.c_void_p if m.group(2) else {
            "int32_t": ctypes.c_int32, "float": ctypes.c_float}[m.group(1)]
        fields += [(name.strip(), ctype) for name in m.group(3).split(",")]
    assert fields == list(P.OneKernelArgs._fields_)
    stamps = [name for name, _ in fields].index("stamps")
    assert fields[stamps][1] is ctypes.c_void_p
