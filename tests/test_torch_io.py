"""The port's text loading against the JAX package's: the native parser
(``parse_file``, bit for bit on CSV, TSV, space and LibSVM text),
``parse_dense_range`` across chunk cuts, ``load_text_file`` (header names,
``name:`` columns, weight/group/ignore columns, sidecars), the two-round
loader's binned matrix and ``load_config_file``."""
import numpy as np
import pytest

from torch_port_cases import CPU

from lightgbm_tpu import io as jax_io
from lightgbm_tpu import io_native as jax_native
from lightgbm_tpu.config import Config as JaxConfig

from lightgbm_tpu_torch import io as port_io
from lightgbm_tpu_torch import io_native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def _fields(rng, n, f):
    """n x f text fields: 17-digit reprs, exponents, nan/inf spellings,
    empty fields, integers, signs."""
    vals = rng.randn(n, f) * 10.0 ** rng.randint(-6, 7, (n, f))
    out = []
    for r in range(n):
        row = []
        for c in range(f):
            v, k = vals[r, c], rng.randint(12)
            if k == 0:
                row.append(repr(v))                    # 17 digits
            elif k == 1:
                row.append("%.6e" % v)
            elif k == 2:
                row.append(("nan", "NaN", "inf", "-inf", "+inf")[
                    rng.randint(5)])
            elif k == 3:
                row.append("")
            elif k == 4:
                row.append("%d" % int(v))
            elif k == 5:
                row.append("+%.4f" % abs(v))
            else:
                row.append("%.10f" % (round(v * 1024) / 1024))
        out.append(row)
    return out


def _dense_text(rows, sep, crlf=False, comments=False):
    lines = []
    for i, row in enumerate(rows):
        if comments and i % 7 == 3:
            lines.append("# a comment line")
        if comments and i % 11 == 5:
            lines.append("")
        lines.append(sep.join(row))
    nl = "\r\n" if crlf else "\n"
    return nl.join(lines) + ("" if comments else nl)


@pytest.mark.parametrize("sep,fmt", [(",", "csv"), ("\t", "tsv"),
                                     (" ", "space")])
@pytest.mark.parametrize("crlf", [False, True])
def test_parse_file_dense_bit_equal_to_jax(tmp_path, sep, fmt, crlf):
    rng = np.random.RandomState(len(fmt) + crlf)
    rows = _fields(rng, 300, 6)
    if sep == " ":
        rows = [[f or "nan" for f in row] for row in rows]  # no empty field
    path = tmp_path / ("d." + fmt)
    path.write_text(_dense_text(rows, sep, crlf=crlf, comments=True))
    got, got_fmt = io_native.parse_file(str(path))
    want, want_fmt = jax_native.parse_file(str(path))
    assert got_fmt == want_fmt == fmt
    assert got.shape == want.shape == (300, 6)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_parse_file_libsvm_bit_equal_to_jax(tmp_path):
    rng = np.random.RandomState(4)
    lines = []
    for r in range(200):
        toks = [repr(float(rng.randint(0, 3)))]
        for j in sorted(rng.choice(30, rng.randint(0, 8), replace=False)):
            v = rng.randn() * 10.0 ** rng.randint(-5, 5)
            toks.append("%d:%s" % (j, repr(v) if j % 2 else "%.5e" % v))
        lines.append(" ".join(toks))
    lines.insert(10, "# comment")
    path = tmp_path / "d.svm"
    path.write_text("\r\n".join(lines) + "\n")
    got, fmt = io_native.parse_file(str(path))
    want, _ = jax_native.parse_file(str(path))
    assert fmt == "libsvm"
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_seventeen_digit_values_may_miss_by_an_ulp(tmp_path):
    """Both parsers divide an up-to-18-digit mantissa by a power of ten,
    rounding twice: identical bits in both packages, within 1 ulp of
    Python's float()."""
    rng = np.random.RandomState(0)
    v = rng.rand(4000)
    path = tmp_path / "v.csv"
    path.write_text("".join("%r,%r\n" % (a, -a) for a in v))
    got = io_native.parse_file(str(path))[0]
    want = jax_native.parse_file(str(path))[0]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ulps = np.abs(_bits(got[:, 0]).astype(np.int64)
                  - _bits(v).astype(np.int64))
    assert ulps.max() <= 1
    assert np.array_equal(got[:, 1], -got[:, 0])


@pytest.mark.parametrize("crlf", [False, True])
def test_parse_dense_range_across_cuts(tmp_path, crlf):
    """Walking the file in byte windows of many sizes (each call parses
    only the whole lines of its window) gives parse_file's matrix; a row
    budget stops before the next data line."""
    rng = np.random.RandomState(9)
    rows = _fields(rng, 120, 5)
    path = tmp_path / "r.csv"
    path.write_text(_dense_text(rows, ",", crlf=crlf, comments=True))
    size = path.stat().st_size
    want = io_native.parse_file(str(path))[0]
    for window in (1, 7, 64, 333, size):
        for max_rows in (1, 5, 1000):
            parts, off = [], 0
            while off < size:
                out = np.empty((max_rows, 5))
                r, nxt = io_native.parse_dense_range(
                    str(path), ",", off, min(size, off + window), out)
                assert r <= max_rows
                if nxt == off:      # no whole line in the window
                    assert r == 0
                    window_end = min(size, off + 2 * window + 512)
                    r, nxt = io_native.parse_dense_range(
                        str(path), ",", off, window_end, out)
                    assert nxt > off
                parts.append(out[:r].copy())
                off = nxt
            got = np.concatenate(parts)
            np.testing.assert_array_equal(_bits(got), _bits(want))
    chunks = list(port_io.dense_chunks(str(path), 0, ",", 5, 17))
    assert [len(c) for c in chunks[:-1]] == [17] * (len(chunks) - 1)
    np.testing.assert_array_equal(_bits(np.concatenate(chunks)), _bits(want))


def test_parse_dense_range_rejects_a_bad_out(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("1,2\n")
    with pytest.raises(ValueError):
        io_native.parse_dense_range(str(path), ",", 0, 4,
                                    np.empty((3, 2), np.float32))
    with pytest.raises(LightGBMError):
        io_native.parse_dense_range(str(tmp_path / "missing.csv"), ",", 0,
                                    4, np.empty((2, 2)))


def _table(tmp_path, rng, n=240, header=True, sep=","):
    """label, weight, query id, an ignored column and four features."""
    names = ["y", "w", "qid", "junk", "f0", "f1", "f2", "f3"]
    y = rng.randint(0, 2, n).astype(float)
    w = np.round(rng.rand(n) * 64) / 64 + 0.5
    qid = np.repeat(rng.permutation(n // 20), 20)   # contiguous, unsorted
    X = np.round(rng.randn(n, 4) * 1024) / 1024
    M = np.column_stack([y, w, qid, rng.randn(n), X])
    path = tmp_path / ("t.csv" if sep == "," else "t.tsv")
    np.savetxt(path, M, delimiter=sep, fmt="%.10f",
               header=sep.join(names) if header else "", comments="")
    return str(path)


def _same_loaded(a, b):
    for x, y in zip(a[:4], b[:4]):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x, np.float64),
                                          np.asarray(y, np.float64))
    assert a[4] == b[4]


@pytest.mark.parametrize("spec", [
    dict(header=True, label_column="name:y", weight_column="name:w",
         group_column="name:qid", ignore_column="name:junk"),
    dict(header=True, label_column="0", weight_column="1",
         group_column="2", ignore_column="3"),
    dict(header=False, label_column="0", weight_column="1",
         ignore_column="2,3"),
    dict(header=False),
])
@pytest.mark.parametrize("sep", [",", "\t"])
def test_load_text_file_equals_jax(tmp_path, spec, sep):
    rng = np.random.RandomState(3)
    path = _table(tmp_path, rng, header=spec["header"], sep=sep)
    got = port_io.load_text_file(path, Config.from_params(dict(spec, **CPU)))
    want = jax_io.load_text_file(path, JaxConfig.from_params(spec))
    _same_loaded(got, want)
    assert got[0].shape[1] == (7 if len(spec) == 1 else 4)


def test_sidecars_and_libsvm_equal_jax(tmp_path):
    rng = np.random.RandomState(8)
    X = np.round(rng.randn(60, 3) * 64) / 64
    y = rng.randint(0, 3, 60)
    path = tmp_path / "rank.tsv"
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.6f")
    np.savetxt(str(path) + ".query", [20, 25, 15], fmt="%d")
    np.savetxt(str(path) + ".weight", rng.rand(60), fmt="%.8f")
    got = port_io.load_text_file(str(path), Config.from_params(CPU))
    want = jax_io.load_text_file(str(path), JaxConfig())
    _same_loaded(got, want)
    assert got[3].tolist() == [20, 25, 15]
    svm = tmp_path / "d.svm"
    svm.write_text("1 0:1.5 3:2.0\n0 1:0.5\n\n1 2:1.0 3:-1\n")
    np.savetxt(str(svm) + ".weight", [1.0, 2.0, 3.0], fmt="%.1f")
    got = port_io.load_text_file(str(svm), Config.from_params(CPU))
    _same_loaded(got, jax_io.load_text_file(str(svm), JaxConfig()))
    assert got[0].shape == (3, 4)
    # a header sends LibSVM to the Python parser in both packages
    hdr = tmp_path / "h.svm"
    hdr.write_text("label features\n1 0:1.5 3:2.0\n0 1:0.5\n")
    got = port_io.load_text_file(str(hdr), Config.from_params(
        dict(CPU, header=True)))
    _same_loaded(got, jax_io.load_text_file(str(hdr), JaxConfig.from_params(
        {"header": True})))


def test_missing_column_name_and_file_raise(tmp_path):
    path = _table(tmp_path, np.random.RandomState(1))
    with pytest.raises(LightGBMError, match="not found in header"):
        port_io.load_text_file(path, Config.from_params(
            dict(CPU, header=True, label_column="name:nope")))
    with pytest.raises(LightGBMError, match="does not exist"):
        port_io.load_text_file(str(tmp_path / "none.csv"),
                               Config.from_params(CPU))


@pytest.mark.parametrize("spec", [
    dict(),
    dict(header=True, label_column="name:y", weight_column="name:w",
         group_column="name:qid", ignore_column="name:junk",
         bin_construct_sample_cnt=100),
])
def test_two_round_equals_jax(tmp_path, spec):
    """Values at 1/1024 (pandas and the native parser both exact); chunks
    smaller than the file; a sample smaller than the rows."""
    rng = np.random.RandomState(11)
    path = _table(tmp_path, rng, n=600, header=bool(spec))
    got = port_io.load_dataset_two_round(
        path, Config.from_params(dict(spec, **CPU, verbosity=-1)),
        chunk_rows=128)
    want = jax_io.load_dataset_two_round(
        path, JaxConfig.from_params(dict(spec, verbosity=-1)),
        chunk_rows=128)
    np.testing.assert_array_equal(got.binned, want.binned)
    assert got.num_data == want.num_data == 600
    for f in ("label", "weight", "query_boundaries"):
        a, b = getattr(got.metadata, f), getattr(want.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.feature_names == want.feature_names
    full = port_io.load_text_file(path, Config.from_params(dict(spec, **CPU)))
    assert got.binned.shape == (600, full[0].shape[1])


def test_two_round_refusals(tmp_path):
    path = _table(tmp_path, np.random.RandomState(2), header=False)
    with pytest.raises(LightGBMError, match="linear_tree"):
        port_io.load_dataset_two_round(path, Config.from_params(
            dict(CPU, linear_tree=True)))
    # sharded loading is ported (tests/test_torch_distributed_load.py):
    # one rank of one loads every row; a LibSVM file is refused, as the
    # JAX package refuses it
    ds = port_io.load_dataset_sharded(path, Config.from_params(CPU))
    assert ds.shard_info == (0, 1, ds.num_data)
    svm = tmp_path / "d.svm"
    svm.write_text("1 0:1.5\n0 1:0.5\n")
    with pytest.raises(LightGBMError, match="dense text formats"):
        port_io.load_dataset_sharded(str(svm), Config.from_params(CPU))
    assert port_io.load_dataset_two_round(str(svm),
                                          Config.from_params(CPU)) is None


def test_load_config_file_and_detect_format_equal_jax(tmp_path):
    conf = tmp_path / "train.conf"
    conf.write_text("# comment\ntask = train\nobjective=binary # trailing\n"
                    "\nnum_leaves = 31\nbad line\ndata = a=b.csv\n")
    assert port_io.load_config_file(str(conf)) == \
        jax_io.load_config_file(str(conf))
    for lines in (["1,2,3"], ["1\t2\t3"], ["1 2:0.5 7:1.2"], ["", "1 2"],
                  ["a,b\tc"]):
        assert port_io.detect_format(lines) == jax_io.detect_format(lines)
