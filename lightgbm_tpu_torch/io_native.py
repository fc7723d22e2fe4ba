"""ctypes bindings for the port's two host libraries: the text parser
(``native/parser.cpp``) and the threaded bin applier
(``native/binning.cpp``), copies of the JAX package's.

Each library builds at first use with ``g++`` into
``lightgbm_tpu_torch/_build/`` (git-ignored), named by the hash of its
source and flags, written under a temporary name and renamed into place,
under the lock the CUDA kernels' builds hold (``ops/kernels._BUILD_LOCK``).
Nothing builds at import time. A failed build or load raises
:class:`LightGBMError` with the compiler's last lines: no path bins with
numpy or parses in Python because of a build fault (the JAX package
degrades to those quietly). Which path a file takes depends only on the
input, as in the JAX package (``io.load_text_file``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .ops.kernels import _BUILD_LOCK, BUILD_DIR
from .utils.log import LightGBMError

NATIVE_DIR = Path(__file__).resolve().parent / "native"

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++14")
#: the sources, with their flags beside GXX_FLAGS
PARSER_SOURCE = "parser.cpp"
BINNING_SOURCE = "binning.cpp"
LIBRARY_FLAGS: Dict[str, Tuple[str, ...]] = {PARSER_SOURCE: (),
                                             BINNING_SOURCE: ("-pthread",)}

#: source name -> bound library, filled at first use
_LIBS: Dict[str, ctypes.CDLL] = {}
#: source name -> seconds its last build took (0.0 when it was cached)
BUILD_SECONDS: Dict[str, float] = {}

_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def library_path(source: Path, flags: Sequence[str] = (),
                 out_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(GXX_FLAGS + tuple(flags)).encode())
    return Path(out_dir) / ("%s-%s.so" % (Path(source).stem,
                                          digest.hexdigest()[:16]))


def build_library(source: Path, flags: Sequence[str] = (),
                  out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into a shared library unless it is built already;
    returns its path. Raises :class:`LightGBMError` when g++ fails."""
    final = library_path(source, flags, out_dir)
    if final.exists():
        return final
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(".%d.tmp" % os.getpid())
    cmd = [shutil.which("g++") or "g++", *GXX_FLAGS, *flags, "-o",
           str(tmp), str(source)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        rc, log = r.returncode, (r.stdout or "") + (r.stderr or "")
    except (OSError, subprocess.TimeoutExpired) as e:
        rc, log = -1, str(e)
    if rc != 0:
        if tmp.exists():
            tmp.unlink()
        tail = "\n".join(log.strip().splitlines()[-20:])
        raise LightGBMError("g++ failed to build %s (exit %d):\n%s"
                            % (Path(source).name, rc, tail))
    os.replace(tmp, final)
    return final


def _library(source: str, bind) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        flags = LIBRARY_FLAGS[source]
        cached = library_path(NATIVE_DIR / source, flags).exists()
        path = build_library(NATIVE_DIR / source, flags)
        try:
            lib = ctypes.CDLL(str(path))
            bind(lib)
        except (OSError, AttributeError) as e:
            raise LightGBMError("cannot load the host library %s: %s"
                                % (path, e)) from e
        BUILD_SECONDS[source] = 0.0 if cached else time.perf_counter() - t0
        _LIBS[source] = lib
        return lib


def _bind_parser(lib: ctypes.CDLL) -> None:
    lib.count_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int64)]
    lib.count_dims.restype = ctypes.c_int
    lib.parse_dense.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_int64, _F64]
    lib.parse_dense.restype = ctypes.c_int
    lib.parse_libsvm.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int64, _F64]
    lib.parse_libsvm.restype = ctypes.c_int
    lib.parse_dense_range.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _F64, ctypes.POINTER(ctypes.c_int64)]
    lib.parse_dense_range.restype = ctypes.c_int64


def _bind_binning(lib: ctypes.CDLL) -> None:
    lib.lgbm_apply_bins_u8.argtypes = [
        _F64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _I32,
        _F64, _I64, _I32, _I32, _I32, _U8, ctypes.c_int64, _I32,
        ctypes.c_int32]
    lib.lgbm_apply_bins_u8.restype = None


def get_lib() -> ctypes.CDLL:
    """The text parser, built and bound at first use."""
    return _library(PARSER_SOURCE, _bind_parser)


def get_binning_lib() -> ctypes.CDLL:
    """The bin applier, built and bound at first use."""
    return _library(BINNING_SOURCE, _bind_binning)


def build_all() -> Dict[str, float]:
    """Build and load both libraries; returns each one's build seconds
    (0.0 when it was already built)."""
    get_lib()
    get_binning_lib()
    return dict(BUILD_SECONDS)


_FORMATS = {ord(","): "csv", ord("\t"): "tsv"}


def parse_file(path: str, expect_fmt: Optional[str] = None
               ) -> Optional[Tuple[np.ndarray, str]]:
    """Parse a CSV/TSV/space/LibSVM file natively.

    Returns (matrix, fmt): column 0 of the matrix is the raw first column
    (the caller applies the label/ignore-column semantics), fmt is one of
    "csv", "tsv", "space", "libsvm". Returns None when the input is for the
    Python parser: an empty file, or a detected format other than
    ``expect_fmt``. Raises when the file cannot be read.
    """
    lib = get_lib()
    sep = ctypes.c_int(0)
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    if lib.count_dims(path.encode(), ctypes.byref(sep), ctypes.byref(rows),
                      ctypes.byref(cols)) != 0:
        raise LightGBMError("cannot read data file %s" % path)
    n, c = int(rows.value), int(cols.value)
    if n == 0 or c == 0:
        return None
    fmt = "libsvm" if sep.value == -1 else _FORMATS.get(sep.value, "space")
    if expect_fmt is not None and fmt != expect_fmt:
        return None
    out = np.empty((n, c), dtype=np.float64)
    if fmt == "libsvm":
        rc = lib.parse_libsvm(path.encode(), n, c, out)
    else:
        rc = lib.parse_dense(path.encode(), sep.value, n, c, out)
    if rc != 0:
        raise LightGBMError("cannot read data file %s" % path)
    return out, fmt


def parse_dense_range(path: str, sep: str, begin: int, end: int,
                      out: np.ndarray) -> Tuple[int, int]:
    """Parse the whole lines of bytes [begin, end) of a dense text file as
    :func:`parse_file` parses them, into the rows of ``out`` (a C-order
    (max_rows, n_cols) float64 array); returns (rows written, the offset
    just past the last line consumed; ``begin`` when no whole line fits)."""
    if out.ndim != 2 or out.dtype != np.float64 \
            or not out.flags.c_contiguous:
        raise ValueError("out must be a C-order 2-D float64 array")
    lib = get_lib()
    nxt = ctypes.c_int64(0)
    r = lib.parse_dense_range(path.encode(), ord(sep), int(begin), int(end),
                              out.shape[1], out.shape[0], out,
                              ctypes.byref(nxt))
    if r < 0:
        raise LightGBMError("cannot read data file %s" % path)
    return int(r), int(nxt.value)


def apply_bins_native(Xv: np.ndarray, specs, out: np.ndarray,
                      nthreads: int = 0) -> None:
    """Bin numerical features into columns of ``out`` ((n, G) uint8, C
    order) natively. specs: list of (x_col, upper_bounds, missing_type,
    missing_bin, out_col); ``nthreads`` 0 means ``os.cpu_count()``."""
    if not specs:
        return
    lib = get_binning_lib()
    col_idx = np.asarray([s[0] for s in specs], np.int32)
    bounds_cat = np.concatenate([np.asarray(s[1], np.float64) for s in specs])
    off = np.zeros(len(specs), np.int64)
    nb = np.asarray([len(s[1]) for s in specs], np.int32)
    np.cumsum(nb[:-1], out=off[1:])
    mtype = np.asarray([s[2] for s in specs], np.int32)
    mbin = np.asarray([s[3] for s in specs], np.int32)
    ocol = np.asarray([s[4] for s in specs], np.int32)
    Xv = np.ascontiguousarray(Xv, dtype=np.float64)
    lib.lgbm_apply_bins_u8(
        Xv, Xv.shape[0], Xv.shape[1], np.int32(len(specs)), col_idx,
        bounds_cat, off, nb, mtype, mbin, out, out.shape[1], ocol,
        np.int32(nthreads if nthreads > 0 else (os.cpu_count() or 1)))
