"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each kernel source is a ``.cu`` file with plain C entry points that launch
on the stream they are given and return ``cudaGetLastError()``; one
:class:`CudaKernel` per entry point, so each counts its own launches. At
first use a source is compiled for Hopper (``sm_90a``) with ``nvcc`` into a
shared library under ``lightgbm_tpu_torch/_build/`` (git-ignored), named
by the hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source never loads a stale library, and bound with
``ctypes``. Nothing here runs at import time: the
CPU tests import every module of the port on a host with no ``nvcc``.

:class:`CudaKernel` also holds the kernel's launch count: the op wrapper
calls :meth:`CudaKernel.launch`, which adds one after every launch the
device accepted, and :func:`reset_launch_counts` zeroes all of them so a
run can show that its main path went through the kernels. Between
:func:`start_timing` and :func:`stop_timing` every launch is also bracketed
by CUDA events, which gives each kernel's device time inside a real run
(off, the cost is one attribute test per launch).

Under CUDA graph capture (:class:`capture_launches`) a wrapper's launch is
recorded, not run: its count goes to the capture's tally instead, no
timing event is recorded, and :func:`add_launches` adds the tally once per
replay, so the counts stay the launches the card ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: held while a library is built: entry points of one source share it
_BUILD_LOCK = threading.Lock()

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaKernel:
    """One ``csrc/<source>`` library: its C entry point ``symbol`` with
    ctypes ``argtypes``, built lazily, plus its launch count."""

    def __init__(self, symbol: str, source: str, argtypes: Sequence,
                 flags: Sequence[str] = ()) -> None:
        self.symbol = symbol
        self.source = CSRC_DIR / source
        self.argtypes = list(argtypes)
        #: nvcc flags of this source beside NVCC_FLAGS (entry points of
        #: one source must agree)
        self.flags = tuple(flags)
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()
        self._launches = 0
        self._events = None   # [(start, end)] CUDA events while timing

    # ---------------------------------------------------------------- build
    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS + self.flags).encode())
        return BUILD_DIR / ("%s-%s.so" % (self.source.stem,
                                          digest.hexdigest()[:16]))

    def build_command(self, out: Path) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, *self.flags, "-o", str(out),
                str(self.source)]

    def _start_build(self) -> Optional[tuple]:
        """Start nvcc for a missing library; returns (process, tmp, final)
        or None when the library is already built."""
        final = self.library_path()
        if final.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = final.with_suffix(".%d.tmp" % os.getpid())
        proc = subprocess.Popen(self.build_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, final

    def _finish_build(self, started: tuple, t0: float) -> None:
        proc, tmp, final = started
        out, _ = proc.communicate()
        self.build_log = out or ""
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s (exit %d):\n%s"
                               % (self.source.name, proc.returncode,
                                  self.build_log))
        os.replace(tmp, final)

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.lgbt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def load(self):
        """The bound C entry point, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                with _BUILD_LOCK:
                    started = self._start_build()
                    if started is not None:
                        self._finish_build(started, time.perf_counter())
                self._bind()
            return self._fn

    # --------------------------------------------------------------- launch
    def launch(self, *args) -> None:
        """Call the C entry point; raise on a non-zero CUDA status, else
        count one launch (into the capture's tally while a graph is being
        captured)."""
        fn = self.load()
        tally = _CAPTURE[0]
        events = self._events if tally is None else None
        if events is not None:
            import torch
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        rc = fn(*args)
        if events is not None:
            ev[1].record()
            events.append(ev)
        if rc != 0:
            msg = self._lib.lgbt_error_string(rc).decode()
            raise RuntimeError("%s: CUDA error %d (%s)"
                               % (self.symbol, rc, msg))
        with self._lock:
            if tally is None:
                self._launches += 1
            else:
                tally[self.symbol] = tally.get(self.symbol, 0) + 1

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    def reset(self) -> None:
        with self._lock:
            self._launches = 0


KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.symbol] = kernel
    return kernel


def build_all() -> float:
    """Build every registered kernel's library that is not built yet, one
    ``nvcc`` per source, all started together; bind every entry point.
    Returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    started = {}
    with _BUILD_LOCK:
        for k in KERNELS.values():
            path = k.library_path()
            if k._fn is None and path not in started:
                started[path] = (k, k._start_build())
        errors = []
        for k, s in started.values():
            try:
                if s is not None:
                    k._finish_build(s, t0)
            except (RuntimeError, OSError) as exc:
                errors.append(str(exc))
        for k in KERNELS.values():        # entry points sharing a source
            builder = started.get(k.library_path(), (k,))[0]
            k.build_log, k.build_seconds = (builder.build_log,
                                            builder.build_seconds)
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        with k._lock:
            if k._fn is None:
                k._bind()
    return time.perf_counter() - t0


#: the launch tally of the graph being captured, or None
_CAPTURE: List[Optional[Dict[str, int]]] = [None]


class capture_launches:
    """Context of a CUDA graph capture: the launches the wrappers record
    inside it are tallied in ``counts`` (symbol -> launches of one replay)
    and not counted as run."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}

    def __enter__(self) -> "capture_launches":
        if _CAPTURE[0] is not None:
            raise RuntimeError("a graph capture is already in progress")
        _CAPTURE[0] = self.counts
        return self

    def __exit__(self, *exc) -> None:
        _CAPTURE[0] = None


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one graph replay (a capture's tally)."""
    for name, n in counts.items():
        k = KERNELS[name]
        with k._lock:
            k._launches += n


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def start_timing() -> None:
    """Bracket every following launch with CUDA events."""
    for k in KERNELS.values():
        k._events = []


def stop_timing() -> Dict[str, float]:
    """Stop timing; returns each kernel's summed device milliseconds since
    :func:`start_timing` (waits for the card)."""
    import torch
    out = {}
    if any(k._events for k in KERNELS.values()):
        torch.cuda.synchronize()
    for name, k in KERNELS.items():
        events, k._events = k._events or [], None
        out[name] = float(sum(a.elapsed_time(b) for a, b in events))
    return out


def stream_of(t) -> int:
    """Handle of the current CUDA stream on ``t``'s device (a Python int
    for ctypes)."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
