"""Logging with levels and a redirectable sink.

TPU-native equivalent of the reference's ``Log`` class
(reference: include/LightGBM/utils/log.h:71) with Fatal/Warning/Info/Debug
levels and a thread-local redirect callback (exposed in the reference as
``LGBM_RegisterLogCallback`` / python ``register_logger``).
"""
from __future__ import annotations

import sys
import threading
from typing import Callable, Optional


class LightGBMError(RuntimeError):
    """Error raised by the framework (reference: include/LightGBM/utils/log.h Fatal)."""


_FATAL = -1
_WARNING = 0
_INFO = 1
_DEBUG = 2

_LEVEL_NAMES = {_FATAL: "Fatal", _WARNING: "Warning", _INFO: "Info", _DEBUG: "Debug"}

# The DEFAULT level/sink are process-global: verbosity configured on the
# main thread (train(params={"verbosity": ...}), register_logger) must hold
# in worker threads too — a purely thread-local default silently reverted
# to INFO/stderr inside mesh/multiprocess workers. ``_state`` carries an
# optional per-thread OVERRIDE on top (set_thread_log_level/_sink), used by
# tests and embedders that need one thread quieter than the process.
_default_level: int = _INFO
_default_sink: Optional[Callable[[str], None]] = None

_state = threading.local()


def _get_level() -> int:
    return getattr(_state, "level", _default_level)


def _get_sink() -> Optional[Callable[[str], None]]:
    return getattr(_state, "sink", _default_sink)


def set_thread_log_level(level: Optional[int]) -> None:
    """Per-thread level override; None clears it (falls back to the
    process-global default set by ``Log.reset_log_level``)."""
    if level is None:
        if hasattr(_state, "level"):
            del _state.level
    else:
        _state.level = level


def set_thread_log_sink(sink: Optional[Callable[[str], None]],
                        clear: bool = False) -> None:
    """Per-thread sink override; ``clear=True`` removes the override."""
    if clear:
        if hasattr(_state, "sink"):
            del _state.sink
    else:
        _state.sink = sink


class Log:
    """Static-style logger mirroring the reference's API shape."""

    FATAL = _FATAL
    WARNING = _WARNING
    INFO = _INFO
    DEBUG = _DEBUG

    @staticmethod
    def reset_log_level(level: int) -> None:
        """Set the PROCESS-GLOBAL default level (the reference's
        ResetLogLevel is likewise global); worker threads inherit it.
        Use ``set_thread_log_level`` for a per-thread override."""
        global _default_level
        _default_level = level

    @staticmethod
    def reset_callback(sink: Optional[Callable[[str], None]]) -> None:
        """Set the PROCESS-GLOBAL sink (``register_logger`` semantics:
        one registered logger serves every thread). Use
        ``set_thread_log_sink`` for a per-thread override."""
        global _default_sink
        _default_sink = sink

    @staticmethod
    def _write(level: int, msg: str) -> None:
        if level > _get_level():
            return
        line = "[LightGBM-TPU] [%s] %s" % (_LEVEL_NAMES[level], msg)
        sink = _get_sink()
        if sink is not None:
            sink(line + "\n")
        else:
            print(line, file=sys.stderr, flush=True)

    @staticmethod
    def debug(msg: str, *args) -> None:
        Log._write(_DEBUG, msg % args if args else msg)

    @staticmethod
    def info(msg: str, *args) -> None:
        Log._write(_INFO, msg % args if args else msg)

    @staticmethod
    def warning(msg: str, *args) -> None:
        Log._write(_WARNING, msg % args if args else msg)

    @staticmethod
    def fatal(msg: str, *args) -> None:
        text = msg % args if args else msg
        Log._write(_FATAL, text)
        raise LightGBMError(text)


def verbosity_to_level(verbosity: int) -> int:
    """Map the ``verbosity`` config parameter to a log level.

    Mirrors the reference mapping (src/io/config.cpp:46-56): <0 fatal-only,
    0 warning, 1 info, >1 debug.
    """
    if verbosity < 0:
        return _FATAL
    if verbosity == 0:
        return _WARNING
    if verbosity == 1:
        return _INFO
    return _DEBUG
