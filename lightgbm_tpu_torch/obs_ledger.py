"""The durable-append substrate of the fleet store (PyTorch port of
``append_jsonl`` and ``read_jsonl`` from ``lightgbm_tpu/obs_ledger.py``;
the run ledger itself is ROADMAP item 10).

JSONL so appends are atomic enough under POSIX (one ``write`` of one
line), the file is greppable, and partial or corrupt lines (a process
killed mid-append) are skipped on read, never fatal.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional


def append_jsonl(path: str, entry: Dict[str, Any]) -> None:
    """One entry as one JSONL line written in ONE write call: concurrent
    writers interleave whole lines and a killed process leaves at most
    one partial line (skipped on read). Creates the file and its parent
    directory on first use."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")


def read_jsonl(path: str,
               max_version: Optional[int] = None) -> Iterator[Dict[str, Any]]:
    """Yield dict lines oldest-first, skipping blank, corrupt and partial
    lines and, when ``max_version`` is given, entries whose ``v`` field
    is newer than the reader understands."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if not isinstance(e, dict):
                continue
            if max_version is not None and e.get("v", 0) > max_version:
                continue
            yield e
