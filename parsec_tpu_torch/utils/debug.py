"""Leveled debug/output streams with a recent-log capture ring.

Mirrors the reference's debug OUTPUT facility (parsec/utils/debug.h:
39-76, utils/output.c): verbosity-leveled streams plus a fixed-size,
thread-safe ring capturing recently FORMATTED log lines for post-mortem
dumps. The structural-event history (the reference's
``parsec_debug_history`` / debug_marks.h EXE/ACTIVATE marks) is the
separate :mod:`~parsec_tpu_torch.utils.debug_history` module — this ring
records what was logged, that one records what the runtime did.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Deque, Tuple

_verbosity = int(os.environ.get("PARSEC_MCA_debug_verbose", "1"))
_history_size = 512
_history: Deque[Tuple[float, int, str]] = deque(maxlen=_history_size)
_lock = threading.Lock()


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def get_verbosity() -> int:
    return _verbosity


def debug_verbose(level: int, stream: str, msg: str, *args) -> None:
    """parsec_debug_verbose analog: print iff level <= current verbosity,
    and always record into the history ring."""
    if args:
        msg = msg % args
    with _lock:
        _history.append((time.time(), level, f"[{stream}] {msg}"))
    if level <= _verbosity:
        print(f"parsec_tpu_torch:{stream}: {msg}", file=sys.stderr)


def warning(stream: str, msg: str, *args) -> None:
    debug_verbose(1, stream, "WARNING: " + msg, *args)


def fatal(stream: str, msg: str, *args) -> None:
    debug_verbose(0, stream, "FATAL: " + msg, *args)
    raise RuntimeError(f"[{stream}] {msg % args if args else msg}")


def history_dump() -> str:
    """Dump the recent-LOG capture ring (formatted lines). For the
    structural EXE/ACTIVATE mark history use
    ``parsec_tpu_torch.utils.debug_history.dump``."""
    with _lock:
        lines = [f"{t:.6f} [{lvl}] {m}" for (t, lvl, m) in _history]
    return "\n".join(lines)


def history_clear() -> None:
    with _lock:
        _history.clear()
