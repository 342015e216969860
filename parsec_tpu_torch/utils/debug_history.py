"""Debug-history ring: always-cheap in-memory marks, dumped on demand.

Reference: the PARSEC_DEBUG_HISTORY build (parsec/utils/debug.h:41-63
``parsec_debug_history_add/dump/purge``, parsec/debug_marks.h
``DEBUG_MARK_EXE`` / ``DEBUG_MARK_CTL_MSG_ACTIVATE_SENT`` / ...):
per-thread ring buffers record scheduling and wire events with
negligible overhead, and the whole interleaved history is dumped when a
race or hang is being chased — the "what was every thread doing right
before it went wrong" tool that asserts alone can't provide.

Python analog: per-thread rings of ``(t, ring-id, fmt, args)``
tuples — the hot path is one cached-size check plus a lock-free deque
append (formatting deferred to dump time; the enabled-size is cached
against the MCA registry generation, so the disabled path is a dict
miss-free comparison). Rings are identified by a monotonic id, never by
``threading.get_ident()`` — ident reuse after a thread exits must not
overwrite a dead thread's marks (often exactly the post-mortem
evidence); dead rings are retained up to ``_MAX_RINGS`` then dropped
oldest-first. Enabled with ``debug.history_size > 0``; fatal paths
(task-body errors, comm AM-handler crashes) dump automatically,
matching ``parsec_debug_history_on_fatal``.

(`utils.debug.history_dump` is a different facility — a capture of
recent formatted LOG lines; this module records structural marks.)
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Tuple

from . import mca_param

mca_param.register("debug.history_size", 0,
                   help="per-thread debug-history ring length "
                        "(0 = disabled; the reference's "
                        "PARSEC_DEBUG_HISTORY build knob)")

_MAX_RINGS = 256          # dead-thread rings retained before eviction

_rings: Dict[int, Deque[Tuple[float, str, tuple]]] = {}
_rings_lock = threading.Lock()          # protects the dict, not the rings
_ring_seq = [0]
_local = threading.local()
# (registry generation, resolved size): one int compare per mark()
_size_cache: Tuple[int, int] = (-1, 0)


def _size() -> int:
    global _size_cache
    gen = mca_param.generation()
    cached_gen, cached = _size_cache
    if cached_gen != gen:
        cached = int(mca_param.get("debug.history_size", 0))
        _size_cache = (gen, cached)
    return cached


def enabled() -> bool:
    return _size() > 0


def mark(fmt: str, *args: Any) -> None:
    """Record one event in this thread's ring (no-op when disabled).
    ``fmt % args`` is deferred to dump time — the hot path stores
    references only (debug_history_add analog)."""
    size = _size()
    if size <= 0:
        return
    ring = getattr(_local, "ring", None)
    if ring is None or ring.maxlen != size:
        ring = deque(maxlen=size)
        _local.ring = ring
        with _rings_lock:
            _ring_seq[0] += 1
            _rings[_ring_seq[0]] = ring
            while len(_rings) > _MAX_RINGS:       # oldest-first eviction
                _rings.pop(next(iter(_rings)))
    ring.append((time.perf_counter(), fmt, args))


def dump(purge: bool = False) -> List[str]:
    """Interleave every ring (live and dead-thread) by timestamp and
    render it (parsec_debug_history_dump). ``purge=True`` clears
    afterwards."""
    with _rings_lock:
        items = [(t, rid, fmt, args)
                 for rid, ring in _rings.items()
                 for (t, fmt, args) in list(ring)]
        if purge:
            for ring in _rings.values():
                ring.clear()
    items.sort(key=lambda it: it[0])
    out = []
    for (t, rid, fmt, args) in items:
        try:
            msg = fmt % args if args else fmt
        except Exception:  # noqa: BLE001 — a bad mark must not mask the dump
            msg = f"{fmt!r} % {args!r}"
        out.append(f"[{t:.6f}] ring-{rid}: {msg}")
    return out


def purge() -> None:
    """Drop all recorded history (parsec_debug_history_purge)."""
    with _rings_lock:
        for ring in _rings.values():
            ring.clear()


def dump_on_fatal(reason: str, tail: int = 200) -> None:
    """Emit the history through the warning logger when a fatal error
    path fires (parsec_debug_history_on_fatal analog)."""
    if not enabled():
        return
    from .debug import warning
    lines = dump()
    shown = lines[-tail:]
    warning("debug_history", "fatal (%s): showing last %d of %d "
            "history marks", reason, len(shown), len(lines))
    for line in shown:
        warning("debug_history", "%s", line)
