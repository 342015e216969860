"""Extensible info registry (parsec_info_t analog).

Reference: ``parsec/class/info.c/h`` (559 LoC) + the per-object info
arrays wired into taskpools, devices and streams
(``parsec_internal.h:688-702``). The reference registers named info
slots once (getting back an index), then every carrier object lazily
materializes per-slot objects via a constructor, so MCA modules can hang
arbitrary state off runtime objects without touching their structs.

Same contract here: :class:`InfoRegistry` maps names → slot ids;
:class:`InfoArray` is the per-carrier store with lazy per-slot
construction. Used for per-device / per-stream extension data (PINS
modules, device statistics extensions) without subclassing.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class InfoRegistry:
    """Process-wide named info slots (parsec_info_register analog)."""

    def __init__(self) -> None:
        self._slots: Dict[str, int] = {}
        self._ctors: List[Optional[Callable[[Any], Any]]] = []
        self._lock = threading.Lock()

    def register(self, name: str,
                 constructor: Optional[Callable[[Any], Any]] = None) -> int:
        """Register (or look up) slot ``name``; returns its id. The
        constructor builds the initial per-carrier value lazily, taking
        the carrier object."""
        with self._lock:
            sid = self._slots.get(name)
            if sid is not None:
                if constructor is not None:
                    self._ctors[sid] = constructor
                return sid
            sid = len(self._ctors)
            self._slots[name] = sid
            self._ctors.append(constructor)
            return sid

    def lookup(self, name: str) -> Optional[int]:
        with self._lock:
            return self._slots.get(name)

    def unregister(self, name: str) -> None:
        """Drop the name→slot binding (slot ids are never reused —
        carriers may still hold values; reference semantics)."""
        with self._lock:
            self._slots.pop(name, None)

    def constructor(self, sid: int) -> Optional[Callable]:
        with self._lock:
            return self._ctors[sid] if 0 <= sid < len(self._ctors) \
                else None

    def names(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._slots)


class InfoArray:
    """Per-carrier slot values with lazy construction
    (parsec_info_object_array analog)."""

    def __init__(self, registry: InfoRegistry, carrier: Any = None):
        self.registry = registry
        self.carrier = carrier
        self._values: Dict[int, Any] = {}
        self._lock = threading.Lock()

    def get(self, slot, default: Any = None) -> Any:
        sid = self.registry.lookup(slot) if isinstance(slot, str) else slot
        if sid is None:
            return default
        with self._lock:
            if sid in self._values:
                return self._values[sid]
            ctor = self.registry.constructor(sid)
            if ctor is None:
                return default
            val = ctor(self.carrier)
            self._values[sid] = val
            return val

    def set(self, slot, value: Any) -> None:
        sid = self.registry.lookup(slot) if isinstance(slot, str) else slot
        if sid is None:
            raise KeyError(f"unknown info slot {slot!r}")
        with self._lock:
            self._values[sid] = value

    def clear(self, slot) -> None:
        sid = self.registry.lookup(slot) if isinstance(slot, str) else slot
        if sid is not None:
            with self._lock:
                self._values.pop(sid, None)


# the process-wide registries the reference exposes as globals
# (parsec_per_device_infos, parsec_per_stream_infos)
per_device_infos = InfoRegistry()
per_stream_infos = InfoRegistry()
