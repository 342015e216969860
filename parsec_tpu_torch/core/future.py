"""Futures and datacopy futures.

Reference: parsec/class/parsec_future.c (base future: set-once value with
blocking get and completion callbacks) and
parsec/class/parsec_datacopy_future.c (futures over data copies whose
fulfillment runs a *trigger* constructing the requested copy lazily —
the mechanism behind reshape promises, remote_dep.h:100-108).

Port divergence: a "copy in another datatype/layout" is a functional
transform of a tensor value (dtype cast, transpose, retiling) — so a datacopy future caches one converted value per
requested :class:`~parsec_tpu_torch.core.reshape.ReshapeSpec` and shares it
across all consumers instead of tracking per-device copy objects.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class Future:
    """Set-once future (parsec_future.c analog).

    ``set`` fulfills the future exactly once; ``get`` blocks; callbacks
    registered with ``on_ready`` fire on the setting thread (or
    immediately if already fulfilled).
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._ready = False
        self._value: Any = None
        self._cbs: List[Callable[[Any], None]] = []

    def is_ready(self) -> bool:
        with self._cond:
            return self._ready

    def set(self, value: Any) -> None:
        with self._cond:
            if self._ready:
                raise RuntimeError("future already fulfilled")
            self._value = value
            self._ready = True
            cbs, self._cbs = self._cbs, []
            self._cond.notify_all()
        for cb in cbs:
            cb(value)

    def get(self, timeout: Optional[float] = None) -> Any:
        with self._cond:
            if not self._cond.wait_for(lambda: self._ready, timeout):
                raise TimeoutError("future not fulfilled in time")
            return self._value

    def on_ready(self, cb: Callable[[Any], None]) -> None:
        with self._cond:
            if not self._ready:
                self._cbs.append(cb)
                return
            value = self._value
        cb(value)


class DataCopyFuture(Future):
    """Future over a data value with lazily-triggered converted copies
    (parsec_datacopy_future.c analog).

    ``get_copy(spec)`` returns the base value for ``spec=None``, else the
    value transformed by ``spec`` — computed by the *trigger* on first
    request (on the requesting thread, like the reference's reshape
    triggers running on compute or comm threads) and cached so every
    consumer of the same spec shares one conversion.
    """

    def __init__(self, value: Any = None, *,
                 trigger: Optional[Callable[[Any, Any], Any]] = None) -> None:
        super().__init__()
        if value is not None:
            self.set(value)
        # trigger(base_value, spec) -> converted value; default applies the
        # spec itself (ReshapeSpec.apply or any callable)
        self._trigger = trigger
        self._copies: Dict[Any, Any] = {}
        self._copies_lock = threading.Lock()

    def _convert(self, base: Any, spec: Any) -> Any:
        if self._trigger is not None:
            return self._trigger(base, spec)
        apply = getattr(spec, "apply", None)
        if apply is not None:
            return apply(base)
        return spec(base)

    def get_copy(self, spec: Any = None,
                 timeout: Optional[float] = None) -> Any:
        base = self.get(timeout)
        if spec is None:
            return base
        key = getattr(spec, "key", spec)
        with self._copies_lock:
            if key in self._copies:
                return self._copies[key]
        converted = self._convert(base, spec)
        with self._copies_lock:
            # a racing consumer may have converted first; keep one copy
            return self._copies.setdefault(key, converted)

    @property
    def nb_copies(self) -> int:
        with self._copies_lock:
            return len(self._copies)
