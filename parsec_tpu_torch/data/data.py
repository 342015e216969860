"""Data items and per-device copies.

Reference: parsec_data_t = key + owner + array of per-device
parsec_data_copy_t with MESI-like coherency INVALID/OWNED/EXCLUSIVE/SHARED
(data_internal.h:35-81, data.h:27-32) and version counters.

In this runtime, values are functional (bodies return new tensors), so the copy
table tracks *where* a version materializes (host numpy vs device
CUDA tensor) rather than guarding against concurrent mutation. The version
counter still orders successive writers of the same logical datum — the
invariant checked by tests mirroring the reference's coherency tests.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Dict, Optional


class CoherencyState(enum.IntEnum):
    INVALID = 0
    OWNED = 1
    EXCLUSIVE = 2
    SHARED = 3


class DataCopy:
    """One materialization of a data version on a device
    (parsec_data_copy_t analog)."""

    __slots__ = ("device_index", "value", "version", "coherency", "dtt")

    def __init__(self, device_index: int, value: Any, version: int = 0,
                 coherency: CoherencyState = CoherencyState.OWNED,
                 dtt: Any = None):
        self.device_index = device_index
        self.value = value
        self.version = version
        self.coherency = coherency
        self.dtt = dtt          # datatype/layout tag (reshape engine)


class Data:
    """A logical datum (parsec_data_t analog): key + owner + copies."""

    def __init__(self, key, owner_device: int = 0, collection=None):
        self.key = key
        self.owner_device = owner_device
        self.collection = collection
        self.version = 0
        self._copies: Dict[int, DataCopy] = {}
        self._lock = threading.Lock()

    def get_copy(self, device_index: int = 0) -> Optional[DataCopy]:
        with self._lock:
            return self._copies.get(device_index)

    def newest_copy(self) -> Optional[DataCopy]:
        with self._lock:
            if not self._copies:
                return None
            return max(self._copies.values(), key=lambda c: c.version)

    def attach_copy(self, device_index: int, value: Any,
                    coherency: CoherencyState = CoherencyState.SHARED) -> DataCopy:
        with self._lock:
            cp = DataCopy(device_index, value, self.version, coherency)
            self._copies[device_index] = cp
            return cp

    def write(self, device_index: int, value: Any) -> DataCopy:
        """A new version produced on ``device_index``: bump the version,
        invalidate other copies (MESI writer takes EXCLUSIVE)."""
        with self._lock:
            self.version += 1
            for cp in self._copies.values():
                cp.coherency = CoherencyState.INVALID
            cp = DataCopy(device_index, value, self.version,
                          CoherencyState.EXCLUSIVE)
            self._copies[device_index] = cp
            return cp
