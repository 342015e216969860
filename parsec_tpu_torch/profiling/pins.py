"""PINS: performance instrumentation callback chains.

Reference: parsec/mca/pins/pins.h — callback chains on runtime events
(SELECT/PREPARE_INPUT/EXEC/COMPLETE_EXEC/RELEASE_DEPS begin+end, ...),
registered per execution stream and invoked via PARSEC_PINS macros.

Here a :class:`PinsManager` per context holds ordered callback lists per
event; modules register with :meth:`register`.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Callable, Dict, List


class PinsEvent(enum.IntEnum):
    SELECT_BEGIN = 0
    SELECT_END = 1
    PREPARE_INPUT_BEGIN = 2
    PREPARE_INPUT_END = 3
    EXEC_BEGIN = 4
    EXEC_END = 5
    COMPLETE_EXEC_BEGIN = 6
    COMPLETE_EXEC_END = 7
    RELEASE_DEPS_BEGIN = 8
    RELEASE_DEPS_END = 9
    TASKPOOL_INIT = 14


class PinsManager:
    def __init__(self, context) -> None:
        self.context = context
        self._chains: Dict[PinsEvent, List[Callable]] = defaultdict(list)

    def register(self, event: PinsEvent, cb: Callable) -> None:
        self._chains[event].append(cb)

    def unregister(self, event: PinsEvent, cb: Callable) -> None:
        try:
            self._chains[event].remove(cb)
        except ValueError:
            pass

    def _fire(self, event: PinsEvent, *args) -> None:
        for cb in self._chains.get(event, ()):
            cb(*args)

    # convenience hooks used by the core
    def taskpool_init(self, tp) -> None:
        self._fire(PinsEvent.TASKPOOL_INIT, tp)

    def select_begin(self, es, tasks) -> None:
        self._fire(PinsEvent.SELECT_BEGIN, es, tasks)

    def prepare_input_begin(self, es, task) -> None:
        self._fire(PinsEvent.PREPARE_INPUT_BEGIN, es, task)

    def prepare_input_end(self, es, task) -> None:
        self._fire(PinsEvent.PREPARE_INPUT_END, es, task)

    def exec_begin(self, es, task) -> None:
        self._fire(PinsEvent.EXEC_BEGIN, es, task)

    def exec_end(self, es, task) -> None:
        self._fire(PinsEvent.EXEC_END, es, task)

    def release_deps_begin(self, es, task) -> None:
        self._fire(PinsEvent.RELEASE_DEPS_BEGIN, es, task)

    def release_deps_end(self, es, task) -> None:
        self._fire(PinsEvent.RELEASE_DEPS_END, es, task)

    def complete_exec_begin(self, es, task) -> None:
        self._fire(PinsEvent.COMPLETE_EXEC_BEGIN, es, task)

    def complete_exec_end(self, es, task) -> None:
        self._fire(PinsEvent.COMPLETE_EXEC_END, es, task)
