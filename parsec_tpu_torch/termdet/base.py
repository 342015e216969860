"""Termdet monitor interface (reference termdet.h:27-120)."""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional


class TermdetState(enum.IntEnum):
    NOT_READY = 0    # taskpool still being constructed; cannot terminate
    BUSY = 1         # tasks or runtime actions outstanding
    IDLE = 2         # locally quiet; distributed modules may still wait
    TERMINATED = 3


class TermdetMonitor:
    """Base monitor: counts tasks and pending runtime actions.

    ``nb_tasks`` mirrors taskpool->nb_tasks, ``runtime_actions`` mirrors
    taskpool->nb_pending_actions (parsec_internal.h:123-143). The taskpool
    is NOT_READY until ``ready()`` (reference: the DSL calls set_nb_tasks /
    starts enqueue), then BUSY until both counters reach zero.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nb_tasks = 0
        self._runtime_actions = 0
        self._state = TermdetState.NOT_READY
        self._on_terminated: Optional[Callable[[], None]] = None
        # False until set_nb_tasks()/ready() closes the startup window:
        # a pool is visible to the workers BEFORE the DSL counts its
        # local tasks, so a task can execute and COMPLETE ahead of
        # set_nb_tasks — that decrement must carry as a deficit, not
        # raise
        self._counted = False

    # -- wiring -----------------------------------------------------------
    def monitor(self, on_terminated: Callable[[], None]) -> None:
        self._on_terminated = on_terminated

    # -- counters ---------------------------------------------------------
    @property
    def nb_tasks(self) -> int:
        return self._nb_tasks

    @property
    def state(self) -> TermdetState:
        return self._state

    def set_nb_tasks(self, n: int) -> None:
        with self._lock:
            # fold in completions that raced the startup enumeration
            # (see _counted): n counts ALL local tasks, including any
            # already completed, so the carried deficit subtracts
            deficit = self._nb_tasks if self._nb_tasks < 0 else 0
            self._nb_tasks = n + deficit
            self._counted = True
            self._rearm_locked()
            if self._nb_tasks < 0:
                raise RuntimeError("nb_tasks went negative")
            fire = self._maybe_idle_locked()
        if fire:
            self._fire()
        self._post_transition()

    def addto_nb_tasks(self, d: int) -> None:
        with self._lock:
            self._nb_tasks += d
            self._rearm_locked()
            if self._nb_tasks < 0 and self._counted:
                raise RuntimeError("nb_tasks went negative")
            fire = self._maybe_idle_locked()
        if fire:
            self._fire()
        self._post_transition()

    def addto_runtime_actions(self, d: int) -> None:
        with self._lock:
            self._runtime_actions += d
            self._rearm_locked()
            if self._runtime_actions < 0:
                raise RuntimeError("runtime_actions went negative")
            fire = self._maybe_idle_locked()
        if fire:
            self._fire()
        self._post_transition()

    def _rearm_locked(self) -> None:
        """NOT_READY→BUSY on first counter activity, and IDLE→BUSY when new
        work appears after a quiet period (reference termdet.h state
        machine: IDLE is not final for modules that wait on remote
        confirmation — a late local task or message must re-arm the
        monitor or termination is missed forever)."""
        if self._state == TermdetState.NOT_READY:
            self._state = TermdetState.BUSY
        elif self._state == TermdetState.IDLE and \
                (self._nb_tasks > 0 or self._runtime_actions > 0):
            self._state = TermdetState.BUSY

    def ready(self) -> None:
        """Transition NOT_READY → BUSY (taskpool fully constructed)."""
        with self._lock:
            self._counted = True     # startup window closed either way
            if self._state == TermdetState.NOT_READY:
                self._state = TermdetState.BUSY
            fire = self._maybe_idle_locked()
        if fire:
            self._fire()
        self._post_transition()

    def _post_transition(self) -> None:
        """Hook invoked after every counter mutation, OUTSIDE the monitor
        lock — distributed modules launch their waves here (launching from
        inside the lock would deadlock when the comm engine delivers the
        wave result synchronously, e.g. the loopback engine)."""

    # -- module-specific idle → terminated policy -------------------------
    def _maybe_idle_locked(self) -> bool:
        """Called with lock held when counters change; returns True when the
        TERMINATED transition fired (callback invoked by caller outside the
        lock)."""
        if (self._state == TermdetState.BUSY
                and self._nb_tasks == 0 and self._runtime_actions == 0):
            self._state = TermdetState.IDLE
            return self._idle_to_terminated_locked()
        return False

    def _idle_to_terminated_locked(self) -> bool:
        """Default (local) policy: IDLE is final → TERMINATED immediately."""
        self._state = TermdetState.TERMINATED
        return True

    def _fire(self) -> None:
        if self._on_terminated is not None:
            self._on_terminated()
