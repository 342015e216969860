"""Scheduler base class (reference sched.h:183-353)."""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.task import Task


class Scheduler:
    """Base scheduler module.

    Lifecycle: ``install(context)`` once, then ``flow_init(es)`` per
    execution stream, then concurrent ``schedule``/``select`` calls from
    worker threads, finally ``remove(context)``.
    """

    name = "base"

    def install(self, context) -> None:
        self.context = context

    def flow_init(self, es) -> None:
        """Allocate per-execution-stream structures (sched.h flow_init)."""

    def schedule(self, es, tasks: Sequence[Task], distance: int = 0) -> None:
        """Insert a ring of ready tasks, `distance` hinting how soon they
        should run (0 = immediately / front of queue)."""
        raise NotImplementedError

    def select(self, es) -> Optional[Task]:
        """Pick the next task for this stream, or None if starved."""
        raise NotImplementedError

    def remove(self, context) -> None:
        pass
