"""Local-queue scheduler with work stealing: ``lfq``.

Reference module parsec/mca/sched/lfq (365 LoC,
sched_local_queues_utils.h): local flat queues, hierarchical steal
core→socket→node, bounded per-thread buffer with overflow to a system
dequeue. Steals stay inside the stream's virtual process (vpmap scoping,
parsec.c:336-382).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

from .base import Scheduler
from ..core.task import Task


class _LocalDeque:
    __slots__ = ("dq", "lock")

    def __init__(self) -> None:
        self.dq = deque()
        self.lock = threading.Lock()

    def push_front(self, items) -> None:
        with self.lock:
            self.dq.extendleft(reversed(items))

    def push_back(self, items) -> None:
        with self.lock:
            self.dq.extend(items)

    def pop_front(self) -> Optional[Task]:
        # empty fast path without the lock (deque truthiness is
        # GIL-atomic): a push racing the check is caught by the next scan
        # or the schedule() wakeup, exactly like a pop that lost the race
        if not self.dq:
            return None
        with self.lock:
            return self.dq.popleft() if self.dq else None

    def pop_back(self) -> Optional[Task]:
        if not self.dq:
            return None
        with self.lock:
            return self.dq.pop() if self.dq else None

    def __len__(self) -> int:
        return len(self.dq)


def _span_order(es):
    """Hierarchical (core→pair→quad→…→VP) peer order: nearest
    topology neighbors first. Stands in for hwloc levels (vpmap-scoped;
    reference sched_local_queues_utils.h steal hierarchy)."""
    peers = sorted((s for s in es.context.streams if s.vp_id == es.vp_id),
                   key=lambda s: s.th_id)
    me = next(i for i, s in enumerate(peers) if s is es)
    order = []
    span = 2
    while span <= max(len(peers), 2):
        base = (me // span) * span
        for i in range(base, min(base + span, len(peers))):
            if peers[i] not in order:
                order.append(peers[i])
        span *= 2
    for p in peers:
        if p not in order:
            order.append(p)
    return order


class LFQScheduler(Scheduler):
    """Local flat queues: bounded per-thread buffer (reference hbbuffer),
    overflow to the system dequeue, HIERARCHICAL steal order
    (core→pair→quad→…, nearest first). ``distance > 0`` skips the local
    buffer entirely — the ordered-ring semantics of sched.h:243-250:
    far-distance tasks go where any starving thread finds them, which is
    what prevents the re-schedule livelock the reference warns about."""
    name = "lfq"
    local_bound = 64

    def install(self, context) -> None:
        super().install(context)
        self.system = _LocalDeque()       # overflow / no-stream pushes

    def flow_init(self, es) -> None:
        es.sched_obj = _LocalDeque()
        es._steal_order = None      # invalidate on (re)install

    def schedule(self, es, tasks: Sequence[Task], distance: int = 0) -> None:
        if distance > 0 or es is None or \
                getattr(es, "sched_obj", None) is None:
            self.system.push_back(tasks)
            return
        q = es.sched_obj
        if len(q) + len(tasks) > self.local_bound:
            fit = max(0, self.local_bound - len(q))
            q.push_front(tasks[:fit])
            self.system.push_back(tasks[fit:])
        else:
            q.push_front(tasks)

    def select(self, es) -> Optional[Task]:
        t = es.sched_obj.pop_front()
        if t is None:
            t = self._steal_and_system(es)
        return t

    def _steal_and_system(self, es) -> Optional[Task]:
        """Steal from VP peers (topology-fixed order, precomputed
        WITHOUT self and cached on the stream), then drain the system
        overflow queue."""
        order = es._steal_order
        if order is None:
            order = es._steal_order = tuple(
                p for p in _span_order(es) if p is not es)
        for peer in order:
            t = peer.sched_obj.pop_back()
            if t is not None:
                es.stats["stolen"] += 1
                return t
        t = self.system.pop_front()
        if t is not None:
            es.stats["stolen"] += 1
        return t
