"""Scheduler framework (reference parsec/mca/sched/).

Common interface (sched.h:183-353): ``install(context)``,
``flow_init(es)`` (per-stream structures), ``schedule(es, tasks, distance)``,
``select(es) -> task``, ``remove()``. The ``distance`` hint orders how soon
tasks should run; schedulers that ignore it can livelock (sched.h:243-250).

This slice ports the default module, ``lfq`` (local flat queues with a
hierarchical steal inside the stream's virtual process).
"""

from .base import Scheduler
from .local_queues import LFQScheduler
from ..utils import mca_param

_MODULES = {
    "lfq": LFQScheduler,   # local flat queues + hierarchical steal
}

mca_param.register("sched", "lfq",
                   help=f"scheduler module ({', '.join(sorted(_MODULES))})")


def new_scheduler(name=None) -> Scheduler:
    name = name or mca_param.get("sched", "lfq")
    try:
        cls = _MODULES[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have {sorted(_MODULES)}")
    return cls()

