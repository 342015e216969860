"""Task, flow and chore structures.

Mirrors the reference's core runtime objects:
- ``parsec_task_t`` (parsec_internal.h:503-516): runtime task instance with
  locals (parameter assignments), per-flow data, priority, chore mask and
  status (statuses at parsec_internal.h:464-469).
- ``parsec_flow_t`` (parsec_description_structures.h:92-106): named data
  access of a task class with access mode READ/WRITE/RW/CTL.
- ``__parsec_chore_t`` (parsec_internal.h:368-374): an *incarnation* of a
  task class on a device type, with an optional ``evaluate`` predicate and
  the executable ``hook``.

Bodies are **functional**: a chore takes the input tile values (torch
tensors) and returns the output tile values for its WRITE/RW flows,
instead of mutating buffers in place; the runtime owns the store-back.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class FlowAccess(enum.IntFlag):
    """Access mode of a flow (reference PARSEC_FLOW_ACCESS_* / SYM_INOUT)."""
    NONE = 0
    READ = 1
    WRITE = 2
    RW = 3
    CTL = 4      # control-only dependency, no data payload


class DeviceType(enum.IntFlag):
    """Device type bits (reference device.h:62-72). ``CUDA`` takes the
    bit the reference package gives its TPU device."""
    NONE = 0
    CPU = 1
    CUDA = 4
    ALL = CPU | CUDA


class HookReturn(enum.IntEnum):
    """Chore hook return codes (reference PARSEC_HOOK_RETURN_*)."""
    DONE = 0        # body executed, proceed to completion
    AGAIN = 1       # reschedule (priority demoted), e.g. resource busy
    ASYNC = 2       # body will complete asynchronously (device pipeline)
    NEXT = 3        # try the next incarnation
    ERROR = -1


class TaskStatus(enum.IntEnum):
    """Task lifecycle (reference parsec_internal.h:464-469)."""
    NONE = 0
    PREPARE_INPUT = 1
    EVAL = 2
    HOOK = 3
    PREPARE_OUTPUT = 4
    COMPLETE = 5


@dataclass
class Flow:
    """A named dataflow of a task class (parsec_flow_t analog)."""
    name: str
    access: FlowAccess
    index: int = -1          # assigned when attached to a task class

    @property
    def is_ctl(self) -> bool:
        return bool(self.access & FlowAccess.CTL)


@dataclass
class Chore:
    """One incarnation of a task class on a device type.

    ``hook(task, *inputs) -> outputs`` where ``inputs`` are the values of
    the task's flows in declaration order and ``outputs`` the new values of
    its WRITE/RW flows in declaration order (a single value may be returned
    for a single output flow). ``evaluate`` may veto this incarnation for a
    particular task (reference __parsec_chore_t.evaluate).
    """
    device_type: DeviceType
    hook: Callable[..., Any]
    evaluate: Optional[Callable[["Task"], bool]] = None
    # may be batched with same-class tasks by a compiled executor
    batchable: bool = True
    # Optional hand-written batched form used by the stacked wavefront
    # executor in place of vmap(hook): ``batch_hook(*stacked_tiles) ->
    # stacked outs`` (e.g. one wide-RHS triangular solve for a whole TRSM
    # wave). ``batch_hook_shared`` names input flows the hook assumes hold
    # ONE tile across the whole batch; the executor verifies this per
    # group and falls back to vmap otherwise.
    batch_hook: Optional[Callable[..., Any]] = None
    batch_hook_shared: Optional[Sequence[str]] = None


_task_counter = itertools.count()


class Task:
    """A runtime task instance (parsec_task_t analog)."""

    __slots__ = ("taskpool", "task_class", "locals", "data", "output",
                 "priority", "chore_mask", "status", "uid", "on_complete")

    def __init__(self, taskpool, task_class, locals: Tuple[int, ...],
                 priority: int = 0):
        self.taskpool = taskpool
        self.task_class = task_class
        self.locals = tuple(locals)
        # per-flow input values, keyed by flow name
        self.data: Dict[str, Any] = {}
        # per-flow output values (filled by completion path)
        self.output: Dict[str, Any] = {}
        self.priority = priority
        self.chore_mask = (1 << 30) - 1
        self.status = TaskStatus.NONE
        self.uid = next(_task_counter)
        self.on_complete: Optional[Callable[["Task"], None]] = None

    @property
    def key(self) -> Tuple[int, Tuple[int, ...]]:
        """Unique key inside the taskpool (task_class.make_key analog)."""
        return self.task_class.make_key(self.locals)

    def input_values(self) -> List[Any]:
        return [self.data.get(f.name) for f in self.task_class.flows
                if not f.is_ctl]

    def __repr__(self) -> str:
        args = ", ".join(map(str, self.locals))
        return f"{self.task_class.name}({args})"


def normalize_outputs(result: Any, out_flow_names: Sequence[str],
                      label: Any) -> Dict[str, Any]:
    """Functional-body result → output-flow dict: None = no outputs,
    dict = as-is, tuple/list zipped against the output flows (arity
    checked), a bare value requires exactly one output flow. ``label`` is
    only used in error messages."""
    if result is None:
        return {}
    if isinstance(result, dict):
        return result
    if isinstance(result, (tuple, list)):
        if len(result) != len(out_flow_names):
            raise ValueError(
                f"{label}: body returned {len(result)} values for "
                f"{len(out_flow_names)} output flows")
        return dict(zip(out_flow_names, result))
    if len(out_flow_names) != 1:
        raise ValueError(
            f"{label}: single return value but {len(out_flow_names)} "
            "output flows")
    return {out_flow_names[0]: result}
