"""Execution context and worker scheduling loop.

Reference mapping:
- ``parsec_init`` (parsec.c:384-924): builds the context — vpmap, execution
  streams (one per core), scheduler selection, device registration — and
  spawns worker threads that block until work arrives.
- ``parsec_context_add_taskpool`` (scheduling.c:678-727): installs the
  default termdet, runs the taskpool's startup hook to seed
  no-predecessor tasks, schedules them.
- ``parsec_context_start/test/wait`` (scheduling.c:750-808).
- ``__parsec_context_wait`` (scheduling.c:537-676): the hot worker loop —
  select → prepare input → execute chore → complete → release deps, with
  exponential backoff when starved.
- ``__parsec_task_progress`` (scheduling.c:472-535) incl. the AGAIN path
  (priority demotion + reschedule) and ASYNC (device completes later).
- Release path ``parsec_release_dep_fct`` (parsec.c:1783-1921): successors
  counted down via the taskpool's pending table; ready tasks pushed as a
  priority-sorted ring; the best one is kept as the stream's bypass
  ``next_task`` (scheduling.c:346-398).

The context runs on one ``torch.device``: ``cuda`` by default, which
raises when PyTorch sees no GPU, or ``cpu`` when the caller asks for it.
Collection reads are staged onto that device, so bodies always see
tensors.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .future import DataCopyFuture
from .reshape import resolve_reshape
from .task import HookReturn, Task, TaskStatus
from .taskpool import DataRef, SuccessorRef, Taskpool
from ..utils import debug_history, mca_param
from ..utils.debug import debug_verbose, warning
from .. import termdet as termdet_mod

mca_param.register("runtime.nb_cores", 0, help="worker streams (0 = os.cpu_count())")
mca_param.register("runtime.backoff_min_us", 50, help="starvation backoff floor")
mca_param.register("runtime.backoff_max_us", 2000, help="starvation backoff ceiling")
mca_param.register("vpmap", "flat",
                   help="virtual-process map: flat | nb:SIZE | "
                        "list:0,0,1,... | file:PATH")


class ExecutionStream:
    """Per-worker execution stream (reference parsec_execution_stream_t)."""

    __slots__ = ("context", "th_id", "vp_id", "sched_obj", "next_task",
                 "thread", "stats", "_steal_order", "infos")

    def __init__(self, context: "Context", th_id: int, vp_id: int):
        from ..utils.info import InfoArray, per_stream_infos
        self.context = context
        self.th_id = th_id
        self.vp_id = vp_id
        self.sched_obj = None
        self.next_task: Optional[Task] = None   # priority bypass slot
        self.thread: Optional[threading.Thread] = None
        self.stats = {"executed": 0, "selected": 0, "starved": 0,
                      "stolen": 0}
        self._steal_order = None    # cached steal order (sched)
        # extensible per-stream info slots (parsec_internal.h:688-702)
        self.infos = InfoArray(per_stream_infos, self)


def resolve_device(device) -> torch.device:
    """The ``torch.device`` a context or a compiled executor runs on.
    ``cuda`` without a GPU raises: the port never continues on the CPU
    unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "parsec_tpu_torch: device 'cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


class Context:
    """The runtime context (parsec_context_t analog)."""

    def __init__(self, nb_cores: Optional[int] = None,
                 scheduler: Optional[str] = None,
                 device="cuda"):
        from .. import device as device_mod
        from .. import sched as sched_mod
        from ..profiling import pins as pins_mod
        from ..utils import vpmap

        self.torch_device = resolve_device(device)
        if nb_cores is None or nb_cores <= 0:
            nb_cores = int(mca_param.get("runtime.nb_cores", 0)) or \
                min(os.cpu_count() or 1, 8)
        self.nb_cores = nb_cores
        self.my_rank = 0
        self.nb_ranks = 1

        vp_ids = vpmap.parse(str(mca_param.get("vpmap", "flat")), nb_cores)
        self.streams = [ExecutionStream(self, i, vp_ids[i])
                        for i in range(nb_cores)]

        self.scheduler = sched_mod.new_scheduler(scheduler)
        self.scheduler.install(self)
        for es in self.streams:
            self.scheduler.flow_init(es)

        self.devices = device_mod.Registry(self)
        self.pins = pins_mod.PinsManager(self)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._active_taskpools: List[Taskpool] = []
        self._aborted: List[Taskpool] = []
        self._started = False
        self._shutdown = False
        self._work_evt = threading.Event()

        for es in self.streams:
            t = threading.Thread(target=self._worker_main, args=(es,),
                                 name=f"parsec-es-{es.th_id}", daemon=True)
            es.thread = t
            t.start()
        debug_verbose(3, "context",
                      "context up: %d streams, sched=%s, device=%s",
                      nb_cores, self.scheduler.name, self.torch_device)

    # ------------------------------------------------------------------ API
    def add_taskpool(self, tp: Taskpool) -> None:
        """parsec_context_add_taskpool analog (scheduling.c:678-727)."""
        if tp.monitor is None:
            tp.monitor = termdet_mod.new_monitor()
        tp.monitor.monitor(tp._on_terminated)
        tp.context = self
        with self._lock:
            self._active_taskpools.append(tp)
        self.pins.taskpool_init(tp)
        startup = tp.startup_hook(tp) or []
        if startup:
            self.schedule(None, list(startup))
        tp.monitor.ready()
        if self._started:
            self._work_evt.set()

    def start(self) -> None:
        """parsec_context_start analog: release the workers."""
        with self._lock:
            self._started = True
        self._work_evt.set()

    def stage_read(self, dc, key, value):
        """Stage one collection read onto the context's device. A numpy
        tile, or a tensor on another device, becomes a tensor on
        ``torch_device`` and is written back, so the collection holds the
        staged copy and one transfer serves every later reader (the
        reference keeps the device copy attached to the data object,
        device_gpu stage-in). Everything else passes through."""
        if isinstance(value, np.ndarray):
            staged = torch.as_tensor(value).to(self.torch_device,
                                               non_blocking=True)
        elif isinstance(value, torch.Tensor) and \
                value.device != self.torch_device:
            staged = value.to(self.torch_device, non_blocking=True)
        else:
            return value
        dc.write_tile(key, staged)
        return staged

    def test(self) -> bool:
        """parsec_context_test analog: True iff all taskpools completed."""
        with self._lock:
            return len(self._active_taskpools) == 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        """parsec_context_wait analog: block until every enqueued taskpool
        terminated. Returns False on timeout."""
        if not self._started:
            self.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._active_taskpools:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if remaining == 0.0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.25)
            if self._aborted:
                tp = self._aborted[0]
                self._aborted.clear()
                raise RuntimeError(
                    f"taskpool {tp.name} aborted: {tp.error}") from tp.error
        return True

    def fini(self) -> None:
        """parsec_fini analog: drain and stop the workers."""
        with self._lock:
            self._shutdown = True
        self._work_evt.set()
        for es in self.streams:
            if es.thread is not None:
                es.thread.join(timeout=5.0)
        for dev in self.devices.devices:
            dev.shutdown()
        self.scheduler.remove(self)
        debug_verbose(3, "context", "context down; stats=%s",
                      {es.th_id: es.stats for es in self.streams})

    # --------------------------------------------------------- scheduling
    def schedule(self, es: Optional[ExecutionStream], tasks: Sequence[Task],
                 distance: int = 0) -> None:
        """__parsec_schedule analog: push a ring of ready tasks."""
        if not tasks:
            return
        for t in tasks:
            t.status = TaskStatus.NONE
        self.pins.select_begin(es, tasks)
        if len(tasks) > 1:
            tasks = sorted(tasks, key=lambda t: -t.priority)
        self.scheduler.schedule(es, tasks, distance)
        # is_set() is a plain bool read; while workers are busy the event
        # stays set, so the common completion path skips set(). A worker
        # that cleared it re-selects BEFORE waiting (see _worker_main),
        # so this cannot lose a wakeup.
        evt = self._work_evt
        if not evt.is_set():
            evt.set()

    def _taskpool_terminated(self, tp: Taskpool) -> None:
        with self._cv:
            try:
                self._active_taskpools.remove(tp)
            except ValueError:
                pass
            if tp.error is not None and tp not in self._aborted:
                self._aborted.append(tp)
            self._cv.notify_all()

    # --------------------------------------------------------- worker loop
    def _worker_main(self, es: ExecutionStream) -> None:
        backoff_min = int(mca_param.get("runtime.backoff_min_us", 50)) / 1e6
        backoff_max = int(mca_param.get("runtime.backoff_max_us", 2000)) / 1e6
        backoff = backoff_min
        while True:
            if self._shutdown:
                return
            if not self._started or not self._active_taskpools:
                self._work_evt.clear()
                # re-check after clear to avoid a lost wakeup from
                # add_taskpool()/start() racing with the clear
                if self._shutdown or (self._started and
                                      self._active_taskpools):
                    continue
                self._work_evt.wait(timeout=0.1)
                continue
            task = es.next_task
            es.next_task = None
            if task is None:
                task = self.scheduler.select(es)
            if task is None:
                es.stats["starved"] += 1
                # event-driven wakeup: schedule() sets _work_evt.
                # Clear-then-reselect avoids the lost-wakeup race; the
                # timeout only bounds termdet/shutdown polling.
                self._work_evt.clear()
                task = self.scheduler.select(es)
                if task is None:
                    self._work_evt.wait(timeout=backoff)
                    backoff = min(backoff * 2, backoff_max)
                    continue
            backoff = backoff_min
            es.stats["selected"] += 1
            try:
                self._task_progress(es, task)
            except Exception as exc:  # noqa: BLE001 - worker must survive
                warning("scheduling", "task %r raised: %s", task, exc)
                import traceback
                traceback.print_exc()
                debug_history.dump_on_fatal(f"task {task!r} raised")
                # successors can never fire: abort the pool so waiters are
                # released with the error instead of hanging (parsec_abort)
                task.taskpool.abort(exc)

    def _task_progress(self, es: ExecutionStream, task: Task) -> None:
        """__parsec_task_progress analog (scheduling.c:472-535)."""
        tc = task.task_class
        # prepare_input (generated data_lookup analog): resolve inputs not
        # attached by the release path (collection reads, NEW values)
        task.status = TaskStatus.PREPARE_INPUT
        lookup = getattr(tc, "data_lookup", None)
        if lookup is not None:
            self.pins.prepare_input_begin(es, task)
            lookup(task)
            self.pins.prepare_input_end(es, task)
        # execute: walk incarnations honoring the chore mask
        task.status = TaskStatus.HOOK
        self.pins.exec_begin(es, task)
        rc = self._execute(es, task)
        if rc == HookReturn.ASYNC:
            return                      # device layer completes it later
        if rc == HookReturn.AGAIN:
            task.priority -= 1          # priority demotion + reschedule
            self.schedule(es, [task], distance=1)
            return
        if rc == HookReturn.ERROR:
            raise RuntimeError(f"all incarnations of {task!r} failed")
        self.complete_task(es, task)

    def _execute(self, es: ExecutionStream, task: Task) -> HookReturn:
        """__parsec_execute analog (scheduling.c:124-203): try incarnations
        in declaration order, skipping masked/vetoed ones."""
        tc = task.task_class
        if debug_history.enabled():     # DEBUG_MARK_EXE analog
            debug_history.mark("EXE %s%r es=%s", tc.name,
                               tuple(task.locals),
                               getattr(es, "th_id", -1))
        for i, chore in enumerate(tc.incarnations):
            if not (task.chore_mask & (1 << i)):
                continue
            if chore.evaluate is not None and not chore.evaluate(task):
                continue
            dev = self.devices.device_for(chore.device_type, task)
            if dev is None:
                continue
            rc = None
            try:
                rc = dev.execute(es, task, chore)
            finally:
                if rc != HookReturn.ASYNC:
                    # async devices keep their in-flight unit until the
                    # manager completes the task; every other outcome —
                    # including a raising hook — releases here
                    dev.release_load()
            if rc == HookReturn.NEXT:
                task.chore_mask &= ~(1 << i)
                continue
            return rc
        return HookReturn.ERROR

    def complete_task(self, es: Optional[ExecutionStream], task: Task) -> None:
        """__parsec_complete_execution + release_deps analog
        (scheduling.c:441-470, parsec.c:1694-1921)."""
        task.status = TaskStatus.COMPLETE
        tp = task.taskpool
        tc = task.task_class
        if es is not None:
            es.stats["executed"] += 1
        self.pins.exec_end(es, task)
        self.pins.complete_exec_begin(es, task)
        self.pins.release_deps_begin(es, task)
        # local refs accumulate and release in ONE striped-lock batch
        # (parsec_release_dep_fct walks its ready-ring the same way)
        local_refs: List[SuccessorRef] = []
        for ref in tc.iterate_successors(task):
            if isinstance(ref, DataRef):
                ref.collection.write_tile(ref.key, ref.value)
                continue
            if ref.reshape_spec is not None or \
                    isinstance(ref.value, DataCopyFuture):
                # reshape promise: one shared conversion per layout
                # (parsec_local_reshape analog, runs on this thread)
                ref.value = resolve_reshape(ref.value, ref.reshape_spec)
                ref.reshape_spec = None
            local_refs.append(ref)
        ready = tp.activate_deps(local_refs) if local_refs else []
        if tc.on_complete is not None:
            tc.on_complete(task)
        if task.on_complete is not None:
            task.on_complete(task)
        if ready:
            if es is not None and es.next_task is None:
                # bypass-slot chaining: the completing task's best
                # successor never touches the queues — the worker loop
                # runs it next (scheduling.c:346-398)
                best = max(ready, key=lambda t: t.priority)
                ready.remove(best)
                es.next_task = best
            if ready:
                self.schedule(es, ready)
        self.pins.release_deps_end(es, task)
        self.pins.complete_exec_end(es, task)
        tp.addto_nb_tasks(-1)


def init(nb_cores: Optional[int] = None, scheduler: Optional[str] = None,
         device="cuda") -> Context:
    """parsec_init analog. ``device`` is ``"cuda"`` (the default; raises
    without a GPU) or ``"cpu"``."""
    return Context(nb_cores=nb_cores, scheduler=scheduler, device=device)


def fini(context: Context) -> None:
    """parsec_fini analog."""
    context.fini()
