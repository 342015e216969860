"""Wavefront planner and the stacked executor: a PTG DAG run as batched
waves on one device.

Port of the reference package's ``compiled/wavefront.py``. Per-task
dispatch of tile-sized work through the host runtime is dominated by
Python and launch overhead; the compiled execution of a task DAG is:

1. enumerate the task space (closed-form, from the PTG description);
2. level the DAG into *waves* (all tasks whose predecessors completed in
   earlier waves) — host-side topological leveling;
3. inside a wave, group tasks by task class and run each group as ONE
   batched call: gather the group's input tiles from a stacked
   device-resident store (one ``(ntiles, mb, nb)`` tensor per
   collection), run the batched body, scatter the outputs back.

Store-based execution is valid when every intermediate tile version has
its readers ordered (by wave level) before the next writer of that tile —
true for accumulate-chain dense LA DAGs (POTRF/GEMM/QR). ``plan_taskpool``
verifies this *hazard-freedom* while planning and rejects DAGs that need
value-passing (those run on the host runtime instead).

There is no XLA here: the executor runs eagerly on the device's stream.
It does not pad batches to powers of two (the reference does so to bound
XLA compilation; an eager run has nothing to compile).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.context import resolve_device
from ..core.task import DeviceType, FlowAccess, Task
from ..core.taskpool import DataRef
from ..dsl.ptg import PTGTaskClass, Taskpool as PTGTaskpool
from ..dsl.ptg import taskpool_uses_reshape
from ..data.matrix import torch_dtype
from ..utils.debug import debug_verbose


@dataclass
class WaveGroup:
    """All tasks of one class inside one wave (sub-grouped by reshape
    signature when dep ``[type=...]`` specs differ across instances)."""
    tc: PTGTaskClass
    level: int
    tasks: List[Tuple[int, ...]]
    # per non-CTL flow, (collection name, np.int64[B] tile-slot indices)
    in_slots: List[Tuple[str, np.ndarray]] = field(default_factory=list)
    out_slots: List[Tuple[str, np.ndarray]] = field(default_factory=list)
    # per in-flow composed ReshapeSpec (or None), shared by every task
    # in the group — applied to the gathered stack before the body
    in_specs: List[Optional[Any]] = field(default_factory=list)


@dataclass
class WavefrontPlan:
    taskpool: PTGTaskpool
    waves: List[List[WaveGroup]]
    collections: Dict[str, Any]              # name -> collection
    slot_maps: Dict[str, Dict[Tuple, int]]   # name -> (tile key -> slot)
    n_tasks: int = 0
    # True when some non-CTL flow carries task->task values with no tile
    # placement: only executors that keep values in carry state (the
    # panel-fused path) or the host runtime can run such plans
    has_value_flows: bool = False
    # dep [type=...] support: True when any dep declares a ReshapeSpec
    has_reshapes: bool = False
    # (collection name, slot) -> spec of the LAST terminal data write —
    # applied by write_back (the Out-side conversion of DataRef writes)
    terminal_specs: Dict[Tuple[str, int], Any] = field(default_factory=dict)

    @property
    def n_waves(self) -> int:
        return len(self.waves)


def _flow_tile(tc: PTGTaskClass, fname: str, locals) -> Tuple[Any, Tuple]:
    spec = tc.specs[fname]
    if spec.tile is None:
        raise ValueError(
            f"compiled mode requires FlowSpec.tile on {tc.name}.{fname}")
    dc, key = spec.tile(tc.tp.g, *locals)
    return dc, tuple(key)


def _is_value_flow(tc: PTGTaskClass, f) -> bool:
    """Non-CTL flow with no tile placement: a task->task value that never
    lives in a collection. Such flows still level the DAG but have no
    slots; the per-tile executors cannot feed them — wave fusers carry
    them in state, the host runtime passes them with activations."""
    return (not f.is_ctl) and tc.specs[f.name].tile is None


def _kahn_levels(n: int, succs: List[List[int]],
                 indeg: np.ndarray) -> np.ndarray:
    """Longest-path level of every task (Kahn's algorithm); raises on a
    cycle."""
    indeg = indeg.copy()
    level = np.zeros(n, dtype=np.int64)
    frontier = [i for i in range(n) if indeg[i] == 0]
    seen = len(frontier)
    while frontier:
        nxt = []
        for i in frontier:
            for j in succs[i]:
                level[j] = max(level[j], level[i] + 1)
                indeg[j] -= 1
                if indeg[j] == 0:
                    nxt.append(j)
                    seen += 1
        frontier = nxt
    if seen != n:
        raise RuntimeError("PTG DAG has a cycle")
    return level


def plan_taskpool(tp: PTGTaskpool) -> WavefrontPlan:
    """Enumerate, level, group and hazard-check a PTG taskpool.

    Dep ``[type=...]`` reshape specs (parsec_reshape.c analog) are
    static per-edge layout maps, so the planner resolves them up front:
    each consumer's composed (Out ∘ In) spec is recorded per group and
    applied to the gathered stack at execution; terminal DataRef specs
    are applied by write_back. Groups whose instances disagree on specs
    are split."""
    has_reshapes = taskpool_uses_reshape(tp)
    # ---- enumerate tasks and assign ids
    tasks: List[Tuple[PTGTaskClass, Tuple[int, ...]]] = []
    tid: Dict[Tuple[str, Tuple], int] = {}
    for tc in tp.task_classes:
        for p in tc.enumerate_space():
            tid[(tc.name, p)] = len(tasks)
            tasks.append((tc, p))
    n = len(tasks)

    # ---- build successor edges via the closed-form iterators
    succs: List[List[int]] = [[] for _ in range(n)]
    edges: List[Tuple[int, int, str]] = []   # (producer, consumer, flow)
    # (consumer tid, flow) -> composed producer∘consumer ReshapeSpec
    # (None recorded for spec-less edges so mixed spec/no-spec fan-ins
    # are detectable)
    edge_specs: Dict[Tuple[int, str], Any] = {}
    _NO_SPEC = object()
    indeg = np.zeros(n, dtype=np.int64)
    for i, (tc, p) in enumerate(tasks):
        dry = Task(tp, tc, p)
        for f in tc.flows:
            dry.data[f.name] = 0
            dry.output[f.name] = 0
        for ref in tc.iterate_successors(dry):
            if isinstance(ref, DataRef):
                continue
            j = tid[(ref.task_class.name, tuple(ref.locals))]
            succs[i].append(j)
            edges.append((i, j, ref.flow_name))
            # conflicting per-(consumer, flow) reshape specs would
            # silently apply one edge's spec to every gathered operand;
            # identity = (name, fn)
            prev = edge_specs.get((j, ref.flow_name), _NO_SPEC)
            new_id = ((ref.reshape_spec.name, ref.reshape_spec.fn)
                      if ref.reshape_spec is not None else None)
            if prev is not _NO_SPEC:
                prev_id = ((prev.name, prev.fn)
                           if prev is not None else None)
                if prev_id != new_id:
                    ctc, cp = tasks[j]
                    pn = prev.name if prev is not None else None
                    nn = (ref.reshape_spec.name
                          if ref.reshape_spec is not None else None)
                    what = (f"same name {pn!r} but different fn objects "
                            "(share ONE ReshapeSpec instance across "
                            "edges when the conversion is the same)"
                            if pn == nn else f"{pn!r} vs {nn!r}")
                    raise ValueError(
                        f"task {ctc.name}{cp} flow {ref.flow_name!r} "
                        f"receives conflicting reshape specs ({what}) "
                        "on different incoming edges; the compiled "
                        "executors apply one spec per gathered flow — "
                        "run this taskpool on the host runtime")
            edge_specs[(j, ref.flow_name)] = ref.reshape_spec
            indeg[j] += 1

    # ---- longest-path leveling
    level = _kahn_levels(n, succs, indeg)

    # ---- per-task input reshape specs (static, from the closed form)
    def _in_flows(tc: PTGTaskClass):
        return [f for f in tc.flows if not f.is_ctl
                and not _is_value_flow(tc, f)
                and (f.access & FlowAccess.READ)]

    def _task_in_specs(i: int, tc: PTGTaskClass, p) -> Tuple:
        if not has_reshapes:
            return ()
        specs = []
        for f in _in_flows(tc):
            spec = edge_specs.get((i, f.name))
            if spec is None:
                dep = tc._active_in(tp.g, tc.specs[f.name], p)
                if dep is not None and dep.src is None and \
                        dep.reshape is not None:
                    spec = dep.reshape
            specs.append(spec)
        return tuple(specs)

    task_specs: List[Tuple] = [
        _task_in_specs(i, tc, p) for i, (tc, p) in enumerate(tasks)]

    # ---- group into waves (split by reshape signature: one group =
    # one batched body call, so every instance must share its specs)
    n_waves = int(level.max()) + 1 if n else 0
    waves: List[List[WaveGroup]] = [[] for _ in range(n_waves)]
    groups: Dict[Tuple, WaveGroup] = {}
    for i, (tc, p) in enumerate(tasks):
        sig = tuple(s.key if s is not None else None
                    for s in task_specs[i])
        gkey = (int(level[i]), tc.name, sig)
        grp = groups.get(gkey)
        if grp is None:
            grp = WaveGroup(tc=tc, level=int(level[i]), tasks=[],
                            in_specs=list(task_specs[i]) or
                            [None] * len(_in_flows(tc)))
            groups[gkey] = grp
            waves[int(level[i])].append(grp)
        grp.tasks.append(p)

    # ---- collect collections + slot maps
    collections: Dict[str, Any] = {}
    slot_maps: Dict[str, Dict[Tuple, int]] = {}

    def _register(dc) -> str:
        if dc.name not in collections:
            collections[dc.name] = dc
            slot_maps[dc.name] = dc.tile_index()
        elif collections[dc.name] is not dc:
            raise ValueError(f"two collections share the name {dc.name!r}")
        return dc.name

    has_value_flows = any(
        _is_value_flow(tc, f)
        for tc in tp.task_classes for f in tc.flows)
    for wave in waves:
        for grp in wave:
            tc = grp.tc
            in_fl = _in_flows(tc)
            out_fl = [f for f in tc.flows if not f.is_ctl
                      and not _is_value_flow(tc, f)
                      and (f.access & FlowAccess.WRITE)]
            ins: Dict[str, List[int]] = {f.name: [] for f in in_fl}
            outs: Dict[str, List[int]] = {f.name: [] for f in out_fl}
            in_names: Dict[str, str] = {}
            out_names: Dict[str, str] = {}
            for p in grp.tasks:
                for f in in_fl:
                    dc, key = _flow_tile(tc, f.name, p)
                    name = _register(dc)
                    in_names[f.name] = name
                    ins[f.name].append(slot_maps[name][key])
                for f in out_fl:
                    dc, key = _flow_tile(tc, f.name, p)
                    name = _register(dc)
                    out_names[f.name] = name
                    outs[f.name].append(slot_maps[name][key])
            grp.in_slots = [(in_names[f.name],
                             np.asarray(ins[f.name], dtype=np.int64))
                            for f in in_fl]
            grp.out_slots = [(out_names[f.name],
                              np.asarray(outs[f.name], dtype=np.int64))
                             for f in out_fl]

    # ---- hazard checks for store-based execution
    # (a) a tile must not be written twice in one wave (lost update);
    # (b) for every dataflow edge P --tile T--> R, no OTHER task may write
    #     T in a wave w with level(P) < w < level(R): the store would hand
    #     R a newer version than the dataflow prescribes. Same-wave writes
    #     (w == level(R)) are safe — the wave gathers before it scatters.
    write_waves: Dict[Tuple[str, Tuple], List[int]] = {}
    for w, wave in enumerate(waves):
        for grp in wave:
            for p in grp.tasks:
                for f in grp.tc.flows:
                    if f.is_ctl or not (f.access & FlowAccess.WRITE) \
                            or _is_value_flow(grp.tc, f):
                        continue
                    dc, key = _flow_tile(grp.tc, f.name, p)
                    tk = (dc.name, key)
                    lst = write_waves.setdefault(tk, [])
                    if w in lst:
                        raise RuntimeError(
                            f"tile {tk} written twice in wave {w}: DAG "
                            f"under-constrained for store-based execution")
                    lst.append(w)
    for (i, j, fname) in edges:
        tc_j, p_j = tasks[j]
        f_j = tc_j.flow_by_name[fname]
        if f_j.is_ctl or _is_value_flow(tc_j, f_j):
            continue
        dc, key = _flow_tile(tc_j, fname, p_j)
        lw, lr = int(level[i]), int(level[j])
        for w in write_waves.get((dc.name, key), ()):
            if lw < w < lr:
                tc_i, p_i = tasks[i]
                raise RuntimeError(
                    f"WAR/versioning hazard on tile {(dc.name, key)}: "
                    f"{tc_i.name}{p_i}@wave{lw} feeds {tc_j.name}{p_j}@"
                    f"wave{lr} but the tile is rewritten in wave {w}; "
                    f"use the host runtime for this DAG")

    # ---- terminal DataRef reshape specs (Out-side [type=...]): applied
    # once by write_back, matching the host runtime's per-write
    # conversion for the FINAL value. A reshaped write that a LATER
    # data-sourced read would observe has no store representation (the
    # store keeps raw values) — refuse loudly.
    terminal_specs: Dict[Tuple[str, int], Any] = {}
    if has_reshapes:
        term_wave: Dict[Tuple[str, int], int] = {}
        reshaped_wmin: Dict[Tuple[str, int], int] = {}
        data_read_wave: Dict[Tuple[str, int], int] = {}
        g = tp.g
        for i, (tc, p) in enumerate(tasks):
            w = int(level[i])
            for spec_ in tc.spec_list:
                for dep in spec_.outs:
                    if dep.data is None or not dep.active(g, p):
                        continue
                    dc, key = dep.data(g, *p)
                    slot_key = (dc.name, slot_maps[dc.name][tuple(key)])
                    if dep.reshape is not None:
                        reshaped_wmin[slot_key] = min(
                            reshaped_wmin.get(slot_key, 1 << 30), w)
                        if term_wave.get(slot_key, -1) <= w:
                            terminal_specs[slot_key] = dep.reshape
                            term_wave[slot_key] = w
                    elif term_wave.get(slot_key, -1) <= w:
                        terminal_specs.pop(slot_key, None)
                        term_wave[slot_key] = w
                dep = tc._active_in(g, spec_, p)
                if dep is not None and dep.data is not None and \
                        spec_.tile is not None:
                    dc, key = dep.data(g, *p)
                    slot_key = (dc.name, slot_maps[dc.name][tuple(key)])
                    data_read_wave[slot_key] = max(
                        data_read_wave.get(slot_key, -1), w)
        for slot_key, w_r in reshaped_wmin.items():
            if data_read_wave.get(slot_key, -1) > w_r:
                raise NotImplementedError(
                    f"tile {slot_key} is written with an Out-side "
                    f"reshape and read back from the collection in a "
                    f"later wave; store-based execution keeps raw "
                    f"values — run this taskpool on the host runtime")

    plan = WavefrontPlan(taskpool=tp, waves=waves, collections=collections,
                         slot_maps=slot_maps, n_tasks=n,
                         has_value_flows=has_value_flows,
                         has_reshapes=has_reshapes,
                         terminal_specs=terminal_specs)
    debug_verbose(3, "wavefront", "planned %s: %d tasks, %d waves",
                  tp.name, n, len(waves))
    return plan


def check_run(taskpool) -> None:
    """End-of-run check of a taskpool's device-side status: a taskpool
    may define ``check_results()`` (POTRF reads its collected Cholesky
    ``info`` there, the run's one host synchronisation)."""
    check = getattr(taskpool, "check_results", None)
    if check is not None:
        check()


class WavefrontExecutor:
    """Executes a :class:`WavefrontPlan` over stacked tile stores.

    - :meth:`run_arrays` — ``{name: (ntiles, mb, nb) store}`` → the same
      stores, updated in place wave by wave (the analog of the
      reference's functional scatter under buffer donation);
    - :meth:`run` — host-driven wrapper: collections → stacked stores on
      ``device`` → ``run_arrays`` → write back.

    A group's batched body is the chore's ``batch_hook`` where its
    shared-flow assumption holds, the unbatched body for a group of one
    task, and ``torch.func.vmap`` over the tile body otherwise.
    """

    def __init__(self, plan: WavefrontPlan, device="cuda"):
        if getattr(plan.taskpool, "requires_fuser", False):
            raise ValueError(
                f"taskpool {plan.taskpool.name!r} has bodies that read "
                "the collection directly (CTL-gather pattern); per-tile "
                "compiled execution cannot feed them — use the "
                "PanelExecutor (compiled.panels) or the host runtime")
        if plan.has_value_flows:
            raise ValueError(
                f"taskpool {plan.taskpool.name!r} carries task->task "
                "values with no tile placement; per-tile compiled "
                "execution cannot route them — use the PanelExecutor "
                "(wave fusers keep values in carry state) or the host "
                "runtime")
        self.plan = plan
        self.device = resolve_device(device)
        self._vmapped: Dict[Any, Callable] = {}

    # -- body lookup ------------------------------------------------------
    @staticmethod
    def _chore(tc: PTGTaskClass):
        """The class's CUDA incarnation, else its CPU one."""
        return tc.chore_for(DeviceType.CUDA) or tc.chore_for(DeviceType.CPU)

    def _raw_body(self, tc: PTGTaskClass) -> Callable:
        """The host body adapted to the executor's calling convention:
        the executor gathers only READ flows, while host bodies take
        every non-CTL flow in declaration order (WRITE-only flows are
        placeholder arguments) — rebuild the full argument list with
        None in the WRITE-only slots."""
        chore = self._chore(tc)
        if chore is None:
            raise ValueError(f"no body for {tc.name}")
        body = chore.hook
        nonctl = [f for f in tc.flows if not f.is_ctl]
        if all(f.access & FlowAccess.READ for f in nonctl):
            return body
        reads = [bool(f.access & FlowAccess.READ) for f in nonctl]

        def adapted(task, *read_vals, _b=body, _reads=tuple(reads)):
            it = iter(read_vals)
            args = [next(it) if r else None for r in _reads]
            return _b(task, *args)

        return adapted

    def _hook_applies(self, chore, grp: WaveGroup) -> bool:
        """A batch_hook may assume flows named in ``batch_hook_shared``
        hold ONE tile across the whole group (e.g. the shared triangular
        factor of a TRSM wave). Verify that from the planner's slot
        indices, once per group, and fall back to vmap when the grouping
        breaks the assumption."""
        if chore is None or chore.batch_hook is None:
            return False
        shared = chore.batch_hook_shared or ()
        if not shared:
            return True
        in_fl = [f for f in grp.tc.flows
                 if not f.is_ctl and (f.access & FlowAccess.READ)]
        by_name = {f.name: slots for f, (_n, slots) in
                   zip(in_fl, grp.in_slots)}
        return all(len(np.unique(by_name[name])) == 1
                   for name in shared if name in by_name)

    def _body(self, grp: WaveGroup) -> Callable:
        """Batched body of one group: the chore's ``batch_hook`` (guarded
        by its shared-flow assumption), then the unbatched body for a
        single task, then ``torch.func.vmap`` over the tile body."""
        tc = grp.tc
        chore = self._chore(tc)
        if self._hook_applies(chore, grp):
            return chore.batch_hook
        single = len(grp.tasks) == 1
        fn = self._vmapped.get((tc.name, single))
        if fn is None:
            body = self._raw_body(tc)
            if single:
                def fn(*tiles, _b=body, _tc=tc):
                    outs = self._normalize_outs(
                        _tc, _b(None, *(t[0] for t in tiles)))
                    return tuple(o[None] for o in outs)
            else:
                fn = torch.func.vmap(lambda *tiles, _b=body: _b(None, *tiles))
            self._vmapped[(tc.name, single)] = fn
        return fn

    @staticmethod
    def _normalize_outs(tc: PTGTaskClass, outs) -> tuple:
        """Body returns → tuple ordered by WRITE-flow declaration order.
        Bodies may return a dict keyed by flow name (the host runtime
        convention), a tuple/list, or a single value."""
        out_fl = [f for f in tc.flows
                  if not f.is_ctl and (f.access & FlowAccess.WRITE)]
        if isinstance(outs, dict):
            missing = [f.name for f in out_fl if f.name not in outs]
            if missing:
                raise ValueError(
                    f"{tc.name}: body dict missing outputs {missing}")
            return tuple(outs[f.name] for f in out_fl)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(out_fl):
            raise ValueError(
                f"{tc.name}: body returned {len(outs)} outputs "
                f"for {len(out_fl)} write flows")
        return tuple(outs)

    @staticmethod
    def _apply_in_specs(grp: WaveGroup, inputs: List[Any]) -> List[Any]:
        """Apply the group's composed dep [type=...] specs to the
        gathered stacks (ReshapeSpec.fn must be batch-safe)."""
        if not any(s is not None for s in grp.in_specs):
            return inputs
        return [s.apply(x) if s is not None else x
                for s, x in zip(grp.in_specs, inputs)]

    # -- store-passing execution ------------------------------------------
    def run_arrays(self, stores: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """stores: name → ``(ntiles, mb, nb)`` tensor, updated in place.
        Each wave gathers every group's inputs (index selection copies
        them, so the wave reads a snapshot) before it scatters."""
        idx_cache: Dict[int, torch.Tensor] = {}

        def index(slots: np.ndarray) -> torch.Tensor:
            t = idx_cache.get(id(slots))
            if t is None:
                t = torch.as_tensor(slots).to(self.device)
                idx_cache[id(slots)] = t
            return t

        for wave in self.plan.waves:
            updates: List[Tuple[str, torch.Tensor, Any]] = []
            for grp in wave:
                inputs = [stores[name].index_select(0, index(slots))
                          for (name, slots) in grp.in_slots]
                inputs = self._apply_in_specs(grp, inputs)
                outs = self._normalize_outs(grp.tc,
                                            self._body(grp)(*inputs))
                for (name, slots), val in zip(grp.out_slots, outs):
                    updates.append((name, index(slots), val))
            for name, sidx, val in updates:
                stores[name].index_copy_(0, sidx,
                                         val.to(stores[name].dtype))
        check_run(self.plan.taskpool)
        return stores

    # -- host-driven run --------------------------------------------------
    def make_stores(self) -> Dict[str, torch.Tensor]:
        stores = {}
        for name, dc in self.plan.collections.items():
            if dc.scratch:
                n = len(self.plan.slot_maps[name])
                stores[name] = torch.zeros(
                    (n, dc.mb, dc.nb), device=self.device,
                    dtype=torch_dtype(dc.dtype))
                continue
            stores[name], _ = dc.to_stacked(self.device)
        return stores

    def write_back(self, stores: Dict[str, torch.Tensor]) -> None:
        tspecs = self.plan.terminal_specs
        for name, dc in self.plan.collections.items():
            if dc.scratch:
                continue
            for key, slot in self.plan.slot_maps[name].items():
                v = stores[name][slot]
                spec = tspecs.get((name, slot))
                dc.write_tile(key, spec.apply(v) if spec is not None else v)

    def run(self) -> float:
        """Collections → stores → run → write back; returns the seconds
        from staging to the end of the run (synchronised)."""
        t0 = time.perf_counter()
        stores = self.run_arrays(self.make_stores())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.write_back(stores)
        return dt
