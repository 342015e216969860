"""Panel-fused executor: wavefront plans over a dense transposed matrix.

Port of the reference package's ``compiled/panels.py`` (the whole-DAG
form). The stacked executor (wavefront.py) runs each wave-group as a
gather → batched body → scatter; for dense one-matrix DAGs (POTRF-like)
the data movement and the per-group calls dominate. This executor is the
next fusion level, the wave-granular analog of the chore ``batch_hook``:
the *taskpool* registers a ``wave_fuser`` that lowers an ENTIRE wave's
groups to a few dense-slice operations against the matrix stored as ONE
``(N, M)`` tensor on the device holding **Aᵀ** (row panel j of the store
= block-column j of A). In that layout every panel write is a row panel
(contiguous rows of leading dimension M), and panel reads are strided
views that cuBLAS and cuSOLVER take as they are (a row-major view with
leading dimension M is a transposed column-major matrix): no panel is
copied to make it contiguous.

Slot bookkeeping comes from the SAME :class:`~.wavefront.WavefrontPlan` —
planning, leveling, and hazard verification are unchanged; only the data
substrate changes. ``write_back`` honors the DAG's write-set: tiles no
task writes are never copied back.

A wave_fuser has signature::

    fuser(wave: List[WaveGroup], geom: Dict[str, PanelGeometry])
        -> Callable[[dict], dict] | None

taking and returning the executor state — a dict with one transposed
dense tensor per collection, keyed by collection name (``geom.name``).
Fusers may stash extra carry entries (underscore-prefixed, e.g. a
factored diagonal consumed by the next wave). The wave functions update
the collection tensors IN PLACE: the analog of the reference's
``donate_argnums=0``, which lets XLA update the donated state in place.
Return None to reject a wave (the executor then refuses, naming it — no
silent fallback).

There is no XLA here: :meth:`PanelExecutor.run_state` runs the wave
functions eagerly on the device's current stream. It issues no host
synchronisation between waves; the one synchronisation of a run is the
taskpool's end-of-run check (``check_results``: POTRF's collected
Cholesky ``info``). Capturing the whole DAG as one CUDA graph (the
reference's whole-DAG ``jit``) and the segmented, bucketed path are
later work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Set, Tuple

import torch

from ..core.context import resolve_device
from ..data.matrix import torch_dtype
from ..utils.debug import debug_verbose
from .wavefront import WavefrontPlan, check_run


@dataclass(frozen=True)
class PanelGeometry:
    """Transposed-dense layout geometry handed to wave fusers: the state
    tensor ``state[name]`` is ``(nb*nt, mb*mt)`` holding the collection
    transposed — tile (i, j) lives at ``D[cols(j), rows(i)]``
    transposed."""
    name: str
    mb: int
    nb: int
    mt: int
    nt: int

    def rows(self, i: int) -> slice:
        """Column range of D covering block-row i of A."""
        return slice(i * self.mb, (i + 1) * self.mb)

    def cols(self, j: int) -> slice:
        """Row range of D covering block-column j of A."""
        return slice(j * self.nb, (j + 1) * self.nb)


def bucket_tiles(t: int, cap: int) -> int:
    """Round a tile count up to the bucket lattice of the segmented panel
    path, capped at ``cap``: exact for t ≤ 16, then multiples of
    2^(⌊log₂t⌋−3) — padding ≤ 12.5% per dimension, O(16·log NT)
    distinct buckets, lattice points independent of N."""
    if t >= cap:
        return cap
    q = 1 << max(0, t.bit_length() - 1 - 3)
    return min(((t + q - 1) // q) * q, cap)


class PanelExecutor:
    """Execute a :class:`WavefrontPlan` over transposed dense storage on
    ``device`` (``cuda`` by default; raises without a GPU).

    Requirements (checked): the taskpool registered ``wave_fuser`` and
    every collection is a tiled matrix. :meth:`run_state` is
    ``state -> state`` (state = ``{collection name: transposed dense
    tensor}``), updating the tensors in place.
    """

    def __init__(self, plan: WavefrontPlan, device="cuda"):
        self.plan = plan
        self.device = resolve_device(device)
        fuser = getattr(plan.taskpool, "wave_fuser", None)
        if fuser is None:
            raise ValueError(
                f"taskpool {plan.taskpool.name!r} registers no wave_fuser; "
                "use the stacked WavefrontExecutor instead")
        if plan.has_reshapes:
            raise ValueError(
                f"taskpool {plan.taskpool.name!r} declares dep "
                "[type=...] reshape specs; wave fusers lower raw panel "
                "slices — use the stacked executor (which applies specs "
                "at gather) or the host runtime")
        self.geoms = {
            name: PanelGeometry(name=name, mb=dc.mb, nb=dc.nb,
                                mt=dc.mt, nt=dc.nt)
            for name, dc in plan.collections.items()}
        # lower every wave up front — planning errors surface at build
        # time, not mid-run
        self._wave_fns: List[Callable] = []
        for w, wave in enumerate(plan.waves):
            fn = fuser(wave, self.geoms)
            if fn is None:
                names = [(g.tc.name, len(g.tasks)) for g in wave]
                raise ValueError(
                    f"wave {w} not fusable by {plan.taskpool.name!r}: "
                    f"{names}")
            self._wave_fns.append(fn)
        # DAG write-set per collection: (i, j) block coords any task writes
        self._written: Dict[str, Set[Tuple[int, int]]] = {
            name: set() for name in self.geoms}
        invmaps = {name: {s: k for k, s in plan.slot_maps[name].items()}
                   for name in self.geoms}
        for wave in plan.waves:
            for grp in wave:
                for (name, slots) in grp.out_slots:
                    for s in slots:
                        self._written[name].add(
                            tuple(invmaps[name][int(s)]))
        debug_verbose(3, "panels", "lowered %s: %d waves onto %d "
                      "transposed dense tensors", plan.taskpool.name,
                      len(self._wave_fns), len(self.geoms))

    def state_shapes(self) -> Dict[str, Tuple[Tuple[int, int], Any]]:
        """``{name: (shape, torch dtype)}`` of the state
        :meth:`make_state` builds."""
        return {name: ((g.nb * g.nt, g.mb * g.mt),
                       torch_dtype(self.plan.collections[name].dtype))
                for name, g in self.geoms.items()}

    # -- dense execution --------------------------------------------------
    def run_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Run every wave on ``state`` (its tensors updated in place) and
        return the collection tensors. Ends with the taskpool's
        end-of-run check, the run's one host synchronisation."""
        state = dict(state)
        for fn in self._wave_fns:
            state = fn(state)
        check_run(self.plan.taskpool)
        # fuser carries (factored diagonals etc.) are wave-transient —
        # only the collection tensors survive
        return {name: state[name] for name in self.geoms}

    # -- host-driven convenience -----------------------------------------
    def make_state(self) -> Dict[str, torch.Tensor]:
        """Collection tiles → transposed dense state on the device, one
        tensor per collection."""
        state = {}
        for name, g in self.geoms.items():
            dc = self.plan.collections[name]
            shape, dtype = self.state_shapes()[name]
            D = torch.empty(shape, dtype=dtype, device=self.device)
            for i in range(g.mt):
                for j in range(g.nt):
                    D[g.cols(j), g.rows(i)] = torch.as_tensor(
                        dc.data_of((i, j))).to(self.device).mT
            state[name] = D
        return state

    def write_back(self, state: Dict[str, torch.Tensor]) -> None:
        """Write ONLY the DAG's write-set back to the collections, as
        tensors on the device — substrate scribbles outside it stay
        invisible at the collection level."""
        for name, g in self.geoms.items():
            dc = self.plan.collections[name]
            D = state[name]
            for (i, j) in sorted(self._written[name]):
                dc.write_tile((i, j), D[g.cols(j), g.rows(i)].mT.clone())

    def run(self) -> float:
        """Collections → state → run → write back; returns the seconds
        from staging to the end of the run (synchronised)."""
        t0 = time.perf_counter()
        out = self.run_state(self.make_state())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.write_back(out)
        return dt
