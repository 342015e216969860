"""Tiled Cholesky factorization (lower) as PTG taskpools.

Port of the reference package's ``algorithms/potrf.py`` — the DPLASMA
dpotrf_L equivalent and the repo's flagship. Task classes and dataflow
mirror the classic dpotrf JDF:

    POTRF(k):  T = chol(A[k,k] after k SYRK updates)
    TRSM(m,k): C = A[m,k] · T^{-T}
    SYRK(m,k): diag update A[m,m] -= C·Cᵀ            (k-th update)
    GEMM(m,n,k): A[m,n] -= A[m,k]·A[n,k]ᵀ            (k-th update)

Every flow carries its logical tile (FlowSpec.tile), so
:func:`build_potrf` runs on the host runtime AND on the compiled
executors; :func:`build_potrf_left` runs on the host runtime and on the
:class:`~..compiled.panels.PanelExecutor` (the flagship path).

Tile bodies are the torch tile kernels of :mod:`..ops.tile_kernels`
(cuBLAS and cuSOLVER on a CUDA tensor). Each taskpool collects the
``info`` of every tile Cholesky in ``tp.chol_infos`` and checks it once
at the end of a run (``tp.check_results``): the compiled executors call
it when their run ends, and on the host runtime it runs when the
taskpool terminates and turns a failure into the taskpool's error, which
``Context.wait`` raises.
"""

from __future__ import annotations

import torch

from ..data.matrix import TiledMatrix
from ..dsl import ptg
from ..ops.precision import apply_matmul_precision
from ..ops.tile_kernels import (gemm_tile, potrf_tile, potrf_tile_blocked,
                                raise_on_failed_cholesky, syrk_tile,
                                tri_inv_tile, trsm_tile, trsm_tiles_gemm,
                                trsm_tiles_wide)
from ..utils import mca_param

# The compiled path's batched kernels. "solve" (default) is the exact
# wide triangular solve — reference numerics (dplasma TRSM). "gemm"
# inverts the shared diagonal factor once per wave and runs every solve
# as a matmul (MAGMA-style) at the cost of squaring the factor's
# condition-number contribution — fine for the well-conditioned
# dense-LA regime DPLASMA targets. Default "solve": a library default
# must not silently diverge from reference numerics.
mca_param.register("potrf.trsm_hook", "solve",
                   help="compiled-path TRSM wave kernel: solve (exact, "
                        "reference numerics) | gemm (inverted-triangle "
                        "multiply, squares the condition-number "
                        "contribution)",
                   choices=("solve", "gemm"))
mca_param.register("potrf.blocked_tile_chol", 1,
                   help="use the matmul-rich blocked in-tile Cholesky in "
                        "the compiled path (0 = one cuSOLVER potrf)")


def _check_grid(A: TiledMatrix) -> None:
    if A.mt != A.nt:
        raise ValueError("POTRF needs a square tile grid")
    if A.mb != A.nb:
        # the wave fusers index the transposed store with nb-granular
        # row panels and mb-granular columns interchangeably — non-
        # square tiles would silently produce wrong slices
        raise ValueError("POTRF needs square tiles (mb == nb)")


def _attach_info_check(tp: ptg.Taskpool) -> None:
    """Give ``tp`` its Cholesky ``info`` list and its end-of-run check.
    On the host runtime the check runs when the taskpool terminates and
    records a failure as the taskpool's error (``Context.wait`` raises
    it)."""
    tp.chol_infos = []

    def check_results():
        raise_on_failed_cholesky(tp.chol_infos)

    def on_complete(pool):
        try:
            check_results()
        except torch.linalg.LinAlgError as exc:
            if pool.error is None:
                pool.error = exc

    tp.check_results = check_results
    tp.on_complete = on_complete


def build_potrf(A: TiledMatrix) -> ptg.Taskpool:
    """Build the right-looking POTRF taskpool over tiled matrix ``A``
    (lower)."""
    _check_grid(A)
    tp = ptg.Taskpool("potrf", A=A, NT=A.nt)
    _attach_info_check(tp)

    POTRF = tp.task_class(
        "POTRF", params=("k",),
        space=lambda g: ((k,) for k in range(g.NT)),
        affinity=lambda g, k: (g.A, (k, k)),
        priority=lambda g, k: 3 * (g.NT - k) ** 2,
        flows=[ptg.FlowSpec(
            "T", ptg.RW,
            tile=lambda g, k: (g.A, (k, k)),
            ins=[ptg.In(data=lambda g, k: (g.A, (k, k)),
                        guard=lambda g, k: k == 0),
                 ptg.In(src=("SYRK", lambda g, k: (k, k - 1), "C"),
                        guard=lambda g, k: k > 0)],
            outs=[ptg.Out(dst=("TRSM",
                               lambda g, k: [(m, k) for m in range(k + 1, g.NT)],
                               "L")),
                  ptg.Out(data=lambda g, k: (g.A, (k, k)))])])

    TRSM = tp.task_class(
        "TRSM", params=("m", "k"),
        space=lambda g: ((m, k) for k in range(g.NT)
                         for m in range(k + 1, g.NT)),
        affinity=lambda g, m, k: (g.A, (m, k)),
        priority=lambda g, m, k: 2 * (g.NT - k) ** 2 - m,
        flows=[
            ptg.FlowSpec(
                "L", ptg.READ,
                tile=lambda g, m, k: (g.A, (k, k)),
                ins=[ptg.In(src=("POTRF", lambda g, m, k: (k,), "T"))]),
            ptg.FlowSpec(
                "C", ptg.RW,
                tile=lambda g, m, k: (g.A, (m, k)),
                ins=[ptg.In(data=lambda g, m, k: (g.A, (m, k)),
                            guard=lambda g, m, k: k == 0),
                     ptg.In(src=("GEMM", lambda g, m, k: (m, k, k - 1), "C"),
                            guard=lambda g, m, k: k > 0)],
                outs=[
                    ptg.Out(dst=("SYRK", lambda g, m, k: (m, k), "A")),
                    # row operand of the GEMMs updating row m
                    ptg.Out(dst=("GEMM",
                                 lambda g, m, k: [(m, n, k)
                                                  for n in range(k + 1, m)],
                                 "A")),
                    # transposed operand of the GEMMs updating column m
                    ptg.Out(dst=("GEMM",
                                 lambda g, m, k: [(i, m, k)
                                                  for i in range(m + 1, g.NT)],
                                 "B")),
                    ptg.Out(data=lambda g, m, k: (g.A, (m, k)))])])

    SYRK = tp.task_class(
        "SYRK", params=("m", "k"),
        space=lambda g: ((m, k) for m in range(1, g.NT)
                         for k in range(m)),
        affinity=lambda g, m, k: (g.A, (m, m)),
        priority=lambda g, m, k: 2 * (g.NT - k) ** 2 - m,
        flows=[
            ptg.FlowSpec(
                "A", ptg.READ,
                tile=lambda g, m, k: (g.A, (m, k)),
                ins=[ptg.In(src=("TRSM", lambda g, m, k: (m, k), "C"))]),
            ptg.FlowSpec(
                "C", ptg.RW,
                tile=lambda g, m, k: (g.A, (m, m)),
                ins=[ptg.In(data=lambda g, m, k: (g.A, (m, m)),
                            guard=lambda g, m, k: k == 0),
                     ptg.In(src=("SYRK", lambda g, m, k: (m, k - 1), "C"),
                            guard=lambda g, m, k: k > 0)],
                outs=[ptg.Out(dst=("SYRK", lambda g, m, k: (m, k + 1), "C"),
                              guard=lambda g, m, k: k < m - 1),
                      ptg.Out(dst=("POTRF", lambda g, m, k: (m,), "T"),
                              guard=lambda g, m, k: k == m - 1)])])

    GEMM = tp.task_class(
        "GEMM", params=("m", "n", "k"),
        space=lambda g: ((m, n, k) for m in range(2, g.NT)
                         for n in range(1, m) for k in range(n)),
        affinity=lambda g, m, n, k: (g.A, (m, n)),
        priority=lambda g, m, n, k: (g.NT - k) ** 2 - m - n,
        flows=[
            ptg.FlowSpec(
                "A", ptg.READ,
                tile=lambda g, m, n, k: (g.A, (m, k)),
                ins=[ptg.In(src=("TRSM", lambda g, m, n, k: (m, k), "C"))]),
            ptg.FlowSpec(
                "B", ptg.READ,
                tile=lambda g, m, n, k: (g.A, (n, k)),
                ins=[ptg.In(src=("TRSM", lambda g, m, n, k: (n, k), "C"))]),
            ptg.FlowSpec(
                "C", ptg.RW,
                tile=lambda g, m, n, k: (g.A, (m, n)),
                ins=[ptg.In(data=lambda g, m, n, k: (g.A, (m, n)),
                            guard=lambda g, m, n, k: k == 0),
                     ptg.In(src=("GEMM",
                                 lambda g, m, n, k: (m, n, k - 1), "C"),
                            guard=lambda g, m, n, k: k > 0)],
                outs=[ptg.Out(dst=("GEMM",
                                   lambda g, m, n, k: (m, n, k + 1), "C"),
                              guard=lambda g, m, n, k: k < n - 1),
                      ptg.Out(dst=("TRSM", lambda g, m, n, k: (m, n), "C"),
                              guard=lambda g, m, n, k: k == n - 1)])])

    # compiled-path batched forms: the stacked executor calls these on a
    # whole wave-group's stacked tiles (the tile kernels take a leading
    # batch dimension)
    def _potrf_hook(Ts):
        if mca_param.get("potrf.blocked_tile_chol", 1):
            return potrf_tile_blocked(Ts, infos=tp.chol_infos)
        return potrf_tile(Ts, infos=tp.chol_infos)

    @POTRF.body(batch_hook=_potrf_hook)
    def potrf_body(task, T):
        return potrf_tile(T, infos=tp.chol_infos)

    def _trsm_hook(Ls, Cs):
        if mca_param.get("potrf.trsm_hook", "solve") == "gemm":
            return trsm_tiles_gemm(Ls[0], Cs)
        return trsm_tiles_wide(Ls[0], Cs)

    # every TRSM(m, k) of one wave shares the same factor L = POTRF(k),
    # so the whole group is one inversion + wide matmul (or one wide-RHS
    # solve; the executor verifies the shared-L grouping per wave)
    @TRSM.body(batch_hook=_trsm_hook, batch_hook_shared=("L",))
    def trsm_body(task, L, C):
        return trsm_tile(C, L)

    @SYRK.body
    def syrk_body(task, A_, C):
        return syrk_tile(C, A_, alpha=-1.0, beta=1.0)

    @GEMM.body
    def gemm_body(task, A_, B_, C):
        return gemm_tile(C, A_, B_, alpha=-1.0, beta=1.0, tb=True)

    tp.wave_fuser = _potrf_wave_fuser
    return tp


def _fuser_helpers(wave):
    """What every POTRF wave function needs: the taskpool's Cholesky
    ``info`` list and the in-tile Cholesky the knob selects."""
    infos = wave[0].tc.tp.chol_infos
    blocked = bool(mca_param.get("potrf.blocked_tile_chol", 1))

    def tile_chol(blk):
        if blocked:
            return potrf_tile_blocked(blk, infos=infos)
        return potrf_tile(blk, infos=infos)

    return tile_chol


def _potrf_wave_fuser(wave, geoms):
    """Lower one right-looking POTRF wave to Aᵀ-dense ops
    (compiled.panels contract).

    ASAP leveling makes every wave one of three shapes per step k —
    [POTRF(k)], [TRSM(·,k)], [SYRK(·,k) (+GEMM(·,·,k))]. In the
    transposed store, block-column panels of A are row panels, so the
    TRSM panel solve and every trailing strip are row-panel reads and
    in-place writes. The shapes are verified from the actual task lists
    (never wave-index arithmetic); unrecognized waves return None.
    """
    (geom,) = geoms.values()      # single-collection DAG
    tile_chol = _fuser_helpers(wave)
    names = sorted(g.tc.name for g in wave)
    mb = geom.mb

    if names == ["POTRF"]:
        (grp,) = wave
        if len(grp.tasks) != 1:
            return None
        (k,) = grp.tasks[0]

        def do_potrf(st, k=k):
            D = st[geom.name]
            r, c = geom.rows(k), geom.cols(k)
            # diag tile of Aᵀ = (A[k,k])ᵀ, symmetric → chol directly;
            # store Lᵀ (upper) back
            D[c, r] = tile_chol(D[c, r]).mT
            return st

        return do_potrf

    if names == ["TRSM"]:
        (grp,) = wave
        ks = {t[1] for t in grp.tasks}
        if len(ks) != 1:
            return None
        k = ks.pop()
        ms = sorted(t[0] for t in grp.tasks)
        if ms != list(range(ms[0], ms[0] + len(ms))):
            return None        # rows must be one contiguous panel

        solve_mode = mca_param.get("potrf.trsm_hook", "solve") == "solve"

        def do_trsm(st, k=k, lo=ms[0], hi=ms[-1] + 1):
            apply_matmul_precision()
            D = st[geom.name]
            c = geom.cols(k)
            # Lᵀ[k,k] stored upper → recover L
            L = D[c, geom.rows(k)].mT
            rest = D[c, lo * mb:hi * mb]
            # C ← C·L⁻ᵀ transposed: Cᵀ ← L⁻¹·Cᵀ, one row panel
            if solve_mode:        # exact wide solve, no inversion
                solved = torch.linalg.solve_triangular(L, rest, upper=False)
            else:                 # invert once per wave, solve as matmul
                solved = torch.matmul(tri_inv_tile(L), rest)
            rest.copy_(solved)
            return st

        return do_trsm

    if names in (["SYRK"], ["GEMM", "SYRK"]):
        syrk = next(g for g in wave if g.tc.name == "SYRK")
        ks = {t[1] for t in syrk.tasks}
        gemm = next((g for g in wave if g.tc.name == "GEMM"), None)
        if gemm is not None:
            ks |= {t[2] for t in gemm.tasks}
        if len(ks) != 1:
            return None
        k = ks.pop()
        rows = sorted(t[0] for t in syrk.tasks)
        lo, hi = rows[0], rows[-1] + 1
        if rows != list(range(lo, hi)):
            return None
        want = {(m, n) for m in range(lo, hi) for n in range(lo, m)}
        have = {(m, n) for (m, n, _k) in (gemm.tasks if gemm else [])}
        if want != have:
            return None        # trailing block-triangle must be complete

        def do_trailing(st, k=k, lo=lo, hi=hi):
            # strip j updates A[j.., j] — in Aᵀ: row panel j, trailing
            # columns; SYRK (diag tile) + GEMM (below) together, never
            # touching strictly-upper tiles. Pt's rows (block-column k)
            # are not among those written.
            apply_matmul_precision()
            D = st[geom.name]
            Pt = D[geom.cols(k), lo * mb:hi * mb]     # (nb, R) = panelᵀ
            for j in range(lo, hi):
                pj = Pt[:, (j - lo) * mb:(j - lo + 1) * mb]
                D[geom.cols(j), j * mb:hi * mb].addmm_(
                    pj.mT, Pt[:, (j - lo) * mb:], alpha=-1.0)
            return st

        return do_trailing

    return None


def potrf_flops(n: int) -> float:
    """Useful FLOPs of an n×n Cholesky (LAPACK count)."""
    return n ** 3 / 3.0 + n ** 2 / 2.0 + n / 6.0


def build_potrf_left(A: TiledMatrix) -> ptg.Taskpool:
    """Left-looking tiled Cholesky (LAPACK-style blocked ``potrf``).

    The right-looking :func:`build_potrf` spreads a tile's updates over
    k-indexed SYRK/GEMM chains; this variant concentrates them: each
    tile receives ALL its k<j contributions in a single ``UPDATE`` task
    that CTL-gathers its producer TRSMs (the reference's CTL-gather
    fan-in, tests/dsl/ptg/controlgather/ctlgat.jdf) and reads their
    written-back tiles from the collection inside the body — the same
    direct-memory pattern reference JDF bodies use for gathered
    operands. ASAP leveling then yields exactly three waves per step k
    ([UPDATE(·,k)], [POTRF(k)], [TRSM(·,k)]), and the panel fuser turns
    each UPDATE wave into ONE dense matmul over all previously factored
    panels.

    One process holds every tile: the remote reads of a distributed
    UPDATE (the comm engine's one-sided fetch) are not ported, and the
    body refuses a context with more than one rank.
    """
    _check_grid(A)
    tp = ptg.Taskpool("potrf_left", A=A, NT=A.nt)
    _attach_info_check(tp)

    def _gathered(g, m, k):
        """Producer TRSMs whose tiles UPDATE(m, k) reads: row m and
        row k, all columns j < k."""
        seen = []
        for row in (m, k):
            for j in range(k):
                if (row, j) not in seen:
                    seen.append((row, j))
        return seen

    UPDATE = tp.task_class(
        "UPDATE", params=("m", "k"),
        space=lambda g: ((m, k) for k in range(1, g.NT)
                         for m in range(k, g.NT)),
        affinity=lambda g, m, k: (g.A, (m, k)),
        priority=lambda g, m, k: 2 * (g.NT - k) ** 2 - m + 1,
        flows=[
            ptg.FlowSpec(
                "G", ptg.CTL,
                ins=[ptg.In(src=("TRSM", _gathered, "G"), gather=True)]),
            ptg.FlowSpec(
                "C", ptg.RW,
                tile=lambda g, m, k: (g.A, (m, k)),
                ins=[ptg.In(data=lambda g, m, k: (g.A, (m, k)))],
                outs=[ptg.Out(dst=("POTRF", lambda g, m, k: (k,), "T"),
                              guard=lambda g, m, k: m == k),
                      ptg.Out(dst=("TRSM", lambda g, m, k: (m, k), "C"),
                              guard=lambda g, m, k: m > k)])])

    POTRF = tp.task_class(
        "POTRF", params=("k",),
        space=lambda g: ((k,) for k in range(g.NT)),
        affinity=lambda g, k: (g.A, (k, k)),
        priority=lambda g, k: 3 * (g.NT - k) ** 2,
        flows=[ptg.FlowSpec(
            "T", ptg.RW,
            tile=lambda g, k: (g.A, (k, k)),
            ins=[ptg.In(data=lambda g, k: (g.A, (k, k)),
                        guard=lambda g, k: k == 0),
                 ptg.In(src=("UPDATE", lambda g, k: (k, k), "C"),
                        guard=lambda g, k: k > 0)],
            outs=[ptg.Out(dst=("TRSM",
                               lambda g, k: [(m, k)
                                             for m in range(k + 1, g.NT)],
                               "L")),
                  ptg.Out(data=lambda g, k: (g.A, (k, k)))])])

    TRSM = tp.task_class(
        "TRSM", params=("m", "k"),
        space=lambda g: ((m, k) for k in range(g.NT)
                         for m in range(k + 1, g.NT)),
        affinity=lambda g, m, k: (g.A, (m, k)),
        priority=lambda g, m, k: 2 * (g.NT - k) ** 2 - m,
        flows=[
            ptg.FlowSpec(
                "L", ptg.READ,
                tile=lambda g, m, k: (g.A, (k, k)),
                ins=[ptg.In(src=("POTRF", lambda g, m, k: (k,), "T"))]),
            ptg.FlowSpec(
                "C", ptg.RW,
                tile=lambda g, m, k: (g.A, (m, k)),
                ins=[ptg.In(data=lambda g, m, k: (g.A, (m, k)),
                            guard=lambda g, m, k: k == 0),
                     ptg.In(src=("UPDATE", lambda g, m, k: (m, k), "C"),
                            guard=lambda g, m, k: k > 0)],
                outs=[ptg.Out(data=lambda g, m, k: (g.A, (m, k)))]),
            ptg.FlowSpec(
                "G", ptg.CTL,
                outs=[ptg.Out(
                    dst=("UPDATE",
                         lambda g, m, k: sorted(
                             {(m, kk) for kk in range(k + 1, m + 1)} |
                             {(m2, m) for m2 in range(m, g.NT)}),
                         "G"))])])

    # the CTL-gather contract guarantees every gathered TRSM has written
    # its tile back before the UPDATE body runs, so the direct reads of
    # the collection are race-free
    @UPDATE.body(batchable=False)
    def update_body(task, C):
        ctx = task.taskpool.context
        if ctx is not None and ctx.nb_ranks > 1:
            raise NotImplementedError(
                "build_potrf_left: UPDATE's remote tile reads are not "
                "ported; run it in a single-rank context")
        g = task.taskpool.g
        m, k = task.locals
        apply_matmul_precision()
        dev = C.device

        def tile(row, j):
            return torch.as_tensor(g.A.data_of((row, j))).to(
                dev, torch.float32)

        acc = C.to(torch.float32, copy=True)
        for j in range(k):
            acc.addmm_(tile(m, j), tile(k, j).mT, alpha=-1.0)
        return acc.to(C.dtype)

    @POTRF.body
    def potrf_body(task, T):
        return potrf_tile(T, infos=tp.chol_infos)

    @TRSM.body(batchable=False)
    def trsm_body(task, L, C):
        return {"C": trsm_tile(C, L)}

    tp.wave_fuser = _potrf_left_wave_fuser
    tp.requires_fuser = True     # compiled per-tile executors can't feed
    #                              the UPDATE body's collection reads
    return tp


def _potrf_left_wave_fuser(wave, geoms):
    """Lower one left-looking POTRF wave to Aᵀ-dense ops.

    Wave shapes per step k: [UPDATE(·,k)] → one matmul applying every
    prior panel's contribution to block-column k, in place in its row
    panel; [POTRF(k)] → diagonal chol (inverse stashed in the carry
    under potrf.trsm_hook=gemm); [TRSM(·,k)] → one panel solve, written
    with the diagonal factor into the row panel."""
    (geom,) = geoms.values()      # single-collection DAG
    tile_chol = _fuser_helpers(wave)
    names = sorted(g.tc.name for g in wave)
    mb, nb = geom.mb, geom.nb

    if names == ["UPDATE"]:
        (grp,) = wave
        ks = {t[1] for t in grp.tasks}
        if len(ks) != 1:
            return None
        k = ks.pop()
        ms = sorted(t[0] for t in grp.tasks)
        lo, hi = ms[0], ms[-1] + 1
        if ms != list(range(lo, hi)) or lo != k:
            return None

        def do_update(st, k=k, hi=hi):
            # Aᵀ[k-row, k..hi) −= (Lᵀ[:k, k])ᵀ · Lᵀ[:k, k..hi): rows
            # 0:r0 are read, rows r0:r1 written in place — disjoint.
            # The updated row panel is carried to this step's POTRF and
            # TRSM waves, which finish it where it lies.
            apply_matmul_precision()
            D = st[geom.name]
            r0, r1 = k * nb, (k + 1) * nb
            U = D[0:r0, r0:r1]
            S = D[0:r0, r0:hi * mb]
            rowk = D[r0:r1, r0:hi * mb]
            rowk.addmm_(U.mT, S, alpha=-1.0)
            st["_rowk"] = rowk
            return st

        return do_update

    solve_mode = mca_param.get("potrf.trsm_hook", "solve") == "solve"

    if names == ["POTRF"]:
        (grp,) = wave
        if len(grp.tasks) != 1:
            return None
        (k,) = grp.tasks[0]

        def do_potrf(st, k=k, last=(k == geom.nt - 1)):
            D = st[geom.name]
            c, r = geom.cols(k), geom.rows(k)
            rowk = st.pop("_rowk", None)
            diag = rowk[:, :nb] if rowk is not None else D[c, r]
            # symmetrize (identity for symmetric input)
            diag = 0.5 * (diag + diag.mT)
            L = tile_chol(diag)
            if not solve_mode:
                # chol-then-invert, as the reference's fuser does
                st["_potrf_inv"] = tri_inv_tile(L)
            if last:
                # no TRSM wave follows: this step's diagonal write is ours
                D[c, r] = L.mT
            else:
                # the TRSM wave writes the diagonal with the solved panel
                st["_potrf_L"] = L
                if rowk is not None:
                    st["_rowk_rest"] = rowk[:, nb:]
            return st

        return do_potrf

    if names == ["TRSM"]:
        (grp,) = wave
        ks = {t[1] for t in grp.tasks}
        if len(ks) != 1:
            return None
        k = ks.pop()
        ms = sorted(t[0] for t in grp.tasks)
        if ms != list(range(ms[0], ms[0] + len(ms))):
            return None

        def do_trsm(st, k=k, lo=ms[0], hi=ms[-1] + 1):
            apply_matmul_precision()
            D = st[geom.name]
            c = geom.cols(k)
            L = st.pop("_potrf_L", None)
            rest = st.pop("_rowk_rest", None)
            if rest is None:     # k = 0: no UPDATE wave preceded
                rest = D[c, lo * mb:hi * mb]
            if solve_mode:
                # exact wide triangular solve: no inversion, no
                # condition-number squaring
                if L is None:
                    L = D[c, geom.rows(k)].mT
                st.pop("_potrf_inv", None)
                solved = torch.linalg.solve_triangular(L, rest, upper=False)
            else:
                inv = st.pop("_potrf_inv", None)
                if inv is None:  # recompute from the stored factor
                    inv = tri_inv_tile(D[c, geom.rows(k)].mT)
                solved = torch.matmul(inv, rest)
            if L is not None and lo == k + 1:
                D[c, geom.rows(k)] = L.mT
            D[c, lo * mb:hi * mb] = solved
            return st

        return do_trsm

    return None
