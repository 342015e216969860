"""The port's tiled-Cholesky slice (parsec_tpu_torch, CPU tensors) against
the JAX package on the same numpy inputs: the POTRF tile kernels, the
wavefront planner's waves, the host runtime with both builders, and the
tiled matrices and distributions.

Every comparison runs at ``ops.matmul_precision=highest`` in both
packages (full FP32 products on both sides). Tolerance for floating
point results: max |port − reference| ≤ 1e-5 · max |reference| — FP32
rounding of the same algorithm in a different summation order stays
near 1e-7 relative at these sizes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parsec_tpu as jparsec
import parsec_tpu_torch as tparsec
from parsec_tpu.algorithms import potrf as jpotrf
from parsec_tpu.compiled.wavefront import plan_taskpool as jplan
from parsec_tpu.data import matrix as jmatrix
from parsec_tpu.ops import tile_kernels as jtk
from parsec_tpu.utils import mca_param as jmca
from parsec_tpu_torch.algorithms import potrf as tpotrf
from parsec_tpu_torch.compiled import plan_taskpool as tplan
from parsec_tpu_torch.core.task import DeviceType
from parsec_tpu_torch.data import matrix as tmatrix
from parsec_tpu_torch.ops import tile_kernels as ttk
from parsec_tpu_torch.utils import mca_param as tmca

REL_TOL = 1e-5


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(np.float32)


def assert_close(port, ref, tol=REL_TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.max(np.abs(port - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.fixture
def knobs():
    """Both packages at full FP32 products, with a small ``ops.tri_base``
    so the recursive triangular kernels recurse at test sizes."""
    def set_both(name, value):
        jmca.set(name, value)
        tmca.set(name, value)

    set_both("ops.matmul_precision", "highest")
    set_both("ops.tri_base", 32)
    yield set_both
    for name in ("ops.matmul_precision", "ops.tri_base",
                 "potrf.trsm_hook", "potrf.blocked_tile_chol"):
        jmca.unset(name)
        tmca.unset(name)


# ------------------------------------------------------------ tile kernels

def _tile_inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    A = spd(n, seed)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    Bs = rng.standard_normal((3, n, n)).astype(np.float32)
    return {"A": A, "L": L, "B": B, "C": C, "Bs": Bs}


KERNELS = {
    "gemm_tile": lambda m, x: m.gemm_tile(x["C"], x["A"], x["B"],
                                          alpha=-1.0, beta=1.0, tb=True),
    "gemm_tile_ta": lambda m, x: m.gemm_tile(x["C"], x["B"], x["A"],
                                             alpha=0.5, beta=2.0, ta=True),
    "syrk_tile": lambda m, x: m.syrk_tile(x["C"], x["B"]),
    "trsm_tile": lambda m, x: m.trsm_tile(x["B"], x["L"]),
    "trsm_tiles_wide": lambda m, x: m.trsm_tiles_wide(x["L"], x["Bs"]),
    "trsm_tiles_gemm": lambda m, x: m.trsm_tiles_gemm(x["L"], x["Bs"]),
    "potrf_tile": lambda m, x: m.potrf_tile(x["A"]),
    "potrf_tile_blocked": lambda m, x: m.potrf_tile_blocked(x["A"]),
    "tri_inv_tile": lambda m, x: m.tri_inv_tile(x["L"]),
    "chol_inv_tile": lambda m, x: m.chol_inv_tile(x["A"], base=32),
    "add_tile": lambda m, x: m.add_tile(x["B"], x["C"]),
    "scale_tile": lambda m, x: m.scale_tile(x["B"], -1.5),
}


# 80 is not a multiple of ops.tri_base = 32: potrf_tile_blocked's last
# block is 16 wide and tri_inv_tile recurses 80 → 40 → 20
@pytest.mark.parametrize("n", [64, 128, 80])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_tile_kernel_matches_reference(knobs, name, n):
    x = _tile_inputs(n)
    ref = KERNELS[name](jtk, {k: jnp.asarray(v) for k, v in x.items()})
    port = KERNELS[name](ttk, {k: torch.from_numpy(v.copy())
                               for k, v in x.items()})
    if isinstance(ref, tuple):
        for p, r in zip(port, ref):
            assert_close(p, r)
    else:
        assert_close(port, ref)


def test_tile_kernels_take_a_batch_dimension(knobs):
    """The stacked executor's batched bodies: a leading batch dimension
    gives the same result as one call per tile."""
    A = torch.from_numpy(np.stack([spd(64, s) for s in range(3)]))
    batched = ttk.potrf_tile_blocked(A)
    for b in range(3):
        torch.testing.assert_close(batched[b], ttk.potrf_tile_blocked(A[b]),
                                   rtol=0, atol=1e-5)


def test_blocked_chol_leaves_its_input_untouched(knobs):
    A = torch.from_numpy(spd(96))
    before = A.clone()
    ttk.potrf_tile_blocked(A)
    assert torch.equal(A, before)


def test_failed_cholesky_is_collected_then_raised():
    bad = -torch.eye(8)
    with pytest.raises(torch.linalg.LinAlgError, match="positive-definite"):
        ttk.potrf_tile(bad)               # no list: checked at once
    infos = []
    ttk.potrf_tile(bad, infos=infos)      # collected, not read yet
    ttk.potrf_tile(torch.eye(8), infos=infos)
    assert len(infos) == 2
    with pytest.raises(torch.linalg.LinAlgError, match="1 tile Cholesky"):
        ttk.raise_on_failed_cholesky(infos)
    assert infos == []


# ---------------------------------------------------------------- planner

def _waves(plan):
    return [sorted((g.tc.name, sorted(g.tasks),
                    tuple((n, tuple(int(s) for s in sl))
                          for n, sl in g.in_slots),
                    tuple((n, tuple(int(s) for s in sl))
                          for n, sl in g.out_slots))
                   for g in wave)
            for wave in plan.waves]


@pytest.mark.parametrize("nt", [4, 7])
@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_planner_waves_match_reference(builder, nt):
    """Same waves: per wave, the same (class, sorted tasks) groups with
    the same gather/scatter slots."""
    n = 16 * nt
    jplan_ = jplan(getattr(jpotrf, builder)(
        jmatrix.TiledMatrix(n, n, 16, 16, name="A")))
    tplan_ = tplan(getattr(tpotrf, builder)(
        tmatrix.TiledMatrix(n, n, 16, 16, name="A")))
    assert tplan_.n_tasks == jplan_.n_tasks
    assert _waves(tplan_) == _waves(jplan_)
    assert tplan_.slot_maps == jplan_.slot_maps
    assert tplan_.has_value_flows == jplan_.has_value_flows is False


@pytest.mark.parametrize("nt", [4, 7])
def test_left_wave_structure(nt):
    """ASAP leveling of the left DAG: exactly 3 waves per step k
    ([UPDATE], [POTRF], [TRSM]) — the schedule the fuser assumes."""
    A = tmatrix.TiledMatrix(16 * nt, 16 * nt, 16, 16, name="A")
    plan = tplan(tpotrf.build_potrf_left(A))
    assert plan.n_waves == 3 * nt - 2       # 3 per step, last has no TRSM
    kinds = [sorted(g.tc.name for g in w) for w in plan.waves]
    assert kinds[0] == ["POTRF"] and kinds[1] == ["TRSM"]
    for k in range(1, nt):
        base = 2 + 3 * (k - 1)
        assert kinds[base] == ["UPDATE"]
        assert kinds[base + 1] == ["POTRF"]
        if k < nt - 1:
            assert kinds[base + 2] == ["TRSM"]


@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_builders_reject_non_square_tiles(builder):
    with pytest.raises(ValueError, match="square tiles"):
        getattr(tpotrf, builder)(tmatrix.TiledMatrix(64, 128, 32, 64))
    with pytest.raises(ValueError, match="square tile grid"):
        getattr(tpotrf, builder)(tmatrix.TiledMatrix(64, 128, 32, 32))


# ----------------------------------------------------------- host runtime

def _host_factor(pkg, matrix_mod, builder_mod, builder, A0, nb, **init_kw):
    A = matrix_mod.TiledMatrix.from_array(A0.copy(), nb, nb, name="A")
    ctx = pkg.init(nb_cores=4, **init_kw)
    try:
        ctx.start()
        ctx.add_taskpool(getattr(builder_mod, builder)(A))
        assert ctx.wait(timeout=120)
        stats = ctx.devices.dump_statistics()
    finally:
        pkg.fini(ctx)
    return np.tril(A.to_array()), stats


@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_host_runtime_matches_reference(knobs, builder):
    A0 = spd(256, seed=5)
    ref, _ = _host_factor(jparsec, jmatrix, jpotrf, builder, A0, 64)
    port, stats = _host_factor(tparsec, tmatrix, tpotrf, builder, A0, 64,
                               device="cpu")
    assert_close(port, ref)
    tp = getattr(tpotrf, builder)(tmatrix.TiledMatrix(256, 256, 64, 64))
    assert sum(d["tasks"] for d in stats) == \
        sum(tc.nb_local_tasks() for tc in tp.task_classes)
    resid = np.linalg.norm(port @ port.T - A0) / np.linalg.norm(A0)
    assert resid < 1e-5, resid


@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_host_runtime_raises_on_non_spd(builder):
    A0 = spd(128, seed=2)
    A0[64:, 64:] = -A0[64:, 64:]       # trailing block not positive
    A = tmatrix.TiledMatrix.from_array(A0, 64, 64, name="A")
    ctx = tparsec.init(nb_cores=2, device="cpu")
    try:
        ctx.add_taskpool(getattr(tpotrf, builder)(A))
        with pytest.raises(RuntimeError, match="positive-definite"):
            ctx.wait(timeout=60)
    finally:
        tparsec.fini(ctx)


def test_host_runtime_bodies_see_tensors(knobs):
    """The UPDATE body's direct collection reads find the TRSM outputs
    as tensors (written back by the runtime), not numpy arrays."""
    A0 = spd(192, seed=1)
    A = tmatrix.TiledMatrix.from_array(A0.copy(), 64, 64, name="A")
    ctx = tparsec.init(nb_cores=2, device="cpu")
    try:
        ctx.add_taskpool(tpotrf.build_potrf_left(A))
        assert ctx.wait(timeout=60)
        [cpu] = ctx.devices.by_type(DeviceType.CPU)
    finally:
        tparsec.fini(ctx)
    for i in range(3):
        for j in range(i + 1):
            assert isinstance(A.data_of((i, j)), torch.Tensor), (i, j)
    assert cpu.stats["tasks"] == 3 + 3 + 3


# ----------------------------------------------------------- tiled matrix

@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_tiled_matrix_round_trip(kind):
    arr = np.random.default_rng(0).standard_normal((96, 64)).astype(
        np.float32)
    src = arr if kind == "numpy" else torch.from_numpy(arr.copy())
    A = tmatrix.TiledMatrix.from_array(src, 32, 16)
    assert (A.mt, A.nt) == (3, 4) and A.dtype == np.float32
    tile = A.data_of((1, 2))
    assert isinstance(tile, np.ndarray if kind == "numpy" else torch.Tensor)
    np.testing.assert_array_equal(A.to_array(), arr)
    # tiles written back as tensors (what the host runtime stores)
    A.write_tile((2, 3), torch.full((32, 16), 7.0))
    out = A.to_array()
    assert np.all(out[64:, 48:] == 7.0)
    np.testing.assert_array_equal(out[:64], arr[:64])


def test_stacked_round_trip_follows_tile_index():
    arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    dist = tmatrix.TwoDimBlockCyclic(P=2, Q=2)
    A = tmatrix.TiledMatrix.from_array(arr, 16, 16, dist=dist)
    ref = jmatrix.TiledMatrix.from_array(
        arr, 16, 16, dist=jmatrix.TwoDimBlockCyclic(P=2, Q=2))
    assert A.tile_index() == ref.tile_index()
    stacked, idx = A.to_stacked("cpu")
    assert stacked.shape == (16, 16, 16)
    for key, s in idx.items():
        np.testing.assert_array_equal(stacked[s].numpy(),
                                      np.asarray(ref.data_of(key)))
    B = tmatrix.TiledMatrix(64, 64, 16, 16, dist=dist)
    B.from_stacked(stacked * 2, idx)
    np.testing.assert_array_equal(B.to_array(), 2 * arr)


@pytest.mark.parametrize("make", [
    lambda m: m.TwoDimBlockCyclic(P=2, Q=3, kp=2, kq=1, ip=1, jq=2),
    lambda m: m.SymTwoDimBlockCyclic(P=2, Q=2, uplo="upper"),
    lambda m: m.TwoDimBandCyclic(P=2, Q=2, band=1),
    lambda m: m.OneDimCyclic(P=3),
    lambda m: m.TwoDimTabular({(i, j): (i * 7 + j) % 5
                               for i in range(6) for j in range(6)}),
], ids=["2dbc", "sym", "band", "1d", "tabular"])
def test_distribution_matches_reference(make):
    d, r = make(tmatrix), make(jmatrix)
    assert d.nodes == r.nodes
    assert [d.rank_of(i, j) for i in range(6) for j in range(6)] == \
        [r.rank_of(i, j) for i in range(6) for j in range(6)]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_subtile_view_flush(kind):
    arr = np.random.default_rng(1).standard_normal((8, 8)).astype(
        np.float32)
    A = tmatrix.TiledMatrix.from_array(arr, 8, 8, name="A")
    if kind == "torch":
        A.write_tile((0, 0), torch.from_numpy(arr.copy()))
    sv = A.subtile((0, 0), 2, 2)
    assert (sv.mt, sv.nt) == (4, 4)
    np.testing.assert_array_equal(sv.data_of((1, 2)), arr[2:4, 4:6])
    sv.write_tile((0, 0), torch.zeros((2, 2)))
    sv.flush()
    out = np.asarray(A.data_of((0, 0)))
    assert np.all(out[0:2, 0:2] == 0)
    np.testing.assert_array_equal(out[2:, :], arr[2:, :])
    np.testing.assert_array_equal(out[:2, 2:], arr[:2, 2:])
