"""The port's compiled executors (parsec_tpu_torch.compiled, CPU tensors)
against the JAX package's on the same numpy inputs: the panel-fused
``PanelExecutor`` for both POTRF builders and both TRSM modes, and the
stacked ``WavefrontExecutor`` on the right-looking builder.

Both packages run at ``ops.matmul_precision=highest``. Tolerances: the
lower factor within 1e-5 · max |reference factor| of the reference's
(FP32 rounding in a different order), and the LAPACK residual
‖LLᵀ − A‖/‖A‖ below 1e-4 (the reference's own test bound).
"""

import numpy as np
import pytest
import torch

from parsec_tpu.algorithms import potrf as jpotrf
from parsec_tpu.compiled import panels as jpanels
from parsec_tpu.compiled.wavefront import (WavefrontExecutor as JWavefront,
                                           plan_taskpool as jplan)
from parsec_tpu.data.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.utils import mca_param as jmca
from parsec_tpu_torch.algorithms import potrf as tpotrf
from parsec_tpu_torch.compiled import (PanelExecutor, PanelGeometry,
                                       WavefrontExecutor, bucket_tiles,
                                       plan_taskpool)
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.utils import mca_param as tmca

REL_TOL = 1e-5


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(np.float32)


@pytest.fixture
def knobs():
    def set_both(name, value):
        jmca.set(name, value)
        tmca.set(name, value)

    set_both("ops.matmul_precision", "highest")
    yield set_both
    for name in ("ops.matmul_precision", "potrf.trsm_hook"):
        jmca.unset(name)
        tmca.unset(name)


def _check_factor(port_A, ref_A, A0):
    L = np.tril(port_A.to_array())
    ref = np.tril(ref_A.to_array())
    err = np.max(np.abs(L - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), err
    resid = np.linalg.norm(L @ L.T - A0) / np.linalg.norm(A0)
    assert resid < 1e-4, resid


@pytest.mark.parametrize("n,nb", [(256, 64), (192, 64), (256, 128)])
@pytest.mark.parametrize("hook", ["solve", "gemm"])
@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_panel_executor_matches_reference(knobs, builder, hook, n, nb):
    knobs("potrf.trsm_hook", hook)
    A0 = spd(n, seed=n + nb)
    ref = JTiledMatrix.from_array(A0.copy(), nb, nb, name="A")
    jpanels.PanelExecutor(jplan(getattr(jpotrf, builder)(ref))).run()
    A = TiledMatrix.from_array(A0.copy(), nb, nb, name="A")
    ex = PanelExecutor(plan_taskpool(getattr(tpotrf, builder)(A)),
                       device="cpu")
    assert ex.run() > 0.0
    _check_factor(A, ref, A0)
    # the written tiles come back as tensors on the executor's device
    assert isinstance(A.data_of((1, 0)), torch.Tensor)


@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_panel_preserves_upper_tiles(knobs, builder):
    """The DAG never writes strictly-upper tiles; neither may the fused
    path (write-set equivalence with the tiled executors)."""
    A0 = spd(256)
    A = TiledMatrix.from_array(A0.copy(), 64, 64, name="A")
    PanelExecutor(plan_taskpool(getattr(tpotrf, builder)(A)),
                  device="cpu").run()
    out = A.to_array()
    for i in range(4):
        for j in range(i + 1, 4):
            blk = (slice(i * 64, (i + 1) * 64), slice(j * 64, (j + 1) * 64))
            assert np.array_equal(out[blk], A0[blk]), (i, j)
            assert isinstance(A.data_of((i, j)), np.ndarray)


def test_panel_requires_wave_fuser():
    A = TiledMatrix.from_array(spd(128), 64, 64, name="A")
    tp = tpotrf.build_potrf(A)
    del tp.wave_fuser
    with pytest.raises(ValueError, match="wave_fuser"):
        PanelExecutor(plan_taskpool(tp), device="cpu")


def test_executors_refuse_cuda_without_a_gpu():
    """``device='cuda'`` (the default) raises rather than continuing on
    the CPU when PyTorch sees no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: 'cuda' is valid here")
    plan = plan_taskpool(tpotrf.build_potrf(
        TiledMatrix.from_array(spd(128), 64, 64, name="A")))
    for make in (PanelExecutor, WavefrontExecutor):
        with pytest.raises(RuntimeError, match="cuda"):
            make(plan)


@pytest.mark.parametrize("builder", ["build_potrf", "build_potrf_left"])
def test_panel_run_raises_on_non_spd(knobs, builder):
    """Cholesky failures are collected on the device and raised once, at
    the end of the run."""
    A0 = spd(192, seed=4)
    A0[128:, 128:] = -A0[128:, 128:]
    A = TiledMatrix.from_array(A0, 64, 64, name="A")
    tp = getattr(tpotrf, builder)(A)
    ex = PanelExecutor(plan_taskpool(tp), device="cpu")
    with pytest.raises(torch.linalg.LinAlgError, match="positive-definite"):
        ex.run_state(ex.make_state())
    assert tp.chol_infos == []


def test_panel_run_updates_state_in_place(knobs):
    """The wave functions write the transposed state in place (the
    analog of buffer donation): the run returns the tensor it was
    given, holding the factor."""
    A = TiledMatrix.from_array(spd(256), 64, 64, name="A")
    ex = PanelExecutor(plan_taskpool(tpotrf.build_potrf_left(A)),
                       device="cpu")
    state = ex.make_state()
    ptr = state["A"].data_ptr()
    out = ex.run_state(state)
    assert out["A"] is state["A"] and out["A"].data_ptr() == ptr
    L = torch.tril(out["A"].mT)
    torch.testing.assert_close(L @ L.mT, torch.from_numpy(spd(256)),
                               rtol=1e-4, atol=1e-3)


def test_panel_geometry_and_buckets():
    g = PanelGeometry(name="A", mb=32, nb=32, mt=4, nt=4)
    assert g.rows(2) == slice(64, 96) and g.cols(3) == slice(96, 128)
    for t in range(1, 200):
        assert bucket_tiles(t, 150) == jpanels.bucket_tiles(t, 150), t


@pytest.mark.parametrize("hook", ["solve", "gemm"])
def test_wavefront_executor_matches_reference(knobs, hook):
    knobs("potrf.trsm_hook", hook)
    A0 = spd(256, seed=11)
    ref = JTiledMatrix.from_array(A0.copy(), 64, 64, name="A")
    JWavefront(jplan(jpotrf.build_potrf(ref))).run()
    A = TiledMatrix.from_array(A0.copy(), 64, 64, name="A")
    WavefrontExecutor(plan_taskpool(tpotrf.build_potrf(A)),
                      device="cpu").run()
    _check_factor(A, ref, A0)


def test_wavefront_executor_refuses_left_looking():
    A = TiledMatrix.from_array(spd(128), 64, 64, name="A")
    with pytest.raises(ValueError, match="PanelExecutor"):
        WavefrontExecutor(plan_taskpool(tpotrf.build_potrf_left(A)),
                          device="cpu")
