"""The port's PTG transformer block (parsec_tpu_torch, CPU device) against
the JAX package's block run through its own runtime, and against the
dense reference, on the same numpy inputs and weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parsec_tpu as jparsec
import parsec_tpu_torch as tparsec
from parsec_tpu.algorithms import transformer as jtr
from parsec_tpu.core.task import DeviceType as JDeviceType
from parsec_tpu.data import LocalCollection as JLocalCollection
from parsec_tpu_torch.algorithms import transformer as ttr
from parsec_tpu_torch.core.task import DeviceType
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl import ptg


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def tctx():
    c = tparsec.init(nb_cores=4, device="cpu")
    c.start()
    yield c
    tparsec.fini(c)


def _arrays(rng, H, T, TS, DH, F):
    """The layout of tests/test_transformer.py: q/k/v (H, S, dh)."""
    D = H * DH
    q, k, v = (rng.standard_normal((H, T * TS, DH)).astype(np.float32)
               for _ in range(3))
    Wo = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    W1 = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
    W2 = (rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32)
    return q, k, v, Wo, W1, W2


def _port_block(q, k, v, Wo, W1, W2, H, T, TS, DH):
    Qc, Kc, Vc = ttr.tiles_from_reference(q, k, v, TS, device="cpu")
    Y = LocalCollection("Y", {(i,): None for i in range(T)})
    weights = ttr.params_from_reference(Wo, W1, W2, device="cpu")
    return ttr.build_transformer_block(Qc, Kc, Vc, Y, H, T, TS, DH,
                                       *weights), Y


def _jax_block_output(q, k, v, Wo, W1, W2, H, T, TS, DH):
    cols = [JLocalCollection(n, {(h, i): x[h, i * TS:(i + 1) * TS]
                                 for h in range(H) for i in range(T)})
            for n, x in (("Q", q), ("K", k), ("V", v))]
    Y = JLocalCollection("Y", {(i,): None for i in range(T)})
    tp = jtr.build_transformer_block(*cols, Y, H, T, TS, DH, Wo, W1, W2)
    c = jparsec.init(nb_cores=2)
    try:
        c.add_taskpool(tp)
        assert c.wait(timeout=120)
    finally:
        jparsec.fini(c)
    return np.concatenate([np.asarray(Y.data_of((i,))) for i in range(T)])


def test_port_transformer_checker(rng):
    tp, _ = _port_block(*_arrays(rng, 2, 3, 8, 4, 16), 2, 3, 8, 4)
    ptg.check_taskpool(tp)
    counts = {tc.name: tc.nb_local_tasks() for tc in tp.task_classes}
    assert counts == {"ATT": 18, "NORM": 6, "GATH": 6, "FFN": 3}


@pytest.mark.parametrize("H,T,TS,DH,F,tol", [
    (2, 3, 8, 4, 16, 2e-3),
    (4, 4, 16, 8, 64, 5e-3),
])
def test_port_block_matches_jax_runtime_and_dense(tctx, rng, H, T, TS, DH,
                                                  F, tol):
    arrs = _arrays(rng, H, T, TS, DH, F)
    tp, Y = _port_block(*arrs, H, T, TS, DH)
    tctx.add_taskpool(tp)
    assert tctx.wait(timeout=120)
    got = torch.cat([Y.data_of((i,)) for i in range(T)]).numpy()
    ref = jtr.reference_block(*arrs)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _jax_block_output(*arrs, H, T, TS, DH),
                               rtol=tol, atol=tol)
    # the port's dense reference agrees with the numpy one (chunked rows)
    tref = ttr.reference_block(*(torch.from_numpy(x) for x in arrs),
                               chunk=TS).numpy()
    np.testing.assert_allclose(tref, ref, rtol=tol, atol=tol)
    # bodies saw tensors: the collections now hold the staged tiles
    assert all(isinstance(Y.data_of((i,)), torch.Tensor) for i in range(T))


def test_port_att_cuda_chore_matches_jax_tpu_chore(rng):
    """The port's CUDA incarnation of ATT (flash + (o, lse) merge), called
    directly on CPU tensors, against the JAX TPU incarnation (Pallas
    interpret mode) — including the mixed generic/CUDA chain."""
    H, T, TS, dh = 1, 3, 32, 16
    tiles = {(nm, i): rng.standard_normal((TS, dh)).astype(np.float32)
             for nm in "qkv" for i in range(T)}
    Wo = np.eye(H * dh, H * dh, dtype=np.float32)

    jcols = [JLocalCollection(n) for n in "QKVY"]
    jtp = jtr.build_transformer_block(*jcols, H, T, TS, dh,
                                      Wo, Wo[:, :8], Wo[:8, :])
    jATT = jtp.task_class_by_name("ATT")
    jtpu = jATT.chore_for(JDeviceType.TPU).hook
    jcpu = jATT.chore_for(JDeviceType.CPU).hook

    tcols = [LocalCollection(n) for n in "QKVY"]
    ttp = ttr.build_transformer_block(
        *tcols, H, T, TS, dh,
        *ttr.params_from_reference(Wo, Wo[:, :8], Wo[:8, :], device="cpu"))
    tATT = ttp.task_class_by_name("ATT")
    tcuda = tATT.chore_for(DeviceType.CUDA).hook
    tcpu = tATT.chore_for(DeviceType.CPU).hook
    assert tcuda is not tcpu

    def jchain(hooks):
        S = (jnp.zeros((TS, dh), jnp.float32),
             jnp.full((TS,), -jnp.inf, jnp.float32),
             jnp.zeros((TS,), jnp.float32))
        for j, hook in enumerate(hooks):
            S = hook(None, *(jnp.asarray(tiles[(n, j if n != "q" else 0)])
                             for n in "qkv"), S)["S"]
        acc, m, l = S
        return np.asarray(acc / l[:, None])

    def tchain(hooks):
        S = (torch.zeros((TS, dh)), torch.full((TS,), -np.inf),
             torch.zeros((TS,)))
        for j, hook in enumerate(hooks):
            S = hook(None, *(torch.from_numpy(tiles[(n, j if n != "q"
                                                     else 0)])
                             for n in "qkv"), S)["S"]
        acc, m, l = S
        return (acc / l[:, None]).numpy()

    ref = jchain([jcpu] * T)
    jflash = jchain([jtpu] * T)
    np.testing.assert_allclose(jflash, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tchain([tcuda] * T), jflash,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tchain([tcpu] * T), ref,
                               rtol=2e-3, atol=2e-3)
    # mixed chain: generic link then CUDA links (state representations
    # agree)
    np.testing.assert_allclose(tchain([tcpu, tcuda, tcuda]), ref,
                               rtol=2e-3, atol=2e-3)
