"""The port's flash attention (parsec_tpu_torch) against the JAX package's
Pallas kernel (run in interpret mode on the CPU, as its own tests run it)
on the same numpy inputs. On CPU tensors the port runs the kernel's plain
PyTorch version; the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parsec_tpu.ops import flash_attention as jax_fa
from parsec_tpu_torch.ops import flash_attention as port_fa
from parsec_tpu_torch.ops import nvcc

# tolerances of tests/test_flash_attention.py
O_TOL = dict(rtol=2e-3, atol=2e-3)
LSE_TOL = dict(rtol=1e-4, atol=1e-4)


def _dense_ref(q, k, v, causal, scale):
    S, H, dh = q.shape
    out = np.zeros_like(q)
    for h in range(H):
        s = q[:, h] @ k[:, h].T * scale
        if causal:
            mask = np.tril(np.ones((S, k.shape[0]), bool))
            s = np.where(mask, s, -np.inf)
        p = np.exp(s - s.max(axis=-1, keepdims=True))
        p = p / p.sum(axis=-1, keepdims=True)
        out[:, h] = p @ v[:, h]
    return out


def _both(q, k, v, **kw):
    """Run the JAX kernel and the port on the same numpy inputs; return
    both results as numpy (tuples when return_lse)."""
    j = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    t = port_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    if kw.get("return_lse"):
        return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in t)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,H,dh,bq,bk", [
    (256, 2, 64, 128, 128),
    (256, 1, 128, 64, 128),
    (384, 2, 32, 128, 128),
])
def test_port_flash_matches_jax_and_dense(causal, S, H, dh, bq, bk):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((S, H, dh)).astype(np.float32)
               for _ in range(3))
    got_jax, got = _both(q, k, v, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, got_jax, **O_TOL)
    np.testing.assert_allclose(got, _dense_ref(q, k, v, causal,
                                               1.0 / np.sqrt(dh)), **O_TOL)


def test_port_flash_cross_attention_lengths():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((128, 2, 64)).astype(np.float32)
    k = rng.standard_normal((256, 2, 64)).astype(np.float32)
    v = rng.standard_normal((256, 2, 64)).astype(np.float32)
    got_jax, got = _both(q, k, v, block_q=64, block_k=128)
    np.testing.assert_allclose(got, got_jax, **O_TOL)
    np.testing.assert_allclose(got, _dense_ref(q, k, v, False, 1.0 / 8.0),
                               **O_TOL)


def test_port_flash_rejects_nondividing_blocks():
    q = torch.zeros((100, 1, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="divide"):
        port_fa.flash_attention(q, q, q, block_q=64, block_k=64)
    qj = jnp.zeros((100, 1, 64), jnp.float32)
    with pytest.raises(ValueError, match="divide"):
        jax_fa.flash_attention(qj, qj, qj, block_q=64, block_k=64)


def test_port_flash_lse_and_state_merge():
    rng = np.random.default_rng(3)
    S, H, dh = 128, 2, 64
    q, k, v = (rng.standard_normal((S, H, dh)).astype(np.float32)
               for _ in range(3))
    (o_j, lse_j), (o, lse) = _both(q, k, v, block_q=64, block_k=64,
                                   return_lse=True)
    np.testing.assert_allclose(o, o_j, **O_TOL)
    np.testing.assert_allclose(lse, lse_j, **LSE_TOL)
    half = S // 2
    parts = [port_fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv),
        block_q=64, block_k=64, return_lse=True)
        for kk, vv in ((k[:half], v[:half]), (k[half:], v[half:]))]
    om, lm = port_fa.merge_attention_states(*parts[0], *parts[1])
    np.testing.assert_allclose(om.numpy(), o_j, **O_TOL)
    np.testing.assert_allclose(lm.numpy(), lse_j, **LSE_TOL)
    # the port's merge agrees with the JAX merge on the same partials
    jm_o, jm_l = jax_fa.merge_attention_states(
        *(jnp.asarray(x.numpy()) for x in (*parts[0], *parts[1])))
    np.testing.assert_allclose(om.numpy(), np.asarray(jm_o), **O_TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jm_l), **LSE_TOL)


def test_port_flash_causal_first_block_rows():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((128, 1, 64)).astype(np.float32)
               for _ in range(3))
    got_jax, got = _both(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got[0, 0], v[0, 0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, got_jax, **O_TOL)


def test_port_flash_default_blocks_adapt_to_sequence():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1536, 1, 64)).astype(np.float32)
    got_jax, got = _both(q, q, q)
    np.testing.assert_allclose(got, got_jax, **O_TOL)
    np.testing.assert_allclose(got, _dense_ref(q, q, q, False, 1.0 / 8.0),
                               **O_TOL)
    assert port_fa._blocks(1536, 1536, 0, 0) == (512, 512)


def test_port_flash_bf16_plain_version_keeps_dtype():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((64, 2, 32)).astype(np.float32))
    o, lse = port_fa.flash_attention(q.bfloat16(), q.bfloat16(),
                                     q.bfloat16(), return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = port_fa.flash_attention(*(q.bfloat16().float(),) * 3)
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(),
                               rtol=1e-2, atol=1e-2)


def test_port_flash_non_cpu_tensors_never_take_the_plain_version():
    """Only CPU tensors reach the plain version: anything else goes to the
    kernel path, which checks its inputs and raises instead of falling
    back (here: tensors on the meta device)."""
    before = port_fa.flash_attention.launches
    q = torch.empty((64, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        port_fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        port_fa.flash_attention(torch.zeros((64, 1, 32)), q, q)
    assert port_fa.flash_attention.launches == before


def test_port_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises (no silent plain-version path); the
    library name tracks the source hash."""
    path = nvcc.library_path("flash_attention")
    assert path.startswith(nvcc.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(nvcc.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    if not nvcc.os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            nvcc.nvcc_path()
