"""The arithmetic of the port's tensor-core flash kernel, on the CPU.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against its plain version there). What its design adds is checked here on
numpy inputs made from a seed:

- split-KV: partial results of the plain version over the kernel's key
  splits, merged by the combine kernel's plain version, match the JAX
  package's Pallas kernel (interpret mode) and the unsplit plain version;
- the split-count helper fills one wave of SMs at the main path's tile
  and never cuts a split below ``MIN_SPLIT_KEYS`` keys;
- TF32: round-to-nearest TF32 emulated by masking mantissa bits, in 1 pass
  and in 3 passes (3xTF32), stays within the tolerances chip_smoke.py
  states for each mode, and 3 passes are far more accurate than 1;
- the precision knob maps to the number of passes.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parsec_tpu.ops import flash_attention as jax_fa
from parsec_tpu_torch.ops import flash_attention as port_fa
from parsec_tpu_torch.ops import precision
from parsec_tpu_torch.utils import mca_param

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, S, Sk, H, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, H, dh)).astype(np.float32)
            for n in (S, Sk, Sk))


def _split_then_combine(q, k, v, causal, n_split):
    """What the kernel does with ``n_split`` CTAs per query block, in
    plain PyTorch: each split's partial (o, lse) on its key range (causal
    on global positions), merged by the combine kernel's plain version."""
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    parts = [port_fa.flash_attention_reference(
        qt, kt[lo:hi], vt[lo:hi], causal, scale, k_offset=lo)
        for lo, hi in port_fa.split_bounds(k.shape[0], n_split)]
    o_part = torch.stack([p[0] for p in parts])
    lse_part = torch.stack([p[1] for p in parts])
    return port_fa.combine_splits(o_part, lse_part), lse_part


# (S, Sk, H, dh, causal)
_CASES = {
    "noncausal": (512, 512, 2, 32, False),
    "causal_masked_splits": (1024, 1024, 1, 32, True),
    "causal_cross_sk_ne_s": (384, 1024, 2, 32, True),
    "ragged_1000": (1000, 1000, 1, 32, True),
}


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_split_combine_matches_jax_kernel(case, n_split):
    """Merged split partials equal the JAX kernel on the same inputs (f32
    both sides, different summation orders: 1e-4 abs/rel) and the unsplit
    plain version (same arithmetic regrouped: 1e-5)."""
    S, Sk, H, dh, causal = _CASES[case]
    q, k, v = _inputs(7, S, Sk, H, dh)
    (o, lse), lse_part = _split_then_combine(q, k, v, causal, n_split)
    if causal and n_split > 1:
        # some split lies wholly in the future of some query rows
        assert bool((lse_part <= -5e29).any())
    o_j, lse_j = jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               rtol=1e-4, atol=1e-4)
    o_1, lse_1 = port_fa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        return_lse=True)
    np.testing.assert_allclose(o.numpy(), o_1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_1.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_combine_skips_wholly_masked_parts_and_keeps_dtype():
    rng = np.random.default_rng(3)
    o_part = torch.from_numpy(rng.standard_normal((3, 4, 2, 8))
                              .astype(np.float32))
    lse_part = torch.from_numpy(rng.standard_normal((3, 4, 2))
                                .astype(np.float32))
    lse_part[1] = -1e30 + math.log(1e-30)        # a split in the future
    o_part[1] = 0.0
    o, lse = port_fa.combine_splits(o_part, lse_part, torch.bfloat16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o2, lse2 = port_fa.merge_attention_states(
        o_part[0], lse_part[0], o_part[2], lse_part[2])
    np.testing.assert_allclose(o.float().numpy(), o2.numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), lse2.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_split_count_fills_one_wave_at_the_main_tile():
    n = port_fa.split_count(1024, 1024, 1, 132)
    assert 1 * math.ceil(1024 / port_fa.BQ) * n >= 128
    assert 16 * n <= 132                    # one CTA per SM, one wave
    assert port_fa.split_count(16384, 16384, 4, 132) == 1   # bench shape


@pytest.mark.parametrize("n_sm", [132, 114, 16])
def test_split_count_and_bounds_keep_every_split_long(n_sm):
    for S in (64, 100, 256, 1000, 1024, 4096):
        for Sk in (64, 127, 128, 300, 1000, 1024, 16384):
            for H in (1, 2, 4, 8):
                n = port_fa.split_count(S, Sk, H, n_sm)
                assert 1 <= n <= math.ceil(Sk / port_fa.MIN_SPLIT_KEYS)
                bounds = port_fa.split_bounds(Sk, n)
                assert len(bounds) == n
                assert bounds[0][0] == 0 and bounds[-1][1] == Sk
                for (lo, hi), nxt in zip(bounds, bounds[1:] + [(Sk, Sk)]):
                    assert hi == nxt[0] and lo % port_fa.SPLIT_ALIGN == 0
                    assert hi - lo >= min(Sk, port_fa.MIN_SPLIT_KEYS)
                if n > 1:
                    ctas = H * math.ceil(S / port_fa.BQ)
                    assert ctas * n <= n_sm


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half of the dropped 13 bits'
    range to the magnitude and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _emulated(q, k, v, passes, scale):
    """One head of the kernel's arithmetic with its TF32 rounding: inputs
    and P rounded (and split for 3 passes), the products summed in f64 so
    only the rounding differs from the reference."""
    def product(a, b):
        if passes == 1:
            return _rna_tf32(a).double() @ _rna_tf32(b).double().T
        ab, as_ = _split(a)
        bb, bs = _split(b)
        return (as_.double() @ bb.double().T + ab.double() @ bs.double().T
                + ab.double() @ bb.double().T)

    s = product(q, k) * scale
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    l = p.sum(dim=-1)
    o = product(p.float(), v.T) / l[:, None]
    return o, m + torch.log(l)


def test_tf32_emulation_at_the_main_tile_meets_the_stated_tolerances():
    """1024 x 1 x 128 f32, unit-normal inputs: each mode's error against
    an f64 reference stays within chip_smoke.py's tolerance for it, and
    3xTF32's error is at least 50x below one TF32 pass's."""
    tol = _chip_smoke().TOL
    q, k, v = (torch.from_numpy(x[:, 0]) for x in _inputs(0, 1024, 1024,
                                                             1, 128))
    scale = 1.0 / math.sqrt(128)
    s = (q.double() @ k.double().T) * scale
    lse_ref = torch.logsumexp(s, dim=-1)
    o_ref = torch.softmax(s, dim=-1) @ v.double()
    err = {}
    for passes in (1, 3):
        o, lse = _emulated(q, k, v, passes, scale)
        err[passes] = ((o - o_ref).abs().max().item(),
                       (lse - lse_ref).abs().max().item())
        t = tol[("float32", passes)]
        assert err[passes][0] <= t["o"] and err[passes][1] <= t["lse"], \
            (passes, err[passes], t)
    assert 50 * err[3][0] <= err[1][0] and 50 * err[3][1] <= err[1][1], err


def test_rna_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11], dtype=torch.float32)
    got = _rna_tf32(x).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                   1.0 + 2 ** -9]


@pytest.mark.parametrize("mode,passes", [("default", 1), ("high", 3),
                                         ("highest", 3)])
def test_precision_knob_picks_the_number_of_passes(mode, passes):
    try:
        mca_param.set("ops.matmul_precision", mode)
        assert port_fa.tf32_passes(precision.matmul_precision()) == passes
    finally:
        mca_param.unset("ops.matmul_precision")
    with pytest.raises(ValueError):
        port_fa.tf32_passes("bf16")
