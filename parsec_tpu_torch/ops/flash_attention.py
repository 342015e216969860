"""Flash attention: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Port of the reference package's Pallas TPU kernel
(``parsec_tpu/ops/flash_attention.py``: ``_fa_kernel`` :44-101, launched
by ``flash_attention`` :113-191). :func:`flash_attention` keeps its
signature and contract over ``(S, H, dh)`` operands. On CUDA tensors it
launches the kernel in ``csrc/flash_attention.cu`` (built with ``nvcc``
for ``sm_90a`` on first use, see :mod:`.nvcc`) or raises; on CPU tensors
it runs :func:`flash_attention_reference`. There is no other path: a
failed build or launch raises, it never falls back.

The kernel follows ``ops.matmul_precision`` (:func:`tf32_passes`): one
TF32 pass per product under ``default``, 3xTF32 under ``high`` and
``highest``. When a launch would leave SMs idle it splits each (head,
query block)'s keys over several CTAs (:func:`split_count`,
:func:`split_bounds`) and merges their partial ``(o, lse)`` with a second
kernel (:func:`combine_splits`).

``flash_attention.launches`` and ``combine_splits.launches`` count kernel
launches (not plain-version calls), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..utils import mca_param
from . import nvcc
from .precision import matmul_precision

mca_param.register("ops.flash_attention_block_q", 1024,
                   help="flash-attention query block size (a contract on "
                        "divisibility; the CUDA kernel picks its own tile)")
mca_param.register("ops.flash_attention_block_k", 1024,
                   help="flash-attention key/value block size (as above)")

_NEG = -1e30          # finite -inf: fully masked rows keep p = 0
_MAX_DH = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = 64               # query rows per CTA of the kernel
SPLIT_ALIGN = 64      # key-split boundaries are multiples of this
MIN_SPLIT_KEYS = 128  # a split covers at least this many keys

_launch_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None
_sm_counts = {}


def _blocks(S: int, Sk: int, block_q: int, block_k: int):
    """The reference's block contract: defaults come from the knobs and
    halve until they divide the sequence; an explicit block that does not
    divide it raises."""
    bq = block_q or int(mca_param.get("ops.flash_attention_block_q", 1024))
    bk = block_k or int(mca_param.get("ops.flash_attention_block_k", 1024))
    bq = min(bq, S)
    bk = min(bk, Sk)
    if not block_q:
        while S % bq:
            bq //= 2
    if not block_k:
        while Sk % bk:
            bk //= 2
    if S % bq or Sk % bk:
        raise ValueError(f"sequence lengths ({S}, {Sk}) must divide the "
                         f"block sizes ({bq}, {bk})")
    return bq, bk


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = nvcc.load("flash_attention")
            lib.fa_fwd.argtypes = [ctypes.c_void_p] * 6 + \
                [ctypes.c_int] * 4 + [ctypes.c_float] + \
                [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.fa_fwd.restype = ctypes.c_int
            lib.fa_combine.argtypes = [ctypes.c_void_p] * 4 + \
                [ctypes.c_long] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.fa_combine.restype = ctypes.c_int
            lib.fa_error_string.argtypes = [ctypes.c_int]
            lib.fa_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_cuda_inputs(q, k, v) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"expected every input on one CUDA device "
                             f"(q on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    S, H, dh = q.shape
    if k.shape != v.shape or k.shape[1:] != (H, dh):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if dh > _MAX_DH:
        raise ValueError(f"flash_attention: head dim {dh} > {_MAX_DH}")


def tf32_passes(mode: str) -> int:
    """TF32 passes per product for a ``ops.matmul_precision`` mode: one
    under ``default``, three (3xTF32, FP32-level accuracy) under ``high``
    and ``highest`` (the reference maps ``high`` to ``highest`` inside its
    kernel too)."""
    if mode == "default":
        return 1
    if mode in ("high", "highest"):
        return 3
    raise ValueError(f"unknown matmul precision {mode!r}")


def split_count(S: int, Sk: int, H: int, n_sm: int) -> int:
    """CTAs per (head, query block) for the kernel's split-KV: as many as
    keep ``H * ceil(S / BQ) * n`` within one wave of ``n_sm`` SMs (one CTA
    fits on an SM), at most one per ``MIN_SPLIT_KEYS`` keys, at least 1."""
    ctas = H * -(-S // BQ)
    return max(1, min(n_sm // ctas, Sk // MIN_SPLIT_KEYS))


def split_bounds(Sk: int, n_split: int):
    """Key ranges ``[(lo, hi), ...]`` of the splits: split ``s`` starts at
    ``floor(s * Sk / n_split)`` rounded down to a multiple of
    ``SPLIT_ALIGN``; the last ends at ``Sk`` (the kernel's
    ``split_start``)."""
    starts = [(s * Sk // n_split) // SPLIT_ALIGN * SPLIT_ALIGN
              for s in range(n_split)] + [Sk]
    return list(zip(starts[:-1], starts[1:]))


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.fa_error_string(rc).decode()} ({rc})")


def _launch(q, k, v, causal: bool, scale: float):
    _check_cuda_inputs(q, k, v)
    S, H, dh = q.shape
    Sk = k.shape[0]
    lib = _library()
    passes = tf32_passes(matmul_precision())
    n_split = split_count(S, Sk, H, _sm_count(q.device))
    o = torch.empty_like(q)
    lse = torch.empty((S, H), dtype=torch.float32, device=q.device)
    # split partials: o (n_split, S, H, dh) then lse (n_split, S, H), f32
    scratch = torch.empty(n_split * S * H * (dh + 1), dtype=torch.float32,
                          device=q.device) if n_split > 1 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(),
                        scratch.data_ptr() if scratch is not None else None,
                        S, Sk, H, dh, float(scale), int(bool(causal)),
                        _DTYPES[q.dtype], passes, n_split, stream)
    _check_rc(lib, rc, "flash_attention")
    with _launch_lock:
        flash_attention.launches += 1
    if n_split > 1:
        n_o = n_split * S * H * dh
        o, lse = combine_splits(scratch[:n_o].view(n_split, S, H, dh),
                                scratch[n_o:].view(n_split, S, H), q.dtype)
    return o, lse


def _launch_combine(o_part, lse_part, dtype):
    n_split, S, H, dh = o_part.shape
    for name, t in (("o_part", o_part), ("lse_part", lse_part)):
        if t.device != o_part.device or t.device.type != "cuda":
            raise ValueError(f"combine_splits: {name} on {t.device}, "
                             f"expected both on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"combine_splits: {name} must be contiguous "
                             f"float32")
    if lse_part.shape != (n_split, S, H) or dtype not in _DTYPES:
        raise ValueError(f"combine_splits: lse_part {tuple(lse_part.shape)}"
                         f" or dtype {dtype} does not fit o_part "
                         f"{tuple(o_part.shape)}")
    lib = _library()
    o = torch.empty((S, H, dh), dtype=dtype, device=o_part.device)
    lse = torch.empty((S, H), dtype=torch.float32, device=o_part.device)
    with torch.cuda.device(o_part.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fa_combine(o_part.data_ptr(), lse_part.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), S * H, dh,
                            n_split, _DTYPES[dtype], stream)
    _check_rc(lib, rc, "combine_splits")
    with _launch_lock:
        combine_splits.launches += 1
    return o, lse


def combine_reference(o_part, lse_part):
    """Plain PyTorch version of the combine kernel: merge ``n`` partial
    softmax-attention results over disjoint key sets, ``o_part (n, ...,
    dh)`` and ``lse_part (n, ...)`` f32, with the n-part identity of
    :func:`merge_attention_states`. Wholly masked parts (``lse <= -5e29``)
    get weight 0. Returns ``(o, lse)`` in f32."""
    M = lse_part.max(dim=0).values
    live = lse_part > _NEG / 2
    w = torch.where(live, torch.exp(lse_part - M), torch.zeros_like(M))
    den = torch.clamp(w.sum(dim=0), min=1e-30)
    o = (o_part * w[..., None]).sum(dim=0) / den[..., None]
    return o, M + torch.log(den)


def combine_splits(o_part, lse_part, dtype=torch.float32):
    """Merge the split-KV partials ``o_part (n_split, S, H, dh)`` and
    ``lse_part (n_split, S, H)`` (f32) into ``(o (S, H, dh) in dtype,
    lse (S, H) f32)``. CUDA tensors go through the combine kernel, CPU
    tensors through :func:`combine_reference`."""
    if o_part.device.type == "cpu" and lse_part.device.type == "cpu":
        o, lse = combine_reference(o_part, lse_part)
        return o.to(dtype), lse
    return _launch_combine(o_part, lse_part, dtype)


combine_splits.launches = 0


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              k_offset: int = 0):
    """Plain PyTorch version of the kernel: dense f32 softmax attention
    per head with the kernel's mask and lse conventions (finite ``-1e30``
    mask on global positions, masked ``p = 0``, ``l`` clamped at
    ``1e-30``). ``k_offset`` is the global position of ``k[0]``, so a key
    split's partial result masks as the whole would. Returns ``(o,
    lse)``: ``o (S, H, dh)`` in ``q.dtype``, ``lse (S, H)`` f32."""
    S, H, dh = q.shape
    Sk = k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((S, H), dtype=torch.float32, device=q.device)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(k_offset, k_offset + Sk,
                            device=q.device)[None, :]
        live = qpos >= kpos
    for h in range(H):
        qh = q[:, h].float()
        s = (qh @ k[:, h].float().T) * scale
        if causal:
            s = torch.where(live, s, torch.full_like(s, _NEG))
        m = s.max(dim=-1).values
        p = torch.exp(s - m[:, None])
        if causal:
            p = torch.where(s > _NEG / 2, p, torch.zeros_like(p))
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        o[:, h] = ((p @ v[:, h].float()) / l[:, None]).to(q.dtype)
        lse[:, h] = m + torch.log(l)
    return o, lse


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = 0, block_k: int = 0,
                    return_lse: bool = False):
    """Softmax attention over ``(S, H, dh)`` operands. CUDA tensors go
    through the hand-written kernel, CPU tensors through
    :func:`flash_attention_reference`. ``return_lse=True`` also returns
    the per-row log-sum-exp ``(S, H)`` — the merge key for combining
    partial attention states. ``block_q``/``block_k`` keep the reference
    kernel's divisibility contract."""
    S, H, dh = q.shape
    Sk = k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    _blocks(S, Sk, block_q, block_k)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        o, lse = flash_attention_reference(q, k, v, causal, scale)
    else:
        o, lse = _launch(q, k, v, causal, scale)
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def merge_attention_states(o1, lse1, o2, lse2):
    """Combine two partial softmax-attention results over disjoint key
    sets: ``o_i`` (..., dh) normalized partial outputs, ``lse_i`` (...)
    their log-sum-exps. Returns the merged ``(o, lse)`` — the standard
    flash/ring state-merge identity."""
    M = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - M)
    w2 = torch.exp(lse2 - M)
    den = w1 + w2
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / den[..., None]
    return o, M + torch.log(den)
