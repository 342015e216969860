"""Tile-level kernels of the tiled Cholesky (the POTRF subset).

The port of the reference package's ``ops/tile_kernels.py:38-216``. These
are the FLOP-carrying bodies of the POTRF taskpools — the role CUDA
kernels in user .jdf BODY sections play in the reference (DPLASMA's
dpotrf/dgemm tiles). The reference writes them in jnp for XLA; here they
are torch calls that go to cuBLAS (products, triangular solves) and
cuSOLVER (``cholesky_ex``) on a CUDA tensor, and to PyTorch's CPU
kernels on a CPU tensor. No kernel of this module is hand-written: the
reference reaches no ``pallas_call`` here either.

Every function takes tiles ``(..., n, n)``: a leading batch dimension
runs one call over a whole stack of tiles, which is what the batched
bodies of the compiled executors use. Products run in float32 whatever
the tile dtype (the reference's ``preferred_element_type=float32``),
under ``ops.matmul_precision``: each function that multiplies calls
:func:`~.precision.apply_matmul_precision` first, so ``default`` runs
TF32 tensor-core products and ``high``/``highest`` full FP32.

Cholesky failures: ``torch.linalg.cholesky`` checks its ``info`` on the
host, which would synchronise the stream at every diagonal tile. These
kernels call ``cholesky_ex(check_errors=False)`` instead and append the
``info`` tensor to a caller's list; :func:`raise_on_failed_cholesky`
reads the whole list once, at the end of a run, and raises if any
factorisation failed. With no list, the check runs at once.

Like ``jnp.linalg.cholesky``, every Cholesky here factors the
symmetrised input ``(A + Aᵀ)/2``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..utils import mca_param
from .precision import apply_matmul_precision

mca_param.register("ops.tri_base", 256,
                   help="base block size for matmul-rich triangular "
                        "kernels (tri_inv_tile / potrf_tile_blocked)")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def raise_on_failed_cholesky(infos: List[torch.Tensor]) -> None:
    """Read every collected Cholesky ``info`` in one host
    synchronisation, empty the list, and raise
    ``torch.linalg.LinAlgError`` if any factorisation failed."""
    if not infos:
        return
    flat = [i.reshape(-1) for i in infos]
    infos.clear()
    dev = flat[0].device
    allinfo = torch.cat([f.to(dev) for f in flat])
    failed = int(allinfo.ne(0).sum())
    if failed:
        first = int(allinfo[allinfo.ne(0)][0])
        raise torch.linalg.LinAlgError(
            f"{failed} tile Cholesky factorisation(s) failed: the leading "
            f"minor of order {first} is not positive-definite")


def _chol(A: torch.Tensor,
          infos: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised float32 tile(s)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.mT),
                                       check_errors=False)
    if infos is None:
        raise_on_failed_cholesky([info])
    else:
        infos.append(info)
    return L


def gemm_tile(C, A, B, alpha=1.0, beta=1.0, ta=False, tb=False):
    """C ← α·op(A)·op(B) + β·C (tile GEMM)."""
    apply_matmul_precision()
    opA = A.mT if ta else A
    opB = B.mT if tb else B
    acc = torch.matmul(_f32(opA), _f32(opB))
    return (alpha * acc + beta * C).to(C.dtype)


def syrk_tile(C, A, alpha=-1.0, beta=1.0):
    """C ← α·A·Aᵀ + β·C (symmetric rank-k update, lower)."""
    apply_matmul_precision()
    Af = _f32(A)
    acc = torch.matmul(Af, Af.mT)
    return (alpha * acc + beta * C).to(C.dtype)


def trsm_tile(B, L):
    """B ← B·L⁻ᵀ — right-solve with the lower-triangular factor L of the
    panel tile (the dpotrf TRSM update: A[m,k] = A[m,k] L[k,k]^-T)."""
    apply_matmul_precision()
    x = torch.linalg.solve_triangular(_f32(L), _f32(B).mT, upper=False)
    return x.mT.to(B.dtype)


def trsm_tiles_wide(L, Bs):
    """Batched B_i ← B_i·L⁻ᵀ with a SHARED factor L, formulated as ONE
    wide-RHS triangular solve: L · Y = [B₁ᵀ | B₂ᵀ | …]."""
    apply_matmul_precision()
    nbatch, mb, nb = Bs.shape
    rhs = _f32(Bs).permute(2, 0, 1).reshape(nb, nbatch * mb)
    Y = torch.linalg.solve_triangular(_f32(L), rhs, upper=False)
    return Y.reshape(nb, nbatch, mb).permute(1, 2, 0).to(Bs.dtype)


def potrf_tile(A, infos: Optional[List[torch.Tensor]] = None):
    """A ← chol(A) lower (diagonal-tile Cholesky)."""
    return _chol(_f32(A), infos).to(A.dtype)


# ---- matmul-rich variants of the triangular kernels ---------------------
# The reference reformulates the in-tile solve and Cholesky around
# matmuls (the MAGMA/DPLASMA GPU trick: invert the diagonal block once,
# turn every solve into a GEMM). On the card the products go to cuBLAS
# and the base blocks to cuSOLVER.

def tri_inv_tile(L, base: int = 0):
    """L⁻¹ of a lower-triangular tile via recursive block inversion:
    [[L11, 0], [L21, L22]]⁻¹ = [[L11⁻¹, 0], [-L22⁻¹·L21·L11⁻¹, L22⁻¹]].
    All flops above the base case are matmuls."""
    apply_matmul_precision()
    base = base or int(mca_param.get("ops.tri_base", 256))

    def rec(T):
        n = T.shape[-1]
        if n <= base or n % 2:
            return torch.linalg.solve_triangular(T, _eye(n, T), upper=False)
        h = n // 2
        i11 = rec(T[..., :h, :h])
        i22 = rec(T[..., h:, h:])
        i21 = -torch.matmul(torch.matmul(i22, T[..., h:, :h]), i11)
        top = torch.cat([i11, torch.zeros_like(i21.mT)], dim=-1)
        return torch.cat([top, torch.cat([i21, i22], dim=-1)], dim=-2)

    return rec(_f32(L)).to(L.dtype)


def chol_inv_tile(A, base: int = 128,
                  infos: Optional[List[torch.Tensor]] = None):
    """(L, L⁻¹) of an SPD tile in ONE recursion: the panel solve uses the
    already-computed I11 as a matmul (L21 = A21·I11ᵀ) and the inverse
    assembles from blocks the recursion already has
    (I21 = −I22·L21·I11). The standalone-call form of the pair; the
    panel fusers keep chol-then-invert, as the reference's do."""
    apply_matmul_precision()

    def rec(T):
        n = T.shape[-1]
        if n <= base or n % 2:
            L = _chol(T, infos)
            return L, torch.linalg.solve_triangular(L, _eye(n, T),
                                                    upper=False)
        h = n // 2
        L11, I11 = rec(T[..., :h, :h])
        L21 = torch.matmul(T[..., h:, :h], I11.mT)
        S = T[..., h:, h:] - torch.matmul(L21, L21.mT)
        L22, I22 = rec(0.5 * (S + S.mT))
        I21 = -torch.matmul(I22, torch.matmul(L21, I11))
        Z = torch.zeros_like(L21.mT)
        L = torch.cat([torch.cat([L11, Z], dim=-1),
                       torch.cat([L21, L22], dim=-1)], dim=-2)
        Inv = torch.cat([torch.cat([I11, Z], dim=-1),
                         torch.cat([I21, I22], dim=-1)], dim=-2)
        return L, Inv

    L, Inv = rec(_f32(A))
    return L.to(A.dtype), Inv.to(A.dtype)


def potrf_tile_blocked(A, base: int = 0,
                       infos: Optional[List[torch.Tensor]] = None):
    """Blocked right-looking in-tile Cholesky: factor a ``base``-sized
    diagonal block, invert it (cheap at base size), and apply panel
    solve + trailing update as matmuls. Works on a private float32 copy
    of the tile, updated in place."""
    base = base or int(mca_param.get("ops.tri_base", 256))
    n = A.shape[-1]
    if n <= base:
        return potrf_tile(A, infos)
    apply_matmul_precision()
    Af = A.to(torch.float32, copy=True)
    L = torch.zeros_like(Af)
    for j in range(0, n, base):
        b = min(base, n - j)
        l11 = _chol(Af[..., j:j + b, j:j + b], infos)
        L[..., j:j + b, j:j + b] = l11
        if j + b < n:
            inv11 = torch.linalg.solve_triangular(l11, _eye(b, l11),
                                                  upper=False)
            panel = torch.matmul(Af[..., j + b:, j:j + b], inv11.mT)
            L[..., j + b:, j:j + b] = panel
            Af[..., j + b:, j + b:] -= torch.matmul(panel, panel.mT)
    return L.to(A.dtype)


def trsm_tiles_gemm(L, Bs):
    """Batched B_i ← B_i·L⁻ᵀ with a SHARED factor L, as one inversion
    plus one wide matmul: Y = [B₁; B₂; …]·(L⁻¹)ᵀ."""
    Linv = tri_inv_tile(L)
    wide = _f32(Bs).reshape(-1, Bs.shape[-1])
    Y = torch.matmul(wide, _f32(Linv).mT)
    return Y.reshape(Bs.shape).to(Bs.dtype)


def add_tile(A, B):
    return A + B


def scale_tile(A, alpha):
    return alpha * A
