"""Tile kernels: the hand-written Hopper flash-attention kernel
(:mod:`.flash_attention`), the tiled-Cholesky tile kernels on cuBLAS and
cuSOLVER (:mod:`.tile_kernels`) and the matmul precision knob."""

from .precision import matmul_precision, apply_matmul_precision
