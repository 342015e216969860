"""Tile kernels: the hand-written Hopper flash-attention kernel
(:mod:`.flash_attention`) and the matmul precision knob."""

from .precision import matmul_precision, apply_matmul_precision
