"""Shipped task-graph algorithms: the transformer block and the tiled
Cholesky (right- and left-looking)."""

from .transformer import build_transformer_block, reference_block
from .potrf import build_potrf, build_potrf_left, potrf_flops
