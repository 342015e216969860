"""Shipped task-graph algorithms. This slice ports the transformer block."""

from .transformer import build_transformer_block, reference_block
