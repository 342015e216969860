"""Matmul precision knob for the port's tile bodies.

The port's copy of ``ops.matmul_precision`` (reference package,
``ops/tile_kernels.py:20-32``). There the knob chooses between the TPU's
bf16 MXU passes (``default``) and f32 emulation (``high``/``highest``).
Here it chooses between TF32 tensor-core products and full FP32:

- ``default``: TF32 allowed for ``torch.matmul`` and cuDNN;
- ``high`` and ``highest``: full FP32 for both.

PyTorch keeps these as two process-wide flags,
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``; :func:`apply_matmul_precision` sets
both explicitly so the mode in force never depends on PyTorch's defaults
(matmul FP32, cuDNN TF32). The hand-written flash kernel reads the knob
itself (``flash_attention.tf32_passes``), as the reference kernel does:
one TF32 tensor-core pass per product under ``default``, 3xTF32
(FP32-level accuracy) under ``high`` and ``highest``; it accumulates in
FP32 either way.
"""

from __future__ import annotations

import torch

from ..utils import mca_param

mca_param.register("ops.matmul_precision", "default",
                   help="matmul precision for tile bodies: default (TF32) "
                        "| high | highest (full FP32)",
                   choices=("default", "high", "highest"))


def matmul_precision() -> str:
    """The configured precision: ``default``, ``high`` or ``highest``."""
    return str(mca_param.get("ops.matmul_precision", "default"))


def apply_matmul_precision() -> str:
    """Set both TF32 flags from the knob and return the mode in force."""
    mode = matmul_precision()
    tf32 = mode == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return mode
