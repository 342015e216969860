"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from ``parsec_tpu_torch``'s
   sources with ``nvcc`` (into the git-ignored ``parsec_tpu_torch/_build/``).
2. Kernel phase: holds the hand-written flash-attention kernel against its
   plain PyTorch version on the card, ``o`` and ``lse``, at the tier-1
   test shapes, a cross-attention shape, the main path's tile and the
   bench shape; prints error and times (kernel, plain version, the
   device's lower bound, and ``scaled_dot_product_attention`` as a
   yardstick the port never calls).
3. Main path: ``parsec_tpu_torch.init(nb_cores=8)`` on ``cuda``, the PTG
   transformer block at S=16384, H=4, dh=128, F=2048 (TS=1024, 1024 ATT
   tasks), ``add_taskpool``/``start``/``wait``. Asserts that every ATT task
   launched the kernel, that every task ran on the CUDA device, and that
   ``Y`` matches a dense FP32 reference computed on the card.
4. Prints one JSON line describing the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero before the last line.
Without a GPU it exits 2 and prints nothing to standard output.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
FP32_PEAK = 67e12      # H100 SXM, FP32 on the CUDA cores (data sheet)
BF16_PEAK = 989e12     # H100 SXM, dense bf16 tensor cores (data sheet)
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
# kernel vs plain version on the same inputs, max abs error allowed.
# f32: both sum in FP32 in different orders (~1e-6 relative observed
# scale); bf16: both round o to bf16 once, so one bf16 ulp of |o| < 4.
TOL = {"float32": {"o": 5e-4, "lse": 1e-3},
       "bfloat16": {"o": 3e-2, "lse": 1e-3}}
# block output vs the dense FP32 reference: |Y - ref| <= ATOL + RTOL*|ref|
Y_ATOL, Y_RTOL = 1e-4, 1e-3

# (S, Sk, H, dh, causal, dtype)
MAIN_TILE = (1024, 1024, 1, 128, False, "float32")
SHAPES = [
    (256, 256, 2, 64, False, "float32"), (256, 256, 2, 64, True, "float32"),
    (256, 256, 1, 128, False, "float32"), (256, 256, 1, 128, True, "float32"),
    (384, 384, 2, 32, False, "float32"), (384, 384, 2, 32, True, "float32"),
    (128, 256, 2, 64, False, "float32"),          # cross attention
    (256, 256, 2, 64, True, "bfloat16"),
    MAIN_TILE,
    (16384, 16384, 4, 128, False, "float32"),     # bench.py transformer row
]


def time_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean device time of ``fn`` over a warm run of launches (CUDA
    events around the whole run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(50, max(3, budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(S, Sk, H, dh, causal, dtype):
    """Least time the card could take: inputs read once and outputs
    written once at the memory rate, against the multiply-adds this
    input needs (causal counts only the live (q, k) pairs) at the peak
    rate of the input type."""
    esize = 4 if dtype == "float32" else 2
    nbytes = (S + 2 * Sk) * H * dh * esize + S * H * dh * esize + S * H * 4
    pairs = sum(min(qp + 1, Sk) for qp in range(S)) if causal else S * Sk
    flops = 4.0 * dh * H * pairs
    peak = FP32_PEAK if dtype == "float32" else BF16_PEAK
    t_bytes, t_ops = nbytes / HBM_RATE, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def kernel_phase(rng):
    import torch
    import torch.nn.functional as F
    from parsec_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = {}
    for shape in SHAPES:
        S, Sk, H, dh, causal, dtype = shape
        dt = getattr(torch, dtype)
        q, k, v = (torch.as_tensor(rng.standard_normal((n, H, dh)),
                                   dtype=torch.float32).to("cuda", dt)
                   for n in (S, Sk, Sk))
        scale = 1.0 / math.sqrt(dh)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        if not (math.isfinite(err_o) and math.isfinite(err_l)) or \
                err_o > TOL[dtype]["o"] or err_l > TOL[dtype]["lse"]:
            raise AssertionError(
                f"flash kernel disagrees with its plain version at {shape}: "
                f"max|o| err {err_o}, max|lse| err {err_l}, tol {TOL[dtype]}")
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             return_lse=True))
        plain_ms = time_ms(lambda: flash_attention_reference(
            q, k, v, causal, scale))
        qt, kt, vt = (x.permute(1, 0, 2).unsqueeze(0).contiguous()
                      for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
        bound_ms, bound_by = bound(*shape)
        row = {"shape": {"S": S, "Sk": Sk, "H": H, "dh": dh,
                         "causal": causal, "dtype": dtype},
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("kernel_shape " + json.dumps(row), flush=True)
        rows[shape] = row
        del q, k, v, o, lse, o_ref, lse_ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def main_path(rng):
    import torch
    import parsec_tpu_torch as parsec
    from parsec_tpu_torch.algorithms.transformer import (
        build_transformer_block, params_from_reference, reference_block,
        tiles_from_reference)
    from parsec_tpu_torch.core.task import DeviceType
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.ops.flash_attention import flash_attention

    S, H, dh, F, TS = 16384, 4, 128, 2048, 1024
    T, D = S // TS, H * dh
    q, k, v = (rng.standard_normal((H, S, dh)).astype(np.float32)
               for _ in range(3))
    Wo = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    W1 = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
    W2 = (rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32)

    parsec.mca_param.set("ops.matmul_precision", "highest")
    ctx = parsec.init(nb_cores=8)
    try:
        cuda_devs = ctx.devices.by_type(DeviceType.CUDA)
        if len(cuda_devs) != 1:
            raise AssertionError(f"expected one CUDA device module, got "
                                 f"{[d.name for d in cuda_devs]}")
        Qc, Kc, Vc = tiles_from_reference(q, k, v, TS, device="cpu")
        Y = LocalCollection("Y", {(i,): None for i in range(T)})
        weights = params_from_reference(Wo, W1, W2, device="cuda")
        tp = build_transformer_block(Qc, Kc, Vc, Y, H, T, TS, dh, *weights)
        n_tasks = sum(tc.nb_local_tasks() for tc in tp.task_classes)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        ctx.add_taskpool(tp)
        ctx.start()
        if not ctx.wait(timeout=600):
            raise AssertionError("transformer block did not terminate")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        cpu_tasks = ctx.devices.by_type(DeviceType.CPU)[0].stats["tasks"]
        cuda_tasks = cuda_devs[0].stats["tasks"]
    finally:
        parsec.fini(ctx)
    if launches != H * T * T:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {H * T * T} (one per ATT task)")
    if cuda_tasks != n_tasks or cpu_tasks != 0:
        raise AssertionError(f"tasks on cuda {cuda_tasks}, on cpu "
                             f"{cpu_tasks}, expected all {n_tasks} on cuda")
    got = torch.cat([Y.data_of((i,)) for i in range(T)])
    ref = reference_block(*(torch.as_tensor(x).to("cuda")
                            for x in (q, k, v)), *weights, chunk=2048)
    if got.shape != (S, D) or not torch.isfinite(got).all():
        raise AssertionError(f"block output {tuple(got.shape)} not finite "
                             f"or not ({S}, {D})")
    err = (got - ref).abs()
    if not (err <= Y_ATOL + Y_RTOL * ref.abs()).all():
        raise AssertionError(f"block output off the dense reference: max "
                             f"abs err {err.max().item()}")
    out = {"S": S, "H": H, "dh": dh, "F": F, "TS": TS, "tasks": n_tasks,
           "flash_launches": launches, "wall_s": wall,
           "tasks_per_s": n_tasks / wall, "max_abs_err": err.max().item(),
           "max_abs_ref": ref.abs().max().item(),
           "matmul_precision": "highest"}
    print("main_path " + json.dumps(out), flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from parsec_tpu_torch.ops import flash_attention as fa_mod, nvcc
    fa_mod._library()
    print(f"build flash_attention.cu: {nvcc.build_seconds['flash_attention']:.2f} s",
          flush=True)
    print(nvcc.build_log.get("flash_attention", ""), flush=True)

    rng = np.random.default_rng(SEED)
    rows = kernel_phase(rng)
    launches = main_path(rng)

    tile = rows[MAIN_TILE]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "parsec_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "parsec_tpu/ops/flash_attention.py:44",
        "launches": launches,
        "max_abs_err": max(tile["max_abs_err_o"], tile["max_abs_err_lse"]),
        "ms": tile["ms"], "plain_ms": tile["plain_ms"],
        "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
        "library_ms": tile["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
