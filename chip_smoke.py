"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from ``parsec_tpu_torch``'s
   sources with ``nvcc`` (into the git-ignored ``parsec_tpu_torch/_build/``).
2. Kernel phase: holds the hand-written flash-attention kernel against its
   plain PyTorch version on the card (run in full FP32), ``o`` and ``lse``,
   in both precision modes (``default``: one TF32 pass; ``highest``:
   3xTF32), at the tier-1 test shapes, a cross-attention shape, the main
   path's tile (also causal, so split-KV runs with wholly masked splits),
   S=1000 (ragged edges), a causal cross-attention shape, bf16 at dh=128
   and the bench shape; prints error and times (kernel, plain version,
   the device's lower bound for the mode, and
   ``scaled_dot_product_attention`` under the same knob as a yardstick
   the port never calls) on one ``kernel_shape`` line each. Then holds
   the split-KV combine kernel against its plain version on the main
   tile's partials (``combine_shape`` line).
3. Main path: ``parsec_tpu_torch.init(nb_cores=8)`` on ``cuda``, the PTG
   transformer block at S=16384, H=4, dh=128, F=2048 (TS=1024, 1024 ATT
   tasks), ``add_taskpool``/``start``/``wait``. Asserts that every ATT task
   launched the kernel (and the combine kernel), that every task ran on the
   CUDA device, and that ``Y`` matches a dense FP32 reference computed on
   the card. The ``main_path`` line adds the bytes staged onto the card and,
   from a ``torch.profiler`` pass over one extra step, the device time of
   both kernels and its share of the step's wall time.
4. Prints one JSON line describing the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero before the last line.
Without a GPU it exits 2 and prints nothing to standard output.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
TF32_PEAK = 495e12     # H100 SXM, dense TF32 tensor cores (data sheet)
BF16_PEAK = 989e12     # H100 SXM, dense bf16 tensor cores (data sheet)
HBM_RATE = 3.35e12     # H100 SXM device memory, bytes/s
MODES = {"highest": 3, "default": 1}   # ops.matmul_precision -> TF32 passes
# kernel vs plain version (full FP32) on the same inputs, max abs error
# allowed, per (input dtype, TF32 passes).
# - f32, 3 passes (3xTF32): FP32-level products, both sides sum in f32 in
#   different orders (~1e-6 observed).
# - f32, 1 pass: inputs and P rounded to TF32 (2^-11 relative), so each
#   score is off by ~sqrt(dh) * 2^-11 * scale (~4e-4 rms at unit-normal
#   inputs, dh=128), lse by a weighted mean of those and o by far less;
#   the CPU emulation (tests/test_torch_flash_split.py) stays well inside.
# - bf16: Q, K, V are exact in TF32 and both sides round o to bf16 once,
#   so one bf16 ulp of |o| < 4; P's TF32 rounding is far below that.
TOL = {("float32", 3): {"o": 5e-4, "lse": 1e-3},
       ("float32", 1): {"o": 1e-2, "lse": 1e-2},
       ("bfloat16", 3): {"o": 3e-2, "lse": 1e-3},
       ("bfloat16", 1): {"o": 3e-2, "lse": 1e-3}}
COMBINE_TOL = 1e-5     # the merge in f32, same formula, different order
# block output vs the dense FP32 reference: |Y - ref| <= ATOL + RTOL*|ref|
Y_ATOL, Y_RTOL = 1e-4, 1e-3

# (S, Sk, H, dh, causal, dtype)
MAIN_TILE = (1024, 1024, 1, 128, False, "float32")
BENCH = (16384, 16384, 4, 128, False, "float32")  # bench.py transformer row
SHAPES = [
    (256, 256, 2, 64, False, "float32"), (256, 256, 2, 64, True, "float32"),
    (256, 256, 1, 128, False, "float32"), (256, 256, 1, 128, True, "float32"),
    (384, 384, 2, 32, False, "float32"), (384, 384, 2, 32, True, "float32"),
    (128, 256, 2, 64, False, "float32"),          # cross attention
    (256, 256, 2, 64, True, "bfloat16"),
    MAIN_TILE,
    (1024, 1024, 1, 128, True, "float32"),        # split-KV, masked splits
    (1000, 1000, 1, 128, False, "float32"),       # ragged edges
    (384, 1024, 2, 128, True, "float32"),         # causal, Sk != S
    (1024, 1024, 1, 128, False, "bfloat16"),      # bf16 at dh = 128
    BENCH,
]


def time_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean time per call of ``fn`` over a warm run of calls, from CUDA
    events around the whole run: device time where the device is the
    bottleneck, the host's time per call where the host is."""
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


def _self_device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if us is None else us


def device_ms(fn, names=(), calls: int = 0):
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    duration of the kernels it runs (host gaps between them excluded),
    over a warm run of calls. Returns the total and, for each name in
    ``names``, the time of the kernels whose name contains it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    if not calls:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        calls = int(min(50, max(3, 0.2 / max(time.perf_counter() - t0, 1e-6))))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, parts = 0.0, dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        us = _self_device_us(e)
        total += us
        for n in names:
            if n in e.key:
                parts[n] += us
    if total == 0.0:
        raise AssertionError("torch.profiler saw no device time")
    return total / calls / 1e3, {n: v / calls / 1e3 for n, v in parts.items()}


def bound(S, Sk, H, dh, causal, dtype, passes):
    """Least time the card could take: inputs read once and outputs
    written once at the memory rate, against the multiply-adds this
    input needs (causal counts only the live (q, k) pairs) at the
    tensor-core peak of the arithmetic the mode uses: f32 at the TF32
    rate, times 3 for 3xTF32; bf16 at the bf16 rate."""
    esize = 4 if dtype == "float32" else 2
    nbytes = (S + 2 * Sk) * H * dh * esize + S * H * dh * esize + S * H * 4
    pairs = sum(min(qp + 1, Sk) for qp in range(S)) if causal else S * Sk
    flops = 4.0 * dh * H * pairs
    t_ops = (flops / BF16_PEAK if dtype == "bfloat16"
             else passes * flops / TF32_PEAK)
    t_bytes = nbytes / HBM_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


@contextlib.contextmanager
def precision(mode):
    """Run under ``ops.matmul_precision = mode`` with PyTorch's TF32
    flags set from it; restore both afterwards."""
    import torch
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.ops.precision import apply_matmul_precision
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    mca_param.set("ops.matmul_precision", mode)
    try:
        apply_matmul_precision()
        yield
    finally:
        mca_param.unset("ops.matmul_precision")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def kernel_phase(rng):
    import torch
    import torch.nn.functional as F
    from parsec_tpu_torch.ops.flash_attention import (
        _sm_count, flash_attention, flash_attention_reference, split_count)
    rows = {}
    for shape in SHAPES:
        S, Sk, H, dh, causal, dtype = shape
        dt = getattr(torch, dtype)
        q, k, v = (torch.as_tensor(rng.standard_normal((n, H, dh)),
                                   dtype=torch.float32).to("cuda", dt)
                   for n in (S, Sk, Sk))
        scale = 1.0 / math.sqrt(dh)
        qt, kt, vt = (x.permute(1, 0, 2).unsqueeze(0).contiguous()
                      for x in (q, k, v))
        with precision("highest"):     # the plain version in full FP32
            o_ref, lse_ref = flash_attention_reference(q, k, v, causal, scale)
            plain_ms, _ = device_ms(lambda: flash_attention_reference(
                q, k, v, causal, scale))
        for mode, passes in MODES.items():
            tol = TOL[(dtype, passes)]
            with precision(mode):
                o, lse = flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
                torch.cuda.synchronize()
                torch.cuda.synchronize()
                err_o = (o.float() - o_ref.float()).abs().max().item()
                err_l = (lse - lse_ref).abs().max().item()
                if not (math.isfinite(err_o) and math.isfinite(err_l)) or \
                        err_o > tol["o"] or err_l > tol["lse"]:
                    raise AssertionError(
                        f"flash kernel disagrees with its plain version at "
                        f"{shape} in {mode} mode: max|o| err {err_o}, "
                        f"max|lse| err {err_l}, tol {tol}")
                call = lambda: flash_attention(  # noqa: E731
                    q, k, v, causal=causal, return_lse=True)
                call_ms = time_ms(call)
                ms, kern = device_ms(call, ("fa_fwd_kernel",
                                            "fa_combine_kernel"))
                library_ms, _ = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, scale=scale))
            bound_ms, bound_by = bound(*shape, passes)
            row = {"shape": {"S": S, "Sk": Sk, "H": H, "dh": dh,
                             "causal": causal, "dtype": dtype},
                   "mode": mode, "passes": passes,
                   "n_split": split_count(S, Sk, H, _sm_count(q.device)),
                   "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
                   "tol": tol, "ms": ms,
                   "fwd_ms": kern["fa_fwd_kernel"],
                   "combine_ms": kern["fa_combine_kernel"],
                   "call_ms": call_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "share_of_bound": bound_ms / ms}
            print("kernel_shape " + json.dumps(row), flush=True)
            rows[(shape, mode)] = row
        del q, k, v, o, lse, o_ref, lse_ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def combine_phase(rng):
    """The combine kernel at the main path's shapes: the main tile's split
    partials from the plain version, merged by the kernel and by its
    plain version."""
    import torch
    from parsec_tpu_torch.ops.flash_attention import (
        _sm_count, combine_reference, combine_splits,
        flash_attention_reference, split_bounds, split_count)
    S, Sk, H, dh = MAIN_TILE[:4]
    q, k, v = (torch.as_tensor(rng.standard_normal((n, H, dh)),
                               dtype=torch.float32).to("cuda")
               for n in (S, Sk, Sk))
    n_split = split_count(S, Sk, H, _sm_count(q.device))
    with precision("highest"):
        parts = [flash_attention_reference(q, k[lo:hi], v[lo:hi], False,
                                           1.0 / math.sqrt(dh), k_offset=lo)
                 for lo, hi in split_bounds(Sk, n_split)]
        o_part = torch.stack([p[0] for p in parts]).contiguous()
        lse_part = torch.stack([p[1] for p in parts]).contiguous()
        o, lse = combine_splits(o_part, lse_part)
        o_ref, lse_ref = combine_reference(o_part, lse_part)
        torch.cuda.synchronize()
        err = max((o - o_ref).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        if not math.isfinite(err) or err > COMBINE_TOL:
            raise AssertionError(f"combine kernel disagrees with its plain "
                                 f"version: max abs err {err}")
        ms, _ = device_ms(lambda: combine_splits(o_part, lse_part))
        plain_ms, _ = device_ms(lambda: combine_reference(o_part, lse_part))
    nbytes = 4 * (n_split * S * H * (dh + 1) + S * H * (dh + 1))
    row = {"n_split": n_split, "S": S, "H": H, "dh": dh,
           "max_abs_err": err, "tol": COMBINE_TOL, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_RATE * 1e3,
           "bound_by": "bytes", "library_ms": None}
    print("combine_shape " + json.dumps(row), flush=True)
    return row


def profile_step(run_step):
    """Device time of the flash and combine kernels, and of every kernel,
    over one block step under ``torch.profiler``; the step's wall time
    under the profiler. ``None`` for device times the profiler did not
    see."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run_step()
    fa = comb = total = 0.0
    for e in prof.key_averages():
        us = _self_device_us(e)
        total += us
        if "fa_fwd_kernel" in e.key:
            fa += us
        elif "fa_combine_kernel" in e.key:
            comb += us
    seen = fa > 0.0
    return {"profiled_wall_s": wall,
            "flash_device_s": fa * 1e-6 if seen else None,
            "combine_device_s": comb * 1e-6 if seen else None,
            "all_kernels_device_s": total * 1e-6 if seen else None}


def main_path(rng):
    import torch
    import parsec_tpu_torch as parsec
    from parsec_tpu_torch.algorithms.transformer import (
        build_transformer_block, params_from_reference, reference_block,
        tiles_from_reference)
    from parsec_tpu_torch.core.task import DeviceType
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.ops.flash_attention import (
        combine_splits, flash_attention)

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
        weights = params_from_reference(Wo, W1, W2, device="cuda")

        def block():
            """A fresh block step: Q/K/V tiles on the host, as a user
            hands them in."""
            Qc, Kc, Vc = tiles_from_reference(q, k, v, TS, device="cpu")
            Y = LocalCollection("Y", {(i,): None for i in range(T)})
            return (build_transformer_block(Qc, Kc, Vc, Y, H, T, TS, dh,
                                            *weights), (Qc, Kc, Vc), Y)

        def run(tp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ctx.start()
            if not ctx.wait(timeout=600):
                raise AssertionError("transformer block did not terminate")
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        tp, qkv, Y = block()
        n_tasks = sum(tc.nb_local_tasks() for tc in tp.task_classes)
        flash_attention.launches = 0
        combine_splits.launches = 0
        wall = run(tp)
        launches = flash_attention.launches
        combine_launches = combine_splits.launches
        cpu_tasks = ctx.devices.by_type(DeviceType.CPU)[0].stats["tasks"]
        cuda_tasks = cuda_devs[0].stats["tasks"]
        bytes_in = cuda_devs[0].stats["bytes_in"]
        # Q/K/V tiles the context staged once into the collections
        # (Context.stage_read), not counted by the device's bytes_in
        staged = sum(c.data_of(key).nbytes for c in qkv for key in c.keys()
                     if c.data_of(key).device.type == "cuda")
        tp2, _, _ = block()
        prof = profile_step(lambda: run(tp2))
    finally:
        parsec.fini(ctx)
    if launches != H * T * T:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {H * T * T} (one per ATT task)")
    if combine_launches == 0:
        raise AssertionError("the combine kernel never ran on the main path")
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
    kern_s = (None if prof["flash_device_s"] is None
              else prof["flash_device_s"] + prof["combine_device_s"])
    out = {"S": S, "H": H, "dh": dh, "F": F, "TS": TS, "tasks": n_tasks,
           "flash_launches": launches, "combine_launches": combine_launches,
           "wall_s": wall, "tasks_per_s": n_tasks / wall,
           "max_abs_err": err.max().item(),
           "max_abs_ref": ref.abs().max().item(),
           "matmul_precision": "highest",
           "device_bytes_in": bytes_in, "collection_bytes_staged": staged,
           "kernels_device_s": kern_s,
           "kernels_share_of_wall": None if kern_s is None else kern_s / wall,
           **prof}
    print("main_path " + json.dumps(out), flush=True)
    return launches, combine_launches


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
    comb = combine_phase(rng)
    launches, combine_launches = main_path(rng)

    src = "parsec_tpu_torch/ops/csrc/flash_attention.cu"
    tile = rows[(MAIN_TILE, "highest")]     # the main path's mode
    kernels = [{
        "name": "flash_attention",
        "route": "cuda", "source": src,
        "replaces": "parsec_tpu/ops/flash_attention.py:44",
        "launches": launches,
        "max_abs_err": max(tile["max_abs_err_o"], tile["max_abs_err_lse"]),
        "ms": tile["fwd_ms"], "plain_ms": tile["plain_ms"],
        "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
        "library_ms": tile["library_ms"],
    }, {
        "name": "flash_attention_combine",
        "route": "cuda", "source": src,
        "replaces": "parsec_tpu/ops/flash_attention.py:44",
        "launches": combine_launches,
        "max_abs_err": comb["max_abs_err"],
        "ms": comb["ms"], "plain_ms": comb["plain_ms"],
        "bound_ms": comb["bound_ms"], "bound_by": comb["bound_by"],
        "library_ms": comb["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
