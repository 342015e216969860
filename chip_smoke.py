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
4. POTRF panel path (``potrf_path`` lines): the flagship tiled Cholesky at
   the reference's own width, N=40960, NB=1024 (NT=40, 1600 tasks, 118
   waves), f32, left-looking, ``plan_taskpool`` → ``PanelExecutor`` on
   ``cuda``, in two modes: ``potrf.trsm_hook=gemm`` under
   ``ops.matmul_precision=default`` (TF32 products) and ``solve`` under
   ``highest`` (FP32). The input A₀ = ½(M+Mᵀ) + 2N·I is made on the card
   from a seeded ``torch.Generator``. Each line gives the host time to
   plan and build the executor, the median wall time of three runs from a
   fresh state, GFLOP/s, the share of the card's bound for the mode, the
   time of ``torch.linalg.cholesky`` (cuSOLVER) on A₀ in the same mode,
   the probe residual ‖(LLᵀ−A₀)x‖/‖A₀x‖ in full FP32, and, from one
   ``torch.profiler`` pass, the kernels' device time, the share of the
   wall time the card is busy and the five kernels with the most device
   time; and the peak device memory.
5. POTRF on the host runtime (``potrf_host`` lines): ``init(nb_cores=8)``
   on ``cuda``, ``build_potrf`` and ``build_potrf_left`` at N=8192,
   NB=1024, ``highest``; every task must run on the CUDA device module.
6. Prints one JSON line describing the hand-written kernels (the POTRF
   path has none: its tile bodies run on cuBLAS and cuSOLVER), then the
   last line ``{"ok": true, "device": {...}}``.

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
FP32_PEAK = 67e12      # H100 SXM, float32 outside the tensor cores
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

# POTRF flagship (bench.py's headline configuration): N, NB, and per
# mode (potrf.trsm_hook, ops.matmul_precision, peak FLOP/s of the
# products the mode runs, probe-residual tolerance). gemm/default squares
# the diagonal factor's condition number and rounds products to TF32;
# solve/highest is the reference numerics (4.5e-7 measured there).
POTRF_N, POTRF_NB = 40960, 1024
POTRF_MODES = [("gemm", "default", TF32_PEAK, 1e-3),
               ("solve", "highest", FP32_PEAK, 1e-5)]
POTRF_HOST_N = 8192
POTRF_RUNS = 3

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


def device_events(prof):
    """The device side of a ``torch.profiler`` pass (kernels, copies,
    memsets): their summed time (s), the time the device was busy (s,
    the union of their intervals) and ``{name: (summed s, count)}``.
    The host-side op events are left out: an op's "self device time"
    repeats the time of the kernels it launched."""
    import torch
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU or \
                getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        s, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (s + e.time_range.elapsed_us() * 1e-6, c + 1)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return (sum(b - a for a, b in spans) * 1e-6, busy * 1e-6, by_name)


def profile_step(run_step):
    """Device time of the flash and combine kernels, and of every kernel,
    over one block step under ``torch.profiler``; the step's wall time
    under the profiler. ``None`` for device times the profiler did not
    see."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run_step()
    total, _busy, by_name = device_events(prof)
    fa = sum(s for n, (s, _c) in by_name.items() if "fa_fwd_kernel" in n)
    comb = sum(s for n, (s, _c) in by_name.items()
               if "fa_combine_kernel" in n)
    seen = fa > 0.0
    return {"profiled_wall_s": wall,
            "flash_device_s": fa if seen else None,
            "combine_device_s": comb if seen else None,
            "all_kernels_device_s": total if seen else None}


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


@contextlib.contextmanager
def knob(name, value):
    """Run with the MCA parameter ``name`` set to ``value``."""
    from parsec_tpu_torch import mca_param
    mca_param.set(name, value)
    try:
        yield
    finally:
        mca_param.unset(name)


def spd_on_card(n, gen):
    """A₀ = ½(M+Mᵀ) + 2n·I on the card, M standard normal from ``gen``:
    exactly symmetric, diagonally dominant."""
    import torch
    M = torch.randn(n, n, generator=gen, device="cuda")
    A0 = M + M.mT
    del M
    A0.mul_(0.5)
    A0.diagonal().add_(2.0 * n)
    return A0


def probe_residual(Lt, A0, nb, x):
    """‖(LLᵀ−A₀)x‖/‖A₀x‖, L read from the upper block triangle of ``Lt``
    (Lᵀ there: the panel executor's transposed state, whose diagonal
    blocks are exactly upper-triangular), computed block by block in
    ``x``'s dtype. In float32 it runs in full FP32 whatever the
    factorisation's mode: TF32 products in the probe would floor the
    residual near 1e-3 (bench.py:2246-2250). In float64 the probe's own
    rounding drops out and what is left is the factor's error."""
    import torch
    nt = A0.shape[0] // nb
    dt = x.dtype
    with precision("highest"):
        y = torch.cat([A0[i * nb:(i + 1) * nb].to(dt) @ x
                       for i in range(nt)])
        z = torch.cat([Lt[j * nb:(j + 1) * nb, j * nb:].to(dt) @ x[j * nb:]
                       for j in range(nt)])
        y2 = torch.cat([Lt[:(i + 1) * nb, i * nb:(i + 1) * nb].to(dt).mT
                        @ z[:(i + 1) * nb] for i in range(nt)])
        return ((y2 - y).norm() / y.norm()).item()


def probe_residuals(Lt, A0, nb, gen):
    """The probe with one x ~ N(0, 1) of shape (N, 8) from ``gen``, in
    float32 (the checked residual) and in float64."""
    import torch
    x = torch.randn(A0.shape[0], 8, generator=gen, device="cuda")
    return (probe_residual(Lt, A0, nb, x),
            probe_residual(Lt, A0, nb, x.double()))


def median_time(fn, prepare, runs):
    """Median wall time of ``runs`` calls of ``fn(prepare())``, each
    bracketed by ``torch.cuda.synchronize()``, after one untimed call;
    returns it with the last call's result."""
    import torch
    times = []
    out = None
    for r in range(runs + 1):
        out = None              # free the last result before the next
        arg = prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        if r:
            times.append(time.perf_counter() - t0)
        del arg
    return sorted(times)[len(times) // 2], times, out


def potrf_path():
    """The flagship: left-looking POTRF through the planner and the
    panel executor at N=40960, NB=1024, in both modes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from parsec_tpu_torch.algorithms.potrf import (build_potrf_left,
                                                   potrf_flops)
    from parsec_tpu_torch.compiled import PanelExecutor, plan_taskpool
    from parsec_tpu_torch.data import TiledMatrix
    N, NB = POTRF_N, POTRF_NB
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    A0 = spd_on_card(N, gen)
    flops = potrf_flops(N)
    rows = []
    for hook, mode, peak, tol in POTRF_MODES:
        with knob("potrf.trsm_hook", hook), precision(mode):
            # plan over an empty TiledMatrix: the planner only needs the
            # tile grid; the state is made on the card
            t0 = time.perf_counter()
            plan = plan_taskpool(build_potrf_left(
                TiledMatrix(N, N, NB, NB, name="A")))
            plan_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ex = PanelExecutor(plan, device="cuda")
            build_s = time.perf_counter() - t0
            # D = A₀ᵀ = A₀ (symmetric): the transposed state
            state_bytes = A0.nbytes
            torch.cuda.reset_peak_memory_stats()
            wall, walls, out = median_time(
                ex.run_state, lambda: {"A": A0.clone()}, POTRF_RUNS)
            peak_mem = torch.cuda.max_memory_allocated()
            resident = torch.cuda.memory_allocated()
            Lt = out["A"]
            if Lt.shape != (N, N) or not torch.isfinite(
                    torch.triu(Lt)).all():
                raise AssertionError(f"factor {tuple(Lt.shape)} not finite "
                                     f"or not ({N}, {N})")
            del out
            # one profiled run from a fresh state
            state = {"A": A0.clone()}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex.run_state(state)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            del state
            dev_s, busy_s, by_name = device_events(prof)
            if dev_s == 0.0:
                raise AssertionError("torch.profiler saw no device time "
                                     "in the POTRF run")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
            # the one PyTorch call that computes the same function
            lib_ms, lib_walls, Lref = median_time(
                torch.linalg.cholesky, lambda: A0, POTRF_RUNS)
            del Lref
            torch.cuda.empty_cache()
        resid, resid64 = probe_residuals(Lt, A0, NB, gen)
        del Lt
        torch.cuda.empty_cache()
        if not math.isfinite(resid) or resid > tol:
            raise AssertionError(f"POTRF {hook}/{mode}: probe residual "
                                 f"{resid} above {tol}")
        row = {"N": N, "NB": NB, "NT": N // NB, "tasks": plan.n_tasks,
               "waves": plan.n_waves, "dtype": "float32",
               "trsm_hook": hook, "matmul_precision": mode,
               "plan_s": plan_s, "build_executor_s": build_s,
               "wall_s": wall, "wall_s_runs": walls,
               "gflops": flops / wall / 1e9,
               "bound_s": flops / peak, "bound_tflops": peak / 1e12,
               "share_of_bound": flops / peak / wall,
               "cholesky_library_s": lib_ms, "cholesky_library_runs":
               lib_walls, "residual": resid, "tol": tol,
               "residual_fp64_probe": resid64,
               "profiled_wall_s": prof_wall, "device_s": dev_s,
               "device_busy_s": busy_s,
               "device_busy_share": busy_s / prof_wall,
               # the profiler slows the host, not the kernels: the same
               # busy time over the unprofiled median wall
               "device_busy_over_wall": busy_s / wall,
               "device_kernels": sum(c for _s, c in by_name.values()),
               "top_kernels": [{"name": n[:120], "s": s, "count": c}
                               for n, (s, c) in top],
               "state_bytes": state_bytes,
               "peak_mem_bytes": peak_mem,
               "peak_over_resident_bytes": peak_mem - resident}
        print("potrf_path " + json.dumps(row), flush=True)
        rows.append(row)
    del A0
    torch.cuda.empty_cache()
    return rows


def potrf_host():
    """POTRF through the host runtime on the card, both builders, at
    N=8192, NB=1024 (NT=8): host tiles in, every task on the CUDA
    device module."""
    import torch
    import parsec_tpu_torch as parsec
    from parsec_tpu_torch.algorithms.potrf import (build_potrf,
                                                   build_potrf_left)
    from parsec_tpu_torch.core.task import DeviceType
    from parsec_tpu_torch.data import TiledMatrix
    N, NB = POTRF_HOST_N, POTRF_NB
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    A0 = spd_on_card(N, gen)
    host = A0.cpu().numpy()
    rows = []
    with precision("highest"):
        ctx = parsec.init(nb_cores=8)
        try:
            [cuda_dev] = ctx.devices.by_type(DeviceType.CUDA)
            [cpu_dev] = ctx.devices.by_type(DeviceType.CPU)
            for build in (build_potrf, build_potrf_left):
                A = TiledMatrix.from_array(host, NB, NB, name="A")
                tp = build(A)
                n_tasks = sum(tc.nb_local_tasks() for tc in tp.task_classes)
                on_cuda, on_cpu = (cuda_dev.stats["tasks"],
                                   cpu_dev.stats["tasks"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ctx.add_taskpool(tp)
                ctx.start()
                if not ctx.wait(timeout=600):
                    raise AssertionError(f"{build.__name__} did not "
                                         f"terminate")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                on_cuda = cuda_dev.stats["tasks"] - on_cuda
                on_cpu = cpu_dev.stats["tasks"] - on_cpu
                if on_cuda != n_tasks or on_cpu != 0:
                    raise AssertionError(
                        f"{build.__name__}: tasks on cuda {on_cuda}, on "
                        f"cpu {on_cpu}, expected all {n_tasks} on cuda")
                # Lᵀ in transposed-state form for the probe
                Lt = torch.zeros(N, N, device="cuda")
                for i in range(N // NB):
                    for j in range(i + 1):
                        t = A.data_of((i, j))
                        if not (isinstance(t, torch.Tensor) and
                                t.device.type == "cuda"):
                            raise AssertionError(
                                f"{build.__name__}: tile {(i, j)} was not "
                                f"written back on the card")
                        Lt[j * NB:(j + 1) * NB, i * NB:(i + 1) * NB] = \
                            (torch.tril(t) if i == j else t).mT
                resid, resid64 = probe_residuals(Lt, A0, NB, gen)
                if not math.isfinite(resid) or resid > 1e-5:
                    raise AssertionError(f"{build.__name__}: probe residual "
                                         f"{resid} above 1e-5")
                row = {"builder": build.__name__, "N": N, "NB": NB,
                       "NT": N // NB, "tasks": n_tasks,
                       "tasks_on_cuda": on_cuda, "tasks_on_cpu": on_cpu,
                       "nb_cores": ctx.nb_cores,
                       "matmul_precision": "highest", "wall_s": wall,
                       "tasks_per_s": n_tasks / wall, "residual": resid,
                       "tol": 1e-5, "residual_fp64_probe": resid64}
                print("potrf_host " + json.dumps(row), flush=True)
                rows.append(row)
                del Lt, A
        finally:
            parsec.fini(ctx)
    del A0
    torch.cuda.empty_cache()
    return rows


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
    potrf_path()
    potrf_host()

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
