"""Where the flash-attention kernel's time goes, on one GPU.

    python3 flash_breakdown.py

Builds ``parsec_tpu_torch/ops/csrc/flash_attention.cu`` as it is, and two
variants made from the same source, into the git-ignored
``parsec_tpu_torch/_build/``:

- ``producer_only``: the consumer issues no wgmma (it still waits for each
  tile, runs the softmax and hands the stage back), so the time is the
  producer's: loads, TF32 rounding and splitting, the transposed stores;
- ``consumer_only``: the producer neither loads nor stores (it still
  hands over every stage), so the time is the consumer's: both products
  and the softmax, on whatever the ring holds.

Times each with CUDA events at the bench shape (16384 x 4 x 128, f32) in
both precision modes (1 and 3 TF32 passes) and prints one JSON line per
(variant, passes) after the card's name and power limit. The variants
are for measurement only: their results are not attention.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SHAPE = (16384, 16384, 4, 128)   # S, Sk, H, dh: the bench.py transformer row
CALLS = 10


def variants(src: str) -> dict:
    def drop(text: str, old: str) -> str:
        if text.count(old) != 1:
            raise SystemExit(f"flash_breakdown: source changed, cannot find "
                             f"{old!r} once")
        return text.replace(old, "")

    producer_only = src.replace("Wg<BK>::ss(", "if (0) Wg<BK>::ss(") \
        .replace("Wg<BK>::rs(", "if (0) Wg<BK>::rs(") \
        .replace("Wg<DHP>::rs(", "if (0) Wg<DHP>::rs(")
    consumer_only = src
    for line in ("ks.store(kbuf, sK);",
                 "vs.store(vbuf, sK + NP * C::T_FLOATS);",
                 "ks.load(kbuf, k, k_lo + (i + 1) * BK, Sk);",
                 "vs.load(vbuf, v, k_lo + (i + 1) * BK, Sk);"):
        consumer_only = drop(consumer_only, line)
    return {"kernel": src, "producer_only": producer_only,
            "consumer_only": consumer_only}


def build(name: str, src: str) -> str:
    from parsec_tpu_torch.ops import nvcc
    tag = hashlib.sha256((src + " ".join(nvcc.NVCC_FLAGS)).encode()).hexdigest()[:16]
    so = os.path.join(nvcc.BUILD_DIR, f"libflash_{name}.{tag}.so")
    if not os.path.exists(so):
        os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
        cu = so[:-3] + ".cu"
        with open(cu, "w") as fh:
            fh.write(src)
        proc = subprocess.run([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", so, cu],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_breakdown: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    from parsec_tpu_torch.ops import nvcc
    with open(os.path.join(nvcc.CSRC, "flash_attention.cu")) as fh:
        srcs = variants(fh.read())
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(*kv), srcs.items())))

    S, Sk, H, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((n, H, dh), device="cuda", generator=gen)
               for n in (S, Sk, Sk))
    o = torch.empty_like(q)
    lse = torch.empty((S, H), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        lib.fa_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for passes in (1, 3):
            def call():
                rc = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(), None, S, Sk, H,
                                dh, dh ** -0.5, 0, 0, passes, 1, stream)
                if rc != 0:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                call()
            end.record()
            end.synchronize()
            print(json.dumps({"variant": name, "passes": passes,
                              "shape": {"S": S, "Sk": Sk, "H": H, "dh": dh},
                              "ms": start.elapsed_time(end) / CALLS}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
