"""CUDA device module: one instance per GPU.

Counterpart of the reference package's ``device/tpu.py`` and of PaRSEC's
CUDA pipeline (mca/device/cuda/device_cuda_module.c). This slice carries
the synchronous path only: the worker thread stages every input of the
task onto this module's GPU with ``.to(device, non_blocking=True)`` and
calls the hook directly. Kernels go onto the thread's current stream of
that device; PyTorch's stream ordering keeps successive tasks in order
without a host synchronisation. The batching manager
(``progress_stream`` analog) is a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .base import Device
from ..core.task import Chore, DeviceType, HookReturn, Task


class CUDADevice(Device):
    device_type = DeviceType.CUDA
    platform = "cuda"

    def __init__(self, index: int) -> None:
        super().__init__()
        self.torch_device = torch.device("cuda", index)
        self.name = f"cuda{index}"
        # accelerators out-throughput the inline CPU device (reference
        # GFLOPS table device_cuda_module.c:53)
        self.weight = 100.0

    def _count_in(self, nbytes: int) -> None:
        with self._lock:
            self.stats["bytes_in"] += nbytes

    def _stage(self, value: Any) -> Any:
        """Move one flow value (a tensor, a numpy array, or a tuple/list
        of them) onto this GPU; anything else passes through."""
        if isinstance(value, torch.Tensor):
            if value.device != self.torch_device:
                self._count_in(value.nbytes)
                return value.to(self.torch_device, non_blocking=True)
            return value
        if isinstance(value, np.ndarray):
            self._count_in(value.nbytes)
            return torch.as_tensor(value).to(self.torch_device,
                                              non_blocking=True)
        if isinstance(value, (tuple, list)):
            return type(value)(self._stage(v) for v in value)
        return value

    def execute(self, es, task: Task, chore: Chore) -> HookReturn:
        for name, value in task.data.items():
            task.data[name] = self._stage(value)
        with torch.cuda.device(self.torch_device):
            return self._run_hook(task, chore)
