"""Device framework (reference parsec/mca/device/).

- :class:`CPUDevice` executes chores inline on the worker thread.
- :class:`~parsec_tpu_torch.device.cuda.CUDADevice` (one per GPU, imported
  only when the context runs on ``cuda``) stages a task's inputs onto its
  GPU and runs the chore there.
"""

from .base import Device, Registry
from .cpu import CPUDevice
from ..core.task import DeviceType

__all__ = ["Device", "Registry", "CPUDevice", "DeviceType"]
