"""CPU device: executes chores inline on the worker thread."""

from __future__ import annotations

from .base import Device
from ..core.task import Chore, DeviceType, HookReturn, Task


class CPUDevice(Device):
    device_type = DeviceType.CPU
    name = "cpu"

    def execute(self, es, task: Task, chore: Chore) -> HookReturn:
        return self._run_hook(task, chore)
