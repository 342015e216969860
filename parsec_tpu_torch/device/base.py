"""Device base class and registry (reference parsec/mca/device/device.c)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..core.task import Chore, DeviceType, HookReturn, Task, \
    normalize_outputs
from ..utils.debug import debug_verbose


class Device:
    """A device module (parsec_device_module_t analog)."""

    device_type = DeviceType.NONE
    name = "device"
    platform = "cpu"

    def __init__(self) -> None:
        self.index = -1
        self.registry: Optional["Registry"] = None
        # statistics (reference device.h:132-141 per-device counters)
        self.stats = {"tasks": 0, "exec_s": 0.0,
                      "bytes_in": 0, "bytes_out": 0}
        # relative throughput weight for load balancing
        # (reference: GFLOPS weights, device_cuda_module.c:53-117)
        self.weight = 1.0
        self.load = 0.0
        self._lock = threading.Lock()
        # extensible per-device info slots (parsec_per_device_infos)
        from ..utils.info import InfoArray, per_device_infos
        self.infos = InfoArray(per_device_infos, self)

    def attach(self, registry: "Registry", index: int) -> None:
        self.registry = registry
        self.index = index

    def execute(self, es, task: Task, chore: Chore) -> HookReturn:
        raise NotImplementedError

    def shutdown(self) -> None:
        """Stop any device-owned threads (called from Context.fini);
        base devices have none."""

    def release_load(self) -> None:
        """Release the in-flight work unit ``Registry.device_for`` added.
        The context releases it when ``execute`` returns anything but
        ASYNC."""
        with self._lock:
            self.load = max(0.0, self.load - 1.0)

    def _run_hook(self, task: Task, chore: Chore) -> HookReturn:
        """Run the functional body and normalize outputs into
        ``task.output`` keyed by output-flow name."""
        t0 = time.perf_counter()
        inputs = task.input_values()
        result = chore.hook(task, *inputs)
        outs = normalize_outputs(
            result, [f.name for f in task.task_class.output_flows],
            task)
        task.output.update(outs)
        with self._lock:
            self.stats["tasks"] += 1
            self.stats["exec_s"] += time.perf_counter() - t0
        return HookReturn.DONE

    def dump_statistics(self) -> Dict:
        return dict(self.stats, name=self.name, index=self.index)


class Registry:
    """Device registry (parsec_mca_device_* analog).

    Always registers the inline CPU device. When the context runs on
    ``cuda``, one :class:`~parsec_tpu_torch.device.cuda.CUDADevice` is
    registered per visible GPU (reference: one module per GPU,
    device_cuda_module.c:326) and the CPU device's weight drops to 0.01
    so it is a last resort, not a load-balancing peer (reference GFLOPS
    weight table, device_cuda_module.c:53)."""

    def __init__(self, context) -> None:
        from .cpu import CPUDevice
        self.context = context
        self.devices: List[Device] = []
        self.add(CPUDevice())
        if context.torch_device.type == "cuda":
            import torch
            from .cuda import CUDADevice
            for i in range(torch.cuda.device_count()):
                self.add(CUDADevice(i))
            self.devices[0].weight = 0.01

    def add(self, dev: Device) -> Device:
        dev.attach(self, len(self.devices))
        self.devices.append(dev)
        debug_verbose(4, "device", "registered device %d: %s",
                      dev.index, dev.name)
        return dev

    def device_for(self, device_type: DeviceType, task: Task) -> Optional[Device]:
        """parsec_get_best_device analog: among devices matching the chore's
        type, pick the least (load + 1) / weight; ties go to the heavier
        device (idle accelerator beats idle CPU)."""
        best, best_score = None, None
        for dev in self.devices:
            if not (dev.device_type & device_type):
                continue
            score = (dev.load + 1.0) / dev.weight
            if best_score is None or score < best_score or \
                    (score == best_score and dev.weight > best.weight):
                best, best_score = dev, score
        if best is not None:
            with best._lock:
                best.load += 1.0       # in-flight unit; the context
        return best                    # releases it (see release_load)

    def by_type(self, device_type: DeviceType) -> List[Device]:
        return [d for d in self.devices if d.device_type & device_type]

    def dump_statistics(self) -> List[Dict]:
        """parsec_mca_device_dump_and_reset_statistics analog."""
        return [d.dump_statistics() for d in self.devices]
