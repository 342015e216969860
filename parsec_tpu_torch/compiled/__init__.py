"""Compiled execution paths: a PTG taskpool's whole DAG planned on the
host and run as waves on one device, instead of task by task through the
host runtime.

- :mod:`wavefront`: enumerate the (closed-form) task space, level it into
  waves, batch same-class tasks per wave, and run each (class, wave)
  group as one batched call that gathers and scatters tiles in a stacked
  device-resident tile store (:class:`~.wavefront.WavefrontExecutor`).
- :mod:`panels`: the wave-fused dense form (the flagship path): the
  taskpool's ``wave_fuser`` turns each planner wave into a few panel
  operations on the matrix held transposed as one dense tensor
  (:class:`~.panels.PanelExecutor`).
"""

from .wavefront import (WaveGroup, WavefrontPlan, WavefrontExecutor,
                        plan_taskpool)
from .panels import PanelExecutor, PanelGeometry, bucket_tiles
