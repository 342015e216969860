"""parsec_tpu_torch — the PyTorch/CUDA port of the parsec_tpu task-dataflow
runtime (PaRSEC-class), for NVIDIA Hopper GPUs.

The layout follows the JAX package ``parsec_tpu`` module by module
(``core/``, ``dsl/``, ``device/``, ``ops/``, ``algorithms/``, ...), so each
module's counterpart is easy to find. This package imports ``torch`` and
never ``jax`` or anything of ``parsec_tpu``.

Public API (mirrors parsec_init / parsec_context_* from runtime.h)::

    import parsec_tpu_torch as parsec
    ctx = parsec.init(nb_cores=8)            # device="cuda" by default
    tp  = build_potrf(A)                     # a PTG taskpool
    ctx.add_taskpool(tp); ctx.start(); ctx.wait()
    parsec.fini(ctx)

    # the compiled flagship path: planner waves fused into panel ops
    PanelExecutor(plan_taskpool(build_potrf_left(A))).run()
"""

from .utils import mca_param
from .utils.debug import debug_verbose, set_verbosity
from .core.context import Context, init, fini
from .core.taskpool import Taskpool, TaskClass
from .core.task import Flow, FlowAccess, Task, DeviceType
from .core.future import Future, DataCopyFuture
from .core.reshape import ReshapeSpec
from . import dsl
from .dsl import ptg
from . import data
from . import device
from . import sched
from . import termdet
from . import profiling
from . import ops
from . import compiled

__all__ = [
    "init", "fini", "Context",
    "Taskpool", "TaskClass", "Flow", "FlowAccess", "Task", "DeviceType",
    "Future", "DataCopyFuture", "ReshapeSpec",
    "dsl", "ptg", "data", "device", "sched", "termdet", "profiling",
    "ops", "compiled", "mca_param", "debug_verbose", "set_verbosity",
]
