from .task import FlowAccess, Flow, Task, TaskStatus, Chore, DeviceType, HookReturn
from .taskpool import Taskpool, TaskClass
from .context import Context, init, fini
