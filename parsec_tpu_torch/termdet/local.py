"""Local termination detection (reference parsec/mca/termdet/local).

Counts local tasks and pending runtime actions; the taskpool is terminated
when both reach zero. This is the default monitor installed by
``context.add_taskpool`` when the DSL did not choose one
(scheduling.c:692-697).
"""

from .base import TermdetMonitor


class LocalTermdet(TermdetMonitor):
    pass
