"""Termination-detection framework (reference parsec/mca/termdet/).

A termdet *monitor* is wired into every taskpool (parsec_internal.h:145) and
drives the state machine NOT_READY → BUSY → IDLE → TERMINATED
(termdet.h:27-120). This slice ports the ``local`` module: it counts local
tasks + pending runtime actions and terminates when both hit zero.
"""

from .base import TermdetMonitor, TermdetState
from .local import LocalTermdet
from ..utils import mca_param

_MODULES = {
    "local": LocalTermdet,
}

mca_param.register("termdet", "local",
                   help="termination detection module (local)")


def new_monitor(name=None) -> TermdetMonitor:
    name = name or mca_param.get("termdet", "local")
    try:
        cls = _MODULES[name]
    except KeyError:
        raise ValueError(f"unknown termdet module {name!r}; have {sorted(_MODULES)}")
    return cls()
