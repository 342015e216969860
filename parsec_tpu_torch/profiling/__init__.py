"""Profiling and instrumentation: the PINS callback chains
(parsec/mca/pins/pins.h:26-53)."""

from . import pins
from .pins import PinsManager, PinsEvent
