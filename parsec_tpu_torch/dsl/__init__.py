"""DSL layer: the front ends that produce taskpools.

This slice ports PTG (parameterized task graphs, the JDF language's
Python form). DTD is a later slice.
"""

from . import ptg
