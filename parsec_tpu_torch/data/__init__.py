"""Data layer: collections and data items.

Reference: parsec_data_t + per-device copies (data_internal.h:35-81) and
data collections with a user-supplied rank_of/vpid_of/data_of vtable
(include/parsec/data_distribution.h:26-100). Tiled matrices and
distributions are a later slice.
"""

from .collection import DataCollection, LocalCollection
from .data import Data, DataCopy, CoherencyState
