"""Data layer: collections, data items and tiled matrices.

Reference: parsec_data_t + per-device copies (data_internal.h:35-81), data
collections with a user-supplied rank_of/vpid_of/data_of vtable
(include/parsec/data_distribution.h:26-100), and the tiled matrices and
distributions of data_dist/matrix/.
"""

from .collection import DataCollection, LocalCollection
from .data import Data, DataCopy, CoherencyState
from .matrix import (Distribution, OneDimCyclic, SubtileView,
                     SymTwoDimBlockCyclic, TiledMatrix, TwoDimBandCyclic,
                     TwoDimBlockCyclic, TwoDimTabular)
