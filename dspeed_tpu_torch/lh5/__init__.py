"""LH5 (LEGEND HDF5) data objects and I/O for dspeed_tpu_torch.

Self-contained replacement for the reference's external ``legend-pydataobj``
(lgdo) and ``legend-lh5io`` dependencies.
"""

from .iterator import LH5Iterator
from .store import LH5Store, ls, read, read_n_rows, write
from .types import (
    LGDO,
    Array,
    ArrayOfEqualSizedArrays,
    Scalar,
    Struct,
    Table,
    VectorOfVectors,
    WaveformTable,
)

__all__ = [
    "LGDO",
    "Array",
    "ArrayOfEqualSizedArrays",
    "Scalar",
    "Struct",
    "Table",
    "VectorOfVectors",
    "WaveformTable",
    "LH5Iterator",
    "LH5Store",
    "ls",
    "read",
    "read_n_rows",
    "write",
]
