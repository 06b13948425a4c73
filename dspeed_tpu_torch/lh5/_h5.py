"""``h5py``, imported when a file is first touched.

In-memory LGDO tables (and ``build_dsp`` over them) need no HDF5 library, so
the LH5 layer imports without ``h5py``; file I/O raises ``ImportError`` on
first use where it is missing.
"""

from __future__ import annotations


class _LazyH5py:
    def __getattr__(self, name: str):
        import h5py as _h5py

        return getattr(_h5py, name)


h5py = _LazyH5py()
