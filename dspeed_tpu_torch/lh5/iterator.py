"""Chunked LH5 table iterator, mirroring ``lh5.LH5Iterator``.

The reference driver streams raw files through an ``LH5Iterator`` with a
configurable ``buffer_len``, entry selections, and "friend" iterators whose
columns are joined onto each chunk (``build_dsp.py:258-330``). This
implementation reads host-side numpy chunks; the processing chain moves them
to device.
"""

from __future__ import annotations

from typing import Collection, Mapping

from ._h5 import h5py
import numpy as np

from ..errors import LH5Error
from . import store as lh5_store
from .types import Table

__all__ = ["LH5Iterator"]


class LH5Iterator:
    def __init__(
        self,
        lh5_files: str | Collection[str],
        groups: str,
        base_path: str = "",
        entry_list: Collection[int] | None = None,
        entry_mask: Collection[bool] | None = None,
        i_start: int = 0,
        n_entries: int | None = None,
        field_mask: Mapping[str, bool] | Collection[str] | None = None,
        buffer_len: int = 3200,
    ) -> None:
        if not isinstance(lh5_files, (list, tuple)):
            lh5_files = [lh5_files]
        if isinstance(groups, (list, tuple)):
            if len(groups) not in (1, len(lh5_files)):
                raise LH5Error(
                    "groups must be a single name or one per file"
                )
            group_list = (
                list(groups) if len(groups) == len(lh5_files)
                else list(groups) * len(lh5_files)
            )
        else:
            group_list = [groups] * len(lh5_files)

        self.lh5_file = lh5_files[0]
        self.lh5_files = list(lh5_files)
        self.group = group_list[0].strip("/")
        self.groups = [g.strip("/") for g in group_list]
        self.buffer_len = buffer_len
        self.field_mask = field_mask
        self._friends: list[tuple[LH5Iterator, str, str]] = []

        self._files = [h5py.File(f, "r") for f in self.lh5_files]
        self._file = self._files[0]
        self._file_rows = [
            lh5_store.read_n_rows(g, fh)
            for g, fh in zip(self.groups, self._files)
        ]
        self._file_offsets = np.concatenate(
            [[0], np.cumsum(self._file_rows)]
        ).astype("int64")
        total = int(self._file_offsets[-1])

        if entry_mask is not None:
            entry_list = np.flatnonzero(np.asarray(entry_mask, dtype=bool))
        if entry_list is not None:
            sel = np.asarray(entry_list, dtype="int64")
        else:
            sel = None

        self._total_rows = total
        self._selection = sel
        self.i_start = i_start
        n_avail = (len(sel) if sel is not None else total) - i_start
        self.n_entries = (
            max(0, n_avail) if n_entries is None else max(0, min(n_entries, n_avail))
        )
        self.current_i_entry = 0

    def __len__(self) -> int:
        return self.n_entries

    def reset_field_mask(self, mask) -> None:
        self.field_mask = mask
        # friend iterators own the columns they provide; filter their masks
        for it, prefix, suffix in self._friends:
            if mask is None:
                it.reset_field_mask(None)
                continue
            names = mask.keys() if isinstance(mask, Mapping) else mask
            sub = []
            for name in names:
                if prefix and not name.startswith(prefix):
                    continue
                if suffix and not name.endswith(suffix):
                    continue
                core = name[len(prefix) : len(name) - len(suffix) if suffix else None]
                sub.append(core)
            it.reset_field_mask(sub)

    def add_friend(self, friend: "LH5Iterator", prefix: str = "", suffix: str = ""):
        friend.buffer_len = self.buffer_len
        self._friends.append((friend, prefix, suffix))

    def _global_rows(self, i_entry: int, n: int) -> np.ndarray | tuple[int, int]:
        """Map selection-space entries [i_entry, i_entry+n) to file rows."""
        start = self.i_start + i_entry
        if self._selection is not None:
            return self._selection[start : start + n]
        return (start, min(start + n, self._total_rows))

    def _read_global(self, start: int, stop: int) -> Table:
        """Read global rows [start, stop) across the file list."""
        parts = []
        for fi, (g, fh) in enumerate(zip(self.groups, self._files)):
            lo = int(self._file_offsets[fi])
            hi = int(self._file_offsets[fi + 1])
            s0, s1 = max(start, lo), min(stop, hi)
            if s0 >= s1:
                continue
            parts.append(
                lh5_store.read(
                    g, fh, start_row=s0 - lo, n_rows=s1 - s0,
                    field_mask=self.field_mask,
                )
            )
        if not parts:
            raise LH5Error("read past end of file list")
        tb = parts[0]
        for p in parts[1:]:
            tb.append(p)
        return tb

    def _read_idx(self, rows: np.ndarray) -> Table:
        if len(self._files) == 1:
            return lh5_store.read(
                self.group, self._file, idx=rows, field_mask=self.field_mask
            )
        # contiguous runs per file (rows are sorted selections)
        parts = []
        fidx = np.searchsorted(self._file_offsets, rows, side="right") - 1
        for fi in np.unique(fidx):
            sel = rows[fidx == fi] - int(self._file_offsets[fi])
            parts.append(
                lh5_store.read(
                    self.groups[fi], self._files[fi], idx=sel,
                    field_mask=self.field_mask,
                )
            )
        tb = parts[0]
        for p in parts[1:]:
            tb.append(p)
        return tb

    def read(self, i_entry: int, n_entries: int | None = None) -> Table:
        """Read a chunk starting at selection entry ``i_entry``."""
        if n_entries is None:
            n_entries = min(self.buffer_len, self.n_entries - i_entry)
        rows = self._global_rows(i_entry, n_entries)
        if isinstance(rows, tuple):
            tb = self._read_global(rows[0], rows[1])
        else:
            tb = self._read_idx(np.asarray(rows))
        if not isinstance(tb, Table):
            raise LH5Error(f"{self.group} is not a table")
        for friend, prefix, suffix in self._friends:
            ftb = friend.read(i_entry, n_entries)
            tb.join(ftb, prefix=prefix, suffix=suffix)
        return tb

    def __iter__(self):
        self.current_i_entry = 0
        i = 0
        while i < self.n_entries:
            n = min(self.buffer_len, self.n_entries - i)
            self.current_i_entry = i
            yield self.read(i, n)
            i += n

    def close(self) -> None:
        for fh in self._files:
            fh.close()
