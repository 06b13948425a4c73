"""In-memory LEGEND data objects (LGDO) for dspeed_tpu_torch.

The reference depends on the external ``legend-pydataobj`` (lgdo) package for
these types (reference ``pyproject.toml:44-46``); this module provides a
self-contained implementation of the subset the DSP engine uses:

- :class:`Scalar`
- :class:`Array` — 1-D+ array of values with attributes
- :class:`ArrayOfEqualSizedArrays` — fixed-length rows
- :class:`VectorOfVectors` — variable-length rows (flattened + cumulative len)
- :class:`Table` — struct of equal-length columns
- :class:`WaveformTable` — table with ``t0``, ``dt``, ``values``
- :class:`Struct` — generic named group

These map 1:1 onto the LH5 on-disk layout (see ``dspeed_tpu_torch.lh5.store``).
All buffers are plain numpy arrays; device arrays enter only inside the
processing chain.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = [
    "LGDO",
    "Scalar",
    "Array",
    "ArrayOfEqualSizedArrays",
    "VectorOfVectors",
    "Table",
    "WaveformTable",
    "Struct",
    "get_element_type",
]


def get_element_type(dtype) -> str:
    """LH5 element-type string for a numpy dtype."""
    kind = np.dtype(dtype).kind
    if kind == "b":
        return "bool"
    if kind in "iuf":
        return "real"
    if kind == "c":
        return "complex"
    if kind in "SU":
        return "string"
    raise ValueError(f"cannot map dtype {dtype} to LH5 element type")


class LGDO:
    """Base class: any LEGEND data object carries an ``attrs`` dict."""

    def __init__(self, attrs: Mapping | None = None) -> None:
        self.attrs: dict[str, Any] = dict(attrs) if attrs else {}

    def form_datatype(self) -> str:
        raise NotImplementedError

    def getattrs(self, datatype: bool = True) -> dict:
        d = dict(self.attrs)
        if datatype:
            d["datatype"] = self.form_datatype()
        return d


class Scalar(LGDO):
    def __init__(self, value, attrs: Mapping | None = None) -> None:
        super().__init__(attrs)
        self.value = value

    def form_datatype(self) -> str:
        if isinstance(self.value, (bool, np.bool_)):
            return "bool"
        if isinstance(self.value, (str, bytes, np.str_)):
            return "string"
        return "real"

    def __eq__(self, other):
        return isinstance(other, Scalar) and other.value == self.value

    def __repr__(self) -> str:
        return f"Scalar({self.value!r})"


class Array(LGDO):
    """An n-dimensional array of values with a resizable leading axis."""

    def __init__(
        self,
        nda: np.ndarray | None = None,
        shape: tuple | int = (),
        dtype=None,
        fill_val=None,
        attrs: Mapping | None = None,
    ) -> None:
        super().__init__(attrs)
        if nda is None:
            if isinstance(shape, int):
                shape = (shape,)
            dtype = np.dtype(dtype) if dtype is not None else np.dtype("float64")
            if fill_val is None:
                nda = np.zeros(shape, dtype=dtype)
            else:
                nda = np.full(shape, fill_val, dtype=dtype)
        else:
            nda = np.asarray(nda)
        self.nda = nda

    @property
    def dtype(self):
        return self.nda.dtype

    @property
    def shape(self):
        return self.nda.shape

    def __len__(self) -> int:
        return self.nda.shape[0] if self.nda.ndim else 0

    def resize(self, new_size: int) -> None:
        old = self.nda.shape[0]
        if new_size == old:
            return
        new = np.zeros((new_size,) + self.nda.shape[1:], dtype=self.nda.dtype)
        n = min(old, new_size)
        new[:n] = self.nda[:n]
        self.nda = new

    def append(self, other: "Array") -> None:
        self.nda = np.concatenate([self.nda, np.asarray(other.nda)], axis=0)

    def __getitem__(self, idx):
        return self.nda[idx]

    def __setitem__(self, idx, val):
        self.nda[idx] = val

    def form_datatype(self) -> str:
        return f"array<{self.nda.ndim}>{{{get_element_type(self.dtype)}}}"

    def __eq__(self, other):
        return (
            isinstance(other, Array)
            and type(other) is type(self)
            and self.nda.shape == other.nda.shape
            and bool(np.array_equal(self.nda, other.nda, equal_nan=self.dtype.kind == "f"))
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.nda.shape}, dtype={self.dtype})"


class ArrayOfEqualSizedArrays(Array):
    """2-D array where each row is an equal-sized inner array."""

    def form_datatype(self) -> str:
        dims = ",".join("1" for _ in range(self.nda.ndim))
        return f"array_of_equalsized_arrays<{dims}>{{{get_element_type(self.dtype)}}}"


class VectorOfVectors(LGDO):
    """Variable-length rows stored as flattened data + cumulative lengths."""

    def __init__(
        self,
        data=None,
        flattened_data: Array | np.ndarray | None = None,
        cumulative_length: Array | np.ndarray | None = None,
        shape_guess: tuple | None = None,
        dtype=None,
        attrs: Mapping | None = None,
    ) -> None:
        super().__init__(attrs)
        if data is not None:
            lens = np.array([len(v) for v in data], dtype="uint32")
            cum = np.cumsum(lens, dtype="uint32")
            flat = (
                np.concatenate([np.asarray(v) for v in data])
                if len(data)
                else np.empty(0, dtype=dtype)
            )
            if dtype is not None:
                flat = flat.astype(dtype)
            self.flattened_data = Array(flat)
            self.cumulative_length = Array(cum)
            return

        if cumulative_length is None:
            size = shape_guess[0] if shape_guess else 0
            cumulative_length = np.zeros(size, dtype="uint32")
        if flattened_data is None:
            cap = int(cumulative_length[-1]) if len(cumulative_length) else 0
            if shape_guess is not None:
                cap = max(cap, int(np.prod(shape_guess)))
            dtype = np.dtype(dtype) if dtype is not None else np.dtype("float64")
            flattened_data = np.empty(cap, dtype=dtype)
        self.flattened_data = (
            flattened_data if isinstance(flattened_data, Array) else Array(flattened_data)
        )
        self.cumulative_length = (
            cumulative_length
            if isinstance(cumulative_length, Array)
            else Array(np.asarray(cumulative_length))
        )

    @property
    def dtype(self):
        return self.flattened_data.dtype

    def __len__(self) -> int:
        return len(self.cumulative_length)

    def __getitem__(self, i: int) -> np.ndarray:
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("VectorOfVectors slicing requires step 1")
            return VectorOfVectors(
                data=[self[j] for j in range(start, stop)],
                dtype=self.dtype,
                attrs=self.attrs,
            )
        if i < 0:
            i += len(self)
        lo = int(self.cumulative_length[i - 1]) if i > 0 else 0
        hi = int(self.cumulative_length[i])
        return self.flattened_data.nda[lo:hi]

    def resize(self, new_size: int) -> None:
        old = len(self)
        self.cumulative_length.resize(new_size)
        if new_size > old:
            last = int(self.cumulative_length[old - 1]) if old > 0 else 0
            self.cumulative_length.nda[old:] = last

    def _set_vector_unsafe(self, start: int, arr2d: np.ndarray, lens: np.ndarray):
        """Bulk-set rows [start, start+len(lens)) from a padded 2-D array."""
        cum = int(self.cumulative_length[start - 1]) if start > 0 else 0
        total = cum + int(np.sum(lens))
        if len(self.flattened_data.nda) < total:
            self.flattened_data.resize(total)
        for i, ln in enumerate(lens):
            ln = int(ln)
            self.flattened_data.nda[cum : cum + ln] = arr2d[i, :ln]
            cum += ln
            self.cumulative_length.nda[start + i] = cum

    def append(self, other: "VectorOfVectors") -> None:
        n0 = len(self)
        base = int(self.cumulative_length[n0 - 1]) if n0 > 0 else 0
        o_flat_len = int(other.cumulative_length[-1]) if len(other) else 0
        self.cumulative_length.nda = np.concatenate(
            [
                self.cumulative_length.nda,
                np.asarray(other.cumulative_length.nda[: len(other)], dtype="uint64").astype(
                    self.cumulative_length.dtype
                )
                + base,
            ]
        )
        flat = self.flattened_data.nda[:base]
        self.flattened_data.nda = np.concatenate(
            [flat, other.flattened_data.nda[:o_flat_len]]
        )

    def to_aoesa(self, max_len: int | None = None, fill_val=np.nan) -> ArrayOfEqualSizedArrays:
        lens = np.diff(self.cumulative_length.nda, prepend=0)
        if max_len is None:
            max_len = int(lens.max()) if len(lens) else 0
        out = np.full((len(self), max_len), fill_val, dtype=self.dtype)
        for i in range(len(self)):
            v = self[i][:max_len]
            out[i, : len(v)] = v
        return ArrayOfEqualSizedArrays(out, attrs=self.attrs)

    def form_datatype(self) -> str:
        return f"array<1>{{array<1>{{{get_element_type(self.dtype)}}}}}"

    def __eq__(self, other):
        if not isinstance(other, VectorOfVectors) or len(other) != len(self):
            return False
        eq_nan = self.dtype.kind == "f"
        return all(
            np.array_equal(self[i], other[i], equal_nan=eq_nan) for i in range(len(self))
        )

    def __repr__(self) -> str:
        return f"VectorOfVectors(len={len(self)}, dtype={self.dtype})"


class Table(LGDO):
    """A struct of equal-length columns."""

    def __init__(
        self,
        col_dict: Mapping[str, LGDO] | None = None,
        size: int | None = None,
        attrs: Mapping | None = None,
    ) -> None:
        super().__init__(attrs)
        self._cols: dict[str, LGDO] = {}
        self.size = size if size is not None else 0
        if col_dict:
            for k, v in col_dict.items():
                self.add_field(k, v, use_obj_size=size is None)

    def add_field(self, name: str, obj: LGDO, use_obj_size: bool = False) -> None:
        self._cols[name] = obj
        if use_obj_size or not self._cols or self.size == 0:
            if len(self._cols) == 1 or use_obj_size:
                self.size = len(obj)

    add_column = add_field

    def remove_column(self, name: str) -> None:
        del self._cols[name]

    def keys(self):
        return self._cols.keys()

    def values(self):
        return self._cols.values()

    def items(self):
        return self._cols.items()

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, slice):
            return self._slice(key)
        raise KeyError(key)

    def _slice(self, sl: slice) -> "Table":
        out = type(self).__new__(type(self))
        LGDO.__init__(out, self.attrs)
        out._cols = {}
        start, stop, step = sl.indices(self.size)
        out.size = max(0, (stop - start + (step - 1)) // step)
        for k, v in self._cols.items():
            if isinstance(v, (VectorOfVectors, Table)):
                out._cols[k] = v[sl]
            else:
                out._cols[k] = type(v)(v.nda[sl], attrs=v.attrs)
        return out

    def __len__(self) -> int:
        return self.size

    def resize(self, new_size: int) -> None:
        self.size = new_size
        for col in self._cols.values():
            col.resize(new_size)

    def append(self, other: "Table") -> None:
        for k, col in self._cols.items():
            col.append(other[k])
        self.size += len(other)

    def join(self, other: "Table", prefix: str = "", suffix: str = "") -> None:
        for k, col in other.items():
            self.add_field(f"{prefix}{k}{suffix}", col)

    def form_datatype(self) -> str:
        return "table{" + ",".join(self._cols.keys()) + "}"

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={self.size}, cols={list(self._cols)})"


class WaveformTable(Table):
    """A table with ``t0``, ``dt`` and ``values`` columns describing waveforms.

    Mirrors ``lgdo.WaveformTable`` as used by the reference engine's waveform
    IO manager (reference ``processing_chain.py:2263-2360``).
    """

    def __init__(
        self,
        size: int | None = None,
        t0=0.0,
        t0_units: str | None = None,
        dt=1.0,
        dt_units: str | None = None,
        values: LGDO | np.ndarray | None = None,
        wf_len: int | None = None,
        dtype=None,
        attrs: Mapping | None = None,
    ) -> None:
        if values is None:
            if size is None:
                size = 0
            if wf_len is None:
                wf_len = 0
            values = ArrayOfEqualSizedArrays(
                np.zeros((size, wf_len), dtype=dtype if dtype is not None else "float64")
            )
        elif isinstance(values, np.ndarray):
            values = ArrayOfEqualSizedArrays(values)
        if size is None:
            size = len(values)

        def _expand(x, units):
            if isinstance(x, Array):
                if units is not None:
                    x.attrs.setdefault("units", units)
                return x
            arr = np.broadcast_to(np.asarray(x, dtype="float64"), (size,)).copy()
            a = Array(arr)
            if units is not None:
                a.attrs["units"] = units
            return a

        t0 = _expand(t0, t0_units)
        dt = _expand(dt, dt_units)
        super().__init__({"t0": t0, "dt": dt, "values": values}, size=size, attrs=attrs)

    @property
    def values(self) -> LGDO:
        return self._cols["values"]

    @property
    def t0(self) -> Array:
        return self._cols["t0"]

    @property
    def dt(self) -> Array:
        return self._cols["dt"]

    @property
    def wf_len(self) -> int:
        v = self.values
        if isinstance(v, ArrayOfEqualSizedArrays):
            return v.nda.shape[1]
        return -1

    @property
    def dt_units(self) -> str | None:
        return self.dt.attrs.get("units")

    @dt_units.setter
    def dt_units(self, u) -> None:
        self.dt.attrs["units"] = str(u)

    @property
    def t0_units(self) -> str | None:
        return self.t0.attrs.get("units")

    @t0_units.setter
    def t0_units(self, u) -> None:
        self.t0.attrs["units"] = str(u)


class Struct(LGDO, dict):
    """A generic named group of LGDOs."""

    def __init__(self, obj_dict: Mapping | None = None, attrs: Mapping | None = None):
        LGDO.__init__(self, attrs)
        dict.__init__(self, obj_dict or {})

    def add_field(self, name: str, obj: LGDO) -> None:
        self[name] = obj

    def form_datatype(self) -> str:
        return "struct{" + ",".join(self.keys()) + "}"
