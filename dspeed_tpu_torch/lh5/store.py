"""LH5 (LEGEND HDF5) file I/O for dspeed_tpu_torch.

Replaces the external ``legend-lh5io``/``lgdo.lh5`` dependency of the
reference (used throughout ``dspeed/build_dsp.py``). Objects are stored
following the LH5 layout: every HDF5 node carries a ``datatype`` attribute
identifying the LGDO type; tables are groups of column datasets; vectors of
vectors are groups of ``cumulative_length`` + ``flattened_data``.

Only host-side numpy touches this layer; device transfer happens in the
processing chain.
"""

from __future__ import annotations

import fnmatch
import os
from typing import Any, Collection, Mapping

from ._h5 import h5py
import numpy as np

from ..errors import LH5Error
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

__all__ = ["LH5Store", "read", "write", "ls", "read_n_rows"]


def _attrs_of(h5obj) -> dict:
    out = {}
    for k, v in h5obj.attrs.items():
        if isinstance(v, bytes):
            v = v.decode()
        out[k] = v
    return out


def _stored_attrs(obj: LGDO) -> dict:
    d = obj.getattrs(datatype=True)
    return {k: v for k, v in d.items() if v is not None}


def ls(lh5_file: str | h5py.File, lh5_group: str = "") -> list[str]:
    """List nodes in an LH5 file matching an fnmatch pattern.

    Mirrors ``lh5.ls`` usage in the reference driver
    (``build_dsp.py:156-186``): a pattern ending in ``/*`` lists children of
    the group; otherwise, returns the matching paths themselves.
    """
    own = isinstance(lh5_file, str)
    if own:
        if not os.path.exists(lh5_file):
            return []
        f = h5py.File(lh5_file, "r")
    else:
        f = lh5_file
    try:
        # a trailing "/" lists the group's children (lh5.ls convention)
        if lh5_group.endswith("/") and lh5_group.strip("/"):
            lh5_group = lh5_group.rstrip("/") + "/*"
        pattern = lh5_group.lstrip("/")
        if pattern.strip("/") == "":
            return list(f.keys())
        if "*" not in pattern and "?" not in pattern:
            return [pattern] if pattern in f else []
        # walk down the path components, expanding wildcards
        matches = [""]
        for comp in pattern.split("/"):
            new = []
            for base in matches:
                node = f[base] if base else f
                if not isinstance(node, h5py.Group):
                    continue
                for child in node.keys():
                    if fnmatch.fnmatch(child, comp):
                        new.append(f"{base}/{child}" if base else child)
            matches = new
        return matches
    finally:
        if own:
            f.close()


def read_n_rows(name: str, lh5_file: str | h5py.File) -> int:
    """Number of rows of the table/array at ``name``."""
    own = isinstance(lh5_file, str)
    f = h5py.File(lh5_file, "r") if own else lh5_file
    try:
        node = f[name]
        dt = _attrs_of(node).get("datatype", "")
        if dt.startswith("table"):
            for key in node.keys():
                return read_n_rows(f"{name}/{key}", f)
            return 0
        if dt.startswith("array<1>{array<1>"):
            return node["cumulative_length"].shape[0]
        if isinstance(node, h5py.Dataset):
            return node.shape[0]
        raise LH5Error(f"cannot get n_rows of {name} with datatype {dt!r}")
    finally:
        if own:
            f.close()


def _read_node(
    node,
    start_row: int = 0,
    n_rows: int | None = None,
    idx: np.ndarray | None = None,
    field_mask: Mapping[str, bool] | Collection[str] | None = None,
) -> LGDO:
    attrs = _attrs_of(node)
    dt = attrs.pop("datatype", None)
    if dt is None:
        raise LH5Error(f"node {node.name} has no LH5 datatype")

    if dt.startswith("table"):
        fields = dt[len("table{") : -1].split(",") if len(dt) > 7 else []
        fields = [x for x in fields if x]
        if field_mask is not None:
            if isinstance(field_mask, Mapping):
                default = not any(field_mask.values())
                fields = [x for x in fields if field_mask.get(x, default)]
            else:
                fields = [x for x in fields if x in field_mask]
        cols = {
            k: _read_node(node[k], start_row, n_rows, idx) for k in fields if k in node
        }
        if set(cols.keys()) >= {"t0", "dt", "values"}:
            tb = WaveformTable(
                t0=cols["t0"], dt=cols["dt"], values=cols["values"], attrs=attrs
            )
            for k, v in cols.items():
                if k not in ("t0", "dt", "values"):
                    tb.add_field(k, v)
            return tb
        size = len(next(iter(cols.values()))) if cols else 0
        return Table(cols, size=size, attrs=attrs)

    if dt.startswith("struct"):
        return Struct(
            {k: _read_node(node[k]) for k in node.keys()},
            attrs=attrs,
        )

    if dt.startswith("array<1>{array<1>"):
        cl = node["cumulative_length"]
        fl = node["flattened_data"]
        total = cl.shape[0]
        if idx is not None:
            cl_all = cl[...]
            rows = np.asarray(idx)
            data = []
            flat = fl[...]
            for i in rows:
                lo = int(cl_all[i - 1]) if i > 0 else 0
                data.append(flat[lo : int(cl_all[i])])
            return VectorOfVectors(data=data, dtype=fl.dtype, attrs=attrs)
        stop = total if n_rows is None else min(total, start_row + n_rows)
        cl_sel = cl[start_row:stop]
        base = int(cl[start_row - 1]) if start_row > 0 else 0
        top = int(cl_sel[-1]) if len(cl_sel) else base
        flat = fl[base:top]
        return VectorOfVectors(
            flattened_data=np.asarray(flat),
            cumulative_length=(np.asarray(cl_sel, dtype="uint64") - base).astype(
                cl.dtype
            ),
            attrs=attrs,
        )

    if isinstance(node, h5py.Dataset):
        if node.shape == ():
            val = node[()]
            if isinstance(val, bytes):
                val = val.decode()
            return Scalar(val, attrs=attrs)
        if idx is not None:
            nda = node[...][np.asarray(idx)]
        else:
            stop = node.shape[0] if n_rows is None else start_row + n_rows
            nda = node[start_row:stop]
        if dt.startswith("array_of_equalsized_arrays"):
            return ArrayOfEqualSizedArrays(nda, attrs=attrs)
        return Array(nda, attrs=attrs)

    raise LH5Error(f"cannot read node {node.name} with datatype {dt!r}")


def read(
    name: str,
    lh5_file: str | h5py.File,
    start_row: int = 0,
    n_rows: int | None = None,
    idx=None,
    field_mask=None,
    obj_buf=None,
) -> LGDO:
    """Read the LGDO at path ``name`` from an LH5 file."""
    own = isinstance(lh5_file, str)
    f = h5py.File(lh5_file, "r") if own else lh5_file
    try:
        name = name.strip("/")
        if name not in f:
            raise LH5Error(f"{name} not found in {lh5_file}")
        obj = _read_node(
            f[name],
            start_row=start_row,
            n_rows=n_rows,
            idx=np.asarray(idx) if idx is not None else None,
            field_mask=field_mask,
        )
        return obj
    finally:
        if own:
            f.close()


def _require_dataset(group, name: str, data: np.ndarray, attrs: dict):
    if name in group:
        return group[name]
    ds = group.create_dataset(
        name,
        data=data,
        maxshape=(None,) + data.shape[1:],
        chunks=(min(max(len(data), 1), 4096),) + data.shape[1:],
        compression=None,
    )
    for k, v in attrs.items():
        ds.attrs[k] = v
    return ds


def _write_array_rows(
    group, name: str, arr: Array, wo_mode: str, write_start: int, n_rows: int
):
    data = np.asarray(arr.nda[:n_rows])
    if name not in group:
        ds = group.create_dataset(
            name,
            data=np.empty((0,) + data.shape[1:], dtype=data.dtype),
            maxshape=(None,) + data.shape[1:],
            chunks=(max(1, min(4096, max(n_rows, 1))),) + data.shape[1:],
        )
        for k, v in _stored_attrs(arr).items():
            ds.attrs[k] = v
    else:
        ds = group[name]
    end = write_start + len(data)
    if ds.shape[0] < end:
        ds.resize(end, axis=0)
    ds[write_start:end] = data


def _write_node(
    obj: LGDO,
    name: str,
    group,
    wo_mode: str,
    write_start: int,
    n_rows: int | None,
):
    if isinstance(obj, Scalar):
        if name in group:
            del group[name]
        ds = group.create_dataset(name, data=obj.value)
        for k, v in _stored_attrs(obj).items():
            ds.attrs[k] = v
        return

    if isinstance(obj, Table):
        if name in group:
            sub = group[name]
        else:
            sub = group.create_group(name)
        # update datatype attr to the current column set
        for k, v in _stored_attrs(obj).items():
            sub.attrs[k] = v
        nr = len(obj) if n_rows is None else n_rows
        for col, cobj in obj.items():
            _write_node(cobj, col, sub, wo_mode, write_start, nr)
        return

    if isinstance(obj, Struct):
        sub = group.require_group(name)
        for k, v in _stored_attrs(obj).items():
            sub.attrs[k] = v
        for key, sobj in obj.items():
            _write_node(sobj, key, sub, wo_mode, 0, None)
        return

    if isinstance(obj, VectorOfVectors):
        nr = len(obj) if n_rows is None else min(n_rows, len(obj))
        sub = group.require_group(name)
        for k, v in _stored_attrs(obj).items():
            sub.attrs[k] = v
        if "cumulative_length" in sub:
            cl_ds = sub["cumulative_length"]
            fl_ds = sub["flattened_data"]
        else:
            cl_ds = sub.create_dataset(
                "cumulative_length",
                data=np.empty(0, dtype=obj.cumulative_length.dtype),
                maxshape=(None,),
                chunks=(4096,),
            )
            cl_ds.attrs["datatype"] = "array<1>{real}"
            fl_ds = sub.create_dataset(
                "flattened_data",
                data=np.empty(0, dtype=obj.dtype),
                maxshape=(None,),
                chunks=(4096,),
            )
            fl_ds.attrs["datatype"] = "array<1>{real}"
        base = int(cl_ds[write_start - 1]) if write_start > 0 else 0
        cl = np.asarray(obj.cumulative_length.nda[:nr], dtype="uint64")
        flat_n = int(cl[-1]) if nr else 0
        end = write_start + nr
        if cl_ds.shape[0] < end:
            cl_ds.resize(end, axis=0)
        cl_ds[write_start:end] = (cl + base).astype(cl_ds.dtype)
        if fl_ds.shape[0] < base + flat_n:
            fl_ds.resize(base + flat_n, axis=0)
        fl_ds[base : base + flat_n] = obj.flattened_data.nda[:flat_n]
        return

    if isinstance(obj, Array):
        nr = len(obj) if n_rows is None else min(n_rows, len(obj))
        _write_array_rows(group, name, obj, wo_mode, write_start, nr)
        return

    raise LH5Error(f"cannot write object of type {type(obj)}")


def write(
    obj: LGDO,
    name: str,
    lh5_file: str | h5py.File,
    group: str = "/",
    wo_mode: str = "append",
    write_start: int = 0,
    n_rows: int | None = None,
) -> None:
    """Write an LGDO into an LH5 file.

    ``wo_mode``: ``"w"``/``"write_safe"`` fails if the object exists,
    ``"a"``/``"append"`` appends rows, ``"o"``/``"overwrite"`` overwrites rows
    in place starting at ``write_start``, ``"of"``/``"overwrite_file"``
    recreates the file.
    """
    mode_map = {
        "w": "w",
        "write_safe": "w",
        "a": "a",
        "append": "a",
        "o": "o",
        "overwrite": "o",
        "u": "o",
        "of": "of",
        "overwrite_file": "of",
    }
    wo = mode_map.get(wo_mode)
    if wo is None:
        raise LH5Error(f"unknown write mode {wo_mode!r}")

    own = isinstance(lh5_file, str)
    if own:
        file_mode = "w" if (wo == "of" or not os.path.exists(lh5_file)) else "a"
        f = h5py.File(lh5_file, file_mode)
    else:
        f = lh5_file
    try:
        grp = f.require_group(group) if group not in ("", "/") else f["/"]
        path = name.strip("/")
        if "/" in path:
            head, path = path.rsplit("/", 1)
            for comp in head.split("/"):
                grp = grp.require_group(comp)
        if wo == "w" and path in grp:
            raise LH5Error(f"{name} already exists in {lh5_file}")
        if wo == "a" and path in grp:
            # determine current length and append at the end
            fullname = f"{grp.name}/{path}".lstrip("/")
            write_start = read_n_rows(fullname, f)
        _write_node(obj, path, grp, wo, write_start, n_rows)
    finally:
        if own:
            f.close()


class LH5Store:
    """File-handle-caching reader/writer, mirroring ``lh5.LH5Store``."""

    def __init__(self, base_path: str = "", keep_open: bool = False) -> None:
        self.base_path = base_path
        self.keep_open = keep_open
        self._files: dict[str, h5py.File] = {}

    def gimme_file(self, lh5_file: str, mode: str = "r") -> h5py.File:
        if isinstance(lh5_file, h5py.File):
            return lh5_file
        path = os.path.join(self.base_path, lh5_file) if self.base_path else lh5_file
        if path in self._files:
            f = self._files[path]
            if mode != "r" and f.mode == "r":
                f.close()
                del self._files[path]
            else:
                return f
        if mode == "r":
            f = h5py.File(path, "r")
        elif not os.path.exists(path):
            f = h5py.File(path, "w")
        else:
            f = h5py.File(path, "a")
        if self.keep_open:
            self._files[path] = f
        return f

    def read(self, name: str, lh5_file: str, **kwargs) -> LGDO:
        f = self.gimme_file(lh5_file, "r")
        try:
            return read(name, f, **kwargs)
        finally:
            if not self.keep_open and isinstance(lh5_file, str):
                f.close()

    def write(
        self,
        obj: LGDO,
        name: str,
        lh5_file: str,
        group: str = "/",
        wo_mode: str = "append",
        write_start: int = 0,
        n_rows: int | None = None,
    ) -> None:
        f = self.gimme_file(lh5_file, "a")
        try:
            write(
                obj,
                name,
                f,
                group=group,
                wo_mode=wo_mode,
                write_start=write_start,
                n_rows=n_rows,
            )
            f.flush()
        finally:
            if not self.keep_open and isinstance(lh5_file, str):
                f.close()

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
