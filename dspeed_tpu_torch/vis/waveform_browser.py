"""Interactive browsing of raw and DSP-transformed waveforms.

The counterpart of the JAX package's ``WaveformBrowser``
(``dspeed_tpu/vis/waveform_browser.py``, after the reference's
``dspeed/vis/waveform_browser.py:25-670``): builds the port's processing
chain over an LH5 file, iterator or table, pulls single entries (re-running
the chain on the chunk that holds them), and draws waveforms and horizontal
or vertical lines with unit-converted x axes, style cycling, formatted
legends, and normalization and alignment parameters.

The chain runs where ``device`` says (default CUDA, as every entry point of
the port), with the port's default fusion, so its hand kernels run. Finding
entries needs no matplotlib: each stored line is a :class:`LineData` (its x
and y arrays, ``get_xdata()`` / ``get_ydata()`` as a ``Line2D`` gives them)
until :meth:`WaveformBrowser.draw_current` wraps it as a
``matplotlib.lines.Line2D``. Only drawing, and a style name, import
matplotlib.
"""

from __future__ import annotations

import itertools
import math
import string
import sys
from typing import Mapping

import numpy as np

from .. import lh5 as lgdo
from ..lh5 import LH5Iterator, Table
from ..processing_chain import build_processing_chain
from ..units import Quantity, ureg

__all__ = ["LineData", "WaveformBrowser"]


def _is_unit(u) -> bool:
    return isinstance(u, str) and bool(u) and u in ureg


class LineData:
    """A stored line's data before it is drawn: the x and y arrays of the
    ``Line2D`` that :meth:`WaveformBrowser.draw_current` makes of it."""

    __slots__ = ("x", "y")

    def __init__(self, x, y) -> None:
        self.x = np.asarray(x)
        self.y = np.asarray(y)

    def get_xdata(self):
        return self.x

    def get_ydata(self):
        return self.y


class WaveformBrowser:
    """Draws waveforms and computed DSP quantities from LH5 data.

    The JAX package's constructor arguments (the reference's docstring,
    ``waveform_browser.py:34-154``, describes them), plus ``device``: where
    the chain runs (default CUDA; pass ``"cpu"`` on a machine without a
    card). An entry past the end raises ``IndexError``; ``safe=True`` (as
    :meth:`find_next` passes it, to every entry of a list, as the reference
    does) skips it.
    """

    def __init__(
        self,
        raw_in,
        lh5_group: str = "",
        base_path: str = "",
        entry_list=None,
        entry_mask=None,
        dsp_config=None,
        database=None,
        aux_values=None,
        lines=None,
        styles=None,
        legend=None,
        legend_opts=None,
        n_drawn: int = 1,
        x_unit=None,
        x_lim=None,
        y_lim=None,
        norm: str = None,
        align: str = None,
        buffer_len: int = 128,
        block_width: int = 8,
        device=None,
    ) -> None:
        # --- input data ---------------------------------------------------
        if isinstance(raw_in, Table):
            self.lh5_it = None
            tb_in = raw_in
        elif isinstance(raw_in, LH5Iterator):
            self.lh5_it = raw_in
            self.lh5_it.buffer_len = buffer_len
            tb_in = self.lh5_it.read(0)
        else:
            self.lh5_it = LH5Iterator(
                raw_in,
                lh5_group,
                base_path=base_path,
                entry_list=entry_list,
                entry_mask=entry_mask,
                buffer_len=buffer_len,
            )
            tb_in = self.lh5_it.read(0)
        self._chunk_start = 0
        self._chunk_len = len(tb_in)

        self.aux_vals = aux_values
        # like the reference (:186), reindex aux values into selection space
        if self.aux_vals is not None and (
            entry_list is not None or entry_mask is not None
        ):
            sel = (
                np.flatnonzero(np.asarray(entry_mask, bool))
                if entry_mask is not None
                else np.asarray(entry_list, "int64")
            )
            self.aux_vals = {
                k: np.asarray(v)[sel] for k, v in self.aux_vals.items()
            }
        self.norm_par = norm
        self.align_par = align
        self.n_drawn = n_drawn
        self.next_entry = 0

        # --- lines to draw ------------------------------------------------
        if lines is None:
            lines = []
        if isinstance(lines, str):
            lines = [lines]
        self.lines: dict[str, list] = {name: [] for name in lines}

        # --- legend formats -----------------------------------------------
        self.legend_format: list[str] = []
        self.legend_vals: dict[str, list] = {}
        if legend is None:
            legend = []
        if isinstance(legend, str):
            legend = [legend]
        for leg in legend:
            # bare name -> "name = {name}" convenience like the reference
            if "{" not in leg and leg:
                self.legend_vals.setdefault(leg, [])
                leg = f"{leg} = {{{leg}}}"
            for _, name, _, _ in string.Formatter().parse(leg):
                if name:
                    self.legend_vals.setdefault(name, [])
            self.legend_format.append(leg)
        self.legend_kwargs = dict(legend_opts) if isinstance(legend_opts, Mapping) else {}

        # --- styles -------------------------------------------------------
        self.styles = None
        if isinstance(styles, Mapping):
            from cycler import cycler

            self.styles = itertools.cycle(cycler(**styles))
        elif isinstance(styles, str):
            import matplotlib.pyplot as plt

            sty = plt.style.library.get(styles)
            if sty is not None and "axes.prop_cycle" in sty:
                self.styles = itertools.cycle(sty["axes.prop_cycle"])

        # --- processing chain ---------------------------------------------
        needed = set(self.lines) | set(self.legend_vals)
        if self.norm_par:
            needed.add(self.norm_par)
        if isinstance(self.align_par, str):
            needed.add(self.align_par)
        if self.aux_vals is not None:
            needed -= set(self.aux_vals.keys())
        outputs = sorted(needed)
        self.proc_chain, self._field_mask, self.lh5_out = build_processing_chain(
            dsp_config if dsp_config is not None else {"processors": {}, "outputs": []},
            tb_in,
            db_dict=database,
            outputs=outputs,
            block_width=block_width,
            device=device,
        )
        if self.lh5_it is not None:
            self.lh5_it.reset_field_mask(self._field_mask)
        self.proc_chain(tb_in, self.lh5_out)

        # --- axes ---------------------------------------------------------
        self.x_unit = None
        if x_unit:
            self.x_unit = ureg.Quantity(x_unit).u if isinstance(x_unit, str) else x_unit
        if self.x_unit is None:
            wf_tb = next(
                (c for c in tb_in.values() if isinstance(c, lgdo.WaveformTable)),
                None,
            )
            if wf_tb is not None and _is_unit(wf_tb.dt_units):
                self.x_unit = ureg.Quantity(wf_tb.dt_units).u
        self.x_lim = x_lim
        self.y_lim = y_lim
        self.auto_x_lim = [np.inf, -np.inf]
        self.auto_y_lim = [np.inf, -np.inf]
        self.n_stored = 0
        self.fig = None
        self.ax = None

    # -- figure management -------------------------------------------------

    def new_figure(self) -> None:
        import matplotlib.pyplot as plt

        self.fig, self.ax = plt.subplots(1)

    def set_figure(self, fig, ax=None) -> None:
        if isinstance(fig, WaveformBrowser):
            self.fig, self.ax = fig.fig, fig.ax
        else:
            self.fig = fig
            self.ax = ax if ax is not None else fig.axes[0]

    def save_figure(self, f_out: str, *args, **kwargs) -> None:
        self.fig.savefig(f_out, *args, **kwargs)

    def clear_data(self) -> None:
        for lines in self.lines.values():
            lines.clear()
        for vals in self.legend_vals.values():
            vals.clear()
        self.auto_x_lim = [np.inf, -np.inf]
        self.auto_y_lim = [np.inf, -np.inf]
        self.n_stored = 0

    # -- data access -------------------------------------------------------

    def _fetch_entry(self, entry: int) -> int | None:
        """Ensure lh5_out holds the chunk containing ``entry``; return the
        in-chunk index, or None past EOF. Only the first ``_chunk_len``
        rows of lh5_out belong to the chunk: the rows after them still hold
        an earlier chunk's outputs."""
        if not 0 <= entry < len(self):
            return None
        if self.lh5_it is None:
            return entry
        bl = self.lh5_it.buffer_len
        chunk = (entry // bl) * bl
        if chunk != self._chunk_start:
            tb_in = self.lh5_it.read(chunk)
            self._chunk_start = chunk
            self._chunk_len = len(tb_in)
            self.proc_chain(tb_in, self.lh5_out)
        i_tb = entry - self._chunk_start
        if i_tb >= self._chunk_len:
            return None
        return i_tb

    def find_entry(self, entry, append: bool = True, safe: bool = False) -> None:
        """Load ``entry`` (or a list of entries) into the internal store."""
        if not append:
            self.clear_data()
        if hasattr(entry, "__iter__"):
            for idx in entry:
                self.find_entry(idx, safe=safe)
            return
        i_tb = self._fetch_entry(entry)
        if i_tb is None:
            if safe:
                return
            raise IndexError(entry)

        if self.norm_par is None:
            norm = 1.0
        elif isinstance(self.norm_par, str):
            norm = float(self._get_column(self.norm_par, i_tb, entry))
        else:
            norm = float(self.norm_par[entry])

        ref_time = 0.0
        if self.align_par is not None:
            val = self._get_column(self.align_par, i_tb, entry)
            unit = self._get_column_unit(self.align_par)
            ref_time = float(np.atleast_1d(val)[0])
            if (
                _is_unit(unit)
                and self.x_unit is not None
                and ureg.is_compatible_with(unit, self.x_unit)
            ):
                ref_time *= float(ureg.Quantity(unit) / Quantity(1, self.x_unit))

        lim = math.sqrt(sys.float_info.max)
        for name, linelist in self.lines.items():
            data = self.lh5_out[name] if name in self.lh5_out else None
            if data is None and self.aux_vals is not None and name in self.aux_vals:
                val = self.aux_vals[name][entry]
                linelist.append(LineData([-lim, lim], [val / norm] * 2))
                self._update_auto_limit(None, np.atleast_1d(val))
                continue
            if isinstance(data, lgdo.WaveformTable):
                y = data.values.nda[i_tb, :] / norm
                scale = (
                    float(ureg.Quantity(data.dt_units) / Quantity(1, self.x_unit))
                    if _is_unit(data.dt_units) and self.x_unit is not None
                    else 1.0
                )
                dt = data.dt.nda[i_tb] * scale
                t0 = data.t0.nda[i_tb] * scale - ref_time
                x = t0 + dt * np.arange(data.wf_len)
                linelist.append(LineData(x, y))
                self._update_auto_limit(x, y)
            elif isinstance(data, (lgdo.ArrayOfEqualSizedArrays, lgdo.VectorOfVectors,
                                   lgdo.Array)):
                if isinstance(data, lgdo.Array) and data.nda.ndim == 1:
                    vals = [data.nda[i_tb]]
                elif isinstance(data, lgdo.VectorOfVectors):
                    vals = list(data[i_tb])
                else:
                    vals = list(data.nda[i_tb])
                unit = data.attrs.get("units")
                if (
                    _is_unit(unit)
                    and self.x_unit is not None
                    and ureg.is_compatible_with(unit, self.x_unit)
                ):
                    scale = float(ureg.Quantity(unit) / Quantity(1, self.x_unit))
                    for val in vals:
                        xv = val * scale - ref_time
                        if np.isnan(xv):
                            continue
                        linelist.append(LineData([xv, xv], [-lim, lim]))
                        self._update_auto_limit(np.array([xv]), None)
                else:
                    for val in vals:
                        if np.isnan(val):
                            continue
                        linelist.append(LineData([-lim, lim], [val / norm] * 2))
                        self._update_auto_limit(None, np.array([val]))
            elif data is None:
                raise KeyError(f"{name} not found in DSP outputs or aux values")

        for name, vals in self.legend_vals.items():
            val = self._get_column(name, i_tb, entry)
            unit = self._get_column_unit(name)
            if _is_unit(unit):
                val = Quantity(float(np.atleast_1d(val)[0]), unit)
            vals.append(val)

        self.n_stored += 1
        self.next_entry = entry + 1

    def _get_column(self, name: str, i_tb: int, entry: int):
        if name in self.lh5_out:
            data = self.lh5_out[name]
            if isinstance(data, lgdo.WaveformTable):
                return data.values.nda[i_tb]
            if isinstance(data, lgdo.VectorOfVectors):
                return data[i_tb]
            return data.nda[i_tb]
        if self.aux_vals is not None and name in self.aux_vals:
            return self.aux_vals[name][entry]
        raise KeyError(f"{name} not found in DSP outputs or aux values")

    def _get_column_unit(self, name: str):
        if name in self.lh5_out:
            return self.lh5_out[name].attrs.get("units")
        return None

    def _update_auto_limit(self, x, y) -> None:
        if x is not None:
            fin = x[np.isfinite(x)]
            if len(fin):
                self.auto_x_lim[0] = min(self.auto_x_lim[0], fin.min())
                self.auto_x_lim[1] = max(self.auto_x_lim[1], fin.max())
        if y is not None:
            fin = y[np.isfinite(y)]
            if len(fin):
                self.auto_y_lim[0] = min(self.auto_y_lim[0], fin.min())
                self.auto_y_lim[1] = max(self.auto_y_lim[1], fin.max())

    # -- drawing -----------------------------------------------------------

    def draw_current(self, clear: bool = True) -> None:
        """Draw everything currently stored; each stored :class:`LineData`
        becomes the ``Line2D`` drawn."""
        import matplotlib.pyplot as plt
        from cycler import cycler
        from matplotlib.lines import Line2D

        if not (self.ax and self.fig and plt.fignum_exists(self.fig.number)):
            self.new_figure()
        if clear:
            self.ax.clear()

        x_lim = self.x_lim if self.x_lim else self.auto_x_lim
        y_lim = self.y_lim
        if not y_lim and np.isfinite(self.auto_y_lim).all():
            yr = self.auto_y_lim[1] - self.auto_y_lim[0]
            y_lim = [self.auto_y_lim[0] - 0.05 * yr, self.auto_y_lim[1] + 0.05 * yr]
        if x_lim and np.isfinite(x_lim).all():
            self.ax.set_xlim(*x_lim)
        if y_lim and np.isfinite(y_lim).all():
            self.ax.set_ylim(*y_lim)

        leg_handles = []
        default_style = itertools.cycle(cycler(plt.rcParams["axes.prop_cycle"]))
        styles = self.styles if self.styles is not None else default_style
        for linelist in self.lines.values():
            for i, line in enumerate(linelist):
                if isinstance(line, LineData):
                    line = linelist[i] = Line2D(line.x, line.y)
                sty = next(styles)
                if sty:
                    line.update(sty)
                if line.get_figure() is not None:
                    line.remove()
                line.set_transform(self.ax.transData)
                self.ax.add_line(line)
                leg_handles.append(line)

        leg_labels = []
        if self.legend_format:
            for i in range(self.n_stored):
                vals = {k: v[i] for k, v in self.legend_vals.items() if i < len(v)}
                for form in self.legend_format:
                    try:
                        leg_labels.append(form.format(**vals))
                    except (KeyError, ValueError, TypeError):
                        leg_labels.append(form)
        if leg_labels:
            self.ax.legend(
                leg_handles[: len(leg_labels)], leg_labels, **self.legend_kwargs
            )
        if self.x_unit is not None:
            self.ax.set_xlabel(format(self.x_unit, "~") or str(self.x_unit))

    def draw_entry(self, entry, append: bool = False, clear: bool = True) -> None:
        self.find_entry(entry, append)
        self.draw_current(clear)

    def find_next(self, n_wfs: int = None, append: bool = False):
        if n_wfs is None:
            n_wfs = self.n_drawn
        start = self.next_entry
        entries = range(start, start + n_wfs)
        self.find_entry(entries, append, safe=True)
        return entries

    def draw_next(self, n_wfs: int = None, append: bool = False, clear: bool = True):
        entries = self.find_next(n_wfs, append)
        self.draw_current(clear)
        return entries

    def reset(self) -> None:
        self.clear_data()
        self.next_entry = 0

    def __len__(self) -> int:
        if self.lh5_it is not None:
            return len(self.lh5_it)
        return len(self.lh5_out)

    def __iter__(self):
        self.reset()
        while self.next_entry < len(self):
            yield self.draw_next()
