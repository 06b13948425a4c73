"""The comparison that decides ``correct``: every output column of every file
completed in the window against the plain reference over the event pool.

A file that starts at pool row ``o`` must equal rows ``o .. o + n`` of the
reference's columns. Each column has a tolerance of its own (the
configuration file's ``check.tolerance``: ``[rtol, atol]``, in the column's
unit): a value is off where ``|program - reference| > rtol * |reference| +
atol``, or where it is NaN on one side only. ``[0, 0]`` is an exact
comparison. Two numbers are compared with their limits (``check.limits``):

- ``bad_share``: the share of the files' events in which some column is off;
  for a VectorOfVectors column, also an event whose length differs. A row
  written to the wrong place, a stale or missing chunk, a dropped column, a
  time point or an amplitude altered where it is produced show here.
- ``energy_gap``: over the ``gap_columns`` and over every chunk of every
  file, the largest of the chunk's median over events of ``|program -
  reference| / scale`` (``scale``: the column's largest magnitude in the
  reference; a VectorOfVectors event: its widest entry; events whose lengths
  differ are left to ``bad_share``). Arithmetic in a lower precision than the
  configuration states shows here, also where it is confined to one chunk.
"""

import numpy as np


def _vov_padded(col):
    """(lengths, flat values, event of each value, slot of each value)."""
    cum = np.asarray(col.cumulative_length.nda, dtype=np.int64)
    lens = np.diff(np.concatenate([[0], cum]))
    total = int(cum[-1]) if len(cum) else 0
    flat = np.asarray(col.flattened_data.nda[:total], dtype=np.float64)
    ev = np.repeat(np.arange(len(lens)), lens)
    slot = np.arange(total) - np.repeat(cum - lens, lens)
    return lens, flat, ev, slot


def off_by(got, want, rtol: float, atol: float):
    """(off, ratio): where ``got`` departs from ``want`` beyond the
    tolerance, and ``|got - want| / (rtol * |want| + atol)`` (inf where
    the tolerance is 0 and the values differ, 0 where both are NaN)."""
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.abs(got - want)
        tol = rtol * np.abs(want) + atol
        ratio = np.where(d == 0, 0.0, d / tol)
    ratio = np.where(nan_g & nan_w, 0.0, np.where(nan_g | nan_w, np.inf, ratio))
    return ratio > 1.0, ratio


class Comparison:
    def __init__(self, ref: dict, spec: dict, chunk: int):
        """``ref``: column name -> reference over the pool (a VectorOfVectors
        column as ``(events, slots)`` NaN-padded, with its lengths under
        ``"n"``); ``spec``: the configuration's ``check``; ``chunk``: the
        events a chunk (``energy_gap`` is a chunk's median)."""
        self.ref = ref
        self.spec = spec
        self.chunk = chunk
        self.tol = spec["tolerance"]
        self.scale = {k: float(np.nanmax(np.abs(v))) if np.isfinite(v).any() else 1.0
                      for k, v in ref.items() if k != "n"}
        for k, s in self.scale.items():
            if s == 0.0:
                self.scale[k] = 1.0
        self.events = 0
        self.bad = 0
        self.gap = 0.0
        self.column_bad = {}  # column -> events it made wrong
        self.worst = {k: 0.0 for k in self.tol}  # column -> largest |d| / tolerance
        self.examples = []  # (column, pool row, program, reference), a few

    def add_file(self, out, offset: int) -> None:
        """Compare one completed file's output table, which starts at pool
        row ``offset``."""
        n = None
        bad = None
        for name, (rtol, atol) in self.tol.items():
            col = out[name]
            ref = self.ref[name]
            if hasattr(col, "cumulative_length"):
                lens, flat, ev, slot = _vov_padded(col)
                n = len(lens)
                r = ref[offset:offset + n]
                rlen = self.ref["n"][offset:offset + n]
                wrong = lens != rlen
                fits = ~wrong[ev] & (slot < r.shape[1])
                want = np.full(len(flat), np.nan)
                want[fits] = r[ev[fits], np.minimum(slot[fits], r.shape[1] - 1)]
                off, ratio = off_by(flat, want, rtol, atol)
                np.logical_or.at(wrong, ev[fits], off[fits])
                if fits.any():
                    self.worst[name] = max(self.worst[name], float(ratio[fits].max()))
                if name in self.spec["gap_columns"]:
                    g = np.zeros(n)
                    d = np.abs(flat - want) / self.scale[name]
                    np.maximum.at(g, ev[fits], np.nan_to_num(d[fits], nan=np.inf))
                    self._chunk_gaps(g, (rlen > 0) & (lens == rlen))
            else:
                got = np.asarray(col.nda, dtype=np.float64)
                n = len(got)
                r = ref[offset:offset + n]
                if len(r) != n:
                    raise ValueError(f"{name}: {n} rows past the pool's end")
                wrong, ratio = off_by(got, r, rtol, atol)
                if n:
                    self.worst[name] = max(self.worst[name], float(ratio.max()))
                for i in np.flatnonzero(wrong)[:max(0, 8 - len(self.examples))]:
                    self.examples.append((name, offset + int(i), float(got[i]), float(r[i])))
                if name in self.spec["gap_columns"]:
                    d = np.abs(got - r) / self.scale[name]
                    self._chunk_gaps(d, np.isfinite(d))
            if wrong.any():
                self.column_bad[name] = self.column_bad.get(name, 0) + int(wrong.sum())
            bad = wrong if bad is None else (bad | wrong)
        self.events += n
        self.bad += int(bad.sum())

    def _chunk_gaps(self, d, keep) -> None:
        """Fold each chunk's median of ``d`` over the events ``keep`` holds
        into ``energy_gap``."""
        for lo in range(0, len(d), self.chunk):
            v = d[lo:lo + self.chunk][keep[lo:lo + self.chunk]]
            if len(v):
                self.gap = max(self.gap, float(np.median(v)))

    def numbers(self) -> dict:
        """The compared numbers: name -> value."""
        share = self.bad / self.events if self.events else 1.0
        return {"bad_share": share, "energy_gap": self.gap}
