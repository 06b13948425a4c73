"""An in-memory event source that ``build_dsp`` reads as it reads a raw file.

``PoolSource`` hands out one "file" of ``n_events`` events of a pool held in
host memory (pageable numpy arrays, as a reader returns them), ``buffer_len``
events a chunk, with the interface of the port's ``LH5Iterator``: ``len``,
``read``, ``n_entries``, ``reset_field_mask``, and iteration with
``current_i_entry``. It subclasses ``LH5Iterator`` only so that
``build_dsp`` takes its production path (read-ahead, staging on the copy
stream, write-behind); it opens no file and does not call the parent's
``__init__``. Every chunk is a zero-copy slice of the pool starting at row
``offset``.
"""

from dspeed_tpu_torch.lh5 import Array, LH5Iterator, Table, WaveformTable


class PoolSource(LH5Iterator):
    def __init__(self, pool: dict, kinds: dict, dt_ns: float, offset: int,
                 n_events: int, buffer_len: int, on_handover=None) -> None:
        """``pool``: column name -> numpy array (events first); ``kinds``:
        column name -> ``"waveform"`` or ``"array"``; ``on_handover``, if
        given, is called as each chunk of the iteration is handed over."""
        self.pool = pool
        self.kinds = kinds
        self.dt_ns = dt_ns
        self.offset = offset
        self.n_entries = n_events
        self.buffer_len = buffer_len
        self.on_handover = on_handover
        self.current_i_entry = 0
        self.field_mask = None
        self.i_start = 0
        self._friends = []

    def __len__(self) -> int:
        return self.n_entries

    def reset_field_mask(self, mask) -> None:
        self.field_mask = mask

    def read(self, i_entry: int, n_entries: int | None = None) -> Table:
        if n_entries is None:
            n_entries = min(self.buffer_len, self.n_entries - i_entry)
        lo = self.offset + i_entry
        cols = {}
        for name, kind in self.kinds.items():
            rows = self.pool[name][lo:lo + n_entries]
            if kind == "waveform":
                cols[name] = WaveformTable(values=rows, t0=0.0, t0_units="ns",
                                           dt=self.dt_ns, dt_units="ns")
            else:
                cols[name] = Array(rows)
        return Table(cols)

    def __iter__(self):
        i = 0
        while i < self.n_entries:
            n = min(self.buffer_len, self.n_entries - i)
            self.current_i_entry = i
            tb = self.read(i, n)
            if self.on_handover is not None:
                self.on_handover()
            yield tb
            i += n

    def close(self) -> None:
        pass
