"""Faults planted in the program's timed path, where a chunk's outputs are
fetched from the device (``ProcessingChain.fetch``), for the readings that
the comparison's limits are set from (``control.py``, on the card) and for
the tests that see a broken run judged not correct (on the CPU).

Every fault but ``half`` strikes one chunk a file, the middle one (the
fetches are counted from the planting on, so the window's files line up):

- ``stale``: the chunk keeps the outputs of the chunk before it (a state
  not refreshed);
- ``half``: the second half of every chunk is left out (NaN, no pulses);
- a column fault of the configuration's ``check.faults``: one output
  column of the chunk altered where it is produced, multiplied by
  ``scale`` and shifted by ``add`` (in the column's unit).
"""

import contextlib

import numpy as np

from dspeed_tpu_torch.processing_chain import ProcessingChain


def kinds(spec: dict) -> list:
    """Every fault that a configuration's ``check`` can have planted."""
    return ["stale", "half"] + [f["name"] for f in spec.get("faults", [])]


def _column(key: str) -> str:
    """An output's column name from the chain's fetch key (``name#id@unit``)."""
    return key.split("#")[0]


@contextlib.contextmanager
def planted(kind: str, spec: dict, chunks_per_file: int):
    """Plant ``kind`` in ``ProcessingChain.fetch`` for the ``with`` block."""
    column = {f["name"]: f for f in spec.get("faults", [])}
    if kind not in ("stale", "half") and kind not in column:
        raise ValueError(f"unknown fault {kind!r}; this configuration has {kinds(spec)}")
    orig = ProcessingChain.fetch
    state = {"i": 0, "prev": None}

    def fetch(self, pending):
        out = orig(self, pending)
        i = state["i"]
        state["i"] += 1
        struck = i % chunks_per_file == chunks_per_file // 2
        if kind == "half":
            for k, v in out.items():
                h = len(v) // 2
                v[h:] = 0 if _column(k) == "no_out" else np.nan
        elif kind == "stale":
            prev = state["prev"]
            state["prev"] = {k: v.copy() for k, v in out.items()}
            if struck and prev is not None:
                for k, v in out.items():
                    v[...] = prev[k]
        elif struck:
            f = column[kind]
            for k, v in out.items():
                if _column(k) == f["column"]:
                    v *= f.get("scale", 1.0)
                    v += f.get("add", 0.0)
        return out

    ProcessingChain.fetch = fetch
    try:
        yield
    finally:
        ProcessingChain.fetch = orig
