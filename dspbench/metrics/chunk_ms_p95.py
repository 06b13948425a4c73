"""95th percentile over the window's chunks of a chunk's latency: from the
source handing it over (on the read-ahead worker) to the end of its
``finish_chunk`` (on the writer thread). Chunks are handed over, and
finished, in order, so the i-th of each belong together."""

import numpy as np


def read(rec):
    hand = rec.get("handover") or []
    ends = [e for _, e in (rec.get("spans") or {}).get("fetch", [])]
    n = min(len(hand), len(ends))
    if n == 0:
        return None
    lat = np.asarray(ends[:n]) - np.asarray(hand[:n])
    return float(np.percentile(lat, 95)) * 1e3
