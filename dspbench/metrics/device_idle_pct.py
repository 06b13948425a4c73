"""Share of the traced window in which the device runs no kernel and no
copy (the union of their intervals in the profiler's trace), in %."""

from tracing import union_s


def read(rec):
    dev, window = rec.get("device"), rec.get("window_s")
    if not dev or not window:
        return None
    busy = union_s([(s, e) for s, e, _ in dev["kernels"] + dev["copies"]])
    return 100.0 * (1.0 - busy / window)
