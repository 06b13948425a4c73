"""The chain's least device time over its kernels' device time, in %.

The least time is the bytes the chain must move, each input sample read
once and each output column written once (the configuration's
``bytes_per_event``), over the card's peak bandwidth; the kernels' time is
the union of the kernel intervals in the profiler's trace of the window.
Bytes only: the yardstick is the same work whatever implements it."""

from tracing import union_s


def read(rec):
    dev = rec.get("device")
    if not dev or not dev["kernels"] or not rec.get("events"):
        return None
    busy = union_s([(s, e) for s, e, _ in dev["kernels"]])
    least = rec["bytes_per_event"] * rec["events"] / rec["peak_bytes_s"]
    return 100.0 * least / busy
