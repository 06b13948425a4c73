"""Mean host span of ``ProcessingChain.dispatch_chunk`` on the main thread, a
chunk: the step loop's enqueue."""


def read(rec):
    spans = (rec.get("spans") or {}).get("dispatch") or []
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e3 / len(spans)
