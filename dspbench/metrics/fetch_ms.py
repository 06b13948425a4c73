"""Mean host span of ``ProcessingChain.finish_chunk`` on the writer thread, a
chunk: the device-to-host fetch, the output managers and the VectorOfVectors
pack."""


def read(rec):
    spans = (rec.get("spans") or {}).get("fetch") or []
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e3 / len(spans)
