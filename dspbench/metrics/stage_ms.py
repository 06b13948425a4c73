"""Mean host span of ``ProcessingChain.stage_inputs`` on the read-ahead worker,
a chunk: the copy into pinned memory and the copy stream's enqueue."""


def read(rec):
    spans = (rec.get("spans") or {}).get("stage") or []
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e3 / len(spans)
