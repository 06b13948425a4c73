"""``build_dsp``'s own ``stats["loading_s"]`` over the window's files, a
chunk: the main thread waiting for the read-ahead worker (and each file's
chain-cache lookup)."""


def read(rec):
    stats, chunks = rec.get("stats") or {}, rec.get("chunks")
    if "loading_s" not in stats or not chunks:
        return None
    return stats["loading_s"] * 1e3 / chunks
