"""Events of every file completed in the window over the window's whole
time (host clock; the window ends at a file boundary, once each file's
outputs are on the host)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["events"] / rec["window_s"]
