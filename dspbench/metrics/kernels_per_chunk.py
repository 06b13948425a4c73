"""Device kernels in the profiler's trace of the window (the port's and
PyTorch's alike), a chunk."""


def read(rec):
    dev, chunks = rec.get("device"), rec.get("chunks")
    if not dev or not chunks:
        return None
    return len(dev["kernels"]) / chunks
