"""Host clock from the benchmark's start to the window's: CUDA start-up,
the kernel libraries' load (their build in a fresh checkout), the event
pool made on the card and copied to host memory, and the warm-up file."""


def read(rec):
    return rec.get("setup_s")
