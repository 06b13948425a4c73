"""Host clock around the process's first ``build_dsp`` call (the warm-up
file: chain build, CUDA's lazy module loading, every shape), ending in
``torch.cuda.synchronize()``."""


def read(rec):
    v = rec.get("first_call_s")
    return None if v is None else v * 1e3
