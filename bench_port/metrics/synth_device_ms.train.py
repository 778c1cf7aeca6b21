"""Device time of a synthetic batch: ms of the kernels, copies and sets
launched under the program's ``synth/batch`` spans (``count/spans.py``),
per batch."""
from bench_port.count.spans import index

SPAN = "synth/batch"


def read(ctx):
    idx = index(ctx)
    n = len(idx.named([SPAN]))
    return idx.device_us([SPAN]) / 1e3 / n if n else None
