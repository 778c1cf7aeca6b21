"""Device time of a train step: ms of the kernels, copies and sets
launched under the program's ``model/forward_backward`` and
``model/update`` spans (``count/spans.py``), per step."""
from bench_port.count.spans import index

SPANS = ("model/forward_backward", "model/update")


def read(ctx):
    idx = index(ctx)
    n = len(idx.named(SPANS[:1]))
    return idx.device_us(SPANS) / 1e3 / n if n else None
