"""Kernel launches of a train step: the runtime's launch calls made under
the program's ``model/forward_backward`` and ``model/update`` spans
(``count/spans.py``), per step."""
from bench_port.count.spans import index

SPANS = ("model/forward_backward", "model/update")


def read(ctx):
    idx = index(ctx)
    n = len(idx.named(SPANS[:1]))
    return idx.launches(SPANS) / n if n else None
