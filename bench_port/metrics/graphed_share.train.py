"""The share of the traced unit's train steps whose forward and backward
replayed a CUDA graph: the program's ``model/forward_backward`` spans
whose ``graph`` count is 1, over all of them, in %. A program whose spans
carry no such count (one that has no graphs) gives nothing."""
from bench_port.count.spans import index


def read(ctx):
    spans = index(ctx).named(["model/forward_backward"])
    flags = [e["args"]["graph"] for e in spans if "graph" in e["args"]]
    return 100.0 * sum(flags) / len(spans) if flags else None
