"""Device time of the pose sweep: ms of the kernels, copies and sets
launched under the program's ``engine/sweep`` spans (``count/spans.py``),
per 1,000 of the triplets those spans count."""
from bench_port.count.spans import index

SPAN = "engine/sweep"


def read(ctx):
    idx = index(ctx)
    triplets = sum(e["args"].get("triplets", 0) for e in idx.named([SPAN]))
    return idx.device_us([SPAN]) / 1e3 / (triplets / 1e3) if triplets else None
