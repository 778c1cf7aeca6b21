"""The host's wait on the card: ms the main thread spent under the
``train#<n>`` spans of the traced unit in runtime calls that block until
the card catches up (the synchronizes, and the copies from the device to
the host that wait for it; ``count/spans.py``), per train step."""
from bench_port.count.spans import index


def read(ctx):
    idx = index(ctx)
    steps = {e["name"] for e in idx.spans.values() if e["name"].startswith("train#")}
    n = len(idx.named(steps))
    return idx.blocked_us(ctx["main_tid"], steps) / 1e3 / n if n else None
