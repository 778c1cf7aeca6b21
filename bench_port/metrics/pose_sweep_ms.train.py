"""The pose sweep (``loader.prepare()``), host clock around each call
ending in a synchronize, in ms per 1,000 triplets swept."""


def read(ctx):
    secs = sum(s for s, _ in ctx["sweeps"])
    n = sum(t for _, t in ctx["sweeps"])
    return secs / n * 1e6 if n else None
