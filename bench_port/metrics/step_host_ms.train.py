"""The host's time to queue one train step (``StageTimer`` stage "train
step": forward, losses, backward, clip and Adam, never waiting on the
card), in ms a call."""


def read(ctx):
    n = ctx["timer"]["calls"].get("train step", 0)
    return ctx["timer"]["seconds"]["train step"] / n * 1e3 if n else None
