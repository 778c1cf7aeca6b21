"""The host's time to queue one synthetic batch (``StageTimer`` stage
"synth batch", which never waits on the card), in ms a call."""


def read(ctx):
    n = ctx["timer"]["calls"].get("synth batch", 0)
    return ctx["timer"]["seconds"]["synth batch"] / n * 1e3 if n else None
