"""The host's time in the metrics and the mining (``StageTimer`` stage
"metric+mining": the evaluator's feed of every val batch and the sweep's
``step_eval``), in ms per val batch."""


def read(ctx):
    n = ctx["steps"]
    return ctx["timer"]["seconds"].get("metric+mining", 0.0) / n * 1e3 if n else None
