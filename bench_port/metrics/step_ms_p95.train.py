"""The 95th percentile of the traced epoch's train steps' host ranges
(``train#<n>``: with PIPELINE_SYNTH the render of step n+1 and train step
n), in ms."""
import numpy as np
from bench_port.count.trace import ranges


def read(ctx):
    lo, hi = ctx["window_us"]
    durs = [e["dur"] / 1e3 for e in ranges(ctx["events"], "train#", lo, hi)]
    return float(np.percentile(durs, 95)) if durs else None
