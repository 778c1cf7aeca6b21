"""Device time of the collectives a train step runs across the cards
(the NCCL kernels of rank 0's traced epoch: the gradient all-reduce, the
global BatchNorm's sums, the pose sweep's gathers, the loader's
broadcasts), in ms per train step."""
from bench_port.count.trace import kernel_durations, ranges


def read(ctx):
    lo, hi = ctx["window_us"]
    steps = len(ranges(ctx["events"], "train#", lo, hi))
    secs = kernel_durations(ctx["events"], lo, hi, "nccl")
    return sum(secs) / steps * 1e3 if steps and secs else None
