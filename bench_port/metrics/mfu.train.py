"""Model FLOP utilization of the traced epoch: forward and backward
operations of the model per image (``count/flops.py``) times the images
trained, over the epoch's wall time and the bfloat16 dense peak of the
cards used, in %."""
from bench_port.count import peaks


def read(ctx):
    lo, hi = ctx["window_us"]
    secs = (hi - lo) / 1e6
    return 100.0 * ctx["flops"]["train"] * ctx["traced_images"] / secs / (peaks.BF16_FLOPS * ctx["chips"])
