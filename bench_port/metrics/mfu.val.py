"""Model FLOP utilization of the traced val sweep: forward operations per
image (``count/flops.py``) times the images, over the sweep's wall time and
the bfloat16 dense peak of one card, in %."""
from bench_port.count import peaks


def read(ctx):
    lo, hi = ctx["window_us"]
    secs = (hi - lo) / 1e6
    return 100.0 * ctx["flops"]["forward"] * ctx["traced_images"] / secs / (peaks.BF16_FLOPS * ctx["chips"])
