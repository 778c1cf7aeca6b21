"""The device's idle share over the traced unit: 1 - the union of its
kernel, copy and set intervals over the unit's wall time, in %."""
from bench_port.count.trace import busy_us


def read(ctx):
    lo, hi = ctx["window_us"]
    return 100.0 * (1.0 - busy_us(ctx["events"], lo, hi) / (hi - lo))
