"""B1's share of its roofline: the least time of the traced raster calls
(the larger of their bytes at the HBM peak and their operations at the
float32 peak, counted from the calls' inputs by ``count/raster_work.py``)
over the device time of the kernels named ``raster_uv_kernel``."""
from bench_port.count import peaks
from bench_port.count.trace import kernel_durations

KERNEL = "raster_uv_kernel"


def read(ctx):
    lo, hi = ctx["window_us"]
    secs = kernel_durations(ctx["events"], lo, hi, KERNEL)
    works = ctx["raster_work"]
    if not secs or len(secs) != len(works):
        return None
    least = sum(max(w["bytes"] / peaks.HBM_BYTES_S, w["ops"] / peaks.FP32_FLOPS) for w in works)
    return 100.0 * least / sum(secs)
