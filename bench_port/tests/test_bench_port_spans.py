"""The readers of the program's spans (``count/spans.py`` and the metrics
built on it) on a small hand-written Chrome trace: device events tied to
their launch calls by ``correlation`` and those to the innermost program
span of their thread; torch's own ranges, other threads and the time
outside the window left out."""
import pytest

from bench_port import run
from bench_port.count.spans import SpanIndex

MAIN, OTHER, AUTOGRAD = 100, 200, 300


def span(sid, name, ts, end, parent, tid=MAIN, step=None, **counts):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": end - ts, "args": {"id": sid, "parent": parent, "step": step, **counts}}


def call(name, ts, dur, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def device(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr):
    return device("kernel", f"k{corr}", ts, dur, corr)


def trace():
    return [
        span(1, "bench/unit", 0, 1000, None),
        span(2, "engine/sweep", 10, 110, 1, triplets=2000),
        span(3, "engine/chunk", 20, 60, 2),
        span(4, "train#0", 200, 500, 1, step=0),
        span(5, "synth/batch", 210, 260, 4, step=0),
        span(6, "synth/render", 220, 250, 5, step=0),
        span(7, "artiboost/train_step", 300, 450, 4, step=0),
        span(8, "model/forward_backward", 300, 400, 7, step=0),
        span(9, "model/update", 400, 450, 7, step=0),
        span(10, "train/log", 460, 490, 4, step=0),
        span(11, "train#1", 500, 800, 1, step=1),
        span(12, "model/forward_backward", 510, 600, 11, step=1),
        span(13, "model/update", 600, 650, 11, step=1),
        span(14, "data/real_decode", 300, 600, None, tid=OTHER),
        # torch's own range: no program span, its calls stay with model/update
        {"ph": "X", "cat": "user_annotation", "name": "Optimizer.step#Adam.step", "pid": 1,
         "tid": MAIN, "ts": 405, "dur": 40, "args": {}},
        call("cudaLaunchKernel", 30, 4, 1), kernel(40, 40, 1),  # engine/chunk
        call("cudaMemsetAsync", 70, 3, 2), device("gpu_memset", "Memset", 80, 5, 2),
        call("cudaLaunchKernel", 150, 4, 11), kernel(160, 7, 11),  # bare bench/unit
        call("cudaLaunchKernelExC", 230, 4, 3), kernel(235, 12, 3),  # synth/render
        call("cudaMemcpyAsync", 255, 2, 4),  # synth/batch, host to device: no wait
        device("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 258, 3, 4),
        call("cudaLaunchKernel", 310, 4, 5), kernel(315, 20, 5),
        call("cudaLaunchKernel", 320, 4, 6), kernel(335, 30, 6),
        call("cudaLaunchKernel", 350, 4, 15, tid=AUTOGRAD), kernel(355, 5, 15),  # backward
        call("cudaLaunchKernel", 410, 4, 7), kernel(415, 10, 7),
        call("cudaMemcpyAsync", 470, 8, 10),  # train/log reads a value back
        device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 474, 2, 10),
        call("cudaMemcpyAsync", 462, 3, 16),  # into pinned memory: returns at once
        device("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 463, 1, 16),
        call("cudaStreamSynchronize", 480, 6, 12),
        call("cudaLaunchKernel", 520, 4, 8), kernel(525, 25, 8),
        call("cudaLaunchKernel", 610, 4, 9), kernel(615, 15, 9),
        call("cudaMemcpy", 660, 5, 18),  # the synchronous copy waits, pinned or not
        device("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 662, 1, 18),
        call("cudaDeviceSynchronize", 850, 20, 17),  # the unit's own, in no step
        call("cudaStreamSynchronize", 350, 100, 13, tid=OTHER),  # another thread's wait
        call("cudaDeviceSynchronize", 1200, 50, 14),  # after the window
    ]


def ctx_of(events):
    return {"events": events, "window_us": (0.0, 1000.0), "main_tid": MAIN}


def read(name, ctx):
    return run.load_reader(name).read(ctx)


def test_each_call_lies_in_the_innermost_span_of_its_thread():
    idx = SpanIndex(trace(), 0.0, 1000.0, MAIN)
    by_corr = {e["args"]["correlation"]: sid for e, sid in idx.launched_in}
    assert by_corr[1] == 3 and by_corr[2] == 2 and by_corr[11] == 1 and by_corr[3] == 6
    assert by_corr[7] == 9 and by_corr[12] == 10 and by_corr[13] == 14 and by_corr[14] is None
    assert by_corr[15] == 8  # a thread without spans of its own: the main thread's
    assert idx.under(["synth/batch"]) == {5, 6}
    assert idx.under(["train#0"]) == {4, 5, 6, 7, 8, 9, 10}


def test_device_ms_by_launching_span_and_the_triplets_divisor():
    ctx = ctx_of(trace())
    # the chunk's kernel and the sweep's own set: 45 us over 2,000 triplets
    assert read("sweep_device_ms.train", ctx) == pytest.approx(0.045 / 2)
    # the render's kernel and the batch's copy: 15 us in one batch
    assert read("synth_device_ms.train", ctx) == pytest.approx(0.015)
    # 65 us in step 0 (5 of them launched by the backward's thread) and 40 in step 1
    assert read("step_device_ms.train", ctx) == pytest.approx(0.0525)


def test_launches_per_step():
    assert read("step_launches.train", ctx_of(trace())) == pytest.approx(6 / 2)


def test_blocked_host_ms_of_the_main_thread_per_train_step():
    # the pageable copy (8 us), the synchronize (6 us) and the synchronous copy
    # (5 us) in the steps, over 2 steps
    assert read("host_wait_ms.train", ctx_of(trace())) == pytest.approx(0.019 / 2)


def test_a_trace_without_program_spans_reads_nothing():
    events = trace()
    for e in events:
        if e["cat"] == "user_annotation":
            e["args"] = {}
    ctx = ctx_of(events)
    for name in ("sweep_device_ms.train", "synth_device_ms.train", "step_device_ms.train",
                 "step_launches.train", "host_wait_ms.train"):
        assert read(name, ctx) is None
