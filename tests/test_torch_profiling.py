"""The span mechanism of ``artiboost_torch/utils/profiling.py``: a shared
null context while no session runs, and while one runs spans with their
parent, step and counts, on their thread's row and on the profiler's own
clock, merged into the exported Chrome trace."""
from __future__ import annotations

import glob
import json
import threading

import pytest
import torch

from artiboost_torch.utils import profiling


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, {e["name"]: e for e in events if e.get("cat") == "user_annotation"}


@pytest.fixture
def session(tmp_path):
    """A running session -> a function that stops it and returns the
    exported trace's events and its spans by name."""
    assert profiling._session is None
    profiling.start_trace(str(tmp_path))
    try:
        yield lambda: _spans(profiling.stop_trace())
    finally:
        profiling.stop_trace()


def test_without_a_session_trace_is_one_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span read the clock or entered record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    null = profiling.trace("engine/sweep")
    assert profiling.trace("engine/sweep", triplets=4) is null
    assert profiling.step_trace("train", 3) is null
    with null as span:
        with profiling.trace("model/update"):
            span.count(bytes=8)
    assert profiling._session is None


def test_exported_trace_holds_nested_spans_with_parent_step_and_counts(session):
    with profiling.trace("bench/unit"):
        with profiling.step_trace("train", 7):
            with profiling.trace("engine/sweep", triplets=8192) as span:
                with profiling.trace("engine/chunk"):
                    pass
                span.count(bytes=4096)
        with profiling.trace("mining/step_eval"):
            pass
    _, spans = session()
    unit, step, batch = spans["bench/unit"], spans["train#7"], spans["engine/sweep"]
    render, mining = spans["engine/chunk"], spans["mining/step_eval"]
    assert unit["args"] == {"id": unit["args"]["id"], "parent": None, "step": None}
    assert step["args"]["parent"] == unit["args"]["id"] and step["args"]["step"] == 7
    assert batch["args"] == {"id": batch["args"]["id"], "parent": step["args"]["id"], "step": 7,
                             "triplets": 8192, "bytes": 4096}
    assert render["args"]["parent"] == batch["args"]["id"] and render["args"]["step"] == 7
    assert mining["args"]["parent"] == unit["args"]["id"] and mining["args"]["step"] is None
    for inner, outer in ((step, unit), (batch, step), (render, batch)):
        assert outer["ts"] <= inner["ts"] and \
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_a_span_on_another_thread_lands_on_that_threads_row(session):
    tids = {}

    def producer():
        tids["producer"] = threading.get_native_id()
        with profiling.trace("data/real_geometry"):
            with profiling.trace("data/real_decode"):
                pass

    with profiling.trace("data/real_wait"):
        thread = threading.Thread(target=producer)
        thread.start()
        thread.join()
    _, spans = session()
    geometry, decode, wait = (spans[n] for n in ("data/real_geometry", "data/real_decode",
                                                 "data/real_wait"))
    assert geometry["tid"] == decode["tid"] == tids["producer"] != wait["tid"]
    assert wait["tid"] == threading.get_native_id()
    # a thread's first span opens in none of another thread's
    assert geometry["args"]["parent"] is None
    assert decode["args"]["parent"] == geometry["args"]["id"]


def test_an_op_inside_a_span_lies_inside_it_on_the_exported_clock(session):
    a = torch.randn(128, 128)
    with profiling.trace("model/forward_backward"):
        a @ a
    events, spans = session()
    span = spans["model/forward_backward"]
    (mm,) = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert mm["tid"] == span["tid"]
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]


def test_step_trace_still_writes_the_train_step_range(tmp_path):
    with profiling.trace_window(str(tmp_path)):
        for step in (4, 5):
            with profiling.step_trace("train", step):
                with profiling.trace("artiboost/train_step"):
                    pass
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    steps = {e["name"]: e["args"]["step"] for e in events if e["name"].startswith("train#")}
    assert steps == {"train#4": 4, "train#5": 5}
    assert sorted(e["args"]["step"] for e in events if e["name"] == "artiboost/train_step") == [4, 5]


@pytest.mark.parametrize("layout", [
    # as the profiler writes it: the list closed just before "traceName"
    '{\n "baseTimeNanoseconds": 1000000,\n "traceEvents": [\n  {"ph": "X", "name": "op"}\n  ],'
    '"traceName": "t.json" }',
    '{"baseTimeNanoseconds": 1000000, "traceEvents": [ ], "traceName": "t.json"}',
])
def test_spans_splice_into_the_exported_trace(tmp_path, layout):
    path = tmp_path / "trace.json"
    path.write_text(layout)
    spans = [("a", 7, 3_000_000, 5_000_000, 1, None, None, {}),
             ("b", 7, 3_500_000, 4_000_000, 2, 1, 4, {"rows": 16})]
    profiling._merge_spans(str(path), spans)
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert [e["name"] for e in events if e.get("cat") != "user_annotation"] == \
        (["op"] if '"op"' in layout else [])
    assert (got["a"]["ts"], got["a"]["dur"], got["a"]["tid"]) == (2000.0, 2000.0, 7)
    assert got["b"]["args"] == {"id": 2, "parent": 1, "step": 4, "rows": 16}


def test_a_trace_laid_out_otherwise_is_refused_and_left_as_it_was(tmp_path):
    layout = '{"traceEvents": [{"ph": "X", "name": "op"}], "baseTimeNanoseconds": 1000000}'
    path = tmp_path / "trace.json"
    path.write_text(layout)
    with pytest.raises(ValueError, match="trace.json"):
        profiling._merge_spans(str(path), [("a", 7, 3_000_000, 5_000_000, 1, None, None, {})])
    assert path.read_text() == layout
