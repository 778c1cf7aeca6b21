"""The reader of the share of train steps replayed as CUDA graphs
(``metrics/graphed_share.train.py``) on the hand-written trace of
``test_bench_port_spans.py``: the ``graph`` counts of the window's
``model/forward_backward`` spans, and nothing from a program whose spans
carry none."""
import pytest

from bench_port.tests.test_bench_port_spans import ctx_of, read, span, trace

FB = "model/forward_backward"


def with_graph(flags):
    """The trace with each forward-backward span's ``graph`` count set from
    ``flags`` (in order; None leaves it out), and one more such span after
    the window."""
    events = trace()
    fb = [e for e in events if e["name"] == FB]
    for e, flag in zip(fb, flags):
        if flag is not None:
            e["args"]["graph"] = flag
    events.append(span(99, FB, 1100, 1150, None, graph=0))
    return events


@pytest.mark.parametrize("flags,share", [((1, 1), 100.0), ((0, 1), 50.0), ((0, 0), 0.0)])
def test_share_of_replayed_steps_in_the_window(flags, share):
    assert read("graphed_share.train", ctx_of(with_graph(flags))) == pytest.approx(share)


def test_spans_without_the_count_read_nothing():
    assert read("graphed_share.train", ctx_of(with_graph((None, None)))) is None
    assert read("graphed_share.train", ctx_of(trace())) is None
