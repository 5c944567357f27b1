"""The profiler's reduction: busy time as the union of device intervals,
idle time summed by the host's span."""

import pytest

from portbench.profile import Spans, summarize, union


def test_union_counts_overlap_once():
    assert union([(0, 10), (5, 15), (20, 30), (30, 31)]) == [(0, 15), (20, 31)]


def test_summarize_busy_and_gaps():
    events = [("k1", 100, 200), ("copy", 150, 250), ("k2", 400, 500)]
    spans = Spans()
    spans.add("enqueue", 0, 300)
    spans.add("read-back", 300, 1000)
    s = summarize(events, (0, 1000), spans)
    assert s["busy_s"] == 250e-9          # not 300: the copy overlaps k1
    assert s["window_s"] == 1000e-9
    assert dict(s["idle_gaps"]) == pytest.approx({"enqueue": 100e-9, "read-back": 650e-9})
    assert s["kernels_s"] == {"k1": 100e-9, "copy": 100e-9, "k2": 100e-9}
    assert s["skew_ns"] == [-100, -500]


def test_span_lookup():
    spans = Spans()
    spans.add("a", 10, 20)
    spans.add("b", 20, 30)
    assert spans.at(15) == "a" and spans.at(20) == "b"
    assert spans.at(35) == "outside the harness's spans"
