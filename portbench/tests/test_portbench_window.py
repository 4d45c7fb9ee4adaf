"""The window's arithmetic: a rate over whole chunks, the union of device
intervals, idle gaps, per-kread deltas."""

import threading

import pytest

from portbench import window as wm


def test_rate_and_per_kread():
    assert wm.rate(3000, 10.0, 12.0) == 1500.0
    with pytest.raises(ValueError):
        wm.rate(1, 5.0, 5.0)
    assert wm.per_kread(0.5, 2000) == 0.25
    assert wm.per_kread(1.0, 0) is None


def test_union_seconds_merges_and_clips():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert wm.union_seconds(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert wm.union_seconds(iv, 1.5, 3.5) == pytest.approx(0.5 + 0.5)
    assert wm.union_seconds([], 0.0, 1.0) == 0.0


def test_idle_gaps_are_named_by_their_neighbours():
    ops = [("a", 1.0, 2.0), ("b", 2.5, 3.0), ("c", 2.6, 2.7), ("d", 6.0, 7.0)]
    g = wm.idle_gaps(ops, 0.0, 8.0)
    assert g[0] == ("b -> d", pytest.approx(3.0))
    assert ("window open -> a", pytest.approx(1.0)) in g
    assert ("d -> window close", pytest.approx(1.0)) in g
    assert ("a -> b", pytest.approx(0.5)) in g
    assert sum(x for _, x in g) == pytest.approx(
        8.0 - wm.union_seconds([(s, e) for _, s, e in ops], 0.0, 8.0))


def test_prof_delta():
    assert wm.prof_delta({"a": 1.0}, {"a": 1.5, "b": 2.0}) == \
        {"a": 0.5, "b": 2.0}


class FakeStream:
    def __init__(self, ends):
        self.chunk_ends = ends
        self.stop = threading.Event()

    def name_of(self, i):
        return str(i)


class FakeProf:
    t = {"x": 0.0}


def test_sink_window_holds_whole_chunks(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(wm.time, "perf_counter", lambda: clock[0])
    ends = [10, 20, 30, 40, 50, 60, 70]
    s = FakeStream(ends)

    class F:
        def write(self, x):
            pass

    sink = wm.SamSink(F(), s, open_after=1, seconds=2.5, prof=FakeProf())
    for i in range(70):
        clock[0] = float(i // 10) + (i % 10) * 0.01
        sink.write(f"{i}\tx\n" if i != 35 else "junk\n")
    assert sink.open["reads"] == 20 and sink.open["t"] == pytest.approx(1.09)
    # chunk 4 ends at 4.09: 3.0 s after the open, the first >= 2.5
    assert sink.close["reads"] == 50 and sink.close["t"] == \
        pytest.approx(4.09)
    assert s.stop.is_set()
    assert sink.bad_in_window == 1
    assert wm.rate(sink.close["reads"] - sink.open["reads"],
                   sink.open["t"], sink.close["t"]) == pytest.approx(10.0)
