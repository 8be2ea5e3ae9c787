"""The readers of the program's phase spans (`tail_share`,
`host_only_share`, `step_host_ms`, `sync_wait_share`) on a synthetic
trace whose span intervals are known, and None from a trace without
spans."""

import pytest

from benchmark import harness, spans
from benchmark.trace import Event, Trace

READERS = ("tail_share", "host_only_share", "step_host_ms",
           "sync_wait_share")
MS = 1_000_000  # ns


def _op(name, start_ms, end_ms):
    return Event(name, "op", int(start_ms * MS), int((end_ms - start_ms) * MS))


def make_trace():
    """A 100 ms call: windowing 0-5, two batches (stack 1 ms each, two
    steps each, the second step of the second batch ending on length
    without a read), a tail with two steps of its own, the splice."""
    ev = [_op("whisper.transcribe_many", 0, 100),
          _op("whisper.window", 0, 5)]
    for b0, last_reads in ((5, True), (35, False)):
        ev += [_op("whisper.batch", b0, b0 + 30),
               _op("whisper.batch.stack", b0, b0 + 1),
               _op("whisper.encode", b0 + 1, b0 + 10),
               _op("aten::conv1d", b0 + 1, b0 + 2),
               _op("whisper.decode", b0 + 10, b0 + 28),
               _op("whisper.decode.prefill", b0 + 10, b0 + 12),
               _op("whisper.decode.step", b0 + 12, b0 + 20),
               _op("aten::mm", b0 + 13, b0 + 14),
               _op("whisper.decode.sync", b0 + 18, b0 + 20),
               _op("aten::item", b0 + 18, b0 + 20),
               _op("whisper.decode.step", b0 + 20, b0 + 28),
               _op("whisper.readback", b0 + 28, b0 + 30)]
        if last_reads:
            ev.append(_op("whisper.decode.sync", b0 + 24, b0 + 28))
    ev += [_op("whisper.tail", 65, 95),
           _op("whisper.encode", 65, 70),
           _op("whisper.decode", 70, 95),
           _op("whisper.decode.prefill", 70, 75),
           _op("whisper.decode.step", 75, 85),
           _op("whisper.decode.sync", 75, 85),
           _op("whisper.decode.step", 85, 95),
           _op("whisper.stitch", 95, 99),
           Event("cudaStreamSynchronize", "runtime", 18 * MS, MS),
           Event("some_kernel", "kernel", 13 * MS, MS)]
    return Trace.from_events(ev, 0.1, {"windows": 3})


def test_span_tree_nests_by_time():
    t = spans.tree(make_trace())
    assert all(x.name.startswith("whisper.") for x in t)
    top = [x.name for x in t if x.parent is None]
    assert top == ["whisper.transcribe_many"]
    batch = next(i for i, x in enumerate(t) if x.name == "whisper.batch")
    assert [c.name for c in spans.children(t, batch)] == [
        "whisper.batch.stack", "whisper.encode", "whisper.decode",
        "whisper.readback"]
    assert len(spans.under(t, "whisper.decode.step", "whisper.batch")) == 4
    assert len(spans.under(t, "whisper.decode.step", "whisper.tail")) == 2


def test_each_reader_on_known_spans():
    tr, c = make_trace(), {}
    assert harness.reader("tail_share")(tr, c) == pytest.approx(30.0)
    # window 5 + two stacks 1 + splice 4, of 100
    assert harness.reader("host_only_share")(tr, c) == pytest.approx(11.0)
    # the batches' steps: 8 - 2, 8 - 4, 8 - 2, 8 (no read): mean 6 ms
    assert harness.reader("step_host_ms")(tr, c) == pytest.approx(6.0)
    # their reads 2 + 4 + 2 of 32 ms of steps; the tail's not counted
    assert harness.reader("sync_wait_share")(tr, c) == pytest.approx(25.0)


def test_readers_give_none_without_spans():
    ev = [_op("aten::mm", 0, 1), _op("aten::item", 2, 3),
          Event("some_kernel", "kernel", 0, MS)]
    tr = Trace.from_events(ev, 0.01, {"windows": 1})
    for name in READERS:
        assert harness.reader(name)(tr, {}) is None, name
    # a call without full batches: no steps to read
    only_tail = Trace.from_events(
        [_op("whisper.transcribe_many", 0, 10), _op("whisper.tail", 1, 9),
         _op("whisper.decode.step", 2, 4)], 0.01, {"windows": 1})
    assert harness.reader("tail_share")(only_tail, {}) == pytest.approx(80.0)
    assert harness.reader("step_host_ms")(only_tail, {}) is None
    assert harness.reader("sync_wait_share")(only_tail, {}) is None
