"""The reader of `graph_step_share` on synthetic traces: steps whose span
holds a `cudaGraphLaunch` runtime call count as replayed, a launch outside
every step counts for none, and a trace without step spans reads None."""

import pytest

from benchmark import harness
from benchmark.trace import Event, Trace

MS = 1_000_000  # ns


def _op(name, start_ms, end_ms):
    return Event(name, "op", int(start_ms * MS), int((end_ms - start_ms) * MS))


def _launch(name, at_ms):
    return Event(name, "runtime", int(at_ms * MS), 5000)


def _trace(graphed_steps, eager_steps, extra=()):
    """A decode of graphed then eager steps of 1 ms each, every step with
    its blocking read, the graphed ones with a replay after it."""
    ev = [_op("whisper.transcribe_many", 0, 100),
          _op("whisper.decode", 0, 90),
          _op("whisper.decode.prefill", 0, 1)]
    t = 1.0
    for i in range(graphed_steps + eager_steps):
        ev += [_op("whisper.decode.step", t, t + 1),
               _op("whisper.decode.sync", t, t + 0.5)]
        if i < graphed_steps:
            ev.append(_launch("cudaGraphLaunch_v10000", t + 0.6))
        else:
            ev.append(_launch("cudaLaunchKernel", t + 0.6))
        t += 1
    ev += list(extra)
    ev.append(Event("some_kernel", "kernel", 2 * MS, MS))
    return Trace.from_events(ev, 0.1, {"windows": 1})


@pytest.mark.parametrize("graphed,eager,share", [(8, 0, 100.0), (6, 2, 75.0),
                                                 (0, 4, 0.0)])
def test_share_of_steps_that_replay_a_graph(graphed, eager, share):
    read = harness.reader("graph_step_share")
    assert read(_trace(graphed, eager), {}) == pytest.approx(share)


def test_a_launch_outside_the_steps_counts_for_none():
    # a replay during the prefill, before the first step span
    tr = _trace(0, 3, extra=[_launch("cudaGraphLaunch", 0.5)])
    assert harness.reader("graph_step_share")(tr, {}) == 0.0


def test_no_step_spans_read_none():
    ev = [_op("aten::mm", 0, 1), _launch("cudaGraphLaunch", 0.5),
          Event("some_kernel", "kernel", 0, MS)]
    tr = Trace.from_events(ev, 0.01, {"windows": 1})
    assert harness.reader("graph_step_share")(tr, {}) is None
