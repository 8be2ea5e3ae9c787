"""The host's time a decoder step of a full batch, in ms: the mean self
time (the span less its child spans, the blocking read of the step) of
the `whisper.decode.step` spans inside `whisper.batch` spans. The tails'
steps are not counted."""

from benchmark import spans


def read(trace, ctx):
    t = spans.tree(trace)
    steps = spans.under(t, "whisper.decode.step", "whisper.batch")
    if not steps:
        return None
    own = [spans.dur(t[i]) - sum(spans.dur(c) for c in spans.children(t, i))
           for i in steps]
    return sum(own) / len(own) / 1e6
