"""Share of the profiled call's `transcribe_many` wall spent on its tail
windows, decoded one at a time: the summed `whisper.tail` spans over the
`whisper.transcribe_many` span."""

from benchmark import spans


def read(trace, ctx):
    t = spans.tree(trace)
    whole = spans.total_ns(t, "whisper.transcribe_many")
    if not whole:
        return None
    return 100.0 * spans.total_ns(t, "whisper.tail") / whole
