"""Share of the profiled call's `transcribe_many` wall in which the
pipeline works on the host alone and queues the device nothing: the
windowing of the recordings (`whisper.window`), the stacking of each
batch's windows (`whisper.batch.stack`) and each stream's splice and text
(`whisper.stitch`), over the `whisper.transcribe_many` span."""

from benchmark import spans

HOST_ONLY = ("whisper.window", "whisper.batch.stack", "whisper.stitch")


def read(trace, ctx):
    t = spans.tree(trace)
    whole = spans.total_ns(t, "whisper.transcribe_many")
    if not whole:
        return None
    return 100.0 * sum(spans.total_ns(t, n) for n in HOST_ONLY) / whole
