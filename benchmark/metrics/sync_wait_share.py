"""Share of the full batches' decoder steps that the host spends waiting
on the device in the step's one blocking read: the summed
`whisper.decode.sync` spans over the summed `whisper.decode.step` spans,
both inside `whisper.batch` spans."""

from benchmark import spans


def read(trace, ctx):
    t = spans.tree(trace)
    steps = spans.under(t, "whisper.decode.step", "whisper.batch")
    total = sum(spans.dur(t[i]) for i in steps)
    if not total:
        return None
    wait = sum(spans.dur(c) for i in steps for c in spans.children(t, i)
               if c.name == "whisper.decode.sync")
    return 100.0 * wait / total
