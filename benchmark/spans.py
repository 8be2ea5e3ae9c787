"""The program's phase spans in a `Trace`: the host events whose names
start with `whisper.` (the spans of `whisper_tpu_torch/utils/profiling.py`),
nested by time, since one thread runs the profiled call. A program without
spans has none, and every reader of them then gives None."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

PREFIX = "whisper."


class Span(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    parent: Optional[int]  # index of the innermost span around it


def tree(trace) -> List[Span]:
    """The spans in order of start, each with its parent's index."""
    out: List[Span] = []
    stack: List[int] = []
    for s, e, name in trace.host:  # sorted by (start, -end)
        if not name.startswith(PREFIX):
            continue
        while stack and out[stack[-1]].end_ns <= s:
            stack.pop()
        out.append(Span(s, e, name, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def dur(span: Span) -> int:
    return span.end_ns - span.start_ns


def total_ns(spans: List[Span], name: str) -> int:
    return sum(dur(x) for x in spans if x.name == name)


def under(spans: List[Span], name: str, ancestor: str) -> List[int]:
    """Indices of the spans named `name` inside a span named `ancestor`."""
    out = []
    for i, x in enumerate(spans):
        if x.name != name:
            continue
        p = x.parent
        while p is not None and spans[p].name != ancestor:
            p = spans[p].parent
        if p is not None:
            out.append(i)
    return out


def children(spans: List[Span], i: int) -> List[Span]:
    """The spans directly inside span i: they follow it in order of start
    until one starts at or after its end."""
    out = []
    for j in range(i + 1, len(spans)):
        if spans[j].start_ns >= spans[i].end_ns:
            break
        if spans[j].parent == i:
            out.append(spans[j])
    return out
