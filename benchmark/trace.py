"""What a traced run reads from `torch.profiler`: the device operations,
the host's runtime calls and operators with their input shapes, reduced
to a `Trace` that the per-layer metric readers take.

Events are kept in memory and reduced here; no trace file is written.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

# Runtime calls that block the host until the device has caught up.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # "kernel", "memcpy", "memset", "runtime" or "op"
    start_ns: int
    dur_ns: int
    shapes: Tuple = ()


def _kind(name: str, on_device: bool) -> str:
    if on_device:
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    return "runtime" if name.startswith("cuda") else "op"


def events_from_profiler(prof) -> List[Event]:
    """The profiler's events as `Event`s, from its raw results (no
    per-event Python tree is built)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        name = e.name()
        kind = _kind(name, on_device)
        shapes = ()
        if kind == "op" and name == "aten::conv1d":
            shapes = tuple(tuple(s) for s in e.shapes())
        out.append(Event(name, kind, int(e.start_ns()), int(e.duration_ns()),
                         shapes))
    return out


@dataclasses.dataclass
class Trace:
    """One profiled call, reduced.

    `device_ops`: (start_ns, end_ns, name) of every kernel, copy and set,
    sorted; `kernels`: {name: [launches, total ns]}; `syncs`: blocking
    runtime calls; `conv_inputs`: input shapes of every aten::conv1d;
    `host`: (start_ns, end_ns, name) of the host's operators and runtime
    calls, sorted by start; `wall_s`: the profiled call's wall time;
    `call`: the call's facts for the readers (windows, lengths, the
    unprofiled wall of the same call, the whole window's work)."""

    device_ops: List[Tuple[int, int, str]]
    kernels: Dict[str, List[int]]
    syncs: int
    conv_inputs: List[Tuple]
    host: List[Tuple[int, int, str]]
    wall_s: float
    call: Dict

    @classmethod
    def from_events(cls, events: Sequence[Event], wall_s: float,
                    call: Dict) -> "Trace":
        device_ops, host, convs = [], [], []
        kernels: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        syncs = 0
        for e in events:
            if e.kind in ("kernel", "memcpy", "memset"):
                device_ops.append((e.start_ns, e.start_ns + e.dur_ns, e.name))
                if e.kind == "kernel":
                    k = kernels[e.name]
                    k[0] += 1
                    k[1] += e.dur_ns
            else:
                host.append((e.start_ns, e.start_ns + e.dur_ns, e.name))
                if e.kind == "runtime" and e.name in SYNC_CALLS:
                    syncs += 1
                if e.name == "aten::conv1d" and e.shapes:
                    convs.append(e.shapes[0])
        device_ops.sort()
        host.sort(key=lambda h: (h[0], -h[1]))
        return cls(device_ops, dict(kernels), syncs, convs, host, wall_s, call)

    def busy_ns(self) -> int:
        """Nanoseconds in which some device operation ran (the union of
        their intervals)."""
        busy, end = 0, None
        for s, e, _ in self.device_ops:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def top_device_ops(self, n: int = 10) -> List[List]:
        """[[name, seconds]] of the device operations that took most time."""
        total: Dict[str, int] = defaultdict(int)
        for s, e, name in self.device_ops:
            total[name] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """[[what the host was doing, seconds]]: the idle time between
        device operations, summed by the innermost host operator or
        runtime call running at each gap's midpoint ("host: no operator"
        where none ran), the n largest."""
        gaps = []
        end = None
        for s, e, _ in self.device_ops:
            if end is not None and s > end:
                gaps.append(((end + s) // 2, s - end))
            end = e if end is None else max(end, e)
        gaps.sort()
        total: Dict[str, int] = defaultdict(int)
        stack: List[Tuple[int, str]] = []  # (end, name) of open operators
        i = 0
        for mid, length in gaps:
            while i < len(self.host) and self.host[i][0] <= mid:
                s, e, name = self.host[i]
                while stack and stack[-1][0] < s:
                    stack.pop()
                stack.append((e, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            total[stack[-1][1] if stack else "host: no operator"] += length
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def kernel_ns(self, patterns) -> Tuple[int, int]:
        """(launches, total ns) of the kernels whose names match any of
        the compiled regular expressions."""
        n = t = 0
        for name, (count, ns) in self.kernels.items():
            if any(p.search(name) for p in patterns):
                n += count
                t += ns
        return n, t
