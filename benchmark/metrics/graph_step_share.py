"""Share of the decoder steps replayed as a CUDA graph, in %: of the
`whisper.decode.step` spans in the profiled call, those whose time range
holds a host runtime call named `cudaGraphLaunch...`. None without step
spans; 0 where every step launched its kernels one by one."""

from bisect import bisect_left

from benchmark import spans


def read(trace, ctx):
    steps = [x for x in spans.tree(trace) if x.name == "whisper.decode.step"]
    if not steps:
        return None
    launches = sorted(s for s, _, name in trace.host
                      if name.startswith("cudaGraphLaunch"))
    replayed = 0
    for x in steps:
        i = bisect_left(launches, x.start_ns)
        replayed += i < len(launches) and launches[i] < x.end_ns
    return 100.0 * replayed / len(steps)
