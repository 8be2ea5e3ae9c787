"""Share of the call's wall time in which no device operation ran: one
minus the device's busy time in the profiled call (the union of its
kernels, copies and sets) over the wall time of the same call run
without the profiler."""


def read(trace, ctx):
    wall = trace.call["unprofiled_wall_s"]
    busy = trace.busy_ns() / 1e9
    if not wall or not busy:
        return None
    return 100.0 * (1.0 - busy / wall)
