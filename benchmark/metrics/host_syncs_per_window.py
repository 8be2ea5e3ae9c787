"""Blocking device-to-host waits (stream, device and event synchronises,
synchronous copies) in the profiled call, over its real windows."""


def read(trace, ctx):
    windows = trace.call["windows"]
    return trace.syncs / windows if windows and trace.syncs else None
