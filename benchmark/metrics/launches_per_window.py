"""Every device kernel launched in the profiled call (the hand-written
kernels, cuBLAS and PyTorch's elementwise kernels alike), over its real
windows. Copies and sets are not kernels."""


def read(trace, ctx):
    windows = trace.call["windows"]
    launches = trace.launches()
    return launches / windows if windows and launches else None
