"""Profiling helpers: the port of `whisper_tpu/utils/profiling.py`.

`trace(log_dir)` records a `torch.profiler` trace (CPU, and the card's
kernels where there is one) into log_dir as a Chrome trace JSON, viewable
in Perfetto or TensorBoard; `scope` and `annotate` name a region in it
(`torch.profiler.record_function`) and, on a CUDA machine, in NVTX.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a trace into log_dir (no-op if log_dir is None)."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """Annotate a region so it shows up named in the trace viewer."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def annotate(name: str):
    """Host-side trace annotation; in torch the same range as `scope`."""
    return scope(name)
