"""Profiling helpers: the port of `whisper_tpu/utils/profiling.py`.

`trace(log_dir)` records a `torch.profiler` trace (CPU, and the card's
kernels where there is one) into log_dir as a Chrome trace JSON, viewable
in Perfetto or TensorBoard. `scope(name)` names a region of the program
in any trace a `torch.profiler` session records, `trace`'s or a caller's
own, on the same clock as the kernels.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_OFF = contextlib.nullcontext()


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


def scope(name: str):
    """A span named `name` while a profiler records, else one shared no-op
    context manager: an untraced run pays one attribute read.

    The span is a host operator event (`_RecordFunctionFast`). It adds no
    device synchronisation and no tensor. `torch.profiler.record_function`
    would also mirror each span onto the card's timeline as a
    `gpu_user_annotation` event covering the kernels it launched, which a
    reader of device events takes for one more kernel."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
