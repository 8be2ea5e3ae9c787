"""Package-wide logging: the counterpart of `whisper_tpu/utils/logging.py`
under the `whisper_tpu_torch` logger name.

Standard `logging` with one verbosity switch for the whole package; the
user-visible `Chunk {i}: ...` contract stays on stdout in the pipeline
whatever the level.
"""

from __future__ import annotations

import logging
import sys

ROOT = "whisper_tpu_torch"


def configure(verbosity: int = 0) -> None:
    """0 = warnings, 1 = info (timings, chunk stats), 2 = debug. The first
    call adds one stderr handler to the package's root logger; later calls
    only change the level."""
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s %(levelname)s] %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False


def get_logger(name: str) -> logging.Logger:
    """The logger `name` under the package's root (`whisper_tpu_torch.`
    is prefixed unless `name` already starts with it)."""
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
