"""Debug/numerics helpers: the port of `whisper_tpu/utils/debug.py`.

`debug_nans()` is `jax_debug_nans`: the first operation inside the context
whose floating output holds a NaN raises FloatingPointError. It checks
every operation as it runs (a `TorchDispatchMode`), the forward included;
`torch.autograd.set_detect_anomaly` checks only the backward.
`assert_all_finite` is the host-side check of a whole tree.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..params import ParamTree
from ..quantize import QTensor

_CHECK = contextvars.ContextVar("debug_nans", default=False)


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _CHECK.get():
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise on the first NaN produced inside the context; `enable=False`
    turns the check off inside an enclosing one."""
    token = _CHECK.set(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _CHECK.reset(token)


def _leaves(node, path):
    """(path, array) for every leaf of a ParamTree, dict, named tuple
    (TrainState, AdamWState, Batch, QTensor), list or array."""
    if isinstance(node, ParamTree):
        node = node.tree()
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(node, QTensor) or hasattr(node, "_fields"):
        for k in node._fields:
            yield from _leaves(getattr(node, k), f"{path}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(node, torch.Tensor):
        yield path, node
    elif node is not None:
        yield path, np.asarray(node)


def assert_all_finite(tree, name: str = "pytree") -> None:
    """Host-side finiteness check over a tree (checkpoint sanity): raises
    FloatingPointError naming the first leaf with a NaN or inf."""
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf.detach()).all())
        else:
            bad = leaf.dtype.kind == "f" and not np.isfinite(leaf).all()
        if bad:
            raise FloatingPointError(
                f"{name}: non-finite values at {path.lstrip('/')}")
