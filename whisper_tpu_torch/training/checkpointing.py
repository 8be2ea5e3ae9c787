"""Training checkpoint/resume: the port of
`whisper_tpu/training/checkpointing.py`.

  * `save_train_state` / `restore_train_state`: the full state (step,
    params, AdamW moments and count) as ONE `torch.save` file at a path,
    tensors keyed by parameter name. It is written to a temporary file
    and renamed, so a save cut short leaves the previous file whole. The
    JAX package writes an orbax directory instead: a train-state file of
    the port and an orbax directory of JAX are not interchangeable.
  * `export_params`: the params as an inference checkpoint
    (`.safetensors`, through `io.checkpoint.save_safetensors`), which both
    packages load, so a fine-tuned model drops straight into either's
    transcribe path.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import WhisperConfig
from ..io import checkpoint as ckpt_io
from ..params import numpy_tree, trainable
from .train import AdamWState, TrainState


def save_train_state(path: str, state: TrainState) -> None:
    """Write {step, params, opt_state} to `path` (a file)."""
    params = {n: p.detach() for n, p in state.params.named_parameters()}
    opt = state.opt_state
    blob = {"step": int(state.step), "params": params,
            "opt_state": {"count": int(opt.count), "mu": opt.mu,
                          "nu": opt.nu}}
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str,
                        target: Optional[TrainState] = None) -> TrainState:
    """Read a `save_train_state` file. With `target` (a matching state,
    e.g. freshly initialized) the values are copied into the target's
    tensors, so they land on its device in its dtypes, and the target's
    tensors are returned; without it, a CPU state in the file's dtypes."""
    blob = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True, mmap=True)
    opt = blob["opt_state"]
    if target is None:
        params = trainable(ckpt_io.unflatten_params(blob["params"]))
        return TrainState(blob["step"], params, AdamWState(
            opt["count"], {n: t.clone() for n, t in opt["mu"].items()},
            {n: t.clone() for n, t in opt["nu"].items()}))
    want = dict(target.params.named_parameters())
    got = blob["params"]
    if {n: t.shape for n, t in got.items()} != {n: p.shape
                                                 for n, p in want.items()}:
        raise ValueError(f"{path}: its parameters do not match the target's")
    with torch.no_grad():
        for name, p in want.items():
            p.copy_(got[name])
            target.opt_state.mu[name].copy_(opt["mu"][name])
            target.opt_state.nu[name].copy_(opt["nu"][name])
    return TrainState(blob["step"], target.params,
                      AdamWState(opt["count"], target.opt_state.mu,
                                 target.opt_state.nu))


def export_params(state: TrainState, cfg: WhisperConfig, path: str) -> None:
    """Write the trained params as an inference checkpoint (.safetensors)."""
    ckpt_io.save_safetensors(numpy_tree(state.params), cfg, path)
