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

Over a mesh (`mesh=` and `cfg=`, the state holding this rank's shards), a
save gathers every tp-sharded tensor (params and both moments) over tp,
and rank 0 alone writes: the file is a meshless save's, byte for byte when
the values are. Every rank must call it; it returns once the file is
complete. A restore reads the whole file on every rank and copies its
shard of each tensor into the target's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import WhisperConfig
from ..io import checkpoint as ckpt_io
from ..parallel.sharding import gather_tensor, shard_tensor
from ..params import numpy_tree, trainable
from .train import AdamWState, TrainState


def _whole(tensors, mesh, cfg):
    """{name: full tensor} of this rank's shards (a tp gather a sharded
    leaf) under a mesh, the tensors themselves without."""
    if mesh is None:
        return tensors
    return {n: gather_tensor(t, n, mesh, cfg) for n, t in tensors.items()}


def _sync(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier()


def save_train_state(path: str, state: TrainState, mesh=None,
                     cfg: Optional[WhisperConfig] = None) -> None:
    """Write {step, params, opt_state} to `path` (a file); over `mesh`
    (with `cfg`), gathered onto rank 0, which writes it."""
    params = {n: p.detach() for n, p in state.params.named_parameters()}
    opt = state.opt_state
    blob = {"step": int(state.step), "params": _whole(params, mesh, cfg),
            "opt_state": {"count": int(opt.count),
                          "mu": _whole(opt.mu, mesh, cfg),
                          "nu": _whole(opt.nu, mesh, cfg)}}
    if mesh is None or mesh.rank == 0:
        path = os.path.abspath(path)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # a file object: the bytes never name
            torch.save(blob, f)     # the (per-process) temporary path
        os.replace(tmp, path)
    _sync(mesh)


def restore_train_state(path: str, target: Optional[TrainState] = None,
                        mesh=None, cfg: Optional[WhisperConfig] = None
                        ) -> TrainState:
    """Read a `save_train_state` file. With `target` (a matching state,
    e.g. freshly initialized) the values are copied into the target's
    tensors, so they land on its device in its dtypes, and the target's
    tensors are returned; without it, a CPU state in the file's dtypes.
    Over `mesh` (with `cfg` and a target of this rank's shards), each
    tensor's shard is copied."""
    blob = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True, mmap=True)
    opt = blob["opt_state"]
    if target is None:
        params = trainable(ckpt_io.unflatten_params(blob["params"]))
        return TrainState(blob["step"], params, AdamWState(
            opt["count"], {n: t.clone() for n, t in opt["mu"].items()},
            {n: t.clone() for n, t in opt["nu"].items()}))
    want = dict(target.params.named_parameters())

    def shard(t, name):
        return t if mesh is None else shard_tensor(t, name, mesh, cfg)

    got = {n: shard(t, n) for n, t in blob["params"].items()}
    if {n: t.shape for n, t in got.items()} != {n: p.shape
                                                 for n, p in want.items()}:
        raise ValueError(f"{path}: its parameters do not match the target's")
    with torch.no_grad():
        for name, p in want.items():
            p.copy_(got[name])
            target.opt_state.mu[name].copy_(shard(opt["mu"][name], name))
            target.opt_state.nu[name].copy_(shard(opt["nu"][name], name))
    return TrainState(blob["step"], target.params,
                      AdamWState(opt["count"], target.opt_state.mu,
                                 target.opt_state.nu))


def export_params(state: TrainState, cfg: WhisperConfig, path: str) -> None:
    """Write the trained params as an inference checkpoint (.safetensors)."""
    ckpt_io.save_safetensors(numpy_tree(state.params), cfg, path)
