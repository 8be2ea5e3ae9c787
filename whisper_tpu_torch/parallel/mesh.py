"""The ("dp", "tp") mesh over torch.distributed ranks, and the process start.

The port of `whisper_tpu/parallel/mesh.py`. Axis conventions are JAX's:
  * "dp" -- data parallel: independent audio windows / training rows;
  * "tp" -- tensor parallel: attention heads and the MLP hidden axis
    sharded per layer (Megatron's layout, `parallel/sharding.py`), with an
    all-reduce after each row-parallel projection.
Whisper's sequence lengths are capped (1500 audio, 448 text positions), so
there is no sequence axis.

Where JAX builds one program over a device array, the port runs one
process per mesh position (SPMD ranks): rank r sits at (r // tp, r % tp),
the row-major order of JAX's `np.asarray(devices).reshape(dp, tp)`. Each
rank holds its own shards as plain local tensors, and the collectives of
`parallel/context.py` run over the two kinds of process group a mesh
creates: the ranks of one dp row (its tp group) and of one tp column (its
dp group).

`init_process` is the counterpart of `jax.distributed.initialize`: the
backend is "nccl" when every rank has a card of its own and "gloo"
otherwise (several ranks on one card, or the CPU), always passed
explicitly, with an `init_method` and a timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (dp, tp) mesh: its position and the process
    groups of its two axes (None for an axis of size 1)."""

    dp: int
    tp: int
    rank: int = 0
    groups: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def group(self, axis: str):
        """The process group of `axis` that this rank belongs to."""
        return self.groups.get(axis)


def default_backend(world_size: int) -> str:
    """"nccl" when every rank of `world_size` can have a card of its own,
    else "gloo"."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_process(rank: int, world_size: int, init_method: str,
                 backend: Optional[str] = None,
                 timeout_s: float = 120.0) -> str:
    """Join the process group as `rank` of `world_size` (the counterpart of
    `jax.distributed.initialize`): `init_method` is "tcp://host:port" or
    "file:///path" (a path no other run uses), `backend` defaults to
    `default_backend(world_size)`, and a collective that waits longer than
    `timeout_s` raises. Under nccl the rank takes card `rank`. Returns the
    backend."""
    backend = backend or default_backend(world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The ("dp", "tp") mesh over the initialised world (one rank, with no
    process group, when none is initialised). dp defaults to world // tp;
    tp must divide the world size, as in JAX. Every rank must call it, with
    the same arguments and in the same order as its other `make_mesh`
    calls: creating a process group is itself collective."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    if n % tp != 0:
        raise ValueError(f"tp={tp} must divide device count {n}")
    dp = dp if dp is not None else n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    rank = dist.get_rank() if initialized else 0
    groups: Dict[str, Optional[object]] = {"dp": None, "tp": None}
    if tp > 1:
        for row in range(dp):
            g = dist.new_group([row * tp + t for t in range(tp)])
            if row == rank // tp:
                groups["tp"] = g
    if dp > 1:
        for col in range(tp):
            g = dist.new_group([r * tp + col for r in range(dp)])
            if col == rank % tp:
                groups["dp"] = g
    return Mesh(dp, tp, rank, groups)


def single_device_mesh() -> Mesh:
    """A dp=1, tp=1 mesh of this process alone: no process group is needed,
    and every collective is a no-op."""
    return Mesh(1, 1, 0, {"dp": None, "tp": None})
