"""The active mesh, and every collective the meshed port runs.

The port of `whisper_tpu/parallel/context.py`. In the JAX package the mesh
context is read while tracing: the Pallas kernel entry points wrap
themselves in a `shard_map`, so each device runs the same kernel on its
local shard (n_head / tp heads, the batch over "dp"), and GSPMD inserts the
row-parallel psum. The port runs one process per mesh position (SPMD
ranks, `parallel/mesh.py`) over plain local tensors: a kernel sees only
its rank's shard already, so it runs unchanged at n_head / tp heads, and
the collectives GSPMD would insert are written out here.

`kernel_mesh(mesh)` sets the mesh that the model functions read while they
run (`models/whisper.py`: the local head count, the row-parallel sums, the
tp MAX of the self cache's row scales); `dp_rows(first, total)` says that
this rank decodes rows [first, first + local) of a batch of `total` rows
split over "dp" (the dp MAX of the cross cache's channel scales, and the
sampler's slice of the batch's draw). Both are context variables: they
hold for the calls made inside the `with` block, in this thread.

The collectives, all over the mesh's tp or dp process group, are no-ops on
a mesh axis of size 1:
  * `tp_sum` (the row-parallel f32 partial product), `tp_max` and `dp_max`
    (absmax values), `dp_sum`, `dp_all_gather` of host (numpy) results,
    and `tp_all_gather` of shards (a checkpoint's gather, the alignment's
    heads);
  * Megatron's two autograd functions for training: `copy_to_tp` (*f*:
    identity forward, tp all-reduce of the gradient backward, before each
    column-parallel projection) and `reduce_from_tp` (*g*: tp all-reduce
    forward, identity backward, after each row-parallel one). *g* is not
    `torch.distributed.nn.functional.all_reduce`: that function's backward
    all-reduces the already-replicated gradient again, multiplying it by
    tp.
The gloo backend has no CUDA form of some collectives, so a CUDA tensor
under gloo is copied to host memory, reduced there and copied back, in
`_all_reduce` and `tp_all_gather`, explicitly: the compute stays on the
card, only the exchange goes through the host. (nccl, the other way
round, takes only CUDA tensors: `dp_all_gather` moves its host arrays to
the card for it.)
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "whisper_tpu_torch_kernel_mesh", default=None)
_DP_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "whisper_tpu_torch_dp_rows", default=None)


def active_mesh():
    """The mesh set by `kernel_mesh`, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def kernel_mesh(mesh):
    """Activate `mesh` for the model functions called inside the block.

    Pass None for a no-op (callers can always wrap unconditionally)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def dp_rows(first: int, total: int):
    """Inside the block this rank decodes rows [first, first + local) of
    a batch of `total` rows split over the active mesh's "dp" axis."""
    token = _DP_ROWS.set((int(first), int(total)))
    try:
        yield
    finally:
        _DP_ROWS.reset(token)


def dp_shard() -> Optional[Tuple[int, int]]:
    """(first row, total rows) set by `dp_rows`, or None."""
    return _DP_ROWS.get()


def tp_size(mesh=None) -> int:
    m = mesh if mesh is not None else active_mesh()
    return int(m.shape.get("tp", 1)) if m is not None else 1


def dp_axis(mesh, *batch_sizes: int) -> Optional[str]:
    """"dp" when the mesh data-parallel axis evenly divides every given
    batch-like size (so each shard gets whole rows/windows), else None."""
    dp = int(mesh.shape.get("dp", 1))
    if dp > 1 and all(b % dp == 0 for b in batch_sizes):
        return "dp"
    return None


def tp_axis(mesh, n_head: int, *channel_sizes: int) -> Optional[str]:
    """"tp" when the mesh tensor-parallel axis divides the head count (whole
    heads per shard) and every given channel size, else None."""
    tp = int(mesh.shape.get("tp", 1))
    if tp > 1 and n_head % tp == 0 and all(c % tp == 0 for c in channel_sizes):
        return "tp"
    return None


# ----------------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------------

# collectives issued over a tp group (`tp_sum`, `tp_max`, `tp_all_gather`)
# since the count was last set to 0 (read by chip_smoke.py: the tp
# collectives a decoder step)
tp_collectives = 0


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce `t` in place over `group`; a CUDA tensor under gloo goes
    through an explicit host copy."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _group(axis: str, mesh=None):
    """The process group of `axis` of the (active) mesh, or None when that
    axis has size 1 or no mesh is active."""
    m = mesh if mesh is not None else active_mesh()
    if m is None or int(m.shape.get(axis, 1)) == 1:
        return None
    return m.group(axis)


def _tp_group(mesh=None):
    """`_group("tp", mesh)`, counting the collective the caller issues over
    it in `tp_collectives`."""
    global tp_collectives
    g = _group("tp", mesh)
    if g is not None:
        tp_collectives += 1
    return g


def tp_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x summed over the tp axis (a new tensor; x itself when tp is 1)."""
    g = _tp_group(mesh)
    return x if g is None else _all_reduce(x.clone(), dist.ReduceOp.SUM, g)


def tp_max(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Elementwise max of x over the tp axis."""
    g = _tp_group(mesh)
    return x if g is None else _all_reduce(x.clone(), dist.ReduceOp.MAX, g)


def dp_max(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Elementwise max of x over the dp axis."""
    g = _group("dp", mesh)
    return x if g is None else _all_reduce(x.clone(), dist.ReduceOp.MAX, g)


def dp_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x summed over the dp axis (a new tensor; x itself when dp is 1)."""
    g = _group("dp", mesh)
    return x if g is None else _all_reduce(x.clone(), dist.ReduceOp.SUM, g)


def dp_all_gather(arrays: List[np.ndarray], mesh=None) -> List[np.ndarray]:
    """Each host array concatenated along axis 0 over the dp axis, in dp
    rank order. Every rank must give arrays of the same shapes and dtypes;
    the exchange runs on CPU tensors (on the card under nccl)."""
    g = _group("dp", mesh)
    if g is None:
        return list(arrays)
    n = dist.get_world_size(g)
    device = "cuda" if dist.get_backend(g) == "nccl" else "cpu"
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=g)
        out.append(np.concatenate([p.cpu().numpy() for p in parts]))
    return out


def tp_all_gather(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """The tp shards of x concatenated along `dim`, in tp rank order (a CUDA
    tensor under gloo goes through an explicit host copy)."""
    g = _tp_group(mesh)
    if g is None:
        return x
    n = dist.get_world_size(g)
    src = x.detach().contiguous()
    host = _via_host(src, g)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


class _CopyToTp(torch.autograd.Function):
    """Megatron's f: identity forward, tp all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return tp_sum(grad.contiguous(), ctx.mesh), None


class _ReduceFromTp(torch.autograd.Function):
    """Megatron's g: tp all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return tp_sum(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """f, before a column-parallel projection: x itself when tp is 1."""
    m = mesh if mesh is not None else active_mesh()
    return x if tp_size(m) == 1 else _CopyToTp.apply(x, m)


def reduce_from_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """g, after a row-parallel partial product: x itself when tp is 1."""
    m = mesh if mesh is not None else active_mesh()
    return x if tp_size(m) == 1 else _ReduceFromTp.apply(x, m)
