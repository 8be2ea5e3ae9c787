"""Megatron-style tensor parallelism + data parallelism over SPMD ranks.

The port of `whisper_tpu/parallel/sharding.py`, with the same rules per
transformer block (d = n_state, L layers):
  column-parallel (output axis sharded over "tp", no communication):
    qkv_w (L, d, 3, d)    -> (None, None, None, "tp")   # the head axis
    qkv_b (L, 3, d)       -> (None, None, "tp")
    cross_q_w (L, d, d)   -> (None, None, "tp")
    cross_kv_w (L,d,2,d)  -> (None, None, None, "tp")
    mlp1_w (L, d, 4d)     -> (None, None, "tp")
  row-parallel (input axis sharded; the model sums the partial products
  over "tp", then adds the replicated bias once):
    attn_o_w (L, d, d)    -> (None, "tp", None)
    cross_o_w (L, d, d)   -> (None, "tp", None)
    mlp2_w (L, 4d, d)     -> (None, "tp", None)
  replicated: layer norms, biases of row-parallel layers, embeddings, convs.

A spec is the tuple of a JAX `PartitionSpec`: one entry per leading axis,
"tp" on the sharded one. The fused qkv keeps its projection axis (3)
apart from the head axis (d), so a shard never crosses the q|k|v
boundary, and each shard holds whole heads. JAX places one global array
across the devices; here each rank keeps only its shard, as a contiguous
copy (the kernels refuse strided channels), and `gather_params` puts the
whole tree back together (for a checkpoint). Quantized (QTensor) leaves
are refused, as JAX's `shard_params` fails on them: int8 weights and the
W8A8 kernels stay off the meshed path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import WhisperConfig
from ..params import ParamTree
from ..quantize import QTensor
from . import context

Spec = Tuple[Optional[str], ...]


def _block_specs(cross: bool) -> Dict[str, Spec]:
    p = {
        "attn_ln_g": (), "attn_ln_b": (),
        "qkv_w": (None, None, None, "tp"),
        "qkv_b": (None, None, "tp"),
        "attn_o_w": (None, "tp", None),
        "attn_o_b": (),
        "mlp_ln_g": (), "mlp_ln_b": (),
        "mlp1_w": (None, None, "tp"),
        "mlp1_b": (None, "tp"),
        "mlp2_w": (None, "tp", None),
        "mlp2_b": (),
    }
    if cross:
        p.update({
            "cross_ln_g": (), "cross_ln_b": (),
            "cross_q_w": (None, None, "tp"),
            "cross_q_b": (None, "tp"),
            "cross_kv_w": (None, None, None, "tp"),
            "cross_kv_b": (None, None, "tp"),
            "cross_o_w": (None, "tp", None),
            "cross_o_b": (),
        })
    return p


def param_specs(cfg: WhisperConfig) -> Dict[str, Any]:
    """The spec tree matching the parameter tree (JAX's `param_pspecs`)."""
    return {
        "encoder": {
            "conv1_w": (), "conv1_b": (),
            "conv2_w": (), "conv2_b": (),
            "pos_emb": (),
            "blocks": _block_specs(cross=False),
            "ln_post_g": (), "ln_post_b": (),
        },
        "decoder": {
            "tok_emb": (),
            "pos_emb": (),
            "blocks": _block_specs(cross=True),
            "ln_g": (), "ln_b": (),
        },
    }


def validate_tp(cfg: WhisperConfig, tp: int) -> None:
    """Check head/hidden divisibility for a balanced tp sharding."""
    for name, heads in (
        ("encoder", cfg.audio_encoder_config.n_audio_head),
        ("decoder", cfg.text_decoder_config.n_text_head),
    ):
        if heads % tp != 0:
            raise ValueError(
                f"{name} head count {heads} not divisible by tp={tp}"
            )
    if (4 * cfg.n_state) % tp != 0:
        raise ValueError(f"MLP hidden {4*cfg.n_state} not divisible by tp={tp}")


def _tp_dim(spec: Spec) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def _cut(t: torch.Tensor, spec: Spec, mesh, path: str) -> torch.Tensor:
    """This rank's piece of the full leaf `t` under `spec`, a contiguous
    copy (`t` itself for a replicated leaf or tp = 1)."""
    dim, tp = _tp_dim(spec), mesh.shape["tp"]
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"{path}: axis {dim} of {tuple(t.shape)} is not "
                         f"divisible by tp={tp}")
    return t.chunk(tp, dim=dim)[mesh.tp_rank].clone(
        memory_format=torch.contiguous_format)


def _walk(tree, specs, fn, path=""):
    """fn(leaf, spec, path) over the leaves of `tree` (a ParamTree or
    nested dict), keeping the tree's structure as nested dicts."""
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    out = {}
    for k, v in tree.items():
        if k not in specs:
            raise ValueError(f"{path}{k}: no sharding rule for this leaf")
        if isinstance(v, (dict, ParamTree)):
            out[k] = _walk(v, specs[k], fn, f"{path}{k}.")
        else:
            out[k] = fn(v, specs[k], f"{path}{k}")
    return out


def _refuse_quantized(leaf, path: str) -> None:
    if isinstance(leaf, QTensor) or getattr(leaf, "_fields", None) == (
            "q", "scale"):
        raise ValueError(
            f"{path}: a quantized (QTensor) tree cannot be sharded over a "
            "mesh; int8 weights and the W8A8 kernels run without one")


def shard_params(params, mesh, cfg: WhisperConfig) -> ParamTree:
    """This rank's shards of `params` (a ParamTree on this rank's device,
    or a nested dict of tensors): each "tp" leaf cut into tp equal pieces
    along its sharded axis, piece `mesh.tp_rank` kept as a contiguous copy;
    replicated leaves kept as they are. `nn.Parameter` leaves come back as
    parameters (the shard of a trainable tree is trainable). Every rank of
    the mesh must start from the same full tree."""
    def cut(leaf, spec, path):
        _refuse_quantized(leaf, path)
        if _tp_dim(spec) is None or mesh.shape["tp"] == 1:
            return leaf
        shard = _cut(leaf.detach(), spec, mesh, path)
        return nn.Parameter(shard) if isinstance(leaf, nn.Parameter) else shard

    return ParamTree(_walk(params, param_specs(cfg), cut))


def gather_params(params, mesh, cfg: WhisperConfig) -> ParamTree:
    """The inverse of `shard_params`: every "tp" leaf's shards concatenated
    over the tp group in tp rank order (a collective: every rank of the
    mesh must call it), as detached buffers; replicated leaves detached."""

    def join(leaf, spec, path):
        _refuse_quantized(leaf, path)
        dim = _tp_dim(spec)
        if dim is None:
            return leaf.detach()
        return context.tp_all_gather(leaf, dim, mesh)

    return ParamTree(_walk(params, param_specs(cfg), join))


def shard_tensor(t: torch.Tensor, name: str, mesh, cfg: WhisperConfig
                 ) -> torch.Tensor:
    """The shard of one full leaf `t`, named by its dotted path (e.g.
    "decoder.blocks.qkv_w"), as `shard_params` would cut it."""
    return _cut(t, _spec_of(name, cfg), mesh, name)


def gather_tensor(t: torch.Tensor, name: str, mesh, cfg: WhisperConfig
                  ) -> torch.Tensor:
    """The full leaf of one shard `t`, named by its dotted path (a
    collective over the tp group for a sharded leaf)."""
    dim = _tp_dim(_spec_of(name, cfg))
    return t.detach() if dim is None else context.tp_all_gather(t, dim, mesh)


def is_sharded(name: str, cfg: WhisperConfig) -> bool:
    """Whether the leaf at dotted path `name` is split over "tp"."""
    return _tp_dim(_spec_of(name, cfg)) is not None


def _spec_of(name: str, cfg: WhisperConfig) -> Spec:
    node: Any = param_specs(cfg)
    for part in name.split("."):
        node = node[part]
    return node
