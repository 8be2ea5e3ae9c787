"""Model parameters as an `nn.Module` tree of stacked tensors.

The layout is the JAX package's (`whisper_tpu/models/whisper.py::
init_params`): blocks are STACKED on a leading layer axis, the fused
projections keep their projection axis (`qkv_w` (L, d, 3, d), `cross_kv_w`
(L, d, 2, d)), and the conv weights are HIO (3, C_in, C_out). For serving,
tensors are buffers that need no gradients, so `.to(device)` and
`.to(dtype)` move the whole tree. Index it like the JAX pytree:
`params["decoder"]["blocks"]["qkv_w"]`.

For training, `trainable` gives a tree whose floating leaves are
`nn.Parameter`s (`requires_grad`, the dtype they were loaded in: JAX trains
in that dtype too), and `numpy_tree` takes any tree back to the numpy
pytree that the checkpoint writers take. A tree that holds parameters
builds its per-layer views anew at every `layers()` call, so a view taken
before an optimizer step never reaches a later step's graph.

Quantized leaves (`quantize.QTensor`, from `quantize_params` or from the
JAX package's quantized tree) are child modules holding `q` and `scale`;
indexing gives the QTensor back. A dtype cast moves them but never casts
them: `q` is integer, and the f32 `scale` rides `.to()` as its int32 bit
pattern, so `.to(torch.bfloat16)` leaves it f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import WhisperConfig
from .quantize import QTensor, pack_int4


class _QLeaf(nn.Module):
    """A QTensor leaf: its `q` and f32 `scale` as buffers."""

    def __init__(self, t: QTensor):
        super().__init__()
        self.register_buffer("q", t.q)
        self.register_buffer("scale", t.scale)

    def qtensor(self) -> QTensor:
        return QTensor(self.q, self.scale)

    def _apply(self, fn, recurse=True):
        # fn may cast floating tensors (.to(dtype), .half()); the scale
        # goes through it as int32 bits, so only its device changes
        self.q = fn(self.q)
        self.scale = fn(self.scale.view(torch.int32)).view(torch.float32)
        return self


class ParamTree(nn.Module):
    """A nested dict of tensors held as module buffers."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._layer_views = None
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, QTensor):
                self.add_module(k, _QLeaf(v))
            elif isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            else:
                self.register_buffer(k, v)

    def __getitem__(self, key: str):
        v = getattr(self, key)
        return v.qtensor() if isinstance(v, _QLeaf) else v

    def __contains__(self, key: str) -> bool:
        return (key in self._buffers or key in self._parameters
                or key in self._modules)

    def layers(self):
        """Per-layer views [{name: tensor[l]}] of this node's stacked
        tensors. A buffer tree builds them once and reuses them until it is
        moved or cast; a tree of parameters builds them at every call
        (inside the forward that records them), never caching a view."""
        if self._parameters:
            # one unbind a tensor: its backward stacks the layers'
            # gradients once, where a view per layer would scatter each
            # into a zero tensor of the whole stack
            views = {k: t.unbind(0) for k, t in
                     {**self._buffers, **self._parameters}.items()}
            n = len(next(iter(views.values())))
            return [{k: v[l] for k, v in views.items()} for l in range(n)]
        if self._layer_views is None:
            n = next(iter(self._buffers.values())).shape[0]
            quant = {k: m for k, m in self._modules.items()
                     if isinstance(m, _QLeaf)}
            self._layer_views = [
                {**{k: t[l] for k, t in self._buffers.items()},
                 **{k: QTensor(m.q[l], m.scale[l]) for k, m in quant.items()}}
                for l in range(n)]
        return self._layer_views

    def _apply(self, fn, recurse=True):
        self._layer_views = None  # .to() replaces the buffers
        return super()._apply(fn, recurse)

    def tree(self) -> Dict[str, Any]:
        """The same tree as plain nested dicts of tensors and QTensors."""
        out: Dict[str, Any] = {**self._buffers, **self._parameters}
        out.update({k: m.qtensor() if isinstance(m, _QLeaf) else m.tree()
                    for k, m in self._modules.items()})
        return out


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable copy (JAX and mmap arrays are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 (JAX, safetensors)
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_qtensor(node, device) -> QTensor:
    """A JAX QTensor with numpy leaves: int8 `q` as it is, `ml_dtypes.int4`
    `q` packed (quantize.py's layout); the scale stays f32."""
    q = np.asarray(node.q)
    if q.dtype.name == "int4":
        qt = pack_int4(torch.from_numpy(q.astype(np.int8)))
    else:
        qt = torch.from_numpy(np.array(q, np.int8))
    scale = torch.from_numpy(np.array(node.scale, np.float32))
    return QTensor(qt.to(device), scale.to(device))


def from_numpy_tree(tree: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None) -> ParamTree:
    """The JAX package's parameter pytree (numpy arrays, e.g. from
    `jax.tree.map(np.asarray, params)` or `whisper_tpu.io.checkpoint.
    load_params`) as a ParamTree on `device`, every layout kept; floating
    tensors are cast to `dtype` when given. Quantized leaves (the JAX
    package's `QTensor(q, scale)` named tuples) become the port's QTensors:
    int4 `q` is packed, `q` and the f32 scale are never cast."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if getattr(node, "_fields", None) == ("q", "scale"):
            return _to_qtensor(node, device)
        return _to_tensor(node, device, dtype)

    return ParamTree(conv(tree))


def trainable(tree, device=None) -> ParamTree:
    """The tree as a ParamTree of trainable leaves: every leaf becomes an
    `nn.Parameter` (`requires_grad`) in its own dtype, on `device` (default:
    where it lies). `tree` is a ParamTree or a nested dict of tensors or
    numpy arrays (the loaders' pytree, `from_numpy_tree`'s rules). Torch
    leaves are copied, so the caller's tensors are never updated. Quantized
    (QTensor) or integer leaves raise ValueError: they have no gradient, as
    JAX's `value_and_grad` refuses integer leaves."""

    def conv(node, path):
        if isinstance(node, ParamTree):
            node = node.tree()
        if isinstance(node, dict):
            return {k: conv(v, f"{path}{k}.") for k, v in node.items()}
        if isinstance(node, QTensor) or getattr(node, "_fields", None) == (
                "q", "scale"):
            raise ValueError(f"{path[:-1]}: a quantized tree cannot be "
                             "trained (integer weights have no gradient)")
        if isinstance(node, torch.Tensor):
            t = node.detach().clone()
        else:
            t = _to_tensor(node, "cpu", None)
        if not t.is_floating_point():
            raise ValueError(f"{path[:-1]}: {t.dtype} leaves cannot be "
                             "trained")
        return nn.Parameter(t if device is None else t.to(device))

    return ParamTree(conv(tree, ""))


def numpy_tree(params) -> Dict[str, Any]:
    """A ParamTree (or nested dict of tensors) as the nested dict of numpy
    arrays that `io.checkpoint.save_safetensors` and the JAX package take,
    every leaf detached and copied to the host in its dtype (bf16 as
    `ml_dtypes.bfloat16`). Quantized trees raise ValueError."""
    tree = params.tree() if isinstance(params, ParamTree) else params

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, QTensor):
            raise ValueError("numpy_tree takes unquantized trees")
        t = node.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return conv(tree)


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> ParamTree:
    """Random-normal parameters with the shapes and init scales of the JAX
    `init_params` (0.02, and 1.0 for the embeddings; LN gains one, biases
    zero). The draws come from `generator` on its device, so they differ
    from JAX's; tests that compare the two packages convert JAX's params
    with `from_numpy_tree` instead."""
    device = generator.device if device is None else torch.device(device)
    enc_cfg, dec_cfg = cfg.audio_encoder_config, cfg.text_decoder_config
    d = cfg.n_state

    def normal(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def blocks(n, cross):
        p = {
            "attn_ln_g": ones(n, d), "attn_ln_b": zeros(n, d),
            "qkv_w": normal((n, d, 3, d)), "qkv_b": zeros(n, 3, d),
            "attn_o_w": normal((n, d, d)), "attn_o_b": zeros(n, d),
            "mlp_ln_g": ones(n, d), "mlp_ln_b": zeros(n, d),
            "mlp1_w": normal((n, d, 4 * d)), "mlp1_b": zeros(n, 4 * d),
            "mlp2_w": normal((n, 4 * d, d)), "mlp2_b": zeros(n, d),
        }
        if cross:
            p.update({
                "cross_ln_g": ones(n, d), "cross_ln_b": zeros(n, d),
                "cross_q_w": normal((n, d, d)), "cross_q_b": zeros(n, d),
                "cross_kv_w": normal((n, d, 2, d)),
                "cross_kv_b": zeros(n, 2, d),
                "cross_o_w": normal((n, d, d)), "cross_o_b": zeros(n, d),
            })
        return p

    return ParamTree({
        "encoder": {
            "conv1_w": normal((3, enc_cfg.n_mels, d)), "conv1_b": zeros(d),
            "conv2_w": normal((3, d, d)), "conv2_b": zeros(d),
            "pos_emb": normal((enc_cfg.n_audio_ctx, d), 1.0),
            "blocks": blocks(enc_cfg.n_audio_layer, cross=False),
            "ln_post_g": ones(d), "ln_post_b": zeros(d),
        },
        "decoder": {
            "tok_emb": normal((dec_cfg.n_vocab, d), 1.0),
            "pos_emb": normal((dec_cfg.n_text_ctx, d), 1.0),
            "blocks": blocks(dec_cfg.n_text_layer, cross=True),
            "ln_g": ones(d), "ln_b": zeros(d),
        },
    })
