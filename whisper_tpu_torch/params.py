"""Model parameters as an `nn.Module` tree of stacked tensors.

The layout is the JAX package's (`whisper_tpu/models/whisper.py::
init_params`): blocks are STACKED on a leading layer axis, the fused
projections keep their projection axis (`qkv_w` (L, d, 3, d), `cross_kv_w`
(L, d, 2, d)), and the conv weights are HIO (3, C_in, C_out). Tensors are
buffers (the port serves only; nothing needs gradients), so `.to(device)`
and `.to(dtype)` move the whole tree. Index it like the JAX pytree:
`params["decoder"]["blocks"]["qkv_w"]`.

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
            else:
                self.register_buffer(k, v)

    def __getitem__(self, key: str):
        v = getattr(self, key)
        return v.qtensor() if isinstance(v, _QLeaf) else v

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules

    def layers(self):
        """Per-layer views [{name: tensor[l]}] of this node's stacked
        tensors, built once and reused until the tree is moved or cast."""
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
        out: Dict[str, Any] = dict(self._buffers)
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
