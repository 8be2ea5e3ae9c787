"""Weight-only int8/int4 quantization, and the int4 storage layout.

Counterpart of `whisper_tpu/quantize.py`: weights become `QTensor(q,
scale)` leaves, symmetric per output channel (quantized over the INPUT
axis, one f32 scale per output column, limit +-127 for 8 bits and +-7 for
4 bits). The model's linear ops dequantize inside the matmul
(`models/whisper.py::_matmul`); activations stay bf16/f32.

int4 storage. PyTorch has no packed 4-bit dtype, so an int4 `q` is a
`torch.uint8` tensor with HALF the channels of the values it holds: two
two's-complement nibbles per byte along the LAST (channel) axis, the low
nibble holding the even channel and the high nibble the odd one
(`pack_int4` / `unpack_int4`). int8 `q` tensors are `torch.int8`, so the
dtype says which layout a QTensor carries. The same layout serves int4
weights and the int4 cross-KV cache (`init_cache(kv_quant="int4")`), whose
rows the decode-attention kernel sign-extends in registers.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

_DECODER_KEYS = (
    "qkv_w", "attn_o_w", "cross_q_w", "cross_kv_w", "cross_o_w",
    "mlp1_w", "mlp2_w",
)


class QTensor(NamedTuple):
    """Per-output-channel symmetric weight (or cache): w ~= q * scale."""

    q: torch.Tensor  # int8, or uint8 holding packed int4 (module doc)
    scale: torch.Tensor  # f32


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7] (..., n), n even -> uint8 (..., n / 2); the low
    nibble holds the even channel."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even channel count, got "
                         f"{q.shape[-1]}")
    u = q.to(torch.int8).view(torch.uint8)
    return (u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 (..., m) of packed nibbles -> int8 (..., 2m), sign-extended."""
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    lo = lo - ((lo & 8) << 1)
    hi = hi - ((hi & 8) << 1)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 2 * p.shape[-1])


def int_values(q: torch.Tensor) -> torch.Tensor:
    """A QTensor's `q` as int8 values, unpacking int4 storage."""
    return unpack_int4(q) if q.dtype == torch.uint8 else q


def _quantize(w32: torch.Tensor, scale: torch.Tensor, lim: float,
              bits: int) -> torch.Tensor:
    q = torch.clamp(torch.round(w32 / scale), -lim, lim).to(torch.int8)
    return pack_int4(q) if bits == 4 else q


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Quantize over the INPUT axis (axis 0) to int8: one scale per output
    column."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return QTensor(_quantize(w32, scale, 127.0, 8), scale)


def dequantize(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (int_values(t.q).float() * t.scale).to(dtype)


def _quantize_blocks(blocks: Dict[str, Any], keys, bits: int
                     ) -> Dict[str, Any]:
    """Replace the `keys` leaves of one stacked block dict, shaped (L, in,
    out) or (L, in, p, out), by QTensors with scales (L, out) / (L, p,
    out)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    lim = float(2 ** (bits - 1) - 1)
    out: Dict[str, Any] = {}
    for k, v in blocks.items():
        if k not in keys:
            out[k] = v
            continue
        w32 = v.float()
        absmax = w32.abs().amax(dim=1)
        scale = torch.where(absmax > 0, absmax / lim, torch.ones_like(absmax))
        out[k] = QTensor(_quantize(w32, scale.unsqueeze(1), lim, bits), scale)
    return out


def quantize_params(params, quantize_encoder: bool = False,
                    keys: tuple = _DECODER_KEYS, bits: int = 8):
    """A new ParamTree whose selected block weights are QTensors: the
    decoder's large matmul weights, and the encoder's with
    `quantize_encoder`. bits=4 stores the packed int4 layout of the module
    doc. The other leaves are shared with `params`."""
    from .params import ParamTree

    tree = params.tree()
    new = {"encoder": dict(tree["encoder"]), "decoder": dict(tree["decoder"])}
    new["decoder"]["blocks"] = _quantize_blocks(tree["decoder"]["blocks"],
                                                keys, bits)
    if quantize_encoder:
        new["encoder"]["blocks"] = _quantize_blocks(
            tree["encoder"]["blocks"], keys, bits)
    return ParamTree(new)
