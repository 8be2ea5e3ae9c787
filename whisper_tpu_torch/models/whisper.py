"""Whisper encoder-decoder as plain PyTorch functions over a ParamTree.

Counterpart of `whisper_tpu/models/whisper.py` (reference: whisper-burn
`src/model/mod.rs`), with the same public names, layouts and rounding
points: blocks stacked on a leading layer axis, fused (d, 3, d) QKV and
(d, 2, d) cross-KV projections, NHC convolutions with HIO weights, dual
(d/h)^-0.25 scaling in the plain attention, a tied output head whose
logits stay f32, and a fixed-shape KV cache.

Where JAX is functional the port updates in place: `init_cache` allocates
the self cache once and `decoder_step` writes each step's K/V rows into it
(`self_k[:, l, pos] = k`, the counterpart of the JAX
`dynamic_update_slice`), returning the SAME cache object. Layers run as a
Python loop over per-layer views of the stacked tensors; in PyTorch a
view costs no copy, so the staging-copy problem behind the JAX stacked
decode design does not arise.

`cfg.attention` picks the path: "xla" is plain PyTorch everywhere;
"flash" routes the encoder attention, the encoder MLP and the S = 1 decode
step through the hand-written kernels in `ops/kernels/` on a CUDA device
(on the CPU their wrappers run the kernels' plain versions). On the card
two rounding points move off JAX's: a bf16 projection adds its bias in
its GEMM's epilogue, rounding once (`_linear`), and the tied head sums in
f32 on tensor cores (`_mm_f32`); the CPU keeps JAX's.

Quantization (`quantize.py`): weights may be QTensors (int8 or packed
int4, dequantized inside the matmul; int8 through the W8A8 kernels with
`cfg.knobs.int8_impl="pallas"`, see `_matmul`), the cross cache int8/int4 with one
scale per (layer, channel) (`kv_quant`), and the self cache int8 or
packed int4 with one f32 scale per row (`self_quant`), appended through
`_q8_rows`.

Under a mesh (`parallel/context.kernel_mesh`), the parameters are this
rank's Megatron shards (`parallel/sharding.py`): every attention runs at
n_head / tp local heads (the kernels unchanged, on the local shard), the
column-parallel projections (qkv, cross q and kv, mlp1) need no
communication, and each row-parallel one (attn_o, cross_o, mlp2) sums its
f32 partial product over tp before the cast and the bias
(`_row_linear`). Training puts Megatron's f and g around them
(`context.copy_to_tp` / `reduce_from_tp`). The self cache's row scales
take a tp MAX (`_q8_rows`), and the cross cache's channel scales a dp MAX
when the batch is split over dp (`_quantize_cross`).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import WhisperConfig
from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_stacked)
from ..ops.kernels.dequant_matmul import quantized_matmul, quantized_matmul_big
from ..ops.kernels.encoder_block import fused_mlp_block
from ..ops.kernels.flash_attention import attention_bhsd
from ..ops.kernels.permute_attention import decode_attention_permute_fused
from ..params import ParamTree
from ..parallel import context as pctx
from ..quantize import QTensor, int_values, pack_int4

NEG_INF = float("-inf")
Layer = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------------
# Primitive ops
# ----------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with its statistics and affine in f32, rounded once to x's
    dtype (F.layer_norm computes bf16 inputs in f32), as the JAX
    layer_norm does."""
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `_mm_f32(a, b)` takes the card's bf16 GEMM (and, with the
    bias, `_linear` its epilogue): both operands bf16 on the card and no
    gradient recorded through them."""
    return (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad)))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n) -> f32, as JAX's `preferred_element_type=f32`
    dot: the products of bf16 operands are exact in f32, the sums run in
    f32. On the card (`_on_tensor_cores`) one bf16 GEMM with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`); elsewhere (the CPU, f32
    operands, autograd) the f32 product of the operands. The two differ
    only in the order of the f32 sums."""
    if _on_tensor_cores(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _matmul(x: torch.Tensor, w, int8_impl: str = "xla") -> torch.Tensor:
    """x (..., d) @ w (d, ...), f32 accumulation, result in x's dtype.

    A QTensor w follows the JAX dispatch (whisper.py:176-229), with
    m = prod(x.shape[:-1]) rows and k, n the weight's in and out widths:
      * int8_impl="pallas", k and n multiples of 128: the W8A8 kernels,
        K6 (`quantized_matmul`) for m <= 1024 and K7
        (`quantized_matmul_big`) above, over int8 or packed int4 weights
        (flattened to (k, n) or (k, n / 2): packing runs along the last
        axis, so the pairs of a (k, ..., d) weight stay pairs of columns).
        The thresholds decide the numerics (the two round the activations
        differently). JAX takes this branch only on a TPU backend; the
        port on any device: on CPU tensors the wrappers run their plain
        versions, so the port on the CPU computes what JAX computes on a
        TPU;
      * int8_impl="w8a8" with m <= 1024, or "auto" with m >= 4096, k and n
        multiples of 128 (JAX's XLA route, whisper.py:173-221, not a
        kernel): `_w8a8` quantizes x per row and takes an s8 x s8 -> s32
        library product;
      * otherwise (int8_impl="xla", the default, or widths not multiples of
        128, JAX's own rule): x @ q (int4 unpacked first; the integers are
        exact in bf16) with the product kept in f32, as JAX's
        `preferred_element_type=f32` keeps it, times the per-channel scale
        in f32, cast once to x's dtype (`_mm_f32`, over the integers in
        x's dtype)."""
    if isinstance(w, QTensor):
        k = w.q.shape[0]
        n = w.scale.numel()  # out channels (int4 q packs two per byte)
        aligned = k % 128 == 0 and n % 128 == 0
        m = x[..., 0].numel()
        if int8_impl == "pallas" and aligned:
            mm = quantized_matmul if m <= 1024 else quantized_matmul_big
            y = mm(x.reshape(m, k).contiguous(), w.q.reshape(k, -1),
                   w.scale.reshape(n), out_dtype=x.dtype)
            return y.reshape(*x.shape[:-1], *w.scale.shape)
        if aligned and ((int8_impl == "w8a8" and m <= 1024)
                        or (int8_impl == "auto" and m >= 4096)):
            return _w8a8(x, w)
        q = int_values(w.q)
        y = _mm_f32(x.reshape(-1, k), q.reshape(k, -1).to(x.dtype))
        y = y.reshape(*x.shape[:-1], *q.shape[1:])
        return (y * w.scale).to(x.dtype)
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _w8a8(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """JAX's "w8a8" product (whisper.py:203-215): x's rows quantized to
    int8 with one scale each (absmax / 127, 1 for a zero row), an exact
    s8 x s8 -> s32 product (`torch._int_mm`; int4 weights unpacked to
    int8 first), times the row and the channel scales in f32, cast once to
    x's dtype. On CUDA `_int_mm` takes more than 16 rows: fewer are padded
    with zero rows, whose products are dropped."""
    q = int_values(w.q)
    k = q.shape[0]
    x32 = x.reshape(-1, k).float()
    m = x32.shape[0]
    absmax = x32.abs().amax(dim=1, keepdim=True)
    xs = torch.where(absmax > 0, absmax * (1.0 / 127.0), 1.0)
    xq = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
    if xq.is_cuda and m <= 16:
        xq = F.pad(xq, (0, 0, 0, 17 - m))
    acc = torch._int_mm(xq, q.reshape(k, -1).contiguous())[:m]
    y = (acc.float() * xs * w.scale.reshape(-1)).to(x.dtype)
    return y.reshape(*x.shape[:-1], *q.shape[1:])


def _epilogue_bias(x: torch.Tensor, w, b: torch.Tensor) -> bool:
    """Whether `_linear` adds the bias in its GEMM's epilogue: a plain
    (not quantized) weight, no tp, and x, w and b `_on_tensor_cores`.
    Any number of rows: at one row PyTorch declines cuBLASLt and instead
    copies the bias into the output and runs a beta = 1 GEMM, which also
    adds it to the f32 sums and rounds once, so a one-row step rounds as
    a batched one does."""
    return (not isinstance(w, QTensor) and pctx.tp_size() == 1
            and _on_tensor_cores(x, w) and _on_tensor_cores(x, b))


def _linear(x: torch.Tensor, w, b: torch.Tensor,
            int8_impl: str = "xla") -> torch.Tensor:
    """x (..., k) @ w (k, ...) + b (w's out shape), in x's dtype. Where
    `_epilogue_bias` holds, one `torch.addmm`: cuBLASLt adds the bias to
    the f32 sums and rounds once, with no pass of its own. Elsewhere (the
    CPU, f32, autograd, QTensor weights, tp > 1) `_matmul`
    rounds the product to x's dtype and the bias is added after, as in
    JAX (whisper.py:235-251). Counted by `_linear.epilogue_bias_calls` /
    `.bias_add_calls`, a graph capture once and its replays not."""
    if _epilogue_bias(x, w, b):
        _linear.epilogue_bias_calls += 1
        k = w.shape[0]
        y = torch.addmm(b.reshape(-1), x.reshape(-1, k), w.reshape(k, -1))
        return y.reshape(*x.shape[:-1], *w.shape[1:])
    _linear.bias_add_calls += 1
    return _matmul(x, w, int8_impl) + b


_linear.epilogue_bias_calls = 0
_linear.bias_add_calls = 0


def _row_linear(x: torch.Tensor, w, b: torch.Tensor,
                int8_impl: str = "xla") -> torch.Tensor:
    """A row-parallel projection (attn_o_w, cross_o_w, mlp2_w): `_linear`
    without tp. Under tp, w holds the rows of this rank's channels of x,
    and the sum runs as GSPMD runs it in JAX (whisper.py:219-229): the f32
    partial product, summed over tp (`reduce_from_tp`, Megatron's g), cast
    to x's dtype, then the replicated bias, added once."""
    if pctx.tp_size() == 1:
        return _linear(x, w, b, int8_impl)
    y = _mm_f32(x.reshape(-1, x.shape[-1]), w)
    y = pctx.reduce_from_tp(y).to(x.dtype)
    _linear.bias_add_calls += 1
    return y.reshape(*x.shape[:-1], w.shape[-1]) + b


def _local_heads(n_head: int) -> int:
    """The heads this rank holds: n_head / tp under the active mesh."""
    return n_head // pctx.tp_size()


def _qkv_proj(x, w, b, int8_impl: str = "xla"):
    """Fused QKV projection: x (..., d) @ w (d, 3, d) + b (3, d) -> q, k, v
    (strided views of one GEMM output, `_linear`'s)."""
    y = _linear(pctx.copy_to_tp(x), w, b, int8_impl)
    return y[..., 0, :], y[..., 1, :], y[..., 2, :]


def _kv_proj(x, w, b, int8_impl: str = "xla"):
    """Fused KV projection: x (..., d) @ w (d, 2, d) + b (2, d) -> k, v."""
    y = _linear(pctx.copy_to_tp(x), w, b, int8_impl)
    return y[..., 0, :], y[..., 1, :]


def qkv_attention(q, k, v, n_head: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, d) projections
    (src/model/mod.rs:493-533): (d/h)^-0.25 on BOTH q and k in their dtype,
    f32 scores plus the additive mask, f32 softmax cast to v's dtype."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // n_head
    scale = (d / n_head) ** -0.25
    qh = (q * scale).reshape(b, sq, n_head, hd).transpose(1, 2)
    kh = (k * scale).reshape(b, sk, n_head, hd).transpose(1, 2)
    vh = v.reshape(b, sk, n_head, hd).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float()).to(v.dtype)
    return out.transpose(1, 2).reshape(b, sq, d)


def causal_mask(sq: int, sk: int, offset: int = 0, device=None) -> torch.Tensor:
    """Additive (1, 1, sq, sk) mask: query i attends keys j <= i + offset
    (src/model/mod.rs:535-544)."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    m = torch.zeros(sq, sk, device=device).masked_fill(j > i + offset, NEG_INF)
    return m[None, None]


# ----------------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------------


def _conv1d_nhc(x, w, b, stride: int):
    """1-D conv, x (B, T, C_in), w (K, C_in, C_out) HIO, padding 1."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride,
                 padding=1)
    # back to a contiguous (B, T, C): the residual stream and the kernels'
    # row-major operands keep this layout through every layer
    return y.transpose(1, 2).contiguous().to(x.dtype) + b


def _attention(q, k, v, n_head: int, impl: str, causal: bool = False,
               mask=None, flash_impl: str = "bsd"):
    """The flash kernel for impl="flash" (K1, or K9 for
    flash_impl="legacy"), else the plain einsum path."""
    if impl == "flash":
        return attention_bhsd(q, k, v, n_head, causal=causal, impl=flash_impl)
    return qkv_attention(q, k, v, n_head, mask)


def _flash_impl(cfg: WhisperConfig) -> str:
    """cfg.knobs.flash_impl, or "bsd" for a config whose knobs lack it
    (the JAX package's own config, which the tests hand to both packages:
    there the choice is an environment variable)."""
    return getattr(cfg.knobs, "flash_impl", "bsd")


def _use_fused_mlp(x: torch.Tensor, w1, impl: str) -> bool:
    """True when the encoder MLP runs as the fused kernel: the flash config
    on a CUDA tensor with plain (not quantized) weights and no tp (the JAX
    gate, whisper.py:329-351, with "tensor on CUDA" in place of "backend is
    tpu": the kernel has no tp decomposition, so under tp the MLP runs as
    column- and row-parallel matmuls; a dp-only mesh keeps it). The
    kernel's wrapper launches or raises for the dtypes and widths it does
    not take: the card never runs the plain MLP in its place."""
    return (impl == "flash" and x.is_cuda and not isinstance(w1, QTensor)
            and pctx.tp_size() == 1)


def _encoder_block(x, p: Layer, n_head: int, eps: float, impl: str = "xla",
                   int8_impl: str = "xla", flash_impl: str = "bsd"):
    """Pre-LN residual encoder block (src/model/mod.rs:298-303). QTensor
    weights skip the fused MLP; under int8_impl="pallas" its two matmuls
    take K6/K7."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"], eps)
    q, k, v = _qkv_proj(h, p["qkv_w"], p["qkv_b"], int8_impl)
    x = x + _row_linear(_attention(q, k, v, n_head, impl,
                                   flash_impl=flash_impl),
                        p["attn_o_w"], p["attn_o_b"], int8_impl)
    if _use_fused_mlp(x, p["mlp1_w"], impl):
        return fused_mlp_block(x, p["mlp_ln_g"], p["mlp_ln_b"], p["mlp1_w"],
                               p["mlp1_b"], p["mlp2_w"], p["mlp2_b"], eps=eps)
    return _mlp(x, p, eps, int8_impl)


def _remat(block, remat: bool):
    """The block, or with `remat` the block under activation checkpointing
    (JAX's `jax.checkpoint` of each block, whisper.py:404-405): under
    autograd only its inputs are kept, and its forward runs again in the
    backward pass, trading FLOPs for device memory in training. Under a
    mesh the recompute issues the forward's collectives again, in the same
    order on every rank."""
    if not remat:
        return block
    mesh = pctx.active_mesh()

    def run(*args):
        # the recompute may run in autograd's device thread, which does
        # not see this thread's context: the block re-enters the mesh
        with pctx.kernel_mesh(mesh):
            return block(*args)

    return functools.partial(torch.utils.checkpoint.checkpoint, run,
                             use_reentrant=False)


def encoder_forward(params: ParamTree, mel: torch.Tensor,
                    cfg: WhisperConfig, remat: bool = False) -> torch.Tensor:
    """AudioEncoder: mel (B, n_mels, T) -> (B, ceil(T/2), d)
    (src/model/mod.rs:228-260); the positional embedding is sliced to the
    post-conv length. `remat` checkpoints each block (`_remat`)."""
    enc = params["encoder"]
    enc_cfg = cfg.audio_encoder_config
    if mel.shape[1] != enc_cfg.n_mels:
        raise ValueError(f"Audio mel spectrum size must be {enc_cfg.n_mels}.")
    if mel.shape[2] > enc_cfg.n_audio_ctx:
        raise ValueError(
            f"Audio length {mel.shape[2]} cannot exceed {enc_cfg.n_audio_ctx}.")
    x = mel.transpose(1, 2).to(enc["conv1_w"].dtype)  # (B, T, n_mels)
    x = F.gelu(_conv1d_nhc(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = F.gelu(_conv1d_nhc(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x + enc["pos_emb"][: x.shape[1]]
    n_head, eps = _local_heads(enc_cfg.n_audio_head), cfg.ln_eps
    block = _remat(_encoder_block, remat)
    for p in enc["blocks"].layers():
        x = block(x, p, n_head, eps, cfg.attention, cfg.knobs.int8_impl,
                  _flash_impl(cfg))
    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"], eps)


# ----------------------------------------------------------------------------
# Decoder: full-sequence forward (the oracle for the cached path)
# ----------------------------------------------------------------------------


def _mlp(h, p: Layer, eps: float, int8_impl: str = "xla"):
    hn = pctx.copy_to_tp(layer_norm(h, p["mlp_ln_g"], p["mlp_ln_b"], eps))
    return h + _row_linear(F.gelu(_linear(hn, p["mlp1_w"], p["mlp1_b"],
                                          int8_impl)),
                           p["mlp2_w"], p["mlp2_b"], int8_impl)


def _decoder_block(x, p: Layer, xa, mask, n_head: int, eps: float,
                   impl: str = "xla", int8_impl: str = "xla",
                   flash_impl: str = "bsd"):
    """Pre-LN residual decoder block (src/model/mod.rs:344-350)."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"], eps)
    q, k, v = _qkv_proj(h, p["qkv_w"], p["qkv_b"], int8_impl)
    x = x + _row_linear(_attention(q, k, v, n_head, impl, causal=True,
                                   mask=mask, flash_impl=flash_impl),
                        p["attn_o_w"], p["attn_o_b"], int8_impl)
    h = layer_norm(x, p["cross_ln_g"], p["cross_ln_b"], eps)
    q = _linear(pctx.copy_to_tp(h), p["cross_q_w"], p["cross_q_b"], int8_impl)
    ck, cv = _kv_proj(xa, p["cross_kv_w"], p["cross_kv_b"], int8_impl)
    x = x + _row_linear(_attention(q, ck, cv, n_head, impl,
                                   flash_impl=flash_impl),
                        p["cross_o_w"], p["cross_o_b"], int8_impl)
    return _mlp(x, p, eps, int8_impl)


def _logits(x, dec) -> torch.Tensor:
    """Tied output head, f32 logits (src/model/mod.rs:156) as JAX computes
    them (whisper.py:479-481), through `_mm_f32`: on the card one bf16
    GEMM, counted by `_logits.tensor_core_calls`, elsewhere the f32
    product, by `_logits.f32_calls`."""
    emb = dec["tok_emb"]
    if _on_tensor_cores(x, emb):
        _logits.tensor_core_calls += 1
    else:
        _logits.f32_calls += 1
    y = _mm_f32(x.reshape(-1, x.shape[-1]), emb.t())
    return y.reshape(*x.shape[:-1], emb.shape[0])


_logits.tensor_core_calls = 0
_logits.f32_calls = 0


def decoder_forward(params: ParamTree, tokens: torch.Tensor,
                    enc_out: torch.Tensor, cfg: WhisperConfig,
                    remat: bool = False) -> torch.Tensor:
    """TextDecoder: tokens (B, S) + enc_out (B, Sa, d) -> f32 logits
    (B, S, V) (src/model/mod.rs:131-157), full recompute. `remat`
    checkpoints each block (`_remat`)."""
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    seq_len = tokens.shape[1]
    if seq_len > dec_cfg.n_text_ctx:
        raise ValueError(f"Token sequence length {seq_len} must not exceed "
                         f"{dec_cfg.n_text_ctx}.")
    x = dec["tok_emb"][tokens.long()] + dec["pos_emb"][:seq_len]
    mask = causal_mask(seq_len, seq_len, device=x.device)
    n_head, eps = _local_heads(dec_cfg.n_text_head), cfg.ln_eps
    block = _remat(_decoder_block, remat)
    for p in dec["blocks"].layers():
        x = block(x, p, enc_out, mask, n_head, eps, cfg.attention,
                  cfg.knobs.int8_impl, _flash_impl(cfg))
    return _logits(layer_norm(x, dec["ln_g"], dec["ln_b"], eps), dec)


def whisper_forward(params: ParamTree, mel: torch.Tensor, tokens: torch.Tensor,
                    cfg: WhisperConfig, remat: bool = False) -> torch.Tensor:
    """`Whisper::forward` (src/model/mod.rs:48-50)."""
    return decoder_forward(params, tokens,
                           encoder_forward(params, mel, cfg, remat), cfg,
                           remat)


# ----------------------------------------------------------------------------
# Incremental decoding with a KV cache
# ----------------------------------------------------------------------------


class DecoderCache(NamedTuple):
    """Fixed-shape decoder state, updated IN PLACE by `decoder_step`.

    self_k/self_v: (B, L, cache_len, d), batch-major; with `self_quant`,
    QTensor(int8 (B, L, C, d) or packed int4 (B, L, C, d / 2), f32 row
    scales (B, L, C));
    cross_k/cross_v: (L, W, Sa, d), layer-major, computed once per window;
    with `kv_quant`, QTensor(int8 or packed int4, f32 scales (L, d));
    W = B / R when R decode lanes share each window (beam search).
    """

    self_k: object
    self_v: object
    cross_k: object
    cross_v: object


def _arr(t):
    """The stored array of a cache tensor or QTensor."""
    return t.q if isinstance(t, QTensor) else t


def _q8_rows(x: torch.Tensor, qdtype=torch.int8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization: x (..., d) -> (q (..., d) int8, or
    (..., d / 2) packed int4 for qdtype=torch.uint8 -- the dtype of the
    cache it is written into --, scale f32 (...)), one scale per cache row
    with no trailing 1 (whisper.py:521): scale = max|x| / lim (1 for an
    all-zero row), q = round(x / scale) clipped to +-lim, lim 127 for int8
    and 7 for int4. Under tp a row's channels lie on tp ranks: the absmax
    takes a tp MAX, so every rank quantizes with the whole row's scale
    (JAX: GSPMD's reduction, permute_attention.py:367-370)."""
    int4 = qdtype == torch.uint8
    lim = 7.0 if int4 else 127.0
    x32 = x.float()
    a = pctx.tp_max(x32.abs().amax(dim=-1, keepdim=True))
    scale = torch.where(a > 0, a / lim, 1.0)
    q = torch.clamp(torch.round(x32 / scale), -lim, lim).to(torch.int8)
    return (pack_int4(q) if int4 else q), scale[..., 0]


def _quantize_cross(x: torch.Tensor, bits: int) -> QTensor:
    """(L, W, Sa, d) cross K or V -> QTensor with one f32 scale per (layer,
    channel) (whisper.py:613-620); int4 packed along d. The scale is taken
    over every window, so when the windows are split over dp
    (`context.dp_rows`) the absmax takes a dp MAX: each rank's shard then
    quantizes with the whole batch's scale, as in the meshless batch."""
    lim = float(2 ** (bits - 1) - 1)
    x32 = x.float()
    absmax = x32.abs().amax(dim=(1, 2))  # (L, d)
    if pctx.dp_shard() is not None:
        absmax = pctx.dp_max(absmax)
    scale = torch.where(absmax > 0, absmax / lim, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[:, None, None, :]), -lim,
                    lim).to(torch.int8)
    return QTensor(pack_int4(q) if bits == 4 else q, scale)


def _cross_kv_vmap_fallback(x, w: QTensor, b):
    """The cross-KV projection of `init_cache` under int8_impl="pallas".
    JAX runs it under `jax.vmap` over the stacked layer weights, and the
    W8A8 kernels' `custom_vmap` rule sends batched weights to its fallback
    (dequant_matmul.py:113-130): x cast to bf16 (even in an f32 model)
    times the weight cast to bf16, accumulated in f32, times the scale,
    cast to x's dtype; then the bias. Here the bf16 values are multiplied
    in f32 (exact products, f32 sums), so no K6/K7 launch."""
    q = int_values(w.q)
    k = q.shape[0]
    y = torch.matmul(x.to(torch.bfloat16).float(), q.float().reshape(k, -1))
    y = (y.reshape(*x.shape[:-1], *q.shape[1:]) * w.scale).to(x.dtype) + b
    _linear.bias_add_calls += 1
    return y[..., 0, :], y[..., 1, :]


def init_cache(params: ParamTree, enc_out: torch.Tensor, cfg: WhisperConfig,
               batch: Optional[int] = None, cache_len: Optional[int] = None,
               kv_quant=False, self_quant=False,
               out: Optional[DecoderCache] = None) -> DecoderCache:
    """Zeroed self cache (capped at `cache_len` rows) and the cross K/V of
    every layer from enc_out. A `batch` that is a multiple R of enc_out's
    gives each window R decode lanes that share ONE cross-KV copy (the
    beam case, whisper.py:584-593): lane i reads window i // R.

    `kv_quant` (True / "int8" / "int4") quantizes the cross cache with one
    scale per (layer, channel); `self_quant` (True / "int8" / "int4") makes
    the self cache int8 (B, L, C, d), or packed int4 (B, L, C, d / 2)
    uint8, with f32 row scales (B, L, C) initialised to 1
    (whisper.py:595-647). Other values raise ValueError, as in JAX.

    `out`, a cache of the shapes and dtypes this call makes (an
    unquantized cross cache), is filled in place and returned instead:
    the cross K/V written into its arrays, the self cache zeroed (row
    scales set to 1)."""
    if out is not None and kv_quant:
        raise ValueError("out= takes an unquantized cross cache")
    if kv_quant and kv_quant not in (True, "int8", "int4"):
        raise ValueError(f"unsupported kv_quant: {kv_quant!r}")
    if self_quant and self_quant not in (True, "int8", "int4"):
        raise ValueError(f"unsupported self_quant: {self_quant!r}")
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_layer = dec_cfg.n_text_layer
    d = dec_cfg.n_text_state // pctx.tp_size()  # this rank's channels
    b_enc, sa, _ = enc_out.shape
    b = batch or b_enc
    if b % b_enc:
        raise ValueError(
            f"decode batch {b} must be a multiple of enc_out batch {b_enc}")
    dtype = dec["tok_emb"].dtype
    xa = enc_out.to(dtype)
    if out is None:
        ck = torch.empty((n_layer, b_enc, sa, d), dtype=dtype,
                         device=xa.device)
        cv = torch.empty_like(ck)
    else:
        ck, cv = out.cross_k, out.cross_v
        if ck.shape != (n_layer, b_enc, sa, d) or ck.dtype != dtype:
            raise ValueError(f"out= cross cache {tuple(ck.shape)} "
                             f"{ck.dtype} != {(n_layer, b_enc, sa, d)} "
                             f"{dtype}")
    int8_impl = cfg.knobs.int8_impl
    for l, p in enumerate(dec["blocks"].layers()):
        w = p["cross_kv_w"]
        if int8_impl == "pallas" and isinstance(w, QTensor):
            ck[l], cv[l] = _cross_kv_vmap_fallback(xa, w, p["cross_kv_b"])
        else:
            ck[l], cv[l] = _kv_proj(xa, w, p["cross_kv_b"], int8_impl)
    if kv_quant:
        bits = 4 if kv_quant == "int4" else 8
        ck, cv = _quantize_cross(ck, bits), _quantize_cross(cv, bits)
    c = min(cache_len or dec_cfg.n_text_ctx, dec_cfg.n_text_ctx)
    shape = (b, n_layer, c, d)
    if out is not None:
        for t in (out.self_k, out.self_v):
            if isinstance(t, QTensor):
                t.q.zero_()
                t.scale.fill_(1.0)
            else:
                t.zero_()
        return out
    if self_quant:
        int4 = self_quant == "int4"
        qshape = (*shape[:3], d // 2) if int4 else shape

        def qcache():
            return QTensor(torch.zeros(qshape, dtype=torch.uint8 if int4
                                       else torch.int8, device=xa.device),
                           torch.ones(shape[:3], dtype=torch.float32,
                                      device=xa.device))
        return DecoderCache(qcache(), qcache(), ck, cv)
    self_k = torch.zeros(shape, dtype=dtype, device=xa.device)
    return DecoderCache(self_k, torch.zeros_like(self_k), ck, cv)


def _cached_attention(q, k_cache, v_cache, last_visible: torch.Tensor,
                      n_head: int, impl: str = "xla") -> torch.Tensor:
    """S new queries (B, S, d) against a (B/R, C, d) cache; key c is
    visible to query i iff c <= last_visible[i]. R = B / cache rows > 1:
    kv row w serves q rows [w*R, (w+1)*R), the beam lanes of one window
    (whisper.py:650-745).

    S = 1 with impl="flash", R = 1 and no per-row scales takes JAX's
    kernel branch (whisper.py:696-706): K8 (`decode_attention`) at
    pos = max(last_visible), q in f32 times hd^-0.5 (and K's per-channel
    scale) cast back to q's dtype, V's per-channel scale on the output, cast
    to q's dtype. `decoder_step` sends every S = 1 flash step to the fused
    path first, so only a direct caller reaches it, as in JAX.

    Otherwise the einsum path of the JAX `_cached_attention`:
    q scaled by hd^-0.5 in f32 (and by K's per-channel scale) and cast
    back, f32 scores (times K's per-row scales), -inf mask, f32 softmax
    (times V's per-row scales, zeroed on masked rows so that a stale scale
    cannot poison the sum), cast to q's dtype, f32 value sum (times V's
    per-channel scale), output in the cache dtype, or q's for a quantized
    cache. Caches may be QTensors: (d,) scales are per channel (cross),
    (B, C) scales per row (self)."""
    k_scale = v_scale = k_rows = v_rows = None
    if isinstance(k_cache, QTensor):
        if k_cache.scale.dim() >= 2:
            k_rows = k_cache.scale
        else:
            k_scale = k_cache.scale
        k_cache = int_values(k_cache.q)
    if isinstance(v_cache, QTensor):
        if v_cache.scale.dim() >= 2:
            v_rows = v_cache.scale
        else:
            v_scale = v_cache.scale
        v_cache = int_values(v_cache.q)
    b, s, d = q.shape
    bk, c = k_cache.shape[:2]
    rep = b // bk
    hd = d // n_head
    if s == 1 and impl == "flash" and rep == 1 and k_rows is None:
        q1 = q[:, 0].float() * float(hd) ** -0.5
        if k_scale is not None:
            q1 = q1 * k_scale
        out = decode_attention(q1.to(q.dtype), k_cache, v_cache,
                               last_visible.max(), n_head)
        if v_scale is not None:
            out = (out.float() * v_scale).to(q.dtype)
        return out[:, None, :]
    q_dtype = q.dtype
    q32 = q.float() * float(hd) ** -0.5
    if k_scale is not None:
        q32 = q32 * k_scale
    out_dtype = (v_cache.dtype if v_scale is None and v_rows is None
                 else q_dtype)
    qh = q32.to(q_dtype).reshape(bk, rep * s, n_head, hd).transpose(1, 2)
    kh = k_cache.to(q_dtype).reshape(bk, c, n_head, hd).transpose(1, 2)
    vh = v_cache.to(q_dtype).reshape(bk, c, n_head, hd).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if k_rows is not None:
        scores = scores * k_rows[:, None, None, :]
    vis = last_visible.reshape(-1, 1).repeat(rep, 1)  # (rep * S, 1)
    hidden = torch.arange(c, device=q.device)[None, :] > vis
    scores = scores.masked_fill(hidden, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if v_rows is not None:
        w = w * torch.where(hidden, 0.0, v_rows[:, None, None, :])
    w = w.to(q_dtype)
    out = torch.matmul(w.float(), vh.float())
    out = out.transpose(1, 2).reshape(b, s, d)
    if v_scale is not None:
        out = out * v_scale
    return out.to(out_dtype)


def _embed(dec, tokens, pos):
    """Token plus positional embedding of S new tokens at [pos, pos + S);
    a (B,) int64 `pos` (S = 1) gathers each row's position."""
    if isinstance(pos, torch.Tensor):
        return dec["tok_emb"][tokens.long()] + dec["pos_emb"][pos][:, None]
    s = tokens.shape[1]
    return dec["tok_emb"][tokens.long()] + dec["pos_emb"][pos:pos + s]


def _append(cache: torch.Tensor, layer: int, pos, rows: torch.Tensor):
    """cache[:, layer, pos] = rows (B, ...), in place: at an int pos, or at
    each row's position of a (B,) int64 tensor."""
    if not isinstance(pos, torch.Tensor):
        cache[:, layer, pos] = rows
        return
    idx = pos.view(-1, *([1] * rows.dim())).expand(rows.shape[0], 1,
                                                   *rows.shape[1:])
    cache[:, layer].scatter_(1, idx, rows[:, None])


def _split(t):
    """(stored array, per-channel scale or None) of a cross cache."""
    return (t.q, t.scale) if isinstance(t, QTensor) else (t, None)


def _decoder_step_fused(params, tokens, pos: Union[int, torch.Tensor],
                        cache: DecoderCache, cfg: WhisperConfig,
                        parents=None, dests=None):
    """Steady-state (S = 1) step over the layer-STACKED caches: the decode
    attention kernel takes the whole cache and the layer index, for the
    self cache (batch-major, rows <= pos visible) and the cross cache
    (layer-major, all rows visible). The JAX `_decoder_step_fused`
    (whisper.py:748-976); `c_used` is the full cache length (the JAX
    prefix-rung ladder is a TPU A/B hook; the kernels read only rows
    [0, pos] anyway). With R lanes per window the cross call passes
    kv_rep = R (the grouped kernel). A quantized cross cache folds K's
    per-channel scale into the query and V's into the output, so the
    kernel stays scale-free. Both calls pass pos as an int, which the
    kernels take as an argument (no pos tensor a step). A (B,) int32
    device `pos` (the captured greedy step, decode/step_graphs.py) is
    read on the device instead: the positional embedding is gathered at
    it, the new self-cache rows are scattered to it, and the self
    attention kernel takes the tensor; the code path is otherwise the
    same.

    The self cache, by type: bf16/f32, the new row is written in place
    and K3 attends; int8 or packed int4 (QTensor), the new row is
    quantized per row (`_q8_rows` to the cache's storage) and written with
    its scale, and K3s attends with the row scales; quantized with
    `parents` (the beam reshuffle), K5 reads each lane's parent slab,
    appends the new row, attends and writes the slab to `dests[i]`
    (copy-on-write slots), all in one pass."""
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_head, eps = _local_heads(dec_cfg.n_text_head), cfg.ln_eps
    b = tokens.shape[0]
    # the head dim (64 at every Whisper width), from the full widths
    scale = float(dec_cfg.n_text_state // dec_cfg.n_text_head) ** -0.5
    ck_arr, ck_scale = _split(cache.cross_k)
    cv_arr, cv_scale = _split(cache.cross_v)
    _, b_cross, sa, _ = ck_arr.shape
    kv_rep = b // b_cross
    quant_self = isinstance(cache.self_k, QTensor)
    sk, sv = cache.self_k, cache.self_v
    c_self = _arr(sk).shape[2]

    if isinstance(pos, torch.Tensor) and parents is not None:
        raise ValueError("the fused beam reshuffle (parents=...) takes an "
                         "int pos")
    # where the new rows go: the int, or each row's device position
    at = pos.long() if isinstance(pos, torch.Tensor) else pos

    ii = cfg.knobs.int8_impl
    h = _embed(dec, tokens, at)  # (B, 1, d)
    for l, p in enumerate(dec["blocks"].layers()):
        hn = layer_norm(h, p["attn_ln_g"], p["attn_ln_b"], eps)
        q, k, v = _qkv_proj(hn, p["qkv_w"], p["qkv_b"], ii)
        q1 = q[:, 0] * scale
        if quant_self:  # both new rows quantized in one pass
            (kq, vq), (ks, vs) = _q8_rows(torch.stack((k[:, 0], v[:, 0])),
                                          sk.q.dtype)
        if quant_self and parents is not None:
            attn = decode_attention_permute_fused(
                q1, sk.q, sv.q, sk.scale, sv.scale, kq, vq, ks, vs, parents,
                pos, l, n_head, beam_k=max(kv_rep, 1), c_used=c_self,
                dests=dests)[0]
        elif quant_self:
            _append(sk.q, l, at, kq)  # in-place append
            _append(sk.scale, l, at, ks)
            _append(sv.q, l, at, vq)
            _append(sv.scale, l, at, vs)
            attn = decode_attention_stacked(
                q1, sk.q, sv.q, pos, l, n_head, batch_major=True,
                k_rowscale=sk.scale, v_rowscale=sv.scale, c_used=c_self)
        else:
            _append(sk, l, at, k[:, 0])  # in-place append
            _append(sv, l, at, v[:, 0])
            attn = decode_attention_stacked(
                q1, sk, sv, pos, l, n_head, batch_major=True,
                c_used=c_self)
        h = h + _row_linear(attn[:, None], p["attn_o_w"], p["attn_o_b"], ii)

        hn = layer_norm(h, p["cross_ln_g"], p["cross_ln_b"], eps)
        q = _linear(pctx.copy_to_tp(hn), p["cross_q_w"], p["cross_q_b"], ii)
        if ck_scale is None:
            q1 = q[:, 0] * scale
        else:
            q1 = (q[:, 0].float() * scale * ck_scale[l]).to(q.dtype)
        cross = decode_attention_stacked(
            q1, ck_arr, cv_arr, sa - 1, l, n_head, kv_rep=kv_rep)
        if cv_scale is not None:
            cross = (cross.float() * cv_scale[l]).to(h.dtype)
        h = h + _row_linear(cross[:, None], p["cross_o_w"], p["cross_o_b"],
                            ii)
        h = _mlp(h, p, eps, ii)
    return _logits(layer_norm(h, dec["ln_g"], dec["ln_b"], eps), dec), cache


def decoder_step(params: ParamTree, tokens: torch.Tensor,
                 pos: Union[int, torch.Tensor],
                 cache: DecoderCache, cfg: WhisperConfig,
                 parents: Optional[torch.Tensor] = None,
                 dests: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, DecoderCache]:
    """Run the decoder on S new tokens at absolute positions [pos, pos+S),
    appending their K/V to the cache IN PLACE; returns (f32 logits
    (B, S, V), the same cache). S = 1 with cfg.attention="flash" takes the
    fused step over the stacked caches; anything else (prefill, or the
    "xla" config) takes the general path with einsum attention.

    `parents` ((B,) int, window-local beam parents) folds the beam
    reshuffle of the self cache into the step: only on the S = 1 flash
    path over a quantized (QTensor) self cache, where K5 reads, appends,
    attends and writes back in one pass. `dests` (copy-on-write slots,
    decode/beam.py::_cow_assign) redirects lane i's write-back to slot
    dests[i]; the cache is then in PHYSICAL slot order and the caller
    keeps the logical-to-physical map. The guards and errors are JAX's
    (whisper.py:1005-1024).

    `pos` may be a (B,) int32 tensor on the fused S = 1 path only (each
    row's position, read on the device: `_decoder_step_fused`)."""
    if dests is not None and parents is None:
        raise ValueError(
            "dests= requires parents= (the fused COW reshuffle path)")
    if tokens.shape[1] == 1 and cfg.attention == "flash":
        if parents is not None and not isinstance(cache.self_k, QTensor):
            raise ValueError(
                "fused beam reshuffle (parents=...) requires a quantized "
                "self-KV cache (self_quant)")
        return _decoder_step_fused(params, tokens, pos, cache, cfg, parents,
                                   dests)
    if parents is not None:
        raise ValueError(
            "parents= is only supported on the S=1 flash decode path; "
            "permute the cache explicitly before this call")
    if isinstance(pos, torch.Tensor):
        raise ValueError("a tensor pos takes the S=1 flash decode path")
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_head, eps = _local_heads(dec_cfg.n_text_head), cfg.ln_eps
    s = tokens.shape[1]
    device = tokens.device
    causal_vis = pos + torch.arange(s, device=device)
    cross_vis = torch.full((s,), _arr(cache.cross_k).shape[2] - 1,
                           device=device)
    sk, sv = cache.self_k, cache.self_v
    quant_self = isinstance(sk, QTensor)

    def layer_of(t, l, batch_major):
        if isinstance(t, QTensor):
            return (QTensor(t.q[:, l], t.scale[:, l]) if batch_major
                    else QTensor(t.q[l], t.scale[l]))
        return t[:, l] if batch_major else t[l]

    ii = cfg.knobs.int8_impl
    h = _embed(dec, tokens, pos)
    for l, p in enumerate(dec["blocks"].layers()):
        hn = layer_norm(h, p["attn_ln_g"], p["attn_ln_b"], eps)
        q, k, v = _qkv_proj(hn, p["qkv_w"], p["qkv_b"], ii)
        if quant_self:  # in-place append of the quantized rows + scales
            sk.q[:, l, pos:pos + s], sk.scale[:, l, pos:pos + s] = _q8_rows(
                k, sk.q.dtype)
            sv.q[:, l, pos:pos + s], sv.scale[:, l, pos:pos + s] = _q8_rows(
                v, sv.q.dtype)
        else:  # in-place append
            sk[:, l, pos:pos + s] = k
            sv[:, l, pos:pos + s] = v
        attn = _cached_attention(q, layer_of(sk, l, True),
                                 layer_of(sv, l, True), causal_vis, n_head,
                                 cfg.attention)
        h = h + _row_linear(attn, p["attn_o_w"], p["attn_o_b"], ii)

        hn = layer_norm(h, p["cross_ln_g"], p["cross_ln_b"], eps)
        q = _linear(pctx.copy_to_tp(hn), p["cross_q_w"], p["cross_q_b"], ii)
        cross = _cached_attention(q, layer_of(cache.cross_k, l, False),
                                  layer_of(cache.cross_v, l, False),
                                  cross_vis, n_head, cfg.attention)
        h = h + _row_linear(cross, p["cross_o_w"], p["cross_o_b"], ii)
        h = _mlp(h, p, eps, ii)
    return _logits(layer_norm(h, dec["ln_g"], dec["ln_b"], eps), dec), cache
