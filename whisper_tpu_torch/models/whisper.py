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
(on the CPU their wrappers run the kernels' plain versions).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import WhisperConfig
from ..ops.kernels.decode_attention import decode_attention_stacked
from ..ops.kernels.encoder_block import fused_mlp_block
from ..ops.kernels.flash_attention import attention_bhsd
from ..params import ParamTree

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


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, ...), f32 accumulation, result in x's dtype."""
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = _matmul(x, w)
    return y if b is None else y + b


def _qkv_proj(x, w, b):
    """Fused QKV projection: x (..., d) @ w (d, 3, d) + b (3, d) -> q, k, v
    (strided views of one GEMM output)."""
    y = _matmul(x, w) + b
    return y[..., 0, :], y[..., 1, :], y[..., 2, :]


def _kv_proj(x, w, b):
    """Fused KV projection: x (..., d) @ w (d, 2, d) + b (2, d) -> k, v."""
    y = _matmul(x, w) + b
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
               mask=None):
    """The flash kernel for impl="flash", else the plain einsum path."""
    if impl == "flash":
        return attention_bhsd(q, k, v, n_head, causal=causal)
    return qkv_attention(q, k, v, n_head, mask)


def _use_fused_mlp(x: torch.Tensor, impl: str) -> bool:
    """True when the encoder MLP runs as the fused kernel: the flash config
    on a CUDA tensor (the JAX gate, whisper.py:329, with "tensor on CUDA" in
    place of "backend is tpu"; the port has neither quantized weights nor a
    mesh yet). The kernel's wrapper launches or raises for the dtypes and
    widths it does not take: the card never runs the plain MLP in its
    place."""
    return impl == "flash" and x.is_cuda


def _encoder_block(x, p: Layer, n_head: int, eps: float, impl: str = "xla"):
    """Pre-LN residual encoder block (src/model/mod.rs:298-303)."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"], eps)
    q, k, v = _qkv_proj(h, p["qkv_w"], p["qkv_b"])
    x = x + _linear(_attention(q, k, v, n_head, impl), p["attn_o_w"],
                    p["attn_o_b"])
    if _use_fused_mlp(x, impl):
        return fused_mlp_block(x, p["mlp_ln_g"], p["mlp_ln_b"], p["mlp1_w"],
                               p["mlp1_b"], p["mlp2_w"], p["mlp2_b"], eps=eps)
    h = layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"], eps)
    h = _linear(F.gelu(_linear(h, p["mlp1_w"], p["mlp1_b"])), p["mlp2_w"],
                p["mlp2_b"])
    return x + h


def encoder_forward(params: ParamTree, mel: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """AudioEncoder: mel (B, n_mels, T) -> (B, ceil(T/2), d)
    (src/model/mod.rs:228-260); the positional embedding is sliced to the
    post-conv length."""
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
    n_head, eps = enc_cfg.n_audio_head, cfg.ln_eps
    for p in enc["blocks"].layers():
        x = _encoder_block(x, p, n_head, eps, cfg.attention)
    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"], eps)


# ----------------------------------------------------------------------------
# Decoder: full-sequence forward (the oracle for the cached path)
# ----------------------------------------------------------------------------


def _mlp(h, p: Layer, eps: float):
    hn = layer_norm(h, p["mlp_ln_g"], p["mlp_ln_b"], eps)
    return h + _linear(F.gelu(_linear(hn, p["mlp1_w"], p["mlp1_b"])),
                       p["mlp2_w"], p["mlp2_b"])


def _decoder_block(x, p: Layer, xa, mask, n_head: int, eps: float,
                   impl: str = "xla"):
    """Pre-LN residual decoder block (src/model/mod.rs:344-350)."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"], eps)
    q, k, v = _qkv_proj(h, p["qkv_w"], p["qkv_b"])
    x = x + _linear(_attention(q, k, v, n_head, impl, causal=True, mask=mask),
                    p["attn_o_w"], p["attn_o_b"])
    h = layer_norm(x, p["cross_ln_g"], p["cross_ln_b"], eps)
    q = _linear(h, p["cross_q_w"], p["cross_q_b"])
    ck, cv = _kv_proj(xa, p["cross_kv_w"], p["cross_kv_b"])
    x = x + _linear(_attention(q, ck, cv, n_head, impl), p["cross_o_w"],
                    p["cross_o_b"])
    return _mlp(x, p, eps)


def _logits(x, dec) -> torch.Tensor:
    """Tied output head, f32 logits (src/model/mod.rs:156)."""
    return torch.matmul(x.float(), dec["tok_emb"].float().t())


def decoder_forward(params: ParamTree, tokens: torch.Tensor,
                    enc_out: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """TextDecoder: tokens (B, S) + enc_out (B, Sa, d) -> f32 logits
    (B, S, V) (src/model/mod.rs:131-157), full recompute."""
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    seq_len = tokens.shape[1]
    if seq_len > dec_cfg.n_text_ctx:
        raise ValueError(f"Token sequence length {seq_len} must not exceed "
                         f"{dec_cfg.n_text_ctx}.")
    x = dec["tok_emb"][tokens.long()] + dec["pos_emb"][:seq_len]
    mask = causal_mask(seq_len, seq_len, device=x.device)
    n_head, eps = dec_cfg.n_text_head, cfg.ln_eps
    for p in dec["blocks"].layers():
        x = _decoder_block(x, p, enc_out, mask, n_head, eps, cfg.attention)
    return _logits(layer_norm(x, dec["ln_g"], dec["ln_b"], eps), dec)


def whisper_forward(params: ParamTree, mel: torch.Tensor, tokens: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """`Whisper::forward` (src/model/mod.rs:48-50)."""
    return decoder_forward(params, tokens, encoder_forward(params, mel, cfg),
                           cfg)


# ----------------------------------------------------------------------------
# Incremental decoding with a KV cache
# ----------------------------------------------------------------------------


class DecoderCache(NamedTuple):
    """Fixed-shape decoder state, updated IN PLACE by `decoder_step`.

    self_k/self_v: (B, L, cache_len, d), batch-major;
    cross_k/cross_v: (L, W, Sa, d), layer-major, computed once per window;
    W = B / R when R decode lanes share each window (beam search).
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def init_cache(params: ParamTree, enc_out: torch.Tensor, cfg: WhisperConfig,
               batch: Optional[int] = None, cache_len: Optional[int] = None,
               kv_quant: bool = False, self_quant: bool = False
               ) -> DecoderCache:
    """Zeroed self cache (capped at `cache_len` rows) and the cross K/V of
    every layer from enc_out. A `batch` that is a multiple R of enc_out's
    gives each window R decode lanes that share ONE cross-KV copy (the
    beam case, whisper.py:584-593): lane i reads window i // R. bf16/f32
    caches only: quantized caches are ROADMAP queue 1 item 9."""
    if kv_quant or self_quant:
        raise NotImplementedError(
            "quantized KV caches are ROADMAP queue 1 item 9, not ported yet")
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_layer, d = dec_cfg.n_text_layer, dec_cfg.n_text_state
    b_enc, sa, _ = enc_out.shape
    b = batch or b_enc
    if b % b_enc:
        raise ValueError(
            f"decode batch {b} must be a multiple of enc_out batch {b_enc}")
    dtype = dec["tok_emb"].dtype
    xa = enc_out.to(dtype)
    blocks = dec["blocks"]
    ck = torch.empty((n_layer, b_enc, sa, d), dtype=dtype, device=xa.device)
    cv = torch.empty_like(ck)
    for l in range(n_layer):
        ck[l], cv[l] = _kv_proj(xa, blocks["cross_kv_w"][l],
                                blocks["cross_kv_b"][l])
    c = min(cache_len or dec_cfg.n_text_ctx, dec_cfg.n_text_ctx)
    self_k = torch.zeros((b, n_layer, c, d), dtype=dtype, device=xa.device)
    return DecoderCache(self_k, torch.zeros_like(self_k), ck, cv)


def _cached_attention(q, k_cache, v_cache, last_visible: torch.Tensor,
                      n_head: int) -> torch.Tensor:
    """S new queries (B, S, d) against a (B/R, C, d) cache; key c is
    visible to query i iff c <= last_visible[i]. R = B / cache rows > 1:
    kv row w serves q rows [w*R, (w+1)*R), the beam lanes of one window
    (whisper.py:692-742). The einsum path of the JAX `_cached_attention`:
    q scaled by hd^-0.5 in f32 and cast back, f32 scores, -inf mask, f32
    softmax cast to q's dtype, f32 value sum, output in the cache dtype."""
    b, s, d = q.shape
    bk, c = k_cache.shape[:2]
    rep = b // bk
    hd = d // n_head
    qh = (q * float(hd) ** -0.5).reshape(bk, rep * s, n_head, hd)
    qh = qh.transpose(1, 2)
    kh = k_cache.to(q.dtype).reshape(bk, c, n_head, hd).transpose(1, 2)
    vh = v_cache.to(q.dtype).reshape(bk, c, n_head, hd).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    vis = last_visible.reshape(-1, 1).repeat(rep, 1)  # (rep * S, 1)
    hidden = torch.arange(c, device=q.device)[None, :] > vis
    scores = scores.masked_fill(hidden, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(w.float(), vh.float())
    return out.transpose(1, 2).reshape(b, s, d).to(v_cache.dtype)


def _embed(dec, tokens, pos: int):
    s = tokens.shape[1]
    return dec["tok_emb"][tokens.long()] + dec["pos_emb"][pos:pos + s]


def _decoder_step_fused(params, tokens, pos: int, cache: DecoderCache,
                        cfg: WhisperConfig):
    """Steady-state (S = 1) step over the layer-STACKED caches: the decode
    attention kernel takes the whole cache and the layer index, for the
    self cache (batch-major, rows <= pos visible) and the cross cache
    (layer-major, all rows visible). The bf16/f32 branch of the JAX
    `_decoder_step_fused` (whisper.py:923-954); `c_used` is the full
    cache length (the JAX prefix-rung ladder is a TPU A/B hook). With R
    lanes per window the cross call passes kv_rep = R (the grouped
    kernel)."""
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_head, eps = dec_cfg.n_text_head, cfg.ln_eps
    b = tokens.shape[0]
    scale = float(dec_cfg.n_text_state // n_head) ** -0.5
    _, b_cross, sa, _ = cache.cross_k.shape
    kv_rep = b // b_cross
    c_self = cache.self_k.shape[2]
    pos_self = torch.full((b,), pos, dtype=torch.int32, device=tokens.device)
    pos_cross = torch.full((b,), sa - 1, dtype=torch.int32, device=tokens.device)

    h = _embed(dec, tokens, pos)  # (B, 1, d)
    for l, p in enumerate(dec["blocks"].layers()):
        hn = layer_norm(h, p["attn_ln_g"], p["attn_ln_b"], eps)
        q, k, v = _qkv_proj(hn, p["qkv_w"], p["qkv_b"])
        cache.self_k[:, l, pos] = k[:, 0]  # in-place append
        cache.self_v[:, l, pos] = v[:, 0]
        q1 = q[:, 0] * scale
        attn = decode_attention_stacked(
            q1, cache.self_k, cache.self_v, pos_self, l, n_head,
            batch_major=True, c_used=c_self)
        h = h + _linear(attn[:, None], p["attn_o_w"], p["attn_o_b"])

        hn = layer_norm(h, p["cross_ln_g"], p["cross_ln_b"], eps)
        q = _linear(hn, p["cross_q_w"], p["cross_q_b"])
        q1 = q[:, 0] * scale
        cross = decode_attention_stacked(
            q1, cache.cross_k, cache.cross_v, pos_cross, l, n_head,
            kv_rep=kv_rep)
        h = h + _linear(cross[:, None], p["cross_o_w"], p["cross_o_b"])
        h = _mlp(h, p, eps)
    return _logits(layer_norm(h, dec["ln_g"], dec["ln_b"], eps), dec), cache


def decoder_step(params: ParamTree, tokens: torch.Tensor, pos: int,
                 cache: DecoderCache, cfg: WhisperConfig
                 ) -> Tuple[torch.Tensor, DecoderCache]:
    """Run the decoder on S new tokens at absolute positions [pos, pos+S),
    appending their K/V to the cache IN PLACE; returns (f32 logits
    (B, S, V), the same cache). S = 1 with cfg.attention="flash" takes the
    fused step over the stacked caches; anything else (prefill, or the
    "xla" config) takes the general path with einsum attention."""
    if tokens.shape[1] == 1 and cfg.attention == "flash":
        return _decoder_step_fused(params, tokens, pos, cache, cfg)
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_head, eps = dec_cfg.n_text_head, cfg.ln_eps
    s = tokens.shape[1]
    device = tokens.device
    causal_vis = pos + torch.arange(s, device=device)
    cross_vis = torch.full((s,), cache.cross_k.shape[2] - 1, device=device)

    h = _embed(dec, tokens, pos)
    for l, p in enumerate(dec["blocks"].layers()):
        hn = layer_norm(h, p["attn_ln_g"], p["attn_ln_b"], eps)
        q, k, v = _qkv_proj(hn, p["qkv_w"], p["qkv_b"])
        cache.self_k[:, l, pos:pos + s] = k  # in-place append
        cache.self_v[:, l, pos:pos + s] = v
        attn = _cached_attention(q, cache.self_k[:, l], cache.self_v[:, l],
                                 causal_vis, n_head)
        h = h + _linear(attn, p["attn_o_w"], p["attn_o_b"])

        hn = layer_norm(h, p["cross_ln_g"], p["cross_ln_b"], eps)
        q = _linear(hn, p["cross_q_w"], p["cross_q_b"])
        cross = _cached_attention(q, cache.cross_k[l], cache.cross_v[l],
                                  cross_vis, n_head)
        h = h + _linear(cross, p["cross_o_w"], p["cross_o_b"])
        h = _mlp(h, p, eps)
    return _logits(layer_norm(h, dec["ln_g"], dec["ln_b"], eps), dec), cache
