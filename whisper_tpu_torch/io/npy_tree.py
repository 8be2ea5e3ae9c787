"""Loader for the reference's npy dump-tree checkpoint format: the port's
copy of `whisper_tpu/io/npy_tree.py` (loading only; the writer takes a
JAX pytree and stays there).

Format (whisper-burn `src/model/load.rs:19-27` + `python/dump.py:130-139`):
every tensor is a 1-D float32 .npy whose first D entries are the dimensions
and the rest the flattened values; scalars are `[1.0, value]`
(dump.py:130-132). Linear weights are stored PRE-TRANSPOSED to (in, out)
(dump.py:143). Directory layout documented at dump.py:186-210:

  encoder/
    conv1/{weight,bias}.npy   conv2/{weight,bias}.npy
    block_<i>/
      attn/{query,key,value,out}/{weight[,bias]}.npy + n_head.npy
      attn_ln/{weight,bias,eps}.npy
      mlp/{mlp1,mlp2}/{weight,bias}.npy
      mlp_ln/{weight,bias,eps}.npy
    ln_post/{weight,bias,eps}.npy
    positional_embedding.npy  n_layer.npy  n_mels.npy  n_audio_state.npy
  decoder/
    token_embedding/weight.npy  positional_embedding.npy
    block_<i>/{attn,attn_ln,cross_attn,cross_attn_ln,mlp,mlp_ln}/...
    ln/{weight,bias,eps}.npy  n_layer.npy

Config inference mirrors the reference loader: n_audio_ctx from the encoder
positional-embedding shape (load.rs:227), n_vocab/n_text_ctx from decoder
shapes (load.rs:269-272), heads from the n_head scalars (load.rs:229,265).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import AudioEncoderConfig, TextDecoderConfig, WhisperConfig

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# Primitive reads of the dims-prefixed npy encoding
# ----------------------------------------------------------------------------


def read_tensor(path: str, ndim: int) -> np.ndarray:
    """Read one dims-prefixed tensor (load.rs:19-27)."""
    flat = np.load(path)
    if flat.ndim != 1:
        raise ValueError(f"{path}: expected 1-D dims-prefixed array")
    shape = tuple(int(v) for v in flat[:ndim])
    return flat[ndim:].reshape(shape).astype(np.float32)


def read_scalar(path: str) -> float:
    """Read a `[1.0, value]` scalar (dump.py:130-132, load.rs:47-53)."""
    return float(read_tensor(path, 1)[0])


# ----------------------------------------------------------------------------
# Loading into the whisper_tpu parameter pytree
# ----------------------------------------------------------------------------


def _load_linear(path: str, d_in: int, d_out: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    w = read_tensor(os.path.join(path, "weight.npy"), 2)
    if w.shape != (d_in, d_out):
        raise ValueError(f"{path}: weight shape {w.shape} != ({d_in},{d_out})")
    bias_path = os.path.join(path, "bias.npy")
    b = read_tensor(bias_path, 1) if os.path.exists(bias_path) else None
    return w, b


def _load_ln(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    g = read_tensor(os.path.join(path, "weight.npy"), 1)
    b = read_tensor(os.path.join(path, "bias.npy"), 1)
    eps = read_scalar(os.path.join(path, "eps.npy"))
    return g, b, eps


def _load_attn(path: str, d: int, cross: bool) -> Dict[str, np.ndarray]:
    """Fuse query/key/value linears into the runtime layout.

    K has no bias (src/model/mod.rs:402-404); its fused bias slot is zero so
    the fused matmul is exactly equivalent.
    """
    qw, qb = _load_linear(os.path.join(path, "query"), d, d)
    kw, kb = _load_linear(os.path.join(path, "key"), d, d)
    vw, vb = _load_linear(os.path.join(path, "value"), d, d)
    ow, ob = _load_linear(os.path.join(path, "out"), d, d)
    if kb is None:
        kb = np.zeros((d,), np.float32)
    if cross:
        return {
            "q_w": qw,
            "q_b": qb,
            "kv_w": np.stack([kw, vw], axis=1),   # (d, 2, d)
            "kv_b": np.stack([kb, vb]),           # (2, d)
            "o_w": ow,
            "o_b": ob,
        }
    return {
        "qkv_w": np.stack([qw, kw, vw], axis=1),  # (d, 3, d)
        "qkv_b": np.stack([qb, kb, vb]),          # (3, d)
        "o_w": ow,
        "o_b": ob,
    }


def _load_block(path: str, d: int, cross: bool) -> Tuple[Dict[str, np.ndarray], float]:
    attn = _load_attn(os.path.join(path, "attn"), d, cross=False)
    aln_g, aln_b, eps = _load_ln(os.path.join(path, "attn_ln"))
    m1w, m1b = _load_linear(os.path.join(path, "mlp", "mlp1"), d, 4 * d)
    m2w, m2b = _load_linear(os.path.join(path, "mlp", "mlp2"), 4 * d, d)
    mln_g, mln_b, eps2 = _load_ln(os.path.join(path, "mlp_ln"))
    blk = {
        "attn_ln_g": aln_g,
        "attn_ln_b": aln_b,
        "qkv_w": attn["qkv_w"],
        "qkv_b": attn["qkv_b"],
        "attn_o_w": attn["o_w"],
        "attn_o_b": attn["o_b"],
        "mlp_ln_g": mln_g,
        "mlp_ln_b": mln_b,
        "mlp1_w": m1w,
        "mlp1_b": m1b,
        "mlp2_w": m2w,
        "mlp2_b": m2b,
    }
    if cross:
        ca = _load_attn(os.path.join(path, "cross_attn"), d, cross=True)
        cln_g, cln_b, _ = _load_ln(os.path.join(path, "cross_attn_ln"))
        blk.update(
            {
                "cross_ln_g": cln_g,
                "cross_ln_b": cln_b,
                "cross_q_w": ca["q_w"],
                "cross_q_b": ca["q_b"],
                "cross_kv_w": ca["kv_w"],
                "cross_kv_b": ca["kv_b"],
                "cross_o_w": ca["o_w"],
                "cross_o_b": ca["o_b"],
            }
        )
    return blk, eps


def _stack_blocks(blocks) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}


def load_whisper(path: str) -> Tuple[Params, WhisperConfig]:
    """Load a dump tree -> (params pytree, inferred config).

    Parity: `load_whisper` (src/model/load.rs:295-310).
    """
    enc_path = os.path.join(path, "encoder")
    dec_path = os.path.join(path, "decoder")

    # ---- encoder (load.rs:203-252)
    n_mels = int(read_scalar(os.path.join(enc_path, "n_mels.npy")))
    d = int(read_scalar(os.path.join(enc_path, "n_audio_state.npy")))
    n_layer_e = int(read_scalar(os.path.join(enc_path, "n_layer.npy")))

    conv1_w = read_tensor(os.path.join(enc_path, "conv1", "weight.npy"), 3)
    conv1_b = read_tensor(os.path.join(enc_path, "conv1", "bias.npy"), 1)
    conv2_w = read_tensor(os.path.join(enc_path, "conv2", "weight.npy"), 3)
    conv2_b = read_tensor(os.path.join(enc_path, "conv2", "bias.npy"), 1)
    if conv1_w.shape != (d, n_mels, 3):
        raise ValueError(f"conv1 weight shape {conv1_w.shape} != ({d},{n_mels},3)")
    # torch layout (out, in, k) -> NHC/HIO layout (k, in, out)
    conv1_w = conv1_w.transpose(2, 1, 0)
    conv2_w = conv2_w.transpose(2, 1, 0)

    enc_blocks = []
    eps = 1e-5
    n_head_e = None
    for i in range(n_layer_e):
        bp = os.path.join(enc_path, f"block_{i}")
        blk, eps = _load_block(bp, d, cross=False)
        enc_blocks.append(blk)
        nh = int(read_scalar(os.path.join(bp, "attn", "n_head.npy")))
        if n_head_e is None:
            n_head_e = nh
        elif n_head_e != nh:
            raise ValueError("inconsistent encoder n_head across blocks")

    lnp_g, lnp_b, _ = _load_ln(os.path.join(enc_path, "ln_post"))
    enc_pos = read_tensor(os.path.join(enc_path, "positional_embedding.npy"), 2)
    n_audio_ctx = enc_pos.shape[0]  # inferred (load.rs:227)

    # ---- decoder (load.rs:254-293)
    tok_emb = read_tensor(os.path.join(dec_path, "token_embedding", "weight.npy"), 2)
    dec_pos = read_tensor(os.path.join(dec_path, "positional_embedding.npy"), 2)
    n_layer_d = int(read_scalar(os.path.join(dec_path, "n_layer.npy")))

    dec_blocks = []
    n_head_d = None
    for i in range(n_layer_d):
        bp = os.path.join(dec_path, f"block_{i}")
        blk, _ = _load_block(bp, d, cross=True)
        dec_blocks.append(blk)
        nh = int(read_scalar(os.path.join(bp, "attn", "n_head.npy")))
        n_head_d = n_head_d or nh

    ln_g, ln_b, _ = _load_ln(os.path.join(dec_path, "ln"))
    n_text_ctx, n_text_state = dec_pos.shape  # inferred (load.rs:269)
    n_vocab = tok_emb.shape[0]  # inferred (load.rs:272)

    params: Params = {
        "encoder": {
            "conv1_w": conv1_w,
            "conv1_b": conv1_b,
            "conv2_w": conv2_w,
            "conv2_b": conv2_b,
            "pos_emb": enc_pos,
            "blocks": _stack_blocks(enc_blocks),
            "ln_post_g": lnp_g,
            "ln_post_b": lnp_b,
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos_emb": dec_pos,
            "blocks": _stack_blocks(dec_blocks),
            "ln_g": ln_g,
            "ln_b": ln_b,
        },
    }
    cfg = WhisperConfig(
        audio_encoder_config=AudioEncoderConfig(
            n_mels=n_mels,
            n_audio_ctx=n_audio_ctx,
            n_audio_state=d,
            n_audio_head=n_head_e,
            n_audio_layer=n_layer_e,
        ),
        text_decoder_config=TextDecoderConfig(
            n_vocab=n_vocab,
            n_text_ctx=n_text_ctx,
            n_text_state=n_text_state,
            n_text_head=n_head_d,
            n_text_layer=n_layer_d,
        ),
        ln_eps=eps,
    )
    return params, cfg
