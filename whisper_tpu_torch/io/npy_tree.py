"""Loader and writer of the reference's npy dump-tree checkpoint format:
the port's copy of `whisper_tpu/io/npy_tree.py`, over the parameter tree
as nested dicts of numpy arrays.

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
# Primitive read/write of the dims-prefixed npy encoding
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


def write_tensor(arr: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(arr, np.float32)
    np.save(path, np.concatenate([np.array(arr.shape, np.float32), arr.ravel()]))


def write_scalar(value: float, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.array([1.0, float(value)], np.float32))


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


# ----------------------------------------------------------------------------
# Saving (produces trees byte-compatible with the reference loader; used by
# tests and by the convert CLI's round-trip path)
# ----------------------------------------------------------------------------


def _save_linear(w: np.ndarray, b: Optional[np.ndarray], path: str) -> None:
    write_tensor(w, os.path.join(path, "weight.npy"))
    if b is not None:
        write_tensor(b, os.path.join(path, "bias.npy"))


def _save_ln(g, b, eps: float, path: str) -> None:
    write_tensor(g, os.path.join(path, "weight.npy"))
    write_tensor(b, os.path.join(path, "bias.npy"))
    write_scalar(eps, os.path.join(path, "eps.npy"))


def _save_block(blk: Dict[str, np.ndarray], i: int, path: str, n_head: int,
                eps: float, cross: bool) -> None:
    d = blk["attn_o_w"].shape[-1]
    qw, kw, vw = blk["qkv_w"][i, :, 0], blk["qkv_w"][i, :, 1], blk["qkv_w"][i, :, 2]
    qb, kb, vb = blk["qkv_b"][i]
    ap = os.path.join(path, "attn")
    _save_linear(qw, qb, os.path.join(ap, "query"))
    _save_linear(kw, None, os.path.join(ap, "key"))  # K: no bias
    _save_linear(vw, vb, os.path.join(ap, "value"))
    _save_linear(blk["attn_o_w"][i], blk["attn_o_b"][i], os.path.join(ap, "out"))
    write_scalar(n_head, os.path.join(ap, "n_head.npy"))
    _save_ln(blk["attn_ln_g"][i], blk["attn_ln_b"][i], eps, os.path.join(path, "attn_ln"))
    if cross:
        cp = os.path.join(path, "cross_attn")
        ckw, cvw = blk["cross_kv_w"][i, :, 0], blk["cross_kv_w"][i, :, 1]
        ckb, cvb = blk["cross_kv_b"][i]
        _save_linear(blk["cross_q_w"][i], blk["cross_q_b"][i], os.path.join(cp, "query"))
        _save_linear(ckw, None, os.path.join(cp, "key"))
        _save_linear(cvw, cvb, os.path.join(cp, "value"))
        _save_linear(blk["cross_o_w"][i], blk["cross_o_b"][i], os.path.join(cp, "out"))
        write_scalar(n_head, os.path.join(cp, "n_head.npy"))
        _save_ln(
            blk["cross_ln_g"][i], blk["cross_ln_b"][i], eps,
            os.path.join(path, "cross_attn_ln"),
        )
    _save_linear(blk["mlp1_w"][i], blk["mlp1_b"][i], os.path.join(path, "mlp", "mlp1"))
    _save_linear(blk["mlp2_w"][i], blk["mlp2_b"][i], os.path.join(path, "mlp", "mlp2"))
    _save_ln(blk["mlp_ln_g"][i], blk["mlp_ln_b"][i], eps, os.path.join(path, "mlp_ln"))


def save_whisper(params: Params, cfg: WhisperConfig, path: str) -> None:
    """Write params (numpy leaves) as a reference-format dump tree
    (dump.py:186-210 layout)."""
    enc_cfg, dec_cfg = cfg.audio_encoder_config, cfg.text_decoder_config
    eps = cfg.ln_eps

    enc = params["encoder"]
    ep = os.path.join(path, "encoder")
    # back to torch layout (out, in, k)
    write_tensor(enc["conv1_w"].transpose(2, 1, 0), os.path.join(ep, "conv1", "weight.npy"))
    write_tensor(enc["conv1_b"], os.path.join(ep, "conv1", "bias.npy"))
    write_tensor(enc["conv2_w"].transpose(2, 1, 0), os.path.join(ep, "conv2", "weight.npy"))
    write_tensor(enc["conv2_b"], os.path.join(ep, "conv2", "bias.npy"))
    for i in range(enc_cfg.n_audio_layer):
        _save_block(
            enc["blocks"], i, os.path.join(ep, f"block_{i}"),
            enc_cfg.n_audio_head, eps, cross=False,
        )
    _save_ln(enc["ln_post_g"], enc["ln_post_b"], eps, os.path.join(ep, "ln_post"))
    write_tensor(enc["pos_emb"], os.path.join(ep, "positional_embedding.npy"))
    write_scalar(enc_cfg.n_audio_layer, os.path.join(ep, "n_layer.npy"))
    write_scalar(enc_cfg.n_mels, os.path.join(ep, "n_mels.npy"))
    write_scalar(enc_cfg.n_audio_state, os.path.join(ep, "n_audio_state.npy"))

    dec = params["decoder"]
    dp = os.path.join(path, "decoder")
    write_tensor(dec["tok_emb"], os.path.join(dp, "token_embedding", "weight.npy"))
    write_tensor(dec["pos_emb"], os.path.join(dp, "positional_embedding.npy"))
    for i in range(dec_cfg.n_text_layer):
        _save_block(
            dec["blocks"], i, os.path.join(dp, f"block_{i}"),
            dec_cfg.n_text_head, eps, cross=True,
        )
    _save_ln(dec["ln_g"], dec["ln_b"], eps, os.path.join(dp, "ln"))
    write_scalar(dec_cfg.n_text_layer, os.path.join(dp, "n_layer.npy"))
