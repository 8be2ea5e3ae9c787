"""Reader AND writer for Burn `.mpk.gz` records (the reference's fast-load
format): the port's copy of `whisper_tpu/io/mpk.py`.

The reference's convert CLI saves the model with Burn 0.9's `DefaultRecorder`
(= gzipped named-MessagePack, src/bin/convert/main.rs:17-19): the module
record tree is serialized with field names preserved, tensors as
`DataSerialize { value: [f32...], shape: [usize...] }` leaves (wrapped in
`ParamSerde { id, param }`), and constants (usize fields like `n_head`,
module-less layers like GELU) as unit/nil values.

Both directions were written against that format's structure as documented by
the Burn 0.9 sources referenced in SURVEY.md; no sample `.mpk.gz` exists in
this offline environment, so the reader is deliberately *tolerant*: it walks
the decoded msgpack tree, treats any map containing ("value", "shape") --
possibly nested under "param"/"id" wrappers -- as a tensor leaf, and resolves
module paths by field name (encoder/decoder/conv1/blocks/... -- the same
names as the Rust structs in src/model/mod.rs). The writer emits the
canonical param-wrapped layout, including the decoder's precomputed causal
`mask` Param (src/model/mod.rs:125) the Rust loader expects; writer->reader
round-trip equality is tested. Validation against a real Burn-produced file
remains an open item (requires the Rust toolchain or a sample record).
"""

from __future__ import annotations

import gzip
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import AudioEncoderConfig, TextDecoderConfig, WhisperConfig
log = logging.getLogger(__name__)

Params = Dict[str, Any]


def _decode_msgpack(raw: bytes) -> Any:
    import msgpack

    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


def _as_tensor(node: Any) -> Optional[np.ndarray]:
    """Recognize a tensor leaf in any of the plausible Burn serializations."""
    if not isinstance(node, dict):
        return None
    # unwrap Param { id, value/param } wrappers
    for wrapper in ("param", "value"):
        if wrapper in node and isinstance(node[wrapper], dict):
            inner = _as_tensor(node[wrapper])
            if inner is not None:
                return inner
    if "value" in node and "shape" in node:
        value, shape = node["value"], node["shape"]
        if isinstance(value, (list, bytes)) and isinstance(shape, list):
            if isinstance(value, bytes):
                arr = np.frombuffer(value, dtype="<f4")
            else:
                arr = np.asarray(value, dtype=np.float32)
            return arr.reshape([int(s) for s in shape])
    return None


def _get(node: Dict[str, Any], *names: str) -> Any:
    for n in names:
        if isinstance(node, dict) and n in node:
            return node[n]
    raise KeyError(f"record missing field {names} (have {list(node)[:10]})")


def _tensor(node: Dict[str, Any], *names: str) -> np.ndarray:
    t = _as_tensor(_get(node, *names))
    if t is None:
        raise ValueError(f"field {names} is not a tensor leaf")
    return t


def _maybe_tensor(node: Dict[str, Any], name: str) -> Optional[np.ndarray]:
    if not isinstance(node, dict) or name not in node or node[name] is None:
        return None
    return _as_tensor(node[name])


def _linear(node: Dict[str, Any]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Burn LinearRecord {weight (d_in, d_out), bias}."""
    return _tensor(node, "weight"), _maybe_tensor(node, "bias")


def _ln(node: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    return _tensor(node, "gamma", "weight"), _tensor(node, "beta", "bias")


def _attn(node: Dict[str, Any], d: int, cross: bool) -> Dict[str, np.ndarray]:
    qw, qb = _linear(_get(node, "query"))
    kw, kb = _linear(_get(node, "key"))
    vw, vb = _linear(_get(node, "value"))
    ow, ob = _linear(_get(node, "out"))
    if kb is None:
        kb = np.zeros((d,), np.float32)
    if cross:
        return {
            "cross_q_w": qw, "cross_q_b": qb,
            "cross_kv_w": np.stack([kw, vw], axis=1),
            "cross_kv_b": np.stack([kb, vb]),
            "cross_o_w": ow, "cross_o_b": ob,
        }
    return {
        "qkv_w": np.stack([qw, kw, vw], axis=1),
        "qkv_b": np.stack([qb, kb, vb]),
        "attn_o_w": ow, "attn_o_b": ob,
    }


def _block(node: Dict[str, Any], d: int, cross: bool) -> Dict[str, np.ndarray]:
    blk: Dict[str, np.ndarray] = {}
    blk.update(_attn(_get(node, "attn"), d, cross=False))
    g, b = _ln(_get(node, "attn_ln"))
    blk["attn_ln_g"], blk["attn_ln_b"] = g, b
    if cross:
        blk.update(_attn(_get(node, "cross_attn"), d, cross=True))
        g, b = _ln(_get(node, "cross_attn_ln"))
        blk["cross_ln_g"], blk["cross_ln_b"] = g, b
    mlp = _get(node, "mlp")
    m1w, m1b = _linear(_get(mlp, "lin1", "mlp1"))
    m2w, m2b = _linear(_get(mlp, "lin2", "mlp2"))
    blk["mlp1_w"], blk["mlp1_b"] = m1w, m1b
    blk["mlp2_w"], blk["mlp2_b"] = m2w, m2b
    g, b = _ln(_get(node, "mlp_ln"))
    blk["mlp_ln_g"], blk["mlp_ln_b"] = g, b
    return blk


def _stack(blocks: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}


def load_whisper_record(
    path: str, cfg: Optional[WhisperConfig] = None
) -> Tuple[Params, WhisperConfig]:
    """Load a Burn `.mpk.gz` (or plain `.mpk`) Whisper record."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".gz") or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    root = _decode_msgpack(raw)
    if not isinstance(root, dict):
        raise ValueError(f"{path}: unexpected msgpack root {type(root)}")
    # some serializations wrap the record in {"item": ...}
    if "item" in root and "encoder" not in root:
        root = root["item"]

    enc = _get(root, "encoder")
    dec = _get(root, "decoder")

    # conv weights: Burn Conv1d stores (channels_out, channels_in, kernel)
    conv1_w = _tensor(_get(enc, "conv1"), "weight")
    conv1_b = _tensor(_get(enc, "conv1"), "bias")
    conv2_w = _tensor(_get(enc, "conv2"), "weight")
    conv2_b = _tensor(_get(enc, "conv2"), "bias")
    n_mels = conv1_w.shape[1]
    d = conv1_w.shape[0]
    conv1_w = conv1_w.transpose(2, 1, 0)  # -> (k, in, out)
    conv2_w = conv2_w.transpose(2, 1, 0)

    enc_blocks_raw = _get(enc, "blocks")
    enc_blocks = [_block(bn, d, cross=False) for bn in enc_blocks_raw]
    enc_pos = _tensor(enc, "positional_embedding")
    lnp_g, lnp_b = _ln(_get(enc, "ln_post"))

    tok_emb = _tensor(dec, "token_embedding")
    dec_pos = _tensor(dec, "positional_embedding")
    dec_blocks_raw = _get(dec, "blocks")
    dec_blocks = [_block(bn, d, cross=True) for bn in dec_blocks_raw]
    ln_g, ln_b = _ln(_get(dec, "ln"))

    params: Params = {
        "encoder": {
            "conv1_w": conv1_w, "conv1_b": conv1_b,
            "conv2_w": conv2_w, "conv2_b": conv2_b,
            "pos_emb": enc_pos,
            "blocks": _stack(enc_blocks),
            "ln_post_g": lnp_g, "ln_post_b": lnp_b,
        },
        "decoder": {
            "tok_emb": tok_emb, "pos_emb": dec_pos,
            "blocks": _stack(dec_blocks),
            "ln_g": ln_g, "ln_b": ln_b,
        },
    }

    if cfg is None:
        # n_head is a Burn constant (not serialized); fall back to the
        # standard head width d/64 used by every Whisper size. WRONG for
        # nonstandard head counts -- pass cfg or keep the .cfg next to the
        # record (the reference always writes one, convert/main.rs:51).
        n_head = max(1, d // 64)
        log.warning(
            "%s: no .cfg provided; inferring n_head=%d from d/64 -- wrong "
            "for models with nonstandard head widths", path, n_head,
        )
        cfg = WhisperConfig(
            audio_encoder_config=AudioEncoderConfig(
                n_mels=n_mels,
                n_audio_ctx=enc_pos.shape[0],
                n_audio_state=d,
                n_audio_head=n_head,
                n_audio_layer=len(enc_blocks),
            ),
            text_decoder_config=TextDecoderConfig(
                n_vocab=tok_emb.shape[0],
                n_text_ctx=dec_pos.shape[0],
                n_text_state=dec_pos.shape[1],
                n_text_head=n_head,
                n_text_layer=len(dec_blocks),
            ),
        )
    return params, cfg


# ----------------------------------------------------------------------------
# Writer: params pytree -> Burn-layout named-msgpack record.
# ----------------------------------------------------------------------------


def _leaf(arr: np.ndarray, ident: int) -> Dict[str, Any]:
    """ParamSerde { id, param: DataSerialize { value, shape } }."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    return {
        "id": f"{ident:032x}",
        "param": {
            "value": a.reshape(-1).tolist(),
            "shape": [int(s) for s in a.shape],
        },
    }


class _Ids:
    """Deterministic Param ids (Burn uses random uuids; determinism is
    friendlier to tests and diffing and equally valid on load)."""

    def __init__(self):
        self.n = 0

    def leaf(self, arr: np.ndarray) -> Dict[str, Any]:
        self.n += 1
        return _leaf(arr, self.n)


def _write_linear(ids: _Ids, w: np.ndarray,
                  b: Optional[np.ndarray]) -> Dict[str, Any]:
    """Burn LinearRecord: weight (d_in, d_out) -- the same orientation the
    npy dumper pre-transposes to (python/dump.py:143) and this repo stores."""
    return {
        "weight": ids.leaf(w),
        "bias": None if b is None else ids.leaf(b),
    }


def _write_ln(ids: _Ids, g: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    return {"gamma": ids.leaf(g), "beta": ids.leaf(b), "epsilon": None}


def _write_attn(ids: _Ids, blk: Dict[str, np.ndarray], i: int,
                cross: bool) -> Dict[str, Any]:
    if cross:
        qw, qb = blk["cross_q_w"][i], blk["cross_q_b"][i]
        kw, vw = blk["cross_kv_w"][i, :, 0], blk["cross_kv_w"][i, :, 1]
        kb, vb = blk["cross_kv_b"][i, 0], blk["cross_kv_b"][i, 1]
        ow, ob = blk["cross_o_w"][i], blk["cross_o_b"][i]
    else:
        qw, kw, vw = (blk["qkv_w"][i, :, j] for j in range(3))
        qb, kb, vb = (blk["qkv_b"][i, j] for j in range(3))
        ow, ob = blk["attn_o_w"][i], blk["attn_o_b"][i]
    return {
        "n_head": None,  # Burn constant (from .cfg), src/model/mod.rs:420
        "query": _write_linear(ids, qw, qb),
        # K has no bias in the reference (src/model/mod.rs:402-404)
        "key": _write_linear(ids, kw, None),
        "value": _write_linear(ids, vw, vb),
        "out": _write_linear(ids, ow, ob),
    }


def _write_block(ids: _Ids, blk: Dict[str, np.ndarray], i: int,
                 cross: bool) -> Dict[str, Any]:
    node: Dict[str, Any] = {
        "attn": _write_attn(ids, blk, i, cross=False),
        "attn_ln": _write_ln(ids, blk["attn_ln_g"][i], blk["attn_ln_b"][i]),
    }
    if cross:
        node["cross_attn"] = _write_attn(ids, blk, i, cross=True)
        node["cross_attn_ln"] = _write_ln(
            ids, blk["cross_ln_g"][i], blk["cross_ln_b"][i])
    node["mlp"] = {
        "lin1": _write_linear(ids, blk["mlp1_w"][i], blk["mlp1_b"][i]),
        "gelu": None,
        "lin2": _write_linear(ids, blk["mlp2_w"][i], blk["mlp2_b"][i]),
    }
    node["mlp_ln"] = _write_ln(ids, blk["mlp_ln_g"][i], blk["mlp_ln_b"][i])
    return node


def causal_mask(n_ctx: int) -> np.ndarray:
    """The decoder's precomputed additive causal mask Param
    (`attn_decoder_mask`, src/model/mod.rs:535-544): row i has -inf at
    columns > i. Stored as f32::NEG_INFINITY in the Burn record; msgpack
    carries f32 -inf natively."""
    mask = np.zeros((n_ctx, n_ctx), np.float32)
    mask[np.triu_indices(n_ctx, k=1)] = -np.inf
    return mask


def save_whisper_record(params: Params, cfg: WhisperConfig, path: str) -> None:
    """Write a Burn 0.9 DefaultRecorder-layout `.mpk.gz` record
    (src/bin/convert/main.rs:17-19 output contract).

    The caller should write `<name>.cfg` next to it like the reference
    (convert/main.rs:51); constants (n_head etc.) live there, not here.
    """
    import msgpack

    to_np = lambda x: np.asarray(x, dtype=np.float32)
    enc, dec = params["encoder"], params["decoder"]
    eb, db = enc["blocks"], dec["blocks"]
    n_enc = eb["qkv_w"].shape[0]
    n_dec = db["qkv_w"].shape[0]
    ids = _Ids()

    enc_node = {
        "conv1": {
            # Burn Conv1d stores (out, in, k); the pytree keeps (k, in, out)
            "weight": ids.leaf(to_np(enc["conv1_w"]).transpose(2, 1, 0)),
            "bias": ids.leaf(to_np(enc["conv1_b"])),
            "stride": None, "kernel_size": None, "dilation": None,
            "groups": None, "padding": None,
        },
        "gelu1": None,
        "conv2": {
            "weight": ids.leaf(to_np(enc["conv2_w"]).transpose(2, 1, 0)),
            "bias": ids.leaf(to_np(enc["conv2_b"])),
            "stride": None, "kernel_size": None, "dilation": None,
            "groups": None, "padding": None,
        },
        "gelu2": None,
        "blocks": [
            _write_block(ids, {k: to_np(v) for k, v in eb.items()}, i,
                         cross=False)
            for i in range(n_enc)
        ],
        "ln_post": _write_ln(ids, to_np(enc["ln_post_g"]),
                             to_np(enc["ln_post_b"])),
        "positional_embedding": ids.leaf(to_np(enc["pos_emb"])),
        "n_mels": None,
        "n_audio_ctx": None,
    }
    n_text_ctx = int(np.asarray(dec["pos_emb"]).shape[0])
    dec_node = {
        "token_embedding": ids.leaf(to_np(dec["tok_emb"])),
        "positional_embedding": ids.leaf(to_np(dec["pos_emb"])),
        "blocks": [
            _write_block(ids, {k: to_np(v) for k, v in db.items()}, i,
                         cross=True)
            for i in range(n_dec)
        ],
        "ln": _write_ln(ids, to_np(dec["ln_g"]), to_np(dec["ln_b"])),
        # the reference stores the full-context causal mask as a Param
        # (src/model/mod.rs:125,152); the Rust loader expects it present
        "mask": ids.leaf(causal_mask(n_text_ctx)),
        "n_vocab": None,
        "n_text_ctx": None,
    }

    record = {"item": {"encoder": enc_node, "decoder": dec_node}}
    raw = msgpack.packb(record, use_single_float=True)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=6) as f:
            f.write(raw)
    else:
        with open(path, "wb") as f:
            f.write(raw)
