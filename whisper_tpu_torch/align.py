"""Word-level timestamps via cross-attention DTW alignment.

The port's copy of `whisper_tpu/align.py` (the reference, whisper-burn,
emits plain text only; its timestamp vocabulary is unused,
src/token.rs:317-321): the standard Whisper word-timing method --
teacher-force the decoded tokens through the decoder, collect the
cross-attention weights of the alignment heads, normalize + median-filter
them, and dynamic-time-warp the token axis against the audio-frame axis
(20 ms per encoder position). Token jump times are grouped into words by
byte-level BPE space splitting.

The weight-collecting pass is one teacher-forced decoder forward over the
FULL token sequence in plain PyTorch: the JAX package computes these
weights with `jnp.einsum` outside any Pallas kernel, and no decode kernel
returns attention weights, so on the card too they come from plain torch
(the encoder in front of it runs the kernels). JAX pads the sequence to a
multiple of 64 to reuse compiled programs; the causal mask makes the real
rows independent of that padding, and the eager pass needs none. The DTW is
O(tokens x frames) sequential scalar work and stays on the host (numpy).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import WhisperConfig
from .models.whisper import (_kv_proj, _linear, _local_heads,
                             _mlp, _qkv_proj, _row_linear, causal_mask,
                             layer_norm, qkv_attention)
from .parallel import context as pctx
from .params import ParamTree

FRAME_SECONDS = 0.02  # one encoder position = two 10 ms mel frames


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float  # seconds, window-relative (caller adds the offset)
    end: float
    tokens: List[int]


def default_alignment_heads(cfg: WhisperConfig) -> List[Tuple[int, int]]:
    """Generic alignment-head set: every head of the top half of decoder
    layers (OpenAI's fallback when a model has no baked head mask)."""
    dec = cfg.text_decoder_config
    return [
        (l, h)
        for l in range(dec.n_text_layer // 2, dec.n_text_layer)
        for h in range(dec.n_text_head)
    ]


def cross_attention_weights(
    params: ParamTree,
    enc_out: torch.Tensor,  # (1, Sa, d)
    tokens: torch.Tensor,  # (S,) int64 full sequence (prompt + text + EOT)
    cfg: WhisperConfig,
) -> torch.Tensor:
    """Teacher-forced decoder pass returning the cross-attention softmax of
    every layer: (L, H, S, Sa) f32. Mirrors the JAX `cross_attention_
    weights` (align.py:55-107) exactly: the decoder block's math with the
    scale (d/h)^-0.25 on q AND k in their dtype, f32 scores and an f32
    softmax, whose weights (cast to v's dtype) also feed the block's
    output. Plain PyTorch on any device (the self-attention as well, as
    JAX's `qkv_attention`); QTensor weights take the dequant matmul. Under
    a tp mesh each rank computes its local heads (the model's tp layout,
    models/whisper.py) and the weights are gathered over tp, so every rank
    returns all H heads."""
    dec = params["decoder"]
    dec_cfg = cfg.text_decoder_config
    n_head, eps = _local_heads(dec_cfg.n_text_head), cfg.ln_eps
    d = dec_cfg.n_text_state // pctx.tp_size()
    hd = d // n_head
    scale = (d / n_head) ** -0.25
    toks = tokens.long()[None, :]
    s = toks.shape[1]

    h = dec["tok_emb"][toks] + dec["pos_emb"][:s]
    mask = causal_mask(s, s, device=h.device)
    ws = []
    for p in dec["blocks"].layers():
        hn = layer_norm(h, p["attn_ln_g"], p["attn_ln_b"], eps)
        q, k, v = _qkv_proj(hn, p["qkv_w"], p["qkv_b"])
        h = h + _row_linear(qkv_attention(q, k, v, n_head, mask=mask),
                            p["attn_o_w"], p["attn_o_b"])

        hn = layer_norm(h, p["cross_ln_g"], p["cross_ln_b"], eps)
        q = _linear(pctx.copy_to_tp(hn), p["cross_q_w"], p["cross_q_b"])
        ck, cv = _kv_proj(enc_out.to(h.dtype), p["cross_kv_w"],
                          p["cross_kv_b"])
        qh = (q * scale).reshape(1, s, n_head, hd).transpose(1, 2)
        kh = (ck * scale).reshape(1, -1, n_head, hd).transpose(1, 2)
        vh = cv.reshape(1, -1, n_head, hd).transpose(1, 2)
        w = torch.softmax(torch.matmul(qh.float(), kh.float().transpose(-1, -2)),
                          dim=-1)  # (1, H, S, Sa) f32
        out = torch.matmul(w.to(vh.dtype).float(), vh.float()).to(vh.dtype)
        out = out.transpose(1, 2).reshape(1, s, d)
        h = h + _row_linear(out, p["cross_o_w"], p["cross_o_b"])
        h = _mlp(h, p, eps)
        ws.append(w[0])
    return pctx.tp_all_gather(torch.stack(ws), 1)  # (L, H, S, Sa)


def median_filter(x: np.ndarray, width: int = 7, device="cpu") -> np.ndarray:
    """Median filter over the LAST axis, edge-padded (odd width), computed
    with torch on `device`: for an odd width the median is the middle
    order statistic, so the result equals the JAX package's `np.median`
    bit for bit, and on the card it takes milliseconds where numpy takes
    seconds over a large model's top-half heads."""
    if width <= 1:
        return x
    if width % 2 == 0:
        raise ValueError(f"median_filter takes an odd width, got {width}")
    pad = width // 2
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    t = F.pad(t.reshape(-1, 1, t.shape[-1]), (pad, pad), mode="replicate")
    med = t.unfold(-1, width, 1).median(dim=-1).values
    return med.reshape(x.shape).cpu().numpy()


def dtw(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path minimizing summed cost over an (N, M) matrix.

    Returns (text_indices, time_indices) tracing the optimal path from
    (0, 0) to (N-1, M-1) with steps {down, right, diagonal}."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), np.int8)
    for i in range(1, n + 1):
        row = cost[i - 1]
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]
            c1 = acc[i - 1, j]
            c2 = acc[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                acc[i, j] = c0 + row[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                acc[i, j] = c1 + row[j - 1]
                trace[i, j] = 1
            else:
                acc[i, j] = c2 + row[j - 1]
                trace[i, j] = 2
    i, j = n, m
    ti, tj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(tj[::-1])


def split_tokens_on_spaces(
    tokens: Sequence[int], tok
) -> List[Tuple[str, List[int], List[int]]]:
    """Group text tokens into words: [(word, tokens, positions)].

    Byte-level BPE pieces may split UTF-8 codepoints, so subwords are
    flushed only when their accumulated decode carries no trailing
    replacement character (OpenAI's split_tokens_on_unicode), then merged
    into words at leading spaces. Special tokens are skipped but keep their
    positions out of the words."""
    words: List[Tuple[str, List[int], List[int]]] = []
    cur: List[int] = []
    cur_pos: List[int] = []

    def flush_subword(text: str, toks: List[int], pos: List[int]) -> None:
        # A subword that starts with whitespace starts a NEW word (byte-level
        # BPE attaches the space to the following piece; with single-byte
        # pieces the bare " " itself opens the word and later pieces append).
        start_new = not words or text.startswith(" ") or not text.strip()
        if start_new:
            words.append((text, list(toks), list(pos)))
        else:
            w, t, p = words[-1]
            words[-1] = (w + text, t + list(toks), p + list(pos))

    for i, t in enumerate(tokens):
        t = int(t)
        if tok.is_special(t):
            continue
        cur.append(t)
        cur_pos.append(i)
        decoded = tok.decode(cur, skip_special=True)
        if decoded and "�" not in decoded[-1:]:
            flush_subword(decoded, cur, cur_pos)
            cur, cur_pos = [], []
    if cur:
        decoded = tok.decode(cur, skip_special=True)
        if decoded.strip():
            flush_subword(decoded, cur, cur_pos)
    return [(w.strip(), t, p) for w, t, p in words if w.strip()]


# OpenAI Whisper's defaults (timing.py merge_punctuations): punctuation
# that opens a phrase attaches to the FOLLOWING word, closing punctuation
# to the PRECEDING word, so punctuation never stands as its own "word"
# with a meaningless timestamp.
PREPEND_PUNCTUATIONS = "\"'\u201c\u00bf([{-"
APPEND_PUNCTUATIONS = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


def merge_punctuations(
    words: List[WordTiming],
    prepend: str = PREPEND_PUNCTUATIONS,
    append: str = APPEND_PUNCTUATIONS,
) -> List[WordTiming]:
    """Merge punctuation-only words into their neighbors.

    A word consisting solely of opening punctuation merges into the next
    word (which keeps its own timing); solely-closing punctuation merges
    into the previous word. Matches the published method's semantics on
    this module's stripped word strings."""
    out: List[Optional[WordTiming]] = list(words)
    # prepend: scan backwards so chains ("¿( word") collapse fully
    j = len(out) - 1
    for i in range(len(out) - 2, -1, -1):
        prev, nxt = out[i], out[j]
        if prev is not None and nxt is not None and prev.word in prepend:
            out[j] = WordTiming(prev.word + nxt.word, nxt.start, nxt.end,
                                list(prev.tokens) + list(nxt.tokens))
            out[i] = None
        else:
            j = i
    merged = [w for w in out if w is not None]
    out = list(merged)
    i = 0
    for j in range(1, len(out)):
        prev, nxt = out[i], out[j]
        if prev is not None and nxt is not None and nxt.word in append:
            out[i] = WordTiming(prev.word + nxt.word, prev.start, prev.end,
                                list(prev.tokens) + list(nxt.tokens))
            out[j] = None
        else:
            i = j
    return [w for w in out if w is not None]


def find_word_timings(
    params: ParamTree,
    enc_out: torch.Tensor,  # (1, Sa, d) of the window
    tokens: Sequence[int],  # full window sequence (prompt + text + EOT)
    cfg: WhisperConfig,
    tok,
    num_frames: int,  # VALID encoder positions (real audio frames // 2)
    heads: Optional[Sequence[Tuple[int, int]]] = None,
    medfilt_width: int = 7,
) -> List[WordTiming]:
    """Align `tokens` against the audio and return per-word timings.

    The standard Whisper method: alignment-head cross-attention weights,
    per-head mean/std normalization over the token axis, median filter over
    frames, head-averaged cost matrix, DTW, word grouping. Times are
    window-relative seconds on the 20 ms encoder grid.

    Head priority: explicit `heads` arg > the model's baked mask
    (`cfg.alignment_heads`, persisted by the converters) > the generic
    top-half fallback. Baked masks track audio time far better than the
    fallback -- on real checkpoints always convert with the mask."""
    if heads is not None:
        heads = list(heads)
    elif cfg.alignment_heads:
        heads = [tuple(p) for p in cfg.alignment_heads]
    else:
        heads = default_alignment_heads(cfg)
    toks = list(map(int, tokens))
    s_real = len(toks)
    with torch.inference_mode():
        ws = cross_attention_weights(
            params, enc_out,
            torch.tensor(toks, dtype=torch.long, device=enc_out.device), cfg)
        # the heads' weights only leave the device
        sel = ws[[l for l, _ in heads], [h for _, h in heads]].cpu().numpy()
    sel = sel[:, :, : max(num_frames, 2)]  # (n_heads, S, F)
    mean = sel.mean(axis=-2, keepdims=True)
    std = sel.std(axis=-2, keepdims=True) + 1e-8
    sel = (sel - mean) / std
    sel = median_filter(sel, medfilt_width, device=enc_out.device)
    matrix = sel.mean(axis=0)  # (S, F)

    text_idx, time_idx = dtw(-matrix.astype(np.float64))
    s = s_real
    # first frame index where the path reaches token i; end = next start
    jumps = np.full(s + 1, time_idx[-1] + 1, np.int64)
    seen = np.zeros(s + 1, bool)
    for ti, fj in zip(text_idx, time_idx):
        if not seen[ti]:
            jumps[ti] = fj
            seen[ti] = True
    start_t = jumps * FRAME_SECONDS

    out: List[WordTiming] = []
    for word, wtoks, pos in split_tokens_on_spaces(tokens, tok):
        t0 = float(start_t[pos[0]])
        t1 = float(start_t[min(pos[-1] + 1, s)])
        out.append(WordTiming(word, t0, max(t1, t0), wtoks))
    return merge_punctuations(out)
