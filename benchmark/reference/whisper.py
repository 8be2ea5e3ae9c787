"""Whisper in plain float32 PyTorch: the log-mel frontend, the encoder, a
teacher-forced decoder that gives the logits at every position of a given
token sequence, and a plain beam search over a decoder that keeps its
keys and values.

It follows the published model (OpenAI's `whisper/model.py` and
`whisper/audio.py`) with the window semantics of the configuration's
`assumed` block: a window's mel keeps at most n_ctx - padding frames and
is padded with `padding` zero frames. The weights come in the layout the
benchmark makes them in (`benchmark/weights.py`): per-layer matrices
stored (in, out), fused QKV (d, 3, d) and cross KV (d, 2, d), stacked on a
leading layer axis; each layer is cast to float32 when it is used, so the
whole model is never held in float32 at once.

On CUDA the caller turns TF32 off (`float32_matmuls`), so every product
here is a float32 product.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 matrix products and convolutions on CUDA (no TF32)
    inside the block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def window_samples(n_audio_ctx: int, padding: int) -> int:
    """Samples of a full window: the most that give n_audio_ctx - padding
    mel frames (one frame every HOP samples, the last frame dropped)."""
    return HOP * (n_audio_ctx - padding + 1) - 1


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale triangular filters with Slaney area normalisation,
    (n_mels, N_FFT // 2 + 1), as librosa.filters.mel(sr=16000, n_fft=400,
    n_mels=n_mels) builds the filters Whisper ships."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        return (min_log_mel + math.log(f / min_log_hz) / logstep
                if f >= min_log_hz else f / f_sp)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2.0),
                       n_mels + 2)
    hz = np.where(mels >= min_log_mel,
                  min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                  f_sp * mels)
    fft_hz = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    ramps = hz[:, None] - fft_hz[None, :]
    lower = -ramps[:-2] / np.diff(hz)[:-1, None]
    upper = ramps[2:] / np.diff(hz)[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(wave: torch.Tensor, n_mels: int, n_audio_ctx: int,
            padding: int) -> torch.Tensor:
    """(B, n) waveforms of one length -> (B, n_mels, T) float32 log-mel:
    a periodic Hann STFT with reflection padding (float64), power, the last
    frame dropped, mel filters, log10 floored at 1e-10, each window floored
    at its own maximum - 8, (x + 4) / 4; then at most n_audio_ctx - padding
    frames kept and `padding` zero frames appended."""
    x = wave.to(torch.float64)
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                               device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.abs() ** 2
    power = power[..., :-1]
    filt = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.log10(torch.clamp(filt @ power, min=1e-10))
    mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
    mel = (mel + 4.0) / 4.0
    mel = mel[:, :, :n_audio_ctx - padding]
    return F.pad(mel, (0, padding)).to(torch.float32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _layer(blocks: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: _f32(v[i]) for k, v in blocks.items()}


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)


def _attention(q, k, v, n_head: int, causal: bool):
    """Softmax(q k^T / sqrt(hd)) v over heads; q (B, Sq, d), k, v (B, Sk, d)."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // n_head
    qh = q.reshape(b, sq, n_head, hd).transpose(1, 2)
    kh = k.reshape(b, sk, n_head, hd).transpose(1, 2)
    vh = v.reshape(b, sk, n_head, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        hide = torch.ones(sq, sk, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(hide, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, sq, d)


def _mlp(x, p):
    h = _ln(x, p["mlp_ln_g"], p["mlp_ln_b"])
    return x + F.gelu(h @ p["mlp1_w"] + p["mlp1_b"]) @ p["mlp2_w"] + p["mlp2_b"]


def encoder(weights: Dict, mel: torch.Tensor, n_head: int) -> torch.Tensor:
    """mel (B, n_mels, T) -> (B, ceil(T / 2), d): two GELU convolutions
    (kernel 3, padding 1, the second of stride 2), the positional
    embedding, pre-LN residual blocks, a final LayerNorm."""
    enc = weights["encoder"]
    # conv weights are stored (kernel, in, out); F.conv1d takes (out, in, kernel)
    x = F.gelu(F.conv1d(mel, _f32(enc["conv1_w"]).permute(2, 1, 0),
                        _f32(enc["conv1_b"]), padding=1))
    x = F.gelu(F.conv1d(x, _f32(enc["conv2_w"]).permute(2, 1, 0),
                        _f32(enc["conv2_b"]), stride=2, padding=1))
    x = x.transpose(1, 2) + _f32(enc["pos_emb"][:x.shape[2]])
    blocks = enc["blocks"]
    for i in range(blocks["qkv_w"].shape[0]):
        p = _layer(blocks, i)
        d = x.shape[-1]
        h = _ln(x, p["attn_ln_g"], p["attn_ln_b"])
        qkv = h @ p["qkv_w"].reshape(d, 3 * d) + p["qkv_b"].reshape(3 * d)
        q, k, v = qkv.split(d, dim=-1)
        x = x + _attention(q, k, v, n_head, False) @ p["attn_o_w"] + p["attn_o_b"]
        x = _mlp(x, p)
    return _ln(x, _f32(enc["ln_post_g"]), _f32(enc["ln_post_b"]))


def decoder_logits(weights: Dict, tokens: torch.Tensor, audio: torch.Tensor,
                   n_head: int) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) and the encoder output
    (B, Sa, d) -> float32 logits (B, S, V); position i's logits score the
    token at i + 1. Causal self-attention, cross-attention to the audio,
    pre-LN residual blocks, a final LayerNorm and the tied embedding as
    the output head."""
    dec = weights["decoder"]
    emb = _f32(dec["tok_emb"])
    s = tokens.shape[1]
    x = emb[tokens] + _f32(dec["pos_emb"][:s])
    blocks = dec["blocks"]
    for i in range(blocks["qkv_w"].shape[0]):
        p = _layer(blocks, i)
        d = x.shape[-1]
        h = _ln(x, p["attn_ln_g"], p["attn_ln_b"])
        qkv = h @ p["qkv_w"].reshape(d, 3 * d) + p["qkv_b"].reshape(3 * d)
        q, k, v = qkv.split(d, dim=-1)
        x = x + _attention(q, k, v, n_head, True) @ p["attn_o_w"] + p["attn_o_b"]
        h = _ln(x, p["cross_ln_g"], p["cross_ln_b"])
        q = h @ p["cross_q_w"] + p["cross_q_b"]
        kv = audio @ p["cross_kv_w"].reshape(d, 2 * d) + p["cross_kv_b"].reshape(2 * d)
        k, v = kv.split(d, dim=-1)
        x = x + _attention(q, k, v, n_head, False) @ p["cross_o_w"] + p["cross_o_b"]
        x = _mlp(x, p)
    x = _ln(x, _f32(dec["ln_g"]), _f32(dec["ln_b"]))
    return x @ emb.t()


def _attention_from(q, k, v, n_head: int, pos0: int):
    """Self-attention of new tokens at positions pos0, pos0 + 1, ... over
    the keys of positions 0 .. pos0 + len(q) - 1: each sees itself and
    what came before it."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // n_head
    qh = q.reshape(b, sq, n_head, hd).transpose(1, 2)
    kh = k.reshape(b, sk, n_head, hd).transpose(1, 2)
    vh = v.reshape(b, sk, n_head, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    seen = torch.arange(sk, device=q.device)[None, :]
    now = pos0 + torch.arange(sq, device=q.device)[:, None]
    scores = scores.masked_fill(seen > now, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, sq, d)


def _decoder_from(layers, dec, x, pos0: int, cache, cross, n_head: int,
                  lanes: int):
    """New tokens' embeddings x (B, s, d) at positions pos0.. through the
    decoder, their keys and values appended to `cache` (one (k, v) a
    layer, or None); row r attends to the audio of window r // lanes in
    `cross`. -> (float32 logits (B, s, V), cache)."""
    for i, p in enumerate(layers):
        d = x.shape[-1]
        h = _ln(x, p["attn_ln_g"], p["attn_ln_b"])
        qkv = h @ p["qkv_w"].reshape(d, 3 * d) + p["qkv_b"].reshape(3 * d)
        q, k, v = qkv.split(d, dim=-1)
        if cache[i] is not None:
            k = torch.cat([cache[i][0], k], 1)
            v = torch.cat([cache[i][1], v], 1)
        cache[i] = (k, v)
        x = x + (_attention_from(q, k, v, n_head, pos0) @ p["attn_o_w"]
                 + p["attn_o_b"])
        h = _ln(x, p["cross_ln_g"], p["cross_ln_b"])
        q = h @ p["cross_q_w"] + p["cross_q_b"]
        ck, cv = cross[i]
        b, s, _ = q.shape
        att = _attention(q.reshape(ck.shape[0], lanes * s, d), ck, cv, n_head,
                         False).reshape(b, s, d)
        x = x + att @ p["cross_o_w"] + p["cross_o_b"]
        x = _mlp(x, p)
    x = _ln(x, _f32(dec["ln_g"]), _f32(dec["ln_b"]))
    return x @ _f32(dec["tok_emb"]).t(), cache


def log_probs(logits: torch.Tensor, seq_len, first_special: int,
              masked_until: int) -> torch.Tensor:
    """float64 log-softmax of (..., V) logits over the allowed tokens: the
    ids from first_special on are forbidden while the sequence so far
    (prompt included) is at most `masked_until` long. `seq_len` is an int
    or a tensor broadcast against the leading dimensions."""
    x = logits.double()
    ids = torch.arange(x.shape[-1], device=x.device)
    masked = torch.as_tensor(seq_len, device=x.device) <= masked_until
    forbid = masked[..., None] & (ids >= first_special)
    return torch.log_softmax(x.masked_fill(forbid, float("-inf")), dim=-1)


def beam_search(weights: Dict, audio: torch.Tensor, prompt, n_head: int,
                beam: int, depth: int, first_special: int,
                masked_until: int):
    """Plain beam search over W windows: audio (W, Sa, d), the shared
    prompt ids -> (tokens (W, depth), summed log-probs (W,) float64) of
    each window's best lane after `depth` steps. One lane starts from the
    prompt; each step extends every lane by every token (`log_probs`) and
    keeps the `beam` best sums of the window; the end-of-text token gets
    no special treatment (these weights never rank it near the top)."""
    dec = weights["decoder"]
    blocks = dec["blocks"]
    layers = [_layer(blocks, i) for i in range(blocks["qkv_w"].shape[0])]
    d = audio.shape[-1]
    cross = [(audio @ p["cross_kv_w"].reshape(d, 2 * d)
              + p["cross_kv_b"].reshape(2 * d)).split(d, dim=-1)
             for p in layers]
    emb, pos = _f32(dec["tok_emb"]), dec["pos_emb"]
    w, n_prompt = audio.shape[0], len(prompt)
    ids = torch.tensor([list(prompt)] * w, device=audio.device)
    logits, cache = _decoder_from(layers, dec, emb[ids] + _f32(pos[:n_prompt]),
                                  0, [None] * len(layers), cross, n_head, 1)
    logp = log_probs(logits[:, -1], n_prompt, first_special, masked_until)
    logp = logp.repeat_interleave(beam, 0)
    cache = [(k.repeat_interleave(beam, 0), v.repeat_interleave(beam, 0))
             for k, v in cache]
    score = torch.full((w, beam), float("-inf"), dtype=torch.float64,
                       device=audio.device)
    score[:, 0] = 0.0
    tokens = torch.zeros((w, beam, 0), dtype=torch.long, device=audio.device)
    first = (torch.arange(w, device=audio.device) * beam)[:, None]
    for step in range(depth):
        n_vocab = logp.shape[-1]
        cand = (score[:, :, None] + logp.reshape(w, beam, n_vocab))
        score, flat = cand.reshape(w, beam * n_vocab).topk(beam, dim=-1)
        parent, tok = flat // n_vocab, flat % n_vocab
        tokens = torch.cat([tokens.gather(1, parent[:, :, None].expand(
            -1, -1, tokens.shape[2])), tok[:, :, None]], 2)
        if step == depth - 1:
            break
        rows = (parent + first).reshape(-1)
        cache = [(k[rows], v[rows]) for k, v in cache]
        x = emb[tok.reshape(-1)][:, None] + _f32(pos[n_prompt + step])
        logits, cache = _decoder_from(layers, dec, x, n_prompt + step, cache,
                                      cross, n_head, beam)
        logp = log_probs(logits[:, -1], n_prompt + step + 1, first_special,
                         masked_until)
    best = score.argmax(1)
    lanes = torch.arange(w, device=audio.device)
    return tokens[lanes, best], score[lanes, best]
