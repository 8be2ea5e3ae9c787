"""Spoken-language identification.

Counterpart of `whisper_tpu/pipeline/detect.py` (:26-62; the reference,
whisper-burn, requires the language as a CLI argument,
src/bin/transcribe/main.rs:97-105). Standard Whisper language ID: ONE
S = 1 `decoder_step` on the prompt `[SOT]` over an 8-row cache, then a
softmax over the language tokens at the next position. On the card with
the flash config that step is the fused one (K3 for self and cross
attention).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..text.tokenizer import WhisperTokenizer


def _lang_logits(params, enc_out: torch.Tensor, sot: int,
                 cfg: WhisperConfig) -> torch.Tensor:
    """(B, V) f32 logits of the token after SOT."""
    cache = M.init_cache(params, enc_out, cfg, cache_len=8)
    tokens = torch.full((enc_out.shape[0], 1), sot, dtype=torch.long,
                        device=enc_out.device)
    logits, _ = M.decoder_step(params, tokens, 0, cache, cfg)
    return logits[:, 0]


def detect_language(
    params,
    enc_out: torch.Tensor,  # (B, Sa, d)
    cfg: WhisperConfig,
    tokenizer: WhisperTokenizer,
) -> List[Tuple[str, Dict[str, float]]]:
    """Returns per stream: (best language code, {code: probability}), the
    probabilities a softmax over the language tokens only (in f32 on the
    host, as JAX computes it), like OpenAI's detect_language."""
    languages = tokenizer.available_languages()
    lang_ids = [tokenizer.language_token(c) for c in languages]
    with torch.inference_mode():
        logits = _lang_logits(params, enc_out, tokenizer.sot, cfg)
        lang_logits = logits[:, lang_ids].float().cpu().numpy()
    lang_logits -= lang_logits.max(axis=-1, keepdims=True)
    probs = np.exp(lang_logits)
    probs /= probs.sum(axis=-1, keepdims=True)

    out = []
    for row in probs:
        dist = {code: float(p) for code, p in zip(languages, row)}
        out.append((languages[int(row.argmax())], dist))
    return out
