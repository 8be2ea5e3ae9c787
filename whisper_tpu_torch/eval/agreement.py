"""Quantization agreement gate: quantized decode vs a reference config.

Counterpart of `whisper_tpu/eval/agreement.py`, with its signature, its
seeded inputs and its report. Before a quantized configuration (int8 or
int4 weights, an int8/int4 cross cache, an int8/int4 self cache) may be a
default, it must decode the SAME tokens as the reference path on fixed
inputs: token-identical decodes imply identical WER, the BASELINE accuracy
bar ("<= 0.1 absolute WER delta").

`decode_agreement` runs the window program (log-mel frontend -> batched
encoder -> greedy / batched beam decode with a KV cache) under both
parameterizations on seeded synthetic audio and reports:

  * token_match_rate: matching positions / compared positions (per window,
    up to the shorter sequence, summed over windows);
  * exact_window_rate: fraction of windows whose decodes are identical;
  * max_logit_delta_rel: max |logits_test - logits_ref| / max|logits_ref| on
    a teacher-forced decoder forward (a decode-independent numeric bound).

Everything runs on the device the params live on (the card, unless the
caller built them on the CPU); `cfg` picks the paths as everywhere in the
port (`cfg.attention`, `cfg.knobs.int8_impl`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WhisperConfig
from ..decode import beam as dbeam
from ..decode import greedy as dgreedy
from ..models import whisper as M
from ..ops.audio import max_waveform_samples, prep_audio
from ..params import ParamTree


def _mel(waves: torch.Tensor, cfg: WhisperConfig, padding: int
         ) -> torch.Tensor:
    """(W, n_samples) -> the encoder's (W, n_mels, frames) input: clipped
    to encoder_ctx - padding frames, then `padding` zero frames."""
    mel = prep_audio(waves, per_sample_max=True, n_mels=cfg.n_mels)
    keep = min(mel.shape[2], cfg.encoder_ctx_size - padding)
    return F.pad(mel[:, :, :keep], (0, padding))


def _decode_windows(params: ParamTree, waves: torch.Tensor,
                    prompt: torch.Tensor, cfg: WhisperConfig, *,
                    strategy: str, eot_id: int,
                    suppress_mask: Optional[torch.Tensor], beam_size: int,
                    max_depth: int, padding: int, kv_quant,
                    self_quant=False):
    """W windows -> (tokens (W, ctx), lengths (W,)) as numpy: one batched
    encoder over the W windows, then one batched decode."""
    with torch.no_grad():
        enc = M.encoder_forward(params, _mel(waves, cfg, padding), cfg)
        if strategy == "beam":
            toks, lengths, _ = dbeam.beam_search_batched(
                params, enc, prompt, cfg, eot_id=eot_id,
                suppress_mask=suppress_mask, beam_size=beam_size,
                max_depth=max_depth, kv_quant=kv_quant,
                self_quant=self_quant)
        else:
            toks, lengths, _ = dgreedy.greedy_decode(
                params, enc, prompt, cfg, eot_id=eot_id,
                suppress_mask=suppress_mask, max_depth=max_depth,
                kv_quant=kv_quant, self_quant=self_quant)
    return toks.cpu().numpy(), lengths.cpu().numpy()


def decode_agreement(
    params_ref: ParamTree,
    params_test: ParamTree,
    cfg: WhisperConfig,
    *,
    eot_id: int,
    prompt: Sequence[int],
    suppress_mask: Optional[np.ndarray] = None,
    strategies: Sequence[str] = ("greedy", "beam"),
    beam_size: int = 5,
    max_depth: int = 32,
    n_windows: int = 8,
    window_seconds: Optional[float] = None,
    padding: int = 10,
    kv_quant_test=False,
    self_quant_test=False,
    seed: int = 0,
) -> Dict[str, Any]:
    """Compare decodes of params_test (with the test's cache quantization)
    against params_ref (unquantized caches).

    Returns {"greedy": {...}, "beam": {...}, "max_logit_delta_rel": float}
    where each strategy dict has token_match_rate, exact_window_rate, and
    n_windows. Inputs are seeded standard-normal audio at the production
    window length (or `window_seconds`), drawn from
    `np.random.default_rng(seed)` in the JAX package's order, so both
    packages decode the same audio.
    """
    device = params_ref["encoder"]["conv1_w"].device
    rng = np.random.default_rng(seed)
    if window_seconds is None:
        n_samples = max_waveform_samples(cfg.encoder_ctx_size - padding)
    else:
        n_samples = int(window_seconds * 16000)
    waves = torch.from_numpy(
        rng.standard_normal((n_windows, n_samples)).astype(np.float32) * 0.1
    ).to(device)
    prompt_t = torch.as_tensor(np.asarray(prompt, np.int64), device=device)
    sup = (None if suppress_mask is None else torch.as_tensor(
        np.asarray(suppress_mask, np.float32), device=device))

    out: Dict[str, Any] = {}
    for strategy in strategies:
        kw = dict(strategy=strategy, eot_id=eot_id, suppress_mask=sup,
                  beam_size=beam_size, max_depth=max_depth, padding=padding)
        rt, rl = _decode_windows(params_ref, waves, prompt_t, cfg,
                                 kv_quant=False, **kw)
        tt, tl = _decode_windows(params_test, waves, prompt_t, cfg,
                                 kv_quant=kv_quant_test,
                                 self_quant=self_quant_test, **kw)
        matched = compared = exact = 0
        for i in range(n_windows):
            a = rt[i, : rl[i]]
            b = tt[i, : tl[i]]
            n = min(len(a), len(b))
            matched += int((a[:n] == b[:n]).sum())
            compared += max(len(a), len(b))
            exact += int(len(a) == len(b) and bool((a == b).all()))
        out[strategy] = {
            "token_match_rate": matched / max(compared, 1),
            "exact_window_rate": exact / n_windows,
            "n_windows": n_windows,
        }

    # decode-independent numeric bound: teacher-forced logits delta
    toks = torch.as_tensor(
        rng.integers(0, cfg.text_decoder_config.n_vocab, (2, 8)),
        device=device)
    mel = _mel(waves[:2], cfg, padding)

    def logits(p):
        with torch.no_grad():
            enc = M.encoder_forward(p, mel, cfg)
            return M.decoder_forward(p, toks, enc, cfg).float().cpu().numpy()

    ref, test = logits(params_ref), logits(params_test)
    out["max_logit_delta_rel"] = float(
        np.abs(test - ref).max() / max(np.abs(ref).max(), 1e-9))
    return out


def gate(report: Dict[str, Any], *, min_token_match: float = 0.99,
         max_logit_delta_rel: float = 0.1) -> None:
    """Raise AssertionError unless the agreement report clears the bar."""
    for strategy in ("greedy", "beam"):
        if strategy in report:
            rate = report[strategy]["token_match_rate"]
            assert rate >= min_token_match, (
                f"{strategy} token match {rate:.4f} < {min_token_match}"
            )
    delta = report["max_logit_delta_rel"]
    assert delta <= max_logit_delta_rel, (
        f"logit delta {delta:.4f} > {max_logit_delta_rel}"
    )
