"""Training data pipeline: (audio, text) pairs -> fixed-shape Batches.

The port of `whisper_tpu/training/data.py`:

  * fixed shapes: every batch is (B, n_mels, T_ctx) mel x (B, S_ctx)
    tokens; waveforms are padded or truncated to the full encoder context,
    token rows to the full decoder context;
  * the loss mask scores exactly the teacher-forced text + EOT
    predictions, never the prompt or padding (the `train.Batch` contract);
  * the batch order is numpy's `default_rng(seed).permutation`, so the
    batches equal the JAX package's element for element;
  * SpecAugment draws its bands from an explicit `torch.Generator`
    (`spec_augment`) and masks them in `mask_bands`: the draws differ from
    `jax.random`'s, the masking does not.

Batches are built on the host (CPU tensors); the train step moves them to
the params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SAMPLE_RATE, WhisperConfig
from ..ops.audio import max_waveform_samples, prep_audio
from ..text.tokenizer import WhisperTokenizer
from .train import Batch


def encode_example(text: str, tok: WhisperTokenizer, n_text_ctx: int,
                   lang: str = "en", task: str = "transcribe"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One transcript -> (tokens, loss_mask), both (n_text_ctx,).

    tokens = [SOT, lang, task, notimestamps] + text + [EOT] + pad(EOT).
    mask[t] = 1 iff the prediction of tokens[t+1] is scored: the positions
    from the last prompt token through the token before EOT (scoring the
    text and the EOT emission), 0 on prompt/pad.

    Raises ValueError when the example does not fit the decoder context.
    """
    prompt = tok.prompt_ids(lang, task)
    body = tok.encode(text)
    seq = list(prompt) + list(body) + [tok.eot]
    if len(seq) > n_text_ctx:
        raise ValueError(
            f"example needs {len(seq)} tokens > n_text_ctx={n_text_ctx}")
    tokens = np.full((n_text_ctx,), tok.eot, np.int32)
    tokens[: len(seq)] = seq
    mask = np.zeros((n_text_ctx,), np.float32)
    # positions predicting body[0] .. EOT: indices len(prompt)-1 .. len(seq)-2
    mask[len(prompt) - 1: len(seq) - 1] = 1.0
    return tokens, mask


def build_batch(waveforms: Sequence[np.ndarray], texts: Sequence[str],
                tok: WhisperTokenizer, cfg: WhisperConfig, lang: str = "en",
                task: str = "transcribe") -> Batch:
    """Pad/truncate 16 kHz float32 waveforms to the full encoder context
    (longer audio is TRUNCATED to one window), take their log-mel with a
    per-sample clamp, encode the texts."""
    if len(waveforms) != len(texts):
        raise ValueError("waveforms and texts must pair up")
    n_samples = max_waveform_samples(cfg.encoder_ctx_size)
    waves = np.zeros((len(waveforms), n_samples), np.float32)
    for i, w in enumerate(waveforms):
        w = np.asarray(w, np.float32)[:n_samples]
        waves[i, : len(w)] = w
    mel = prep_audio(torch.from_numpy(waves), per_sample_max=True,
                     n_mels=cfg.n_mels)

    rows = [encode_example(t, tok, cfg.decoder_ctx_size, lang, task)
            for t in texts]
    tokens = np.stack([r[0] for r in rows])
    mask = np.stack([r[1] for r in rows])
    return Batch(mel=mel, tokens=torch.from_numpy(tokens),
                 loss_mask=torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# SpecAugment (Park et al. 2019): frequency + time masking.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    n_freq_masks: int = 2
    freq_mask_width: int = 27       # mel bins, F in the paper (LibriSpeech)
    n_time_masks: int = 2
    time_mask_width: int = 100      # mel frames (= 1 s at 10 ms hop)


def _draw_bands(generator: torch.Generator, b: int, size: int, width: int,
                count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, w), each (count, B) int64: w uniform in [0, width] and
    start uniform in [0, max(size - w + 1, 1)), JAX's bounds; the start's
    bound varies per element, so a uniform draw is scaled to it."""
    w = torch.randint(0, width + 1, (count, b), generator=generator)
    hi = torch.clamp(size - w + 1, min=1)
    u = torch.rand((count, b), generator=generator, dtype=torch.float64)
    start = torch.minimum((u * hi).long(), hi - 1)
    return start, w


def _band_mask(start: torch.Tensor, w: torch.Tensor, size: int,
               device) -> torch.Tensor:
    """(B, size) bool: the union of the [start, start + w) bands."""
    pos = torch.arange(size, device=device)
    start, end = start.to(device), (start + w).to(device)
    m = (pos >= start[:, :, None]) & (pos < end[:, :, None])
    return m.any(dim=0)


def mask_bands(mel: torch.Tensor, freq_start: torch.Tensor,
               freq_width: torch.Tensor, time_start: torch.Tensor,
               time_width: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, T) with the drawn bands -- (count, B) starts and
    widths, frequency bands over the mel bins, time bands over the frames
    -- set to the per-sample mel mean (the mean, not zero: the log-mel
    floor is data-dependent after the max-8 clamp). The masking of the JAX
    `spec_augment`."""
    _, n_mels, t = mel.shape
    fill = mel.mean(dim=(1, 2), keepdim=True)
    fmask = _band_mask(freq_start, freq_width, n_mels, mel.device)
    tmask = _band_mask(time_start, time_width, t, mel.device)
    masked = fmask[:, :, None] | tmask[:, None, :]
    return torch.where(masked, fill, mel)


def spec_augment(mel: torch.Tensor, generator: torch.Generator,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """Mask random frequency bands and time spans of mel (B, n_mels, T)
    with the per-sample mean; the bands come from `generator` (a CPU
    generator: the same seed gives the same bands on any device)."""
    b, n_mels, t = mel.shape
    fs, fw = _draw_bands(generator, b, n_mels, cfg.freq_mask_width,
                         cfg.n_freq_masks)
    ts, tw = _draw_bands(generator, b, t, cfg.time_mask_width,
                         cfg.n_time_masks)
    return mask_bands(mel, fs, fw, ts, tw)


# ---------------------------------------------------------------------------
# Dataset iteration
# ---------------------------------------------------------------------------

def load_examples(items: Iterable[Tuple[str, str]],
                  limit: Optional[int] = None,
                  resample_to: int = SAMPLE_RATE
                  ) -> List[Tuple[np.ndarray, str]]:
    """(audio_path, transcript) pairs -> [(waveform16k, transcript)]:
    WAV/FLAC through the native loader (Python fallback), resampled when
    needed."""
    from ..io import native as wav_native, wav as pywav

    out: List[Tuple[np.ndarray, str]] = []
    for i, (path, text) in enumerate(items):
        if limit is not None and i >= limit:
            break
        wave, rate = wav_native.load_audio(path)
        if rate != resample_to:
            wave = pywav.resample(wave, rate, resample_to)
        out.append((wave, text))
    return out


def iter_batches(examples: Sequence[Tuple[np.ndarray, str]],
                 tok: WhisperTokenizer, cfg: WhisperConfig, batch_size: int,
                 lang: str = "en", task: str = "transcribe", seed: int = 0,
                 epochs: Optional[int] = None) -> Iterator[Batch]:
    """Shuffled fixed-size batches, reshuffling each epoch; drops examples
    that exceed the decoder context (with one warning) and the final ragged
    batch.
    """
    from ..utils.logging import get_logger

    log = get_logger("training.data")
    keep: List[Tuple[np.ndarray, str]] = []
    dropped = 0
    for wave, text in examples:
        try:
            encode_example(text, tok, cfg.decoder_ctx_size, lang, task)
        except ValueError:
            dropped += 1
            continue
        keep.append((wave, text))
    if dropped:
        log.warning("dropped %d/%d examples exceeding n_text_ctx=%d",
                    dropped, len(examples), cfg.decoder_ctx_size)
    if len(keep) < batch_size:
        raise ValueError(
            f"{len(keep)} usable examples < batch_size={batch_size}")

    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(keep))
        for i in range(0, len(keep) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield build_batch(
                [keep[j][0] for j in idx], [keep[j][1] for j in idx],
                tok, cfg, lang, task)
        epoch += 1
