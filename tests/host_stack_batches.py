"""The batch build of `BatchTranscriber.transcribe_many` as it was before
batches were cut on the device: every full window copied out of its
stream, the batch `np.stack`ed on the host and a short one padded by
repeating its first window, the numpy batch handed to `_decode_batch`.
Kept here as the reference that tests/test_torch_batch_rows.py and
tests/test_torch_cuda.py hold the device-built batches to. Torch and numpy
only (no JAX), so the card's tests may import it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from whisper_tpu_torch.ops.audio import max_waveform_samples
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import vad
from whisper_tpu_torch.pipeline.transcribe import window_waveform


def host_batch(windows: Sequence[np.ndarray], batch_size: int) -> np.ndarray:
    """np.stack of the windows, padded to `batch_size` with the first."""
    waves = np.stack(windows)
    if len(windows) < batch_size:
        waves = np.concatenate(
            [waves, np.repeat(waves[:1], batch_size - len(windows), axis=0)])
    return waves


def host_stack_transcribe_many(bt, waveforms: Sequence[np.ndarray], opt,
                               sample_rate: int = 16000
                               ) -> List[Tuple[str, List[int]]]:
    """`bt.transcribe_many(waveforms, sample_rate, opt)` over host-stacked
    batches, for options without the ladder or timestamps."""
    _, use_ladder = bt._ladder_temps(opt)
    assert not use_ladder and not opt.timestamps
    n_window = max_waveform_samples(bt.cfg.encoder_ctx_size - opt.padding)
    overlap = int(sample_rate * opt.chunk_overlap_seconds)
    if overlap >= n_window:
        overlap = n_window // 2
    prompt, n_cond = bt._build_prompt(opt)
    sup_len = opt.suppress_until_len + n_cond
    full, tail, n_windows = [], [], []
    for s, wave in enumerate(waveforms):
        wave = np.asarray(wave, np.float32)
        bounds = list(window_waveform(wave, sample_rate, n_window, overlap))
        n_windows.append(len(bounds))
        for i, (start, end) in enumerate(bounds):
            chunk = np.ascontiguousarray(wave[start:end])
            if opt.vad and vad.is_silent(chunk, sample_rate,
                                         opt.vad_threshold_db,
                                         opt.vad_min_speech_seconds):
                continue
            if len(chunk) == n_window:
                full.append((s, i, chunk))
            elif len(chunk) >= 400:
                tail.append((s, i, chunk))
    results = {}
    bsz = bt.batch_size
    with torch.inference_mode():
        for i in range(0, len(full), bsz):
            group = full[i:i + bsz]
            waves = host_batch([g[2] for g in group], bsz)
            toks, lengths, _, _ = bt._decode_batch(waves, prompt, sup_len,
                                                   opt, sot_pos=n_cond)
            for j, (s, w, _) in enumerate(group):
                results[(s, w)] = [int(t) for t in toks[j, :lengths[j]]
                                   ][n_cond:]
        for s, w, chunk in tail:
            results[(s, w)] = bt._decode(chunk, prompt, sup_len,
                                         opt)[0][n_cond:]
    out = []
    for s in range(len(waveforms)):
        tokens = TB._splice([results.get((s, w)) for w in range(n_windows[s])],
                            opt)
        out.append((bt.tok.decode(tokens, skip_special=True), tokens))
    return out
