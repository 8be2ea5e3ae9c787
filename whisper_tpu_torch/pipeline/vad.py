"""Energy-based voice-activity pre-filter for long-form transcription: the
port's copy of `whisper_tpu/pipeline/vad.py`.

New capability beyond the reference (whisper-burn runs the full
encoder+decoder on every window, src/transcribe.rs:148-383): windows that
contain no audible energy are skipped on the HOST before any device work is
dispatched, so silence costs ~0 chip time instead of a full window decode.
This complements the model-based `no_speech_threshold` gate (which still
pays for the encoder and one decode before rejecting a window): the energy
VAD is a cheap first layer for genuinely silent audio (dead air, leading /
trailing silence, gaps between takes), while the nospeech gate catches
non-silent non-speech (music, noise) that energy cannot.

Deliberately NOT a learned VAD: the environment ships no Silero/webrtcvad
weights, and a threshold on short-time RMS is transparent, dependency-free,
and conservative by construction — with the default -40 dBFS threshold and
100 ms minimum speech duration, any plausible speech energy keeps the
window. False "speech" positives only cost speed (the window decodes and
the nospeech/quality gates still apply); the threshold must be raised
deliberately to risk dropping quiet speech.
"""

from __future__ import annotations

import numpy as np

# 25 ms frames, 10 ms hop at 16 kHz — the standard short-time analysis grid
# (matches the STFT frontend's n_fft=400 / hop=160, ops/audio.py).
FRAME_LENGTH = 400
HOP_LENGTH = 160


def frame_rms(
    waveform: np.ndarray,
    frame_length: int = FRAME_LENGTH,
    hop_length: int = HOP_LENGTH,
) -> np.ndarray:
    """Short-time RMS per frame, computed in f64 on the host.

    Returns a (n_frames,) float64 array; a waveform shorter than one frame
    yields a single frame padded conceptually with nothing (RMS over the
    samples that exist).
    """
    x = np.asarray(waveform, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError(f"frame_rms expects a 1-D waveform, got {x.shape}")
    if len(x) == 0:
        return np.zeros((0,), np.float64)
    if len(x) <= frame_length:
        return np.atleast_1d(np.sqrt(np.mean(np.square(x))))
    n_frames = 1 + (len(x) - frame_length) // hop_length
    # cumulative-sum trick: one pass, no (n_frames, frame_length) copy
    csum = np.concatenate([[0.0], np.cumsum(np.square(x))])
    starts = np.arange(n_frames) * hop_length
    energy = csum[starts + frame_length] - csum[starts]
    return np.sqrt(energy / frame_length)


def speech_duration_seconds(
    waveform: np.ndarray,
    sample_rate: int,
    threshold_db: float = -40.0,
) -> float:
    """Total duration (s) of frames whose RMS exceeds `threshold_db` dBFS.

    dBFS is relative to a full-scale amplitude of 1.0 (the pipeline's
    waveforms are normalized to [-1, 1] by the loaders, cli.py / io/wav.py).
    """
    rms = frame_rms(waveform)
    thresh = 10.0 ** (threshold_db / 20.0)
    n_active = int(np.count_nonzero(rms > thresh))
    return n_active * HOP_LENGTH / float(sample_rate)


def is_silent(
    waveform: np.ndarray,
    sample_rate: int,
    threshold_db: float = -40.0,
    min_speech_seconds: float = 0.1,
) -> bool:
    """True iff the window carries less than `min_speech_seconds` of frames
    above `threshold_db` dBFS — i.e. it is safe to skip entirely.

    The duration floor makes single-sample clicks and brief transients not
    count as speech, while anything sustained for >= min_speech_seconds
    (default 100 ms, about the shortest phone) keeps the window.
    """
    return (
        speech_duration_seconds(waveform, sample_rate, threshold_db)
        < min_speech_seconds
    )
