"""WAV loading with the reference's normalization semantics: the port's
copy of `whisper_tpu/io/wav.py`.

Parity target: `load_audio_waveform` (whisper-burn
`src/bin/transcribe/main.rs:31-55`): single-channel requirement, integer
samples normalized by 2^(bits-1) - 1 (note: NOT 2^(bits-1)), float samples
passed through. The reference asserts 16 kHz; we return the true rate and let
the caller decide (the CLI asserts like the reference unless --resample).

Implemented as a minimal RIFF parser (numpy only) supporting PCM int16/24/32
and IEEE float32 -- the same format coverage as the reference's `hound` use.
A C++ fast path lives in native/; this pure-Python version is the fallback
and the semantics oracle.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


class WavFormatError(ValueError):
    pass


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a WAV file -> (float32 samples in [-1, 1], sample_rate).

    Multi-channel files are rejected like the reference (main.rs:42).
    """
    with open(path, "rb") as f:
        data = f.read()
    return decode_wav(data, path)


def decode_wav(data: bytes, path: str = "<memory>") -> Tuple[np.ndarray, int]:
    """Parse WAV bytes in memory -> (float32 samples, sample_rate)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavFormatError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    samples = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_format, n_channels, sample_rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", body, 0
            )
            if audio_format == 0xFFFE and chunk_size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format, n_channels, sample_rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or samples is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, bits = fmt

    if n_channels != 1:
        raise WavFormatError("The audio must be single-channel.")

    if audio_format == 3:  # IEEE float
        if bits != 32:
            raise WavFormatError(f"unsupported float bit depth: {bits}")
        wave = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    elif audio_format == 1:  # PCM
        if bits == 16:
            ints = np.frombuffer(samples, dtype="<i2").astype(np.float32)
        elif bits == 32:
            ints = np.frombuffer(samples, dtype="<i4").astype(np.float32)
        elif bits == 24:
            raw = np.frombuffer(samples, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = ((ints << 8) >> 8).astype(np.float32)  # sign-extend
        elif bits == 8:
            ints = np.frombuffer(samples, dtype=np.uint8).astype(np.float32) - 128.0
        else:
            raise WavFormatError(f"unsupported PCM bit depth: {bits}")
        # Reference normalization: / (2^(bits-1) - 1) (main.rs:44,50).
        # Divide IN f32 like the reference's `s as f32 / max` (for 32-bit the
        # divisor rounds to 2^31 in f32) -- bit-identical to the native
        # loader and the Rust semantics, no f64 double rounding.
        wave = ints / np.float32(2 ** (bits - 1) - 1)
    else:
        raise WavFormatError(f"unsupported WAV format code: {audio_format}")

    return wave, sample_rate


def resample(wave: np.ndarray, src_rate: int, dst_rate: int = 16_000) -> np.ndarray:
    """Polyphase resampling (convenience beyond the reference, which requires
    pre-resampled 16 kHz input per README.md:69-74)."""
    if src_rate == dst_rate:
        return wave
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(wave, dst_rate // g, src_rate // g).astype(np.float32)
