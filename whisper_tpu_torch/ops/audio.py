"""Log-mel spectrogram frontend in PyTorch.

Counterpart of `whisper_tpu/ops/audio.py` (reference: whisper-burn
`src/audio.rs`): periodic Hann window, reflection-padded GEMM-DFT STFT,
Slaney mel filterbank, and the `prep_audio` log/clamp pipeline with its
drop-last-frame quirk and the dynamic-range clamp at (max - 8.0), computed
on the device with no host sync.

The DFT is one f32 matmul of all frames against a (n_fft, 2 * n_freq)
windowed cos/sin basis, as in the JAX package, which asks XLA for
`Precision.HIGHEST`. The counterpart here is full f32: on CUDA the matmul
must not run in TF32 (`torch.backends.cuda.matmul.allow_tf32`, False by
default). The filterbank and basis are built in float64 with numpy -- the
bodies are copies of the JAX module's, which cannot be imported here
because that module imports jax.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HOP_LENGTH, N_FFT, N_MELS

__all__ = ["max_waveform_samples", "num_frames", "hann_window",
           "mel_filters", "stft", "prep_audio"]


def max_waveform_samples(n_frame_max: int) -> int:
    """Max number of waveform samples yielding <= n_frame_max mel frames
    (src/audio.rs:12-17)."""
    return HOP_LENGTH * (n_frame_max + 1) + (N_FFT % 2) - 1


def num_frames(n_samples: int) -> int:
    """Mel frames `prep_audio` produces for n_samples (last frame dropped)."""
    return (n_samples + 2 * (N_FFT // 2) - N_FFT) // HOP_LENGTH


def hann_window(window_length: int = N_FFT, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window as sin^2(pi*n/N) (src/audio.rs:272-278)."""
    n = np.arange(window_length, dtype=np.float64)
    w = np.sin(n * math.pi / window_length) ** 2
    return torch.tensor(w, dtype=dtype, device=device)


def _hz_to_mel(freq: float) -> float:
    """Scalar Hz->mel, Slaney (src/audio.rs:198-230)."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    if freq >= min_log_hz:
        return min_log_mel + math.log(freq / min_log_hz) / logstep
    return freq / f_sp


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Vector mel->Hz, Slaney (src/audio.rs:232-266)."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    linear = f_sp * mels
    log_part = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return np.where(mels >= min_log_mel, log_part, linear)


@functools.lru_cache(maxsize=8)
def _mel_filters_np(sample_rate: float, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular filterbank (n_mels, n_fft//2+1), f32."""
    n_freq = n_fft // 2 + 1
    fftfreqs = np.arange(n_freq, dtype=np.float64) * (sample_rate / n_fft)
    n_pts = n_mels + 2
    min_mel, max_mel = _hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0)
    mels = (np.arange(n_pts, dtype=np.float64)
            * ((max_mel - min_mel) / (n_pts - 1)) + min_mel)
    mel_f = _mel_to_hz(mels)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:n_mels] / fdiff[:n_mels, None]
    upper = ramps[2: n_mels + 2] / fdiff[1: n_mels + 1, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_filters(sample_rate: float = 16_000.0, n_fft: int = N_FFT,
                n_mels: int = N_MELS, device=None) -> torch.Tensor:
    return torch.from_numpy(
        _mel_filters_np(float(sample_rate), n_fft, n_mels)).to(device)


@functools.lru_cache(maxsize=4)
def _dft_basis_np(n_fft: int) -> np.ndarray:
    """Windowed DFT basis (n_fft, 2*n_freq): [cos | -sin] columns scaled by
    the periodic Hann window (src/audio.rs:348-366)."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)
    angle = (2.0 * math.pi / n_fft) * np.outer(n, k)
    window = np.sin(n * math.pi / n_fft) ** 2
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (window[:, None] * basis).astype(np.float32)


def stft(x: torch.Tensor, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH):
    """STFT of a (B, T) waveform -> (real, imag), each (B, n_freq, frames):
    reflection padding of n_fft//2 (src/audio.rs:296-306), then one GEMM."""
    if x.shape[-1] < n_fft:
        raise ValueError(f"waveform length {x.shape[-1]} must be >= n_fft={n_fft}")
    n_freq = n_fft // 2 + 1
    pad = n_fft // 2
    xp = F.pad(x.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop_length)  # (B, F, n_fft)
    basis = torch.from_numpy(_dft_basis_np(n_fft)).to(x.device)
    spec = torch.matmul(frames, basis)  # (B, F, 2*n_freq)
    return (spec[..., :n_freq].transpose(1, 2),
            spec[..., n_freq:].transpose(1, 2))


def prep_audio(waveform: torch.Tensor, sample_rate: float = 16_000.0,
               per_sample_max: bool = False, n_mels: int = N_MELS
               ) -> torch.Tensor:
    """Waveform (B, n_samples) -> log-mel (B, n_mels, frames)
    (src/audio.rs:34-56): power spectrum minus the last frame, mel
    matmul, log10 clamped at 1e-10, clamp at (max - 8) over the whole
    tensor (or per sample with `per_sample_max`), then (x + 4) / 4."""
    real, imag = stft(waveform)
    power = (real * real + imag * imag)[:, :, :-1]
    mel = mel_filters(sample_rate, n_mels=n_mels, device=waveform.device)
    mel_spec = torch.matmul(mel, power)  # (B, n_mels, F)
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    if per_sample_max:
        mx = log_spec.amax(dim=(1, 2), keepdim=True)
    else:
        mx = log_spec.max()
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return (log_spec + 4.0) / 4.0
