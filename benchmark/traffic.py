"""The traffic generator: reads a traffic file and a configuration file,
and gives the recordings of a run, their windows, and their audio.

A mix is data (`benchmark/traffic/<name>.json`): the entry point, the
decode options, the batch size, the recording lengths in minutes and how
many recordings a call takes. The lengths follow the file's rotation, the
same for every seed, so the work of a run does not depend on its seed;
only the audio does. A run is made of whole rotations, each the same
work, so that its rate does not depend on how many rotations fit.

Windows follow the configuration's `assumed` window: a full window is
`window_samples` long, consecutive windows start `window - overlap`
samples apart, the last one (the "tail") is shorter, and a remnant under
one STFT frame (400 samples) is not decoded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.whisper import N_FFT, SAMPLE_RATE, window_samples
from .weights import derived_seed


@dataclasses.dataclass(frozen=True)
class Geometry:
    window: int  # samples of a full window
    shift: int  # samples between window starts
    padding: int  # zero mel frames appended to a window


def geometry(cfg: Dict, traffic: Dict) -> Geometry:
    opt = traffic["options"]
    window = window_samples(cfg["max_source_positions"], opt["padding"])
    overlap = int(SAMPLE_RATE * opt["chunk_overlap_seconds"])
    if overlap >= window:
        overlap = window // 2
    return Geometry(window, max(window - overlap, 1), opt["padding"])


def windows(n_samples: int, geo: Geometry) -> List[Tuple[int, int]]:
    """(start, end) of each decoded window of a recording, in order: the
    full windows, then at most one tail of at least N_FFT samples."""
    n = max(n_samples - 1, 0) // geo.shift + 1
    out = []
    for i in range(n):
        start = i * geo.shift
        end = min(start + geo.window, n_samples)
        if end - start == geo.window or end - start >= N_FFT:
            out.append((start, end))
    return out


@dataclasses.dataclass(frozen=True)
class Call:
    index: int  # position in the run: 0, 1, ...
    lengths: Tuple[int, ...]  # samples of each recording of the call


def rotation(traffic: Dict) -> List[Tuple[int, ...]]:
    """The recordings of each call of one rotation, in samples."""
    minutes = traffic["recording_minutes"]
    per_call = traffic["recordings_per_call"]
    lengths = [int(m * 60 * SAMPLE_RATE) for m in minutes]
    return [tuple(lengths[i:i + per_call])
            for i in range(0, len(lengths), per_call)]


def window_counts(lengths, geo: Geometry, batch: int) -> Dict[str, int]:
    """Real (full and tail) windows of a call, and the padding rows its
    last batch adds (full windows are batched `batch` at a time, tails
    decode one at a time)."""
    full = tails = 0
    for n in lengths:
        for start, end in windows(n, geo):
            if end - start == geo.window:
                full += 1
            else:
                tails += 1
    return {"full": full, "tails": tails,
            "padding": -full % batch if full else 0}


def audio(n_samples: int, seed: int, call: int, recording: int,
          device) -> torch.Tensor:
    """Speech-shaped synthetic audio, made on `device` in float32: phrases
    of 1-6 s, each with its own pitch (a tone and a frequency-modulated
    overtone, as chip_smoke.py's `synthetic_speech`), syllable bursts and
    loudness, one in five a pause, over a floor of noise. The phrases make
    every window's content its own, so that its transcript depends on it.
    The same (seed, call, recording) gives the same samples."""
    rng = np.random.default_rng(derived_seed(seed, 1000 + 97 * call + recording))
    lengths = []
    total = 0
    while total < n_samples:
        lengths.append(int(rng.uniform(1.0, 6.0) * SAMPLE_RATE))
        total += lengths[-1]
    k = len(lengths)
    loud = rng.uniform(0.05, 1.0, k) * (rng.random(k) >= 0.2)
    params = torch.tensor(np.stack([rng.uniform(100.0, 300.0, k),  # pitch
                                    rng.uniform(500.0, 2500.0, k),  # overtone
                                    rng.uniform(1.0, 5.0, k),  # modulation
                                    rng.uniform(2.0, 6.0, k),  # syllables
                                    loud]), dtype=torch.float64, device=device)
    ends = torch.tensor(np.cumsum(lengths), dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, 2000 + 97 * call + recording))
    out = torch.empty(n_samples, dtype=torch.float32, device=device)
    chunk = 1 << 24
    for lo in range(0, n_samples, chunk):
        hi = min(lo + chunk, n_samples)
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        f0, f1, fm, syl, amp = params[:, torch.searchsorted(ends, i, right=True)]
        t = i.to(torch.float64) / SAMPLE_RATE
        x = (0.6 * torch.sin(2 * math.pi * f0 * t)
             + 0.4 * torch.sin(2 * math.pi * f1 * t
                               * (1 + 0.3 * torch.sin(2 * math.pi * fm * t))))
        burst = 0.5 + 0.5 * torch.sign(torch.sin(2 * math.pi * syl * t))
        out[lo:hi] = (amp * burst * x).to(torch.float32) + 0.02 * torch.randn(
            hi - lo, generator=gen, dtype=torch.float32, device=device)
    return out


def host_audio(n_samples: int, seed: int, call: int, recording: int,
               device) -> np.ndarray:
    """`audio` copied to a host numpy array, as the program takes it."""
    return audio(n_samples, seed, call, recording, device).cpu().numpy()
