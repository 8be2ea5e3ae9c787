"""ctypes bindings for the C++ audio loader (`native/whisper_io.cpp`): the
port's copy of the loading half of `whisper_tpu/io/native.py`.

Looks for `native/libwhisper_io.so` at the repository root (build it with
`make -C native`) at the first call, never at import. WAV decoding falls
back to the pure-Python parser in `io/wav.py` (bit-identical output) when
the library is missing; FLAC needs the library.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from . import wav as _pywav

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libwhisper_io.so")

_ERRORS = {
    -1: "not a RIFF/WAVE file",
    -2: "missing fmt/data chunk",
    -3: "The audio must be single-channel.",
    -4: "unsupported WAV format",
    -5: "output buffer too small",
}


class _WioInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("n_samples", ctypes.c_uint32),
        ("bits", ctypes.c_uint16),
        ("format", ctypes.c_uint16),
    ]


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("n_channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("total_samples", ctypes.c_uint64),
    ]


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    """The loader library with its signatures set, or None if not built."""
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.wio_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_WioInfo)]
    lib.wio_probe.restype = ctypes.c_int
    lib.wio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.wio_decode.restype = ctypes.c_int
    if hasattr(lib, "flac_decode"):
        lib.flac_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_FlacInfo)]
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.flac_decode.restype = ctypes.c_int64
    return lib


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Native WAV decode; the pure-Python parser when the library is absent."""
    lib = _lib()
    if lib is None:
        return _pywav.load_wav(path)
    with open(path, "rb") as f:
        data = f.read()
    info = _WioInfo()
    rc = lib.wio_probe(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise _pywav.WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    out = np.empty(info.n_samples, np.float32)
    rc = lib.wio_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    if rc != 0:
        raise _pywav.WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    return out, int(info.sample_rate)


def load_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 samples in [-1, 1], sample_rate).

    Stereo is averaged to mono; normalization matches the WAV loader
    (/(2^(bits-1) - 1), reference main.rs:44-52 semantics).
    """
    lib = _lib()
    if lib is None or not hasattr(lib, "flac_decode"):
        raise _pywav.WavFormatError(
            "FLAC support requires native/libwhisper_io.so (make -C native)")
    with open(path, "rb") as f:
        data = f.read()
    info = _FlacInfo()
    rc = lib.flac_probe(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise _pywav.WavFormatError(f"{path}: FLAC probe failed ({rc})")
    cap = int(info.total_samples) if info.total_samples else len(data) * 8
    while True:
        out = np.empty(cap, np.int32)
        n = lib.flac_decode(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
        if n != -5:  # FLAC_BUFFER_SMALL: only when total_samples is unknown
            break
        # highly compressible streams (constant/silence frames) can exceed
        # 8 samples per encoded byte; grow geometrically and retry
        cap *= 4
    if n < 0:
        raise _pywav.WavFormatError(f"{path}: FLAC decode failed ({n})")
    denom = float(2 ** (info.bits_per_sample - 1) - 1)
    return (out[:n].astype(np.float32) / denom), int(info.sample_rate)


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch by extension: .flac via the native decoder, else WAV."""
    if path.lower().endswith(".flac"):
        return load_flac(path)
    return load_wav(path)
