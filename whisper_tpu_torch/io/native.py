"""ctypes bindings for the C++ audio loader (`native/whisper_io.cpp`,
`native/flac_decoder.cpp`): the port's copy of `whisper_tpu/io/native.py`.

Looks for `native/libwhisper_io.so` at the repository root (build it with
`make -C native`) at the first call, never at import. WAV decoding and
`window` fall back to pure Python (bit-identical output) when the library
is missing; FLAC needs the library. `load_flac_raw` and `verify_flac_md5`
check a decode against the encoder's STREAMINFO MD5.
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
    lib.wio_window.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.wio_window.restype = ctypes.c_int
    if hasattr(lib, "flac_decode"):
        lib.flac_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_FlacInfo)]
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.flac_decode.restype = ctypes.c_int64
        if hasattr(lib, "flac_decode_raw"):
            lib.flac_decode_raw.argtypes = lib.flac_decode.argtypes
            lib.flac_decode_raw.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """Whether the native library is built and loads."""
    return _lib() is not None


def flac_available() -> bool:
    """Whether the library has the FLAC decoder."""
    lib = _lib()
    return lib is not None and hasattr(lib, "flac_decode")


def window(wave: np.ndarray, start: int, count: int) -> np.ndarray:
    """Zero-padded window slice [start, start+count)."""
    wave = np.ascontiguousarray(wave, np.float32)
    out = np.empty(count, np.float32)
    lib = _lib()
    if lib is None:
        end = min(start + count, len(wave))
        n = max(end - start, 0)
        out[:n] = wave[start:start + n]
        out[n:] = 0.0
        return out
    rc = lib.wio_window(
        wave.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wave),
        start, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"wio_window failed: {rc}")
    return out


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
    out, n, info = _flac_decode(path, False)
    denom = float(2 ** (info.bits_per_sample - 1) - 1)
    return (out[:n].astype(np.float32) / denom), int(info.sample_rate)


def _flac_decode(path: str, raw: bool):
    """(int32 buffer, samples decoded, info): the mono downmix, or with
    `raw` every channel's integers interleaved."""
    entry = "flac_decode_raw" if raw else "flac_decode"
    lib = _lib()
    if not flac_available() or not hasattr(lib, entry):
        raise _pywav.WavFormatError(
            "FLAC support requires native/libwhisper_io.so (make -C native)")
    with open(path, "rb") as f:
        data = f.read()
    info = _FlacInfo()
    rc = lib.flac_probe(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise _pywav.WavFormatError(f"{path}: FLAC probe failed ({rc})")
    nch = max(int(info.n_channels), 1) if raw else 1
    cap = (int(info.total_samples) if info.total_samples
           else len(data) * 8) * nch
    while True:
        out = np.empty(cap, np.int32)
        n = getattr(lib, entry)(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
        if n != -5:  # FLAC_BUFFER_SMALL: only when total_samples is unknown
            break
        # highly compressible streams (constant/silence frames) can exceed
        # 8 samples per encoded byte; grow geometrically and retry
        cap *= 4
    if n < 0:
        raise _pywav.WavFormatError(f"{path}: FLAC decode failed ({n})")
    return out, int(n), info


def load_flac_raw(path: str) -> Tuple[np.ndarray, "_FlacInfo"]:
    """Decode a FLAC file -> ((n, channels) int32 raw samples, info).

    No downmix, no normalization: the exact per-channel integers the
    encoder hashed into the STREAMINFO MD5 (RFC 9639 §8.2), which
    `verify_flac_md5` checks."""
    out, n, info = _flac_decode(path, True)
    nch = max(int(info.n_channels), 1)
    return out[:n * nch].reshape(n, nch), info


def verify_flac_md5(path: str) -> Optional[bool]:
    """Check the decoded samples against the encoder's STREAMINFO MD5:
    True/False, or None when the stream carries no MD5 (an all-zero
    field). The hash covers the raw interleaved little-endian samples at
    the stream's bit width (RFC 9639 §8.2)."""
    import hashlib

    samples, info = load_flac_raw(path)
    with open(path, "rb") as f:
        f.seek(4)
        # STREAMINFO is the mandatory first block; MD5 is its last 16 bytes
        hdr = f.read(4)
        size = int.from_bytes(hdr[1:4], "big")
        block = f.read(size)
    embedded = block[size - 16:size]
    if embedded == b"\x00" * 16:
        return None
    nbytes = (int(info.bits_per_sample) + 7) // 8
    flat = samples.reshape(-1)
    if nbytes in (1, 2, 4):
        raw = flat.astype(f"<i{nbytes}").tobytes()
    else:  # 24-bit: low 3 bytes of the little-endian i32
        b4 = flat.astype("<i4").view(np.uint8).reshape(-1, 4)
        raw = np.ascontiguousarray(b4[:, :3]).tobytes()
    return hashlib.md5(raw).hexdigest() == embedded.hex()


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch by extension: .flac via the native decoder, else WAV."""
    if path.lower().endswith(".flac"):
        return load_flac(path)
    return load_wav(path)
