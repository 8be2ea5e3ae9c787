"""Model configuration of the PyTorch/CUDA port.

The port's own copy of `whisper_tpu/config.py` (reference: whisper-burn
`src/model/mod.rs:16-20,73-80,164-171`, and the `.cfg` JSON schema its
convert CLI writes, `src/bin/convert/main.rs:51`): the same frozen
dataclasses, presets and `.cfg` reader/writer, so a checkpoint and its
`.cfg` load identically in both packages. `KernelKnobs` keeps the one
knob the port has kernels for, `int8_impl`; the JAX package's other knobs
are TPU A/B switches, and the port reads no WHISPER_TPU_* environment
variable: a knob is set in the config, nowhere else.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

# Audio frontend constants (reference: src/audio.rs:5-8).
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
SAMPLE_RATE = 16_000


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Reference: `AudioEncoderConfig` (src/model/mod.rs:164-171)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4


@dataclasses.dataclass(frozen=True)
class TextDecoderConfig:
    """Reference: `TextDecoderConfig` (src/model/mod.rs:73-80)."""

    n_vocab: int = 51864
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


INT8_IMPLS = ("xla", "pallas", "w8a8", "auto")
FLASH_IMPLS = ("bsd", "legacy")


@dataclasses.dataclass(frozen=True)
class KernelKnobs:
    """Kernel selection (the JAX package's `config.KernelKnobs`, :46-60).

    `int8_impl` picks the product of an int8 weight: "xla" (the default)
    dequantizes the weight inside the matmul, "pallas" runs the W8A8
    kernels (per-row int8 activations: K6 for M <= 1024 rows, K7 above),
    "w8a8" quantizes the activations per row and takes an s8 x s8 -> s32
    library product (JAX's XLA route), and "auto" is "w8a8" from 4096
    rows and "xla" below (`models/whisper.py::_matmul`).

    `flash_impl` picks the encoder's (and the full decoder forward's)
    attention kernel on the flash path: "bsd" (the default) is K1 on the
    (B, S, d) layout, "legacy" is K9 on (B, H, S, hd) views
    (`ops/kernels/flash_attention.py::attention_bhsd`). It is the config
    form of the JAX package's WHISPER_TPU_FLASH_IMPL environment override
    (flash_attention.py:353); the port reads no environment variable.
    """

    int8_impl: str = "xla"
    flash_impl: str = "bsd"

    def __post_init__(self) -> None:
        if self.int8_impl not in INT8_IMPLS:
            raise ValueError(f"int8_impl must be one of {INT8_IMPLS}, got "
                             f"{self.int8_impl!r}")
        if self.flash_impl not in FLASH_IMPLS:
            raise ValueError(f"flash_impl must be one of {FLASH_IMPLS}, got "
                             f"{self.flash_impl!r}")


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Reference: `WhisperConfig` (src/model/mod.rs:16-20).

    `ln_eps` is not in the `.cfg` JSON and defaults to the reference's
    value. `attention` picks the path: "flash" runs the port's hand-written
    kernels (ops/kernels/), "xla" the plain PyTorch version of everything
    (the name is the JAX package's). `alignment_heads` round-trips through
    the `.cfg` JSON as an extra key, absent when None. `knobs` is not
    written to the `.cfg` JSON.
    """

    audio_encoder_config: AudioEncoderConfig = AudioEncoderConfig()
    text_decoder_config: TextDecoderConfig = TextDecoderConfig()
    ln_eps: float = 1e-5
    attention: str = "xla"
    alignment_heads: Optional[Tuple[Tuple[int, int], ...]] = None
    knobs: KernelKnobs = KernelKnobs()

    def __post_init__(self) -> None:
        # Reference asserts encoder/decoder state sizes equal (src/model/mod.rs:27-32).
        if self.audio_encoder_config.n_audio_state != self.text_decoder_config.n_text_state:
            raise ValueError(
                "Audio encoder state size "
                f"{self.audio_encoder_config.n_audio_state} must equal text decoder "
                f"state size {self.text_decoder_config.n_text_state}."
            )

    @property
    def n_state(self) -> int:
        return self.audio_encoder_config.n_audio_state

    @property
    def n_mels(self) -> int:
        """Mel filterbank size the frontend must produce for this model
        (80 everywhere in the reference; 128 for the large-v3 family)."""
        return self.audio_encoder_config.n_mels

    @property
    def encoder_ctx_size(self) -> int:
        """Reference: `Whisper::encoder_ctx_size` (src/model/mod.rs:64-66)."""
        return self.audio_encoder_config.n_audio_ctx

    @property
    def decoder_ctx_size(self) -> int:
        """Reference: `Whisper::decoder_ctx_size` (src/model/mod.rs:68-70)."""
        return self.text_decoder_config.n_text_ctx

    # .cfg JSON (reference format) ------------------------------------------
    @classmethod
    def from_cfg_dict(cls, d: Dict[str, Any]) -> "WhisperConfig":
        enc = d["audio_encoder_config"]
        dec = d["text_decoder_config"]
        return cls(
            audio_encoder_config=AudioEncoderConfig(
                n_mels=int(enc["n_mels"]),
                n_audio_ctx=int(enc["n_audio_ctx"]),
                n_audio_state=int(enc["n_audio_state"]),
                n_audio_head=int(enc["n_audio_head"]),
                n_audio_layer=int(enc["n_audio_layer"]),
            ),
            text_decoder_config=TextDecoderConfig(
                n_vocab=int(dec["n_vocab"]),
                n_text_ctx=int(dec["n_text_ctx"]),
                n_text_state=int(dec["n_text_state"]),
                n_text_head=int(dec["n_text_head"]),
                n_text_layer=int(dec["n_text_layer"]),
            ),
            alignment_heads=(
                tuple((int(l), int(h)) for l, h in d["alignment_heads"])
                if d.get("alignment_heads") else None
            ),
        )

    def to_cfg_dict(self) -> Dict[str, Any]:
        out = {
            "audio_encoder_config": dataclasses.asdict(self.audio_encoder_config),
            "text_decoder_config": dataclasses.asdict(self.text_decoder_config),
        }
        if self.alignment_heads is not None:
            out["alignment_heads"] = [list(p) for p in self.alignment_heads]
        return out

    @classmethod
    def load(cls, path: str) -> "WhisperConfig":
        """Load a `<model>.cfg` JSON file as written by the reference convert CLI."""
        with open(path, "r") as f:
            return cls.from_cfg_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_cfg_dict(), f, indent=2)


# Standard OpenAI Whisper model-size presets (the reference carries them
# only implicitly, via dumped checkpoint shapes, src/model/load.rs:206-227).
_PRESETS = {
    # name: (n_mels, n_audio_ctx, n_state, n_head, n_layer, n_text_layer)
    "tiny": (80, 1500, 384, 6, 4, 4),
    "base": (80, 1500, 512, 8, 6, 6),
    "small": (80, 1500, 768, 12, 12, 12),
    "medium": (80, 1500, 1024, 16, 24, 24),
    "large": (80, 1500, 1280, 20, 32, 32),
    "large-v2": (80, 1500, 1280, 20, 32, 32),
    # 128-mel frontend, 51866-token vocab (<|yue|> appended); turbo keeps the
    # v3 encoder but distills the decoder to 4 layers.
    "large-v3": (128, 1500, 1280, 20, 32, 32),
    "large-v3-turbo": (128, 1500, 1280, 20, 32, 4),
}
_N_VOCAB_MULTILINGUAL = 51865
_N_VOCAB_MULTILINGUAL_V3 = 51866  # +<|yue|>
_N_VOCAB_ENGLISH = 51864


def preset(name: str) -> WhisperConfig:
    """Config for a standard Whisper size, e.g. 'tiny.en', 'base', 'large-v3'."""
    english = name.endswith(".en")
    base_name = name[:-3] if english else name
    if base_name not in _PRESETS:
        raise KeyError(f"Unknown model preset: {name}")
    v3 = base_name.startswith("large-v3")
    if english and v3:
        raise KeyError(f"no English-only variant of {base_name}")
    n_mels, n_ctx, n_state, n_head, n_layer, n_text_layer = _PRESETS[base_name]
    n_vocab = (_N_VOCAB_ENGLISH if english
               else _N_VOCAB_MULTILINGUAL_V3 if v3
               else _N_VOCAB_MULTILINGUAL)
    return WhisperConfig(
        audio_encoder_config=AudioEncoderConfig(
            n_mels=n_mels, n_audio_ctx=n_ctx, n_audio_state=n_state,
            n_audio_head=n_head, n_audio_layer=n_layer),
        text_decoder_config=TextDecoderConfig(
            n_vocab=n_vocab, n_text_ctx=448, n_text_state=n_state,
            n_text_head=n_head, n_text_layer=n_text_layer),
    )


def tiny_test_config(
    n_state: int = 8,
    n_head: int = 2,
    n_layer: int = 2,
    n_vocab: int = 64,
    n_audio_ctx: int = 32,
    n_text_ctx: int = 24,
    n_mels: int = 80,
) -> WhisperConfig:
    """A miniature config for unit tests."""
    return WhisperConfig(
        audio_encoder_config=AudioEncoderConfig(
            n_mels=n_mels, n_audio_ctx=n_audio_ctx, n_audio_state=n_state,
            n_audio_head=n_head, n_audio_layer=n_layer),
        text_decoder_config=TextDecoderConfig(
            n_vocab=n_vocab, n_text_ctx=n_text_ctx, n_text_state=n_state,
            n_text_head=n_head, n_text_layer=n_layer),
    )
