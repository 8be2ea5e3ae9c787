"""Whisper tokenizer: GPT-2 BPE via HF `tokenizers` + Whisper special tokens.
The port's copy of `whisper_tpu/text/tokenizer.py`, unchanged in behaviour.

Capability parity with the reference's `Gpt2Tokenizer` wrapper
(whisper-burn `src/token.rs`): loads the same `tokenizer.json`
(src/token.rs:15), exposes encode/decode/special_token/is_special/vocab_size
(src/token.rs:21-47), the 98-language table (src/token.rs:50-58), and the
special-token string forms (src/token.rs:280-295).

`is_special` follows the reference definition exactly: a token is special iff
it decodes to the empty string with skip_special_tokens=True
(src/token.rs:37-43). This definition drives the beam-search logit maskout
(src/transcribe.rs:244-251), so `suppress_mask()` precomputes it for the whole
vocab in one batched Rust-side sweep instead of the reference's 51k-iteration
host loop per window.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

try:
    from tokenizers import Tokenizer as _HFTokenizer
except ImportError:  # pragma: no cover - tokenizers is a hard runtime dep
    _HFTokenizer = None

# Reference: LANGUAGES (src/token.rs:50-58).
LANGUAGES: tuple = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "ln", "ha", "ba",
    "jw", "su",
)


class SpecialToken:
    """String forms of Whisper's special tokens (src/token.rs:280-295)."""

    END_OF_TEXT = "<|endoftext|>"
    START_OF_TRANSCRIPT = "<|startoftranscript|>"
    TRANSLATE = "<|translate|>"
    TRANSCRIBE = "<|transcribe|>"
    START_OF_LM = "<|startoflm|>"
    START_OF_PREV = "<|startofprev|>"
    NO_SPEECH = "<|nospeech|>"
    NO_TIMESTAMPS = "<|notimestamps|>"

    @staticmethod
    def language(code: str) -> str:
        return f"<|{code}|>"

    @staticmethod
    def timestamp(seconds: float) -> str:
        return f"<|{seconds:.2f}|>"


class WhisperTokenizer:
    """Wrapper matching `Gpt2Tokenizer` (src/token.rs:8-48)."""

    def __init__(self, path: str = "tokenizer.json"):
        if _HFTokenizer is None:
            raise ImportError("the `tokenizers` package is required")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"tokenizer file not found: {path} (place the model's "
                "tokenizer.json next to the weights, like the reference)"
            )
        self._tok = _HFTokenizer.from_file(path)
        self._path = path

    # -- core API (src/token.rs:21-47) ------------------------------------
    def encode(self, text: str) -> List[int]:
        return list(self._tok.encode(text).ids)

    def decode(self, tokens: Sequence[int], skip_special: bool = True) -> str:
        return self._tok.decode(list(map(int, tokens)), skip_special_tokens=skip_special)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def special_token(self, token: str) -> Optional[int]:
        """Id of a special-token string, e.g. SpecialToken.TRANSCRIBE."""
        return self.token_to_id(token)

    def is_special(self, token: int) -> bool:
        """Reference definition: decodes to '' with skip_special=True
        (src/token.rs:37-43)."""
        try:
            return self.decode([token], skip_special=True) == ""
        except Exception:
            return False

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size(with_added_tokens=True)

    # -- convenience ids ---------------------------------------------------
    def _required(self, tok_str: str) -> int:
        tid = self.token_to_id(tok_str)
        if tid is None:
            raise KeyError(f"tokenizer has no token {tok_str!r}")
        return tid

    @property
    def sot(self) -> int:
        return self._required(SpecialToken.START_OF_TRANSCRIPT)

    @property
    def eot(self) -> int:
        return self._required(SpecialToken.END_OF_TEXT)

    @property
    def transcribe(self) -> int:
        return self._required(SpecialToken.TRANSCRIBE)

    @property
    def translate(self) -> int:
        return self._required(SpecialToken.TRANSLATE)

    @property
    def no_timestamps(self) -> int:
        return self._required(SpecialToken.NO_TIMESTAMPS)

    @property
    def start_of_prev(self) -> int:
        return self._required(SpecialToken.START_OF_PREV)

    def language_token(self, code: str) -> int:
        """Id of <|code|>.

        Validates against the 100-language union table (LANGUAGES_V3): the
        reference's table omits "haw" (src/token.rs:50-58) even though the
        trained multilingual vocabulary has it at id 50352, and predates
        large-v3's "yue"; codes beyond the reference's 98 resolve iff the
        loaded tokenizer actually carries the token (a KeyError from
        _required otherwise).
        """
        if code not in LANGUAGES_V3:
            raise KeyError(f"Invalid language abbreviation: {code}")
        return self._required(SpecialToken.language(code))

    def available_languages(self) -> tuple:
        """Language codes (reference order + haw + yue) present in this
        tokenizer."""
        return tuple(
            c for c in LANGUAGES_V3
            if self.token_to_id(SpecialToken.language(c)) is not None
        )

    # -- suppress mask ------------------------------------------------------
    def suppress_mask(self) -> np.ndarray:
        """(vocab,) f32 mask: -inf at special tokens, 0 elsewhere.

        Matches `special_tokens_maskout` (src/transcribe.rs:243-251) but
        computed in one batched decode sweep. Cached per instance (an
        lru_cache on the method would key on `self` at class level and pin
        the tokenizer alive -- the leak class fixed for Transcriber).
        """
        cached = getattr(self, "_suppress_mask_cache", None)
        if cached is not None:
            return cached
        v = self.vocab_size
        decoded = self._tok.decode_batch(
            [[i] for i in range(v)], skip_special_tokens=True
        )
        mask = np.zeros((v,), np.float32)
        for i, s in enumerate(decoded):
            if s == "":
                mask[i] = -np.inf
        self._suppress_mask_cache = mask
        return mask

    def prompt_ids(self, lang: str, task: str = "transcribe",
                   timestamps: bool = False) -> List[int]:
        """Initial decode prompt [SOT, lang, task, notimestamps?]
        (src/transcribe.rs:201-203)."""
        ids = [self.sot, self.language_token(lang)]
        ids.append(self.transcribe if task == "transcribe" else self.translate)
        if not timestamps:
            ids.append(self.no_timestamps)
        return ids

    # -- timestamp tokens ---------------------------------------------------
    # The vocabulary carries 1501 timestamp tokens <|0.00|>..<|30.00|> at
    # 0.02 s steps directly after <|notimestamps|> (src/token.rs:317-321).
    @property
    def timestamp_begin(self) -> int:
        """Id of <|0.00|>; every id >= this is a timestamp token."""
        tid = self.token_to_id(SpecialToken.timestamp(0.0))
        if tid is None:
            raise KeyError("tokenizer has no timestamp tokens")
        return tid

    def is_timestamp(self, token: int) -> bool:
        try:
            return token >= self.timestamp_begin and token < self.vocab_size
        except KeyError:
            return False

    def timestamp_seconds(self, token: int) -> float:
        """<|x.xx|> -> seconds (0.02 s grid)."""
        if not self.is_timestamp(token):
            raise ValueError(f"token {token} is not a timestamp")
        return (token - self.timestamp_begin) * 0.02


# ----------------------------------------------------------------------------
# Synthetic tokenizer construction (tests / offline environments).
# ----------------------------------------------------------------------------


def build_test_tokenizer_json(path: str, n_base_tokens: int = 256) -> None:
    """Write a miniature whisper-style tokenizer.json for tests.

    Byte-level BPE over single bytes plus the full Whisper special-token set
    (the set documented by the reference's `construct_special_tokens`,
    src/token.rs:297-324, minus most timestamps for size).
    """
    import json

    from tokenizers import Tokenizer, models, pre_tokenizers, decoders
    from tokenizers import AddedToken

    # byte-level alphabet as vocab, no merges: every byte is a token
    from tokenizers.pre_tokenizers import ByteLevel

    alphabet = ByteLevel.alphabet()
    vocab = {ch: i for i, ch in enumerate(sorted(alphabet)[:n_base_tokens])}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()

    specials = [SpecialToken.END_OF_TEXT, SpecialToken.START_OF_TRANSCRIPT]
    specials += [SpecialToken.language(c) for c in LANGUAGES]
    specials += [
        SpecialToken.TRANSLATE,
        SpecialToken.TRANSCRIBE,
        SpecialToken.START_OF_LM,
        SpecialToken.START_OF_PREV,
        SpecialToken.NO_SPEECH,
        SpecialToken.NO_TIMESTAMPS,
    ]
    specials += [SpecialToken.timestamp(i * 0.02) for i in range(4)]
    tok.add_special_tokens([AddedToken(s, special=True) for s in specials])
    tok.save(path)


# The real multilingual tokenizer.json carries 99 language tokens -- the
# reference's LANGUAGES table (src/token.rs:50-58, mirrored above) omits
# "haw", which sits between "tt" and "ln" in the trained vocabulary. Using
# the reference order alone would shift every id after 50352 by one.
LANGUAGES_FULL: tuple = (
    LANGUAGES[: LANGUAGES.index("ln")]
    + ("haw",)
    + LANGUAGES[LANGUAGES.index("ln"):]
)

# large-v3 appends Cantonese after the v2 table: 100 language tokens at
# 50259..50358, shifting every later special token up by one (vocab 51866).
LANGUAGES_V3: tuple = LANGUAGES_FULL + ("yue",)


def build_full_scale_tokenizer_json(path: str, v3: bool = False) -> None:
    """Write a FULL-SCALE whisper-layout tokenizer.json (vocab 51865).

    The base vocabulary is synthetic (50257 placeholder word pieces -- the
    real BPE merges are not redistributable offline), but the added-token
    block replicates the real multilingual layout exactly:

        50257 <|endoftext|>        50258 <|startoftranscript|>
        50259..50357 99 languages  50358 <|translate|>
        50359 <|transcribe|>       50360 <|startoflm|>
        50361 <|startofprev|>      50362 <|nospeech|>
        50363 <|notimestamps|>     50364..51864 <|0.00|>..<|30.00|>

    This pins the ids that drive decoding (prompt construction, EOT,
    suppress mask) to their true values, so the id-level semantics are
    validated at real scale without the real file (src/token.rs:297-324
    documents the same added-token set).

    `v3=True` writes the large-v3 layout instead (vocab 51866): <|yue|>
    joins the language block at 50358 and every later special token shifts
    up by one (<|translate|> 50359 ... <|notimestamps|> 50364,
    timestamps 50365..51865).
    """
    from tokenizers import AddedToken, Tokenizer, models

    n_base = 50257
    vocab = {f"w{i} ": i for i in range(n_base)}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))

    specials = [SpecialToken.END_OF_TEXT, SpecialToken.START_OF_TRANSCRIPT]
    specials += [SpecialToken.language(c)
                 for c in (LANGUAGES_V3 if v3 else LANGUAGES_FULL)]
    specials += [
        SpecialToken.TRANSLATE,
        SpecialToken.TRANSCRIBE,
        SpecialToken.START_OF_LM,
        SpecialToken.START_OF_PREV,
        SpecialToken.NO_SPEECH,
        SpecialToken.NO_TIMESTAMPS,
    ]
    specials += [SpecialToken.timestamp(i * 0.02) for i in range(1501)]
    tok.add_special_tokens([AddedToken(s, special=True) for s in specials])
    tok.save(path)
