"""Timestamped segment extraction from decoded token sequences.

Counterpart of `whisper_tpu/pipeline/segments.py` (pure Python, no jax):
with `DecodeOptions(timestamps=True)` the prompt omits <|notimestamps|>,
the model is free to emit <|x.xx|> tokens, and this module turns them into
[{start, end, text}] segments. (The reference, whisper-burn, always
decodes with <|notimestamps|>, src/transcribe.rs:203.)

Parsing follows the vocabulary's semantics: a timestamp token opens a
segment (its time = window offset + x.xx), the next timestamp token closes
it; consecutive timestamps (close immediately followed by the next open) are
the standard Whisper emission pattern. Text before the first timestamp or
after an unclosed one becomes a segment bounded by the window edges.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..text.tokenizer import WhisperTokenizer


@dataclasses.dataclass
class Segment:
    start: float  # seconds, absolute (window offset included)
    end: float
    text: str
    tokens: List[int]
    # per-word timings (align.WordTiming), filled by
    # transcribe_with_timestamps(word_timestamps=True); None otherwise
    words: list = None
    # decode-quality metadata of the window this segment came from (every
    # production Whisper result schema exposes these so consumers can
    # filter low-confidence segments); None when the decode path did not
    # compute them (plain text pipelines)
    avg_logprob: float = None  # mean sampled-token log-prob
    compression_ratio: float = None  # gzip ratio of the window text
    no_speech_prob: float = None  # p(<|nospeech|>) at the SOT position


def segments_from_tokens(
    tokens: Sequence[int],
    tok: WhisperTokenizer,
    offset_s: float = 0.0,
    window_s: float = 30.0,
) -> List[Segment]:
    """Split a decoded (single-window) token sequence at timestamp tokens.

    Non-timestamp special tokens (prompt, EOT) are skipped. Returns [] when
    the sequence carries no text.
    """
    return [s for s, _ in segments_with_positions(tokens, tok, offset_s, window_s)]


def segments_with_positions(
    tokens: Sequence[int],
    tok: WhisperTokenizer,
    offset_s: float = 0.0,
    window_s: float = 30.0,
) -> List:
    """Like segments_from_tokens, but each segment carries the POSITIONS of
    its text tokens within `tokens`: returns [(Segment, [pos, ...])].

    The positions drive token-overlap stitching across windows
    (`Transcriber.transcribe_with_timestamps`): when the stitcher
    splices two windows' raw token lists at an index, segments are trimmed
    at exactly that index instead of being dropped wholesale.
    """
    out: List = []
    cur_tokens: List[int] = []
    cur_pos: List[int] = []
    cur_start = offset_s

    def flush(end_s: float) -> None:
        nonlocal cur_tokens, cur_pos, cur_start
        if cur_tokens:
            text = tok.decode(cur_tokens, skip_special=True)
            if text.strip():
                out.append(
                    (Segment(cur_start, end_s, text, list(cur_tokens)),
                     list(cur_pos))
                )
        cur_tokens = []
        cur_pos = []

    open_segment = False
    for i, t in enumerate(tokens):
        t = int(t)
        if tok.is_timestamp(t):
            ts = offset_s + tok.timestamp_seconds(t)
            if open_segment:
                flush(ts)  # closing timestamp
                open_segment = False
            else:
                flush(ts)  # text without a closing stamp ends here
                cur_start = ts
                open_segment = True
        elif tok.is_special(t):
            continue
        else:
            cur_tokens.append(t)
            cur_pos.append(i)
    flush(offset_s + window_s)
    return out


class TimestampStitcher:
    """Token-overlap stitching for timestamped windows, shared by the
    single-stream (`Transcriber.transcribe_with_timestamps`) and batched
    (`BatchTranscriber.transcribe_many_with_timestamps`) pipelines so both
    give identical segments from identical per-window token sequences.

    Windows are joined by the same suffix/prefix token alignment as the
    plain text path (find_chunk_overlap, whisper-burn src/transcribe.rs:
    76-110 semantics); on a splice, previous segments are trimmed at the
    exact splice index -- no boundary segment is silently dropped or
    duplicated. Feed windows in stream order via `add_window`; read
    `.segments` (text-bearing Segments) and `.all_tokens` at the end.
    """

    def __init__(self, tok: WhisperTokenizer, max_offsets: int = 40,
                 min_overlaps: int = 3):
        self.tok = tok
        self.max_offsets = max_offsets
        self.min_overlaps = min_overlaps
        self.all_tokens: List[int] = []  # stitched raw tokens
        self._segments: List = []  # [(Segment, [global token positions])]

    def add_window(self, new_tokens: Sequence[int], offset_s: float,
                   window_s: float, quality=None) -> None:
        """Stitch one window's decoded tokens (prompt stripped) at absolute
        stream offset `offset_s` spanning `window_s` seconds.

        `quality`: optional (avg_logprob, compression_ratio, no_speech_prob)
        of the window's decode, attached to each of its segments.
        """
        from .transcribe import find_chunk_overlap  # lazy: no import cycle

        tok = self.tok
        new_tokens = [int(t) for t in new_tokens]
        new_segs = segments_with_positions(
            new_tokens, tok, offset_s, window_s)
        if quality is not None:
            for seg, _ in new_segs:
                seg.avg_logprob, seg.compression_ratio, seg.no_speech_prob \
                    = quality

        spliced = find_chunk_overlap(
            self.all_tokens, new_tokens, self.max_offsets, self.min_overlaps)
        if spliced is None:
            base = len(self.all_tokens)
            self.all_tokens = self.all_tokens + new_tokens
            self._segments += [
                (seg, [p + base for p in pos]) for seg, pos in new_segs
            ]
            return
        pi, ci = spliced
        self.all_tokens = self.all_tokens[:pi] + new_tokens[ci:]
        # trim previous segments at the splice: drop text tokens at global
        # positions >= pi (superseded by the new window's reading of the
        # same audio)
        trimmed = []
        for seg, pos in self._segments:
            keep = [(t, p) for t, p in zip(seg.tokens, pos) if p < pi]
            if not keep:
                continue
            if len(keep) != len(seg.tokens):
                toks_k = [t for t, _ in keep]
                seg = dataclasses.replace(
                    seg, tokens=toks_k,
                    text=tok.decode(toks_k, skip_special=True),
                )
            trimmed.append((seg, [p for _, p in keep]))
        self._segments = trimmed
        shift = pi - ci  # window position p -> global p + shift
        for seg, pos in new_segs:
            keep = [(t, p) for t, p in zip(seg.tokens, pos) if p >= ci]
            if not keep:
                continue
            if len(keep) != len(seg.tokens):
                toks_k = [t for t, _ in keep]
                seg = dataclasses.replace(
                    seg, tokens=toks_k,
                    text=tok.decode(toks_k, skip_special=True),
                )
            self._segments.append((seg, [p + shift for _, p in keep]))

    @property
    def segments(self) -> List[Segment]:
        """Text-bearing segments stitched so far."""
        return [s for s, _ in self._segments if s.text.strip()]
