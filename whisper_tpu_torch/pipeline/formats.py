"""Subtitle / tabular writers for timestamped segments.

Counterpart of `whisper_tpu/pipeline/formats.py` (the reference CLI writes
only a plain-text file, src/bin/transcribe/main.rs:150-158). Converts the
[Segment] list produced by ``Transcriber.transcribe_with_timestamps`` into
the standard interchange formats users of OpenAI's `whisper` CLI expect:

* SRT    — numbered cues, ``HH:MM:SS,mmm`` timestamps
* WebVTT — ``WEBVTT`` header, ``HH:MM:SS.mmm`` timestamps; with word
           timings present, one ``<u>``-highlighted cue per word
           (karaoke-style), matching openai-whisper's --highlight_words
* TSV    — ``start\tend\ttext`` with integer milliseconds

All writers are pure string builders over the Segment dataclass
(pipeline/segments.py) so they are trivially testable without a model.
"""

from __future__ import annotations

from typing import Iterable, List


def _hms(seconds: float, *, decimal_sep: str) -> str:
    """``HH:MM:SS<sep>mmm`` with millisecond precision, non-negative."""
    ms = max(0, round(seconds * 1000.0))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1_000)
    return f"{h:02d}:{m:02d}:{s:02d}{decimal_sep}{ms:03d}"


def srt_timestamp(seconds: float) -> str:
    return _hms(seconds, decimal_sep=",")


def vtt_timestamp(seconds: float) -> str:
    return _hms(seconds, decimal_sep=".")


def to_srt(segments: Iterable) -> str:
    """SubRip document: blank-line-separated numbered cues."""
    blocks: List[str] = []
    for i, seg in enumerate(segments, start=1):
        blocks.append(
            f"{i}\n{srt_timestamp(seg.start)} --> {srt_timestamp(seg.end)}\n"
            f"{seg.text.strip()}\n"
        )
    return "\n".join(blocks)


def _word_cues(seg) -> List[str]:
    """Per-word VTT cues for one segment: the full text with the active
    word wrapped in <u>...</u> (openai-whisper --highlight_words shape)."""
    words = seg.words
    cues: List[str] = []
    for j, w in enumerate(words):
        line = "".join(
            f"<u>{v.word}</u>" if k == j else v.word
            for k, v in enumerate(words)
        ).strip()
        end = words[j + 1].start if j + 1 < len(words) else w.end
        cues.append(
            f"{vtt_timestamp(w.start)} --> {vtt_timestamp(max(end, w.start))}\n"
            f"{line}\n"
        )
    return cues


def to_vtt(segments: Iterable, *, highlight_words: bool = False) -> str:
    """WebVTT document. With ``highlight_words`` and word timings present,
    emits one cue per word with the active word underlined."""
    cues: List[str] = ["WEBVTT\n"]
    for seg in segments:
        if highlight_words and seg.words:
            cues.extend(_word_cues(seg))
        else:
            cues.append(
                f"{vtt_timestamp(seg.start)} --> {vtt_timestamp(seg.end)}\n"
                f"{seg.text.strip()}\n"
            )
    return "\n".join(cues)


def to_tsv(segments: Iterable) -> str:
    """``start\tend\ttext`` rows in integer milliseconds (openai-whisper's
    .tsv writer shape), with a header row."""
    rows = ["start\tend\ttext"]
    for seg in segments:
        rows.append(
            f"{round(seg.start * 1000)}\t{round(seg.end * 1000)}\t"
            f"{seg.text.strip()}"
        )
    return "\n".join(rows) + "\n"
