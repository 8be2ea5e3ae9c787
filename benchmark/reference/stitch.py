"""The splice of a stream's consecutive windows into one token list, as
whisper-burn's transcribe loop does it (src/transcribe.rs:56-110).

Consecutive windows overlap in audio, so the end of one window's tokens
may repeat at the start of the next. For each offset o below
`max_offsets` (and below both lengths), the last o + 1 tokens of the
stream so far are laid against the first o + 1 of the new window, and the
positions where the two agree are counted; they need not be contiguous.
The offset with the most agreements (the first such offset on a tie)
wins, and if it agrees in at least `min_overlaps` positions the stream is
cut at its first agreement and the new window continues from there;
otherwise the new window is appended whole (with `min_overlaps` 0 and no
agreement at all, the stream restarts at the new window). A window that
was not decoded (None) is skipped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def overlap(prev: Sequence[int], curr: Sequence[int], max_offsets: int,
            min_overlaps: int) -> Optional[Tuple[int, int]]:
    """(cut in prev, start in curr) of the best alignment, or None."""
    best, where = 0, None
    for o in range(min(len(prev), len(curr), max_offsets)):
        start = len(prev) - 1 - o
        agree = [i for i in range(o + 1) if prev[start + i] == curr[i]]
        if len(agree) > best:
            best, where = len(agree), (start + agree[0], agree[0])
    return (where or (0, 0)) if best >= min_overlaps else None


def stitch(windows: Sequence[Optional[Sequence[int]]], max_offsets: int,
           min_overlaps: int) -> List[int]:
    """One stream's tokens from its windows' tokens, in window order."""
    out: List[int] = []
    for toks in windows:
        if toks is None:
            continue
        cut = overlap(out, toks, max_offsets, min_overlaps)
        if cut is None:
            out.extend(toks)
        else:
            del out[cut[0]:]
            out.extend(toks[cut[1]:])
    return out
