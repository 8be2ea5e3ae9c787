"""Generic host-side beam search -- API parity with the reference's `beam.rs`.

The port's copy of `whisper_tpu/decode/host_beam.py` (pure Python). The
reference exposes a model-agnostic, callback-driven beam search
(`beam_search(initial_beams, next, is_finished, beam_size, max_depth)`,
src/beam.rs:9-37) that the transcription pipeline drives with a closure doing
the device work. The port's pipeline uses the batched device loop of
`decode/beam.py` instead, but this module keeps the generic component: it is
useful for tests with stub scorers, for non-Whisper decoders, and as an
executable specification of the exact reference semantics.

Semantic notes (all mirrored from src/beam.rs):
  * `BeamNode(seq, log_prob)` with raw summed log-prob scores (:3-7);
  * each step: finished beams (per `is_finished`) are frozen; active beams
    expand via `next` and their top-k continuations merge (:39-79);
  * the returned beam list is top-k(active) ++ top-k(finished) (:72-78);
  * early stop when the best current beam is finished (:22-27);
  * `max_by` tie-breaking returns the LAST maximal element (:23,:34).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Generic, List, Sequence, Tuple, TypeVar

T = TypeVar("T")


@dataclasses.dataclass
class BeamNode(Generic[T]):
    """Reference: `BeamNode<T>` (src/beam.rs:3-7)."""

    seq: List[T]
    log_prob: float


NextFn = Callable[[Sequence["BeamNode[T]"]], List[List[Tuple[T, float]]]]
IsFinishedFn = Callable[[Sequence[T]], bool]


def _top_elements(elems: List, score: Callable, num: int) -> List:
    """Keep the `num` best elements, ascending by score (src/beam.rs:81-110).

    Insertion order matches the reference: on score ties the earlier-inserted
    element sits at a lower index; the list is ascending so the LAST element
    is the best.
    """
    top: List = []
    scores: List[float] = []
    for elem in elems:
        s = score(elem)
        if len(top) == num and s < scores[0]:
            continue
        idx = next((i for i, sc in enumerate(scores) if sc >= s), None)
        if idx is not None:
            top.insert(idx, elem)
            scores.insert(idx, s)
        else:
            top.append(elem)
            scores.append(s)
        if len(top) > num:
            top.pop(0)
            scores.pop(0)
    return top


def _best(beams: Sequence[BeamNode]) -> BeamNode:
    """Last maximal element, like Rust's `Iterator::max_by` (src/beam.rs:23)."""
    best = beams[0]
    for b in beams[1:]:
        if b.log_prob >= best.log_prob:
            best = b
    return best


def beam_search_step(
    beams: List[BeamNode],
    next_fn: NextFn,
    is_finished: IsFinishedFn,
    beam_size: int,
) -> List[BeamNode]:
    """One expansion step (src/beam.rs:39-79)."""
    finished: List[BeamNode] = []
    new_beams: List[BeamNode] = []

    continuations = next_fn(beams)
    for node, conts in zip(beams, continuations):
        if is_finished(node.seq):
            finished.append(node)
        else:
            for tok, log_prob in _top_elements(
                list(conts), lambda c: c[1], beam_size
            ):
                new_beams.append(BeamNode(node.seq + [tok], log_prob))

    return _top_elements(new_beams, lambda b: b.log_prob, beam_size) + _top_elements(
        finished, lambda b: b.log_prob, beam_size
    )


def beam_search(
    initial_beams: List[BeamNode],
    next_fn: NextFn,
    is_finished: IsFinishedFn,
    beam_size: int,
    max_depth: int,
) -> List[T]:
    """Full search loop (src/beam.rs:9-37); returns the best sequence."""
    beams = initial_beams
    for _ in range(max_depth):
        if beams and is_finished(_best(beams).seq):
            break
        beams = beam_search_step(beams, next_fn, is_finished, beam_size)
    if not beams:
        return []
    return _best(beams).seq
