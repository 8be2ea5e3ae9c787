"""Whether what the timed path produced is correct, judged by the plain
reference after the window has closed.

Every completed call is held to its shape: each recording comes back as
its windows' tokens (read from the same call) and the stream the program
spliced from them. Every window is the configuration's prompt and then
`max_depth` decoded tokens, as many windows as the recording's length
gives, and the stream must be what the reference splice
(`reference/stitch.py`, with the traffic's stitch options) makes of the
windows. Then a sample of windows drawn from the seed (tails, a window of
a padded last batch, the rest full windows) goes through the reference:
its log-mel, encoder and teacher-forced decoder over the prompt and the
served tokens, in float32 with TF32 off, on weights the reference makes
again from the seed.

A served token's gap is how far its reference logit lies below the
reference's best allowed logit at that position (greedy), or below its
beam_size-th best (beam search, whose lanes each expand their top
beam_size tokens), in standard deviations of the reference's logits at
that position; a token the suppression window forbids reads
FORBIDDEN_GAP. Over the sampled tokens, `widest_gap` is the largest gap
and `mean_gap` their mean.

Under greedy decoding, `logit_noise` is the noise that the served tokens
show in the program's logits, in the same units: the maximum-likelihood
noise level delta under which the served token leaves the reference's
best allowed token as often as it does, a position with the top two a
margin m apart flipping with probability Phi(-m / (delta sqrt 2)). Unlike
the gaps it does not grow with how many near-ties a seed's weights make,
only with how far the program's logits lie from the reference's.

Under beam search the reference also searches each sampled window itself
(`reference.whisper.beam_search`, the same width and depth) and scores
both its own best hypothesis and the served one by its summed log-probs,
teacher-forced. A window's deficit is how far the served hypothesis
scores below the reference's own best (0 where it scores as high or
higher): `mean_deficit` and `widest_deficit` over the sampled windows, in
nats. This sees the scoring of the lanes and the choice of the final
hypothesis, which a per-token gap cannot.

A cell's limits file names the numbers it is held to, each with its limit
and the readings that set it.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import traffic as tr
from .reference import stitch
from .reference import whisper as ref
from .weights import derived_seed, make_weights

BLOCK = 8  # windows a reference pass takes at once
FORBIDDEN_GAP = 1e6  # the gap of a token the suppression window forbids


@dataclasses.dataclass
class CallRecord:
    call: tr.Call
    wall_s: float
    tokens: Optional[List[List[int]]]  # per recording, None if the call raised
    # per recording, each window's tokens (None where not decoded)
    windows: Optional[List[List[Optional[List[int]]]]] = None
    error: Optional[str] = None


@dataclasses.dataclass
class Served:
    """One window as the program served it."""
    call: int
    recording: int
    window: int
    start: int
    end: int
    tokens: List[int]  # the decoded tokens, prompt excluded


def split_calls(records: Sequence[CallRecord], cfg: Dict, traffic: Dict
                ) -> Tuple[List[Served], int, int]:
    """(every window served by a well-formed call, failed calls, calls
    whose answer has the wrong shape or a stream that is not the splice
    of its windows)."""
    geo = tr.geometry(cfg, traffic)
    opt = traffic["options"]
    prompt = cfg["tokens"]["prompt_en_transcribe_notimestamps"]
    per = len(prompt) + opt["max_depth"]
    served, failed, wrong = [], 0, 0
    for rec in records:
        if rec.tokens is None:
            failed += 1
            continue
        ok = (rec.windows is not None
              and len(rec.tokens) == len(rec.call.lengths)
              and len(rec.windows) == len(rec.call.lengths))
        windows = []
        for r, n in enumerate(rec.call.lengths if ok else ()):
            bounds, wins = tr.windows(n, geo), rec.windows[r]
            if len(wins) != len(bounds):
                ok = False
                break
            for w, ((start, end), chunk) in enumerate(zip(bounds, wins)):
                chunk = [int(t) for t in chunk or ()]
                if len(chunk) != per or chunk[:len(prompt)] != prompt:
                    ok = False
                windows.append(Served(rec.call.index, r, w, start, end,
                                      chunk[len(prompt):]))
            if [int(t) for t in rec.tokens[r]] != stitch.stitch(
                    wins, opt["stitch_max_offsets"], opt["stitch_min_overlaps"]):
                ok = False
        if ok:
            served += windows
        else:
            wrong += 1
    return served, failed, wrong


def sample(served: Sequence[Served], cfg: Dict, traffic: Dict, seed: int
           ) -> List[Served]:
    """`check_windows` windows drawn from the seed: up to two tails, one
    window of a last batch that was padded (if any), the rest full."""
    rng = np.random.default_rng(derived_seed(seed, 3))
    n = traffic["check_windows"]
    geo = tr.geometry(cfg, traffic)
    batch = traffic["batch_size"]
    tails = [i for i, s in enumerate(served) if s.end - s.start < geo.window]
    full = [i for i, s in enumerate(served) if s.end - s.start == geo.window]
    # full windows are batched in call order: a call's last batch holds
    # its windows past the last multiple of batch_size
    by_call: Dict[int, List[int]] = {}
    for i in full:
        by_call.setdefault(served[i].call, []).append(i)
    padded = [i for ids in by_call.values() if len(ids) % batch
              for i in ids[len(ids) - len(ids) % batch:]]
    pick = list(rng.choice(tails, min(2, len(tails)), replace=False))
    if padded:
        pick.append(int(rng.choice(padded)))
    taken = set(pick)
    rest = [i for i in full if i not in taken]
    pick += list(rng.choice(rest, min(max(n - len(pick), 0), len(rest)),
                            replace=False))
    return [served[i] for i in sorted(int(i) for i in pick)]


def gaps(logits: torch.Tensor, tokens: torch.Tensor, rank: int,
         masked: torch.Tensor, first_special: int) -> torch.Tensor:
    """(n,) gaps in standard deviations: logits (n, V) scores tokens (n,);
    `masked` rows forbid the ids from first_special on; the threshold is
    the rank-th best allowed logit."""
    logits = logits.double()
    sigma = logits.std(dim=-1, unbiased=False)
    ids = torch.arange(logits.shape[1], device=logits.device)
    forbid = masked[:, None] & (ids >= first_special)[None, :]
    allowed = logits.masked_fill(forbid, float("-inf"))
    threshold = allowed.topk(rank, dim=-1).values[:, -1]
    own = logits.gather(1, tokens[:, None])[:, 0]
    gap = ((threshold - own) / sigma).clamp(min=0.0)
    bad = forbid.gather(1, tokens[:, None])[:, 0]
    return torch.where(bad, torch.full_like(gap, FORBIDDEN_GAP), gap)


def margins(logits: torch.Tensor, tokens: torch.Tensor, masked: torch.Tensor,
            first_special: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(margin (n,), flipped (n,)): how far the best allowed logit lies
    above the second, in standard deviations, and whether the served
    token is not the best."""
    logits = logits.double()
    sigma = logits.std(dim=-1, unbiased=False)
    ids = torch.arange(logits.shape[1], device=logits.device)
    forbid = masked[:, None] & (ids >= first_special)[None, :]
    top = logits.masked_fill(forbid, float("-inf")).topk(2, dim=-1)
    return ((top.values[:, 0] - top.values[:, 1]) / sigma,
            tokens != top.indices[:, 0])


def logit_noise(margin: torch.Tensor, flipped: torch.Tensor) -> float:
    """The maximum-likelihood delta (a grid of 2.3% steps from 1e-5 to
    1) under which P(flip | m) = Phi(-m / (delta sqrt 2)); 0 when no
    token flipped."""
    if not bool(flipped.any()):
        return 0.0
    grid = torch.logspace(-5, 0, 501, dtype=torch.float64,
                          device=margin.device)
    z = -margin.double()[:, None] / (grid[None, :] * 2 ** 0.5)
    f = flipped[:, None]
    ll = torch.where(f, torch.special.log_ndtr(z),
                     torch.special.log_ndtr(-z)).sum(0)
    return float(grid[ll.argmax()])


def rank_of(traffic: Dict) -> int:
    opt = traffic["options"]
    return opt["beam_size"] if opt["strategy"] == "beam" else 1


def blocks(cfg: Dict, traffic: Dict, seed: int, windows: Sequence[Served],
           device, lengths: Dict[Tuple[int, int], int]):
    """Yield [(window, its samples)] of one length, BLOCK at a time.
    `lengths[(call, recording)]` gives each recording's samples, whose
    audio is made again from the seed."""
    by_rec: Dict[Tuple[int, int], List[Served]] = {}
    for s in windows:
        by_rec.setdefault((s.call, s.recording), []).append(s)
    pending: Dict[int, List[Tuple[Served, torch.Tensor]]] = {}
    for (call, rec), wins in sorted(by_rec.items()):
        audio = tr.audio(lengths[(call, rec)], seed, call, rec, device)
        for s in wins:
            block = pending.setdefault(s.end - s.start, [])
            block.append((s, audio[s.start:s.end].clone()))
            if len(block) == BLOCK:
                yield list(block)
                block.clear()
        del audio
    for block in pending.values():
        if block:
            yield block


def teacher_forced(block, prompt: List[int], device) -> torch.Tensor:
    """(B, len(prompt) + depth - 1) ids: each window's prompt and its
    served tokens but the last, whose logits score every served token."""
    return torch.tensor([prompt + s.tokens[:-1] for s, _ in block],
                        device=device)


def masked_positions(cfg: Dict, traffic: Dict, depth: int, device):
    """(depth,) bool: the positions at which the suppression window
    forbids the special tokens (sequence length <= suppress_until_len)."""
    n_prompt = len(cfg["tokens"]["prompt_en_transcribe_notimestamps"])
    return ((n_prompt + torch.arange(depth, device=device))
            <= traffic["options"]["suppress_until_len"])


def sequence_logp(logits: torch.Tensor, tokens: torch.Tensor, cfg: Dict,
                  traffic: Dict) -> torch.Tensor:
    """(B,) float64 summed reference log-probs of tokens (B, depth), whose
    logits (B, depth, V) are the teacher-forced ones that score them."""
    n_prompt = len(cfg["tokens"]["prompt_en_transcribe_notimestamps"])
    seq_len = n_prompt + torch.arange(tokens.shape[1], device=logits.device)
    logp = ref.log_probs(logits, seq_len, cfg["tokens"]["first_special"],
                         traffic["options"]["suppress_until_len"])
    return logp.gather(2, tokens[:, :, None])[:, :, 0].sum(1)


def gap_numbers(weights, cfg, traffic, seed, windows, device, lengths
                ) -> Dict[str, float]:
    """{"widest_gap", "mean_gap"} (standard deviations) over the windows'
    tokens and, under greedy decoding, "logit_noise" (the same units), or
    under beam search {"mean_deficit", "widest_deficit"} (nats) over the
    windows."""
    prompt = cfg["tokens"]["prompt_en_transcribe_notimestamps"]
    padding = traffic["options"]["padding"]
    rank = rank_of(traffic)
    worst, total, count = 0.0, 0.0, 0
    deficits: List[float] = []
    flips: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for block in blocks(cfg, traffic, seed, windows, device, lengths):
        mel = ref.log_mel(torch.stack([w for _, w in block]),
                          cfg["num_mel_bins"], cfg["max_source_positions"],
                          padding)
        audio = ref.encoder(weights, mel, cfg["encoder_attention_heads"])
        ids = teacher_forced(block, prompt, device)
        if rank > 1:  # the reference's own best, scored alongside
            best, _ = ref.beam_search(
                weights, audio, prompt, cfg["decoder_attention_heads"], rank,
                traffic["options"]["max_depth"], cfg["tokens"]["first_special"],
                traffic["options"]["suppress_until_len"])
            ids = torch.cat([ids, torch.cat([ids[:, :len(prompt)],
                                             best[:, :-1]], 1)])
            audio = torch.cat([audio, audio])
        logits = ref.decoder_logits(weights, ids, audio,
                                    cfg["decoder_attention_heads"])
        logits = logits[:, len(prompt) - 1:]
        toks = torch.tensor([s.tokens for s, _ in block], device=device)
        masked = masked_positions(cfg, traffic, toks.shape[1], device)
        for j in range(len(block)):
            g = gaps(logits[j], toks[j], rank, masked,
                     cfg["tokens"]["first_special"])
            worst = max(worst, float(g.max()))
            total += float(g.sum())
            count += len(g)
            if rank == 1:
                flips.append(margins(logits[j], toks[j], masked,
                                     cfg["tokens"]["first_special"]))
        if rank > 1:
            n = len(block)
            got = sequence_logp(logits[:n], toks, cfg, traffic)
            own = sequence_logp(logits[n:], best, cfg, traffic)
            deficits += (own - got).clamp(min=0.0).tolist()
    out = {"widest_gap": worst, "mean_gap": total / count}
    if flips:
        out["logit_noise"] = logit_noise(torch.cat([m for m, _ in flips]),
                                         torch.cat([f for _, f in flips]))
    if deficits:
        out.update(mean_deficit=sum(deficits) / len(deficits),
                   widest_deficit=max(deficits))
    return out


@dataclasses.dataclass
class Judgement:
    correct: bool
    checks: Dict[str, Dict[str, float]]  # name -> {"value", "limit"}
    failed: int  # calls that raised or answered in the wrong shape
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)


def numbers(records: Sequence[CallRecord], cfg: Dict, traffic: Dict,
            seed: int, device) -> Tuple[Dict[str, float], int, int]:
    """(every number the reference reads, failed calls, wrong answers)
    for the completed calls: the shape of each, then a seeded sample of
    their windows against the reference. Run after the program's state
    is freed."""
    served, failed, wrong = split_calls(records, cfg, traffic)
    lengths = {(rec.call.index, r): n for rec in records
               for r, n in enumerate(rec.call.lengths)}
    picked = sample(served, cfg, traffic, seed)
    # nothing compared: no run is correct without it
    names = ["widest_gap", "mean_gap"]
    names += (["mean_deficit", "widest_deficit"] if rank_of(traffic) > 1
              else ["logit_noise"])
    out = {name: FORBIDDEN_GAP for name in names}
    if picked:
        with torch.inference_mode(), ref.float32_matmuls():
            weights = make_weights(cfg, seed, device)
            out.update(gap_numbers(weights, cfg, traffic, seed, picked, device,
                                   lengths))
            del weights
            gc.collect()
    return out, failed, wrong


def judge(records: Sequence[CallRecord], cfg: Dict, traffic: Dict,
          limits: Dict, seed: int, device) -> Judgement:
    """Hold every completed call to its shape and a seeded sample of its
    windows to the reference, by the limits of the cell."""
    values, failed, wrong = numbers(records, cfg, traffic, seed, device)
    checks = {"failed_calls": {"value": failed, "limit": 0},
              "wrong_answers": {"value": wrong, "limit": 0}}
    for name, entry in limits["numbers"].items():
        checks[name] = {"value": values[name], "limit": entry["limit"]}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return Judgement(ok, checks, failed + wrong,
                     {k: v for k, v in values.items() if k not in checks})
